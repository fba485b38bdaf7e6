"""The model-in-the-loop methods and the latent-space dumps on the port's
data-parallel route, on the CPU: ``train_model`` in two gloo ranks (one
spawn for the file, every run inside it) at a global batch of 8, 4 rows a
rank, against ``pcgmix_tpu.train_model(n_devices=2)`` on the CPU mesh,
with torch init and the torch epoch order, on the same data.

- ``(saloptenv)durratiomixup`` and ``(closestknn=2)durmixmagwarp(0.2,4)``
  with the same injected saliency provider or latent function on both
  sides: each rank computes its block's maps or latents and the ranks
  gather them;
- ``lc-nointrusion`` (each rank joins and scores its block of the 4B-row
  pool, the losses are gathered, every rank picks the same rows and
  trains on its block of them) on resnet9-5k, and ``saliency-cutmix``
  (each rank's block of the live model's saliency bins, gathered) on
  Potes(noDropout), whose eval forward has no BatchNorm: on ResNet9 a conv
  bias ahead of BatchNorm has a zero gradient in exact arithmetic whose
  float32 rounding Adam scales, and the eval models part
  (``tests/test_torch_model_in_loop.py``).

Bar (``tests/test_torch_train_dp.py``'s): step 0 within 1e-5, every plot
epoch within 1e-3 relative, the recording-level predictions identical.
The plans (and ``lc-nointrusion``'s picks) of the two ranks are bit-equal
at every step.  The latent-space dumps of a two-rank run equal the
single-device run's within 1e-6, and only rank 0 writes them.  A batch of
7 rows, which does not divide over the ranks, runs whole on each rank
with rank 0's candidate losses: the single-device run's losses within
1e-6 and its picks.  The hooks
that reach spawned ranks pickle: the pretrained saliency provider and a
``LatentSpace`` as what rebuilds them."""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

from pcgmix_tpu.train import TrainConfig as JConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch import latent, utils
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.saliency import make_pretrained_saliency_fn
from pcgmix_tpu_torch.train import TrainConfig, loop
from tests import torch_dp_runs

T, BATCH, EPOCHS = 512, 8, 6
COMMON = dict(num_epochs=EPOCHS, batch_size=BATCH, save_artifacts=False)
HOOKED = [
    ("(saloptenv)durratiomixup", "resnet9-5k",
     {"saliency_model_provider": torch_dp_runs.amplitude_saliency}),
    ("(closestknn=2)durmixmagwarp(0.2,4)", "resnet9-5k",
     {"latent_feature_fn": torch_dp_runs.window_means}),
    ("lc-nointrusion", "resnet9-5k", {}),
]
DUMPED = ["durratiomixup", "gaussiannoise"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset():
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                    sig_len=T, seed=3)


def _potes_without_head_dropout(monkeypatch):
    """Potes(noDropout) in the JAX package: the head's Dropout(0.5) off too,
    and its torch-seeded init the port's seeded init carried over (as
    tests/test_torch_model_in_loop.py runs it)."""
    import flax.linen as fnn

    from pcgmix_tpu.train import convert as jconvert
    from pcgmix_tpu_torch.train.convert import seeded_init

    class _NoDropout:
        def __init__(self, rate, deterministic=None, **kw):
            pass

        def __call__(self, x, *args, **kw):
            return x

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(jconvert, "torch_seeded_init", lambda model, C, T, k, seed: (
        jconvert.torch_potes_to_flax(seeded_init(build_model(model, k, C, T), seed).state_dict())))


def _replicated_runs():
    """A model-in-the-loop method on a batch of 7 rows, which does not
    divide over two ranks: every rank runs all of it, rank 0's candidate
    losses broadcast."""
    return [("lc-nointrusion b7", dict(COMMON, model="resnet9-5k", method="lc-nointrusion",
                                       batch_size=7, device="cpu"), {})]


def _dump_runs(root):
    return [(m, dict(COMMON, model="resnet9-5k", method=m, device="cpu", latent_space=True,
                     experiments_root=os.path.join(root, m)),
             {"latent_space_model": torch_dp_runs.WindowMeans()}) for m in DUMPED]


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """Both ranks' runs, spawned while this process runs the references
    (the JAX package's mesh runs, the port's single-device dumps)."""
    root = tmp_path_factory.mktemp("dp_mil")
    hooked = [(m, dict(COMMON, model=model, method=m, device="cpu"), hooks)
              for m, model, hooks in HOOKED]
    live = [("saliency-cutmix", dict(COMMON, model="Potes(noDropout)",
                                     method="saliency-cutmix", device="cpu"), {})]
    ranks = torch_dp_runs.spawn_in_background({
        "hooked": ("train_runs", (dataset, hooked)),
        "live": ("train_runs", (dataset, live, 0.0)),
        "dumps": ("train_runs", (dataset, _dump_runs(str(root / "dp")))),
        "replicated": ("train_runs", (dataset, _replicated_runs())),
    })
    refs = {}
    for m, model, hooks in HOOKED:
        refs[m] = jtrain(JConfig(**COMMON, model=model, method=m, sig_len=T, torch_init=True,
                                 loader_parity="torch", n_devices=2), dataset, **hooks)
    mp = pytest.MonkeyPatch()
    try:
        _potes_without_head_dropout(mp)
        refs["saliency-cutmix"] = jtrain(JConfig(
            **COMMON, model="Potes(noDropout)", method="saliency-cutmix", sig_len=T,
            torch_init=True, loader_parity="torch", n_devices=2), dataset)
    finally:
        mp.undo()
    one = torch_dp_runs.train_runs(dataset, _dump_runs(str(root / "one"))
                                   + _replicated_runs())
    return ranks(), refs, one, root


def _assert_plans_equal(a, b):
    assert len(a) == len(b) and len(a)
    for p, q in zip(a, b):
        if isinstance(p, dict):
            assert sorted(p) == sorted(q)
            for k in p:
                np.testing.assert_array_equal(p[k], q[k], err_msg=k)
        else:
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("method,group", [(m, "hooked") for m, _, _ in HOOKED]
                         + [("saliency-cutmix", "live")])
def test_two_ranks_track_the_reference_mesh(method, group, runs):
    (r0, r1), refs, _, _ = runs
    got, ref = r0[group][method]["perf"], refs[method]
    assert got["steps"] == ref["steps"] == list(range(1, EPOCHS + 1))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj)).max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


@pytest.mark.parametrize("method,group", [(m, "hooked") for m, _, _ in HOOKED]
                         + [("saliency-cutmix", "live")])
def test_ranks_build_the_same_plans(method, group, runs):
    """Every host choice comes from the gathered numbers: the two ranks'
    plan arrays (displacements, closest pairs, saliency splices) and
    ``lc_select``'s picks are equal, bit for bit, at every step."""
    (r0, r1), _, _, _ = runs
    _assert_plans_equal(r0[group][method]["plans"], r1[group][method]["plans"])
    assert len(r0[group][method]["plans"]) == EPOCHS
    if method == "lc-nointrusion":
        assert len(r0[group][method]["picks"]) == EPOCHS
        _assert_plans_equal(r0[group][method]["picks"], r1[group][method]["picks"])


@pytest.mark.parametrize("method", DUMPED)
def test_dumps_come_from_rank_0_and_equal_single_device(method, runs):
    (r0, r1), _, one, root = runs
    assert (r0["dumps"][method]["dumps"], r1["dumps"][method]["dumps"]) == (EPOCHS, 0)
    names = [f"latent_space_train_{s}.pkl" for s in range(EPOCHS)]
    dp_dir, one_dir = (root / d / method / "latent_space" for d in ("dp", "one"))
    assert sorted(os.listdir(dp_dir)) == sorted(os.listdir(one_dir)) == sorted(names)
    for name in names:
        got, exp = utils.load_dict(str(dp_dir / name)), utils.load_dict(str(one_dir / name))
        assert got["fts"].shape == exp["fts"].shape == (BATCH, 16)
        np.testing.assert_allclose(got["fts"], exp["fts"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["target"], exp["target"])
    assert one[method]["dumps"] == EPOCHS


def _dir_for(path, method):
    return path


def test_hooks_pickle_as_what_rebuilds_them(tmp_path, dataset):
    """The pretrained saliency provider and a LatentSpace reach spawned
    ranks pickled and give the same numbers there; a hook that does not
    pickle is refused before any rank spawns, naming the way round."""
    torch.save(build_model("resnet9-5k", 2, 4, T).state_dict(), tmp_path / "model.pth")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 4, T)).astype(np.float32))
    y = torch.eye(2)[torch.tensor([0, 1, 1, 0])]
    frames = np.tile(np.array([0, 60, 200, 260, 480]), (4, 1))
    cfg = TrainConfig(model="resnet9-5k", device="cpu")
    provider = make_pretrained_saliency_fn(cfg, functools.partial(_dir_for, str(tmp_path)))
    again = pickle.loads(pickle.dumps(provider))
    np.testing.assert_array_equal(again(0)(x, y, frames), provider(0)(x, y, frames))
    torch.save(build_model("ResCNN", 2, 4, T).state_dict(), tmp_path / "rescnn.pth")
    space = latent.LatentSpace(str(tmp_path / "rescnn.pth"), sig_len=T, device="cpu")
    np.testing.assert_array_equal(pickle.loads(pickle.dumps(space.generate))(x),
                                  space.generate(x))
    with pytest.raises(TypeError, match="pickle"):
        loop.train_model(TrainConfig(model="resnet9-5k", method="(saloptenv)durratiomixup",
                                     n_devices=2, device="cpu", save_artifacts=False),
                         dataset, saliency_model_provider=lambda mix_model: None)


def test_replicated_batch_takes_rank_0s_numbers_and_equals_single_device(runs):
    """On a batch that does not divide over the ranks every rank runs the
    single-device step on all of it and takes rank 0's candidate losses:
    the same picks on both ranks, the single-device run's losses."""
    (r0, r1), _, one, _ = runs
    got, ref = r0["replicated"]["lc-nointrusion b7"], one["lc-nointrusion b7"]
    assert got["perf"]["steps"] == ref["perf"]["steps"]
    np.testing.assert_allclose(got["perf"]["train_loss"], ref["perf"]["train_loss"],
                               rtol=0, atol=1e-6)
    assert got["perf"]["test_wav_preds"] == ref["perf"]["test_wav_preds"]
    _assert_plans_equal(got["picks"], r1["replicated"]["lc-nointrusion b7"]["picks"])
    _assert_plans_equal(got["picks"], ref["picks"])

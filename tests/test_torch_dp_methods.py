"""The baselines, ``mixup`` and the latent methods on the port's
data-parallel route, on the CPU: ``train_model`` in two gloo ranks (one
spawn for the file, every method inside it) at a global batch of 8, 4
rows a rank, against ``pcgmix_tpu.train_model(n_devices=2)`` on the CPU
mesh (GSPMD over the global batch), with torch init and the torch epoch
order, on the same data.

- the 1-D baselines that read their own row alone (``timemask``,
  ``cutout``, ``cutout(ch)``, ``s1s2mask``, ``magnitudewarp``,
  ``timewarp``, ``respiratoryscale``), each on its rank's block of the
  plan; ``mixup(mix)``, its partner rows gathered from the corpus;
- ``latentmixup`` (the global latent through the autograd gather),
  ``manifold-cutout`` and ``manifold-cutmix`` (K3's plain version on the
  gathered latent's rows);
- the 2-D masks and ``mixup`` and ``latentmixup`` on a 4/8/16/32-wide
  ResNet9-2D carried over from the JAX package's flax init (the width at
  which the two packages' 2-D traces agree, ``tests/test_torch_spec2d.py``).

Bar (``tests/test_torch_train_dp.py``'s): step 0 within 1e-5, every plot
epoch within 1e-3 relative, the recording-level predictions identical,
over 4 steps: at lr 0.01 the manifold methods are chaotic here (their
eval-mode first part reads conv biases that Adam moves by rounding noise),
and the JAX package's own mesh run leaves its one-device run by 2.6e-3
(``manifold-cutout``) at step 7, 3e-4 (``manifold-cutmix``), but by 4e-5
at most over these 4 steps.
``classical_space`` with ``durmixmagwarp(0.2,4)`` (K4's plain version on a
rank's block of the 5-channel batch, the features of the gathered wide
band): rank 0 writes every step's CSV, equal to the single-device run's
byte for byte.
``gaussiannoise`` draws its noise from a torch generator, which
``jax.random`` does not reproduce: its two ranks are held against the
port's single-device run, every plot epoch within 1e-5 (also with two
steps per dispatch, the noise drawn ahead for the chunk).

The autograd gather: each rank's gradient of a loss that reads partner
rows of every rank equals the concatenated batch's within 1e-6, and one
``latentmixup`` and one ``manifold-cutmix`` step's averaged gradients
equal the single-device step's (a manifold first part gets zeros)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.train import TrainConfig as JConfig
from pcgmix_tpu.train import loop as jloop
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch.data import synthetic_physionet_dict, synthetic_spectrogram_dict
from tests import torch_dp_runs

T, BATCH, EPOCHS = 512, 8, 4
S, SPEC, NARROW = 32, "PhysioNet(spec128)", (4, 8, 16, 32)
METHODS_1D = ["timemask(0.2)", "cutout", "cutout(ch)", "s1s2mask", "magnitudewarp(0.2,4)",
              "timewarp(0.1,3)", "respiratoryscale", "mixup(mix)", "latentmixup",
              "manifold-cutout", "manifold-cutmix"]
METHODS_2D = ["freqmask(0.1)", "timemask(0.1)", "cutout(0.25,0.25)", "mixup(same)",
              "latentmixup"]
COMMON = dict(num_epochs=EPOCHS, batch_size=BATCH, save_artifacts=False)


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
    # 8 recordings × 2 segments: one batch of 8 per epoch (4 rows per rank)
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                    sig_len=T, seed=3)


@pytest.fixture(scope="module")
def spec_dataset():
    return synthetic_spectrogram_dict(num_wavs_train=8, num_wavs_test=4, segments_per_wav=1,
                                      size=S, seed=3)


@pytest.fixture(scope="module")
def narrow_2d():
    """The JAX package's 4/8/16/32-wide 2-D ResNet9 and its flax init at
    PRNGKey(seed_fix), taken jitted once."""
    from pcgmix_tpu.models.resnet9_2d import ResNet9_2D as JResNet9_2D

    variables = jax.jit(JResNet9_2D(filters=NARROW, train=False).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 1, S, S), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, variables)


def _runs_1d(methods):
    return [(m, dict(COMMON, model="resnet9-5k", method=m, device="cpu"), {})
            for m in methods]


def _runs_2d():
    return [(m, dict(COMMON, model="resnet9", dataset=SPEC, method=m, device="cpu"), {})
            for m in METHODS_2D]


def _jax_loop_starts_from(monkeypatch, variables):
    """The JAX loop's ``init_state`` from ``variables`` instead of an op by
    op flax init in each loop call (copied: its step donates the state)."""
    init_state = jloop.init_state

    class Initialized:
        @staticmethod
        def init(key, sample):
            return jax.tree_util.tree_map(jnp.copy, variables)

    monkeypatch.setattr(jloop, "init_state",
                        lambda cfg, model, train_ds, tx: init_state(cfg, Initialized, train_ds,
                                                                    tx))


@pytest.fixture(scope="module")
def runs(dataset, spec_dataset, narrow_2d, tmp_path_factory):
    """Both ranks' results (the 1-D methods and gaussiannoise, the 2-D ones,
    the gather cases), spawned while this process runs the references:
    pcgmix_tpu.train_model(n_devices=2) on the CPU mesh for every method
    but gaussiannoise, and the port's single-device gaussiannoise run."""
    from pcgmix_tpu.models.resnet9_2d import ResNet9_2D as JResNet9_2D

    noise_k2 = ("gaussiannoise k2", dict(COMMON, model="resnet9-5k", method="gaussiannoise",
                                         device="cpu", steps_per_dispatch=2), {})
    roots = {k: str(tmp_path_factory.mktemp(f"classical_{k}")) for k in ("dp", "one")}

    def classical(where):
        return ("classical", dict(COMMON, model="resnet9-5k", method="durmixmagwarp(0.2,4)",
                                  device="cpu", classical_space=True,
                                  experiments_root=roots[where]), {})

    ranks = torch_dp_runs.spawn_in_background({
        "1d": ("train_runs", (dataset, _runs_1d(METHODS_1D + ["gaussiannoise"])
                              + [noise_k2, classical("dp")])),
        "2d": ("train_runs", (spec_dataset, _runs_2d(), None, (NARROW, narrow_2d))),
        "cases": ("rank_cases", ())})
    refs = {}
    for m in METHODS_1D:
        refs["1d", m] = jtrain(JConfig(**COMMON, model="resnet9-5k", method=m, sig_len=T,
                                       torch_init=True, loader_parity="torch",
                                       n_devices=2), dataset)
    mp = pytest.MonkeyPatch()
    try:
        _jax_loop_starts_from(mp, jax.tree_util.tree_map(jnp.asarray, narrow_2d))
        mp.setattr(jloop, "build_model", lambda name, dataset, num_classes, train, **kw:
                   JResNet9_2D(num_classes, NARROW, train=train))
        for m in METHODS_2D:
            refs["2d", m] = jtrain(JConfig(**COMMON, model="resnet9", dataset=SPEC, method=m,
                                           loader_parity="torch", n_devices=2), spec_dataset)
    finally:
        mp.undo()
    one = torch_dp_runs.train_runs(dataset, _runs_1d(["gaussiannoise"]) + [classical("one")])
    refs["classical roots"] = roots
    return ranks(), refs, one


def _assert_tracks(got, ref, step0=1e-5, rel=1e-3):
    assert got["steps"] == ref["steps"] == list(range(1, EPOCHS + 1))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < step0, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj)).max() < rel, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=rel)


@pytest.mark.parametrize("method", METHODS_1D)
def test_two_ranks_track_the_reference_mesh(method, runs):
    (r0, r1), reference, _ = runs
    assert (r0["1d"]["rank"], r1["1d"]["rank"]) == (0, 1)
    _assert_tracks(r0["1d"][method]["perf"], reference["1d", method])
    # every rank planned the global batch: the same plans, bit for bit
    _assert_plans_equal(r0["1d"][method]["plans"], r1["1d"][method]["plans"])


@pytest.mark.parametrize("method", METHODS_2D)
def test_2d_two_ranks_track_the_reference_mesh(method, runs):
    (r0, r1), reference, _ = runs
    _assert_tracks(r0["2d"][method]["perf"], reference["2d", method])
    _assert_plans_equal(r0["2d"][method]["plans"], r1["2d"][method]["plans"])


@pytest.mark.parametrize("key", ["gaussiannoise", "gaussiannoise k2"])
def test_gaussian_noise_two_ranks_equal_single_device(key, runs):
    """Each rank keeps its rows of the global batch's draw from the plan's
    seed, so the two ranks' noise is the single-device run's; with two
    steps per dispatch too, whose noise is drawn ahead for the chunk."""
    (r0, _), _, one = runs
    got, ref = r0["1d"][key]["perf"], one["gaussiannoise"]["perf"]
    assert got["steps"] == ref["steps"]
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=0, atol=1e-5)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def _assert_plans_equal(a, b):
    assert len(a) == len(b) == EPOCHS
    for p, q in zip(a, b):
        assert (p is None) == (q is None)
        if p is not None:
            assert sorted(p) == sorted(q)
            for k in p:
                np.testing.assert_array_equal(p[k], q[k], err_msg=k)


def test_autograd_gather_gives_the_concatenated_batch_gradient(runs):
    (r0, r1), _, _ = runs
    got = np.concatenate([r0["cases"]["gather"], r1["cases"]["gather"]])
    np.testing.assert_allclose(got, torch_dp_runs.gather_grad_case(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["latentmixup", "manifold-cutmix"])
def test_latent_step_gradients_equal_single_device(method, runs):
    """A split step's gradients, averaged over the ranks, are the global
    batch's: the first part's through the autograd gather (latentmixup)
    or zeros (manifold-cutmix); both ranks hold the same.  A conv bias
    ahead of a BatchNorm has a gradient that is zero in exact arithmetic:
    its float32 value is rounding noise of the batch's sums, a few 1e-6 of
    the largest gradient, so the absolute bar is 1e-5 of that."""
    (r0, r1), _, _ = runs
    depth = 2 if method == "latentmixup" else 1
    ref = torch_dp_runs.latent_step_grads(None, method, depth)
    scale = max(float(np.abs(g).max()) for g in ref.values())
    for name, g in ref.items():
        np.testing.assert_array_equal(r0["cases"][method][name], r1["cases"][method][name])
        np.testing.assert_allclose(r0["cases"][method][name], g, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    if method == "manifold-cutmix":
        assert not np.any(ref["conv1.0.weight"]) and not np.any(
            r0["cases"][method]["conv1.0.weight"])


def test_classical_space_rank0_writes_the_single_device_csvs(runs):
    (r0, _), refs, one = runs
    dp, single = (os.path.join(refs["classical roots"][k], "classical_space")
                  for k in ("dp", "one"))
    names = [f"train_{i}.csv" for i in range(EPOCHS)]
    assert sorted(os.listdir(dp)) == sorted(os.listdir(single)) == sorted(names)
    for name in names:
        with open(os.path.join(dp, name)) as f, open(os.path.join(single, name)) as g:
            assert f.read() == g.read(), name
    np.testing.assert_allclose(r0["1d"]["classical"]["perf"]["train_loss"],
                               one["classical"]["perf"]["train_loss"], rtol=1e-3)

"""The live-model methods, the trainer and the runner's dependency runs of
the PyTorch port against pcgmix_tpu: ``lc-nointrusion`` (with and without
``+cutout``, its 4B-row candidate pool on K1's plain version with explicit
rows and a zero base, the reference's cross-class quirk) and
``saliency-cutmix`` (14 pieces from given bins) plan bit-equal to the JAX
engine and apply within 1e-6; ``lc_select`` equal; the frozen ResCNN
embedder within 1e-5 of the JAX model's depth-5 features; every
model-in-the-loop method training on two data-parallel gloo ranks, their
plans equal; ``train_model`` with a salopt and a closest method (the same
injected provider or ``latent_feature_fn`` on both sides),
``lc-nointrusion`` and ``saliency-cutmix`` (the live model) tracking
``pcgmix_tpu.train_model(torch_init=True, loader_parity="torch")`` at the
bar of tests/test_transplant_dynamics.py (step 0 within 1e-5, steps 0–6
within 1e-3 relative); the latent-space dumps equal to the JAX loop's; and
the runner training the dependencies first, in run dirs named as
``pcgmix_tpu.exp.dirs.experiment_dir`` names the JAX runner's
dependencies, with a rerun that trains nothing."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.exp import runner as jrunner
from pcgmix_tpu.exp.dirs import experiment_dir as jexperiment_dir
from pcgmix_tpu.exp.robust import hyperparameters_robust as jrobust
from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch import latent, utils
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import EpochIterator, physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.exp import runner
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.models.rescnn import ResCNN
from pcgmix_tpu_torch.saliency import bin_training_saliency
from pcgmix_tpu_torch.train import TrainConfig, loop, train_model
from pcgmix_tpu_torch.train.convert import jax_to_torch
from tests import torch_dp_runs

B, C, T = 8, 4, 512
STEPS = 8
EYE = np.eye(2, dtype=np.float32)
LC_METHODS = ["lc-nointrusion", "(rand)lc-nointrusion", "lc-nointrusion+cutout+1.0",
              "lc-nointrusion+0.5"]
SALIENCY_CUTMIX = ["saliency-cutmix", "saliency-cutmix+0.6"]
MODEL_IN_THE_LOOP = ["(saloptenv)durratiomixup", "(saloptsum-2)durmixmagwarp(0.2,4)",
                     "(closestknn=8)durratiomixup", "(closestbins=4)durmixmagwarp(0.2,4)",
                     "lc-nointrusion", "saliency-cutmix"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def split():
    ds = synthetic_physionet_dict(num_wavs_train=24, num_wavs_test=2,
                                  segments_per_wav=2, sig_len=T, seed=4)
    return physionet_split(ds, "train", train_balance=False)


def _batches(split, n_steps):
    step = 0
    while True:
        for b in EpochIterator(split, B, 1, step, "torch"):
            yield step, b
            step += 1
            if step >= n_steps:
                return


def _assert_arrays_equal(got, ref, where):
    assert sorted(got) == sorted(ref), where
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype, f"{where} {k}: {g.dtype} vs {r.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=f"{where} {k}")


def _bins_for(step, frames):
    """Per-segment bins of a seeded map, through the port's binning."""
    sal = np.random.default_rng(3000 + step).random((len(frames), T)).astype(np.float32)
    return bin_training_saliency(sal, frames)


def _check(method, split, **hooks_for):
    eng = AugmentEngine(AugmentConfig(method, B, C, T))
    ref = JEngine(JConfig(method, B, C, T))
    japply = jax.jit(ref.apply)
    n_plans = 0
    for step, b in _batches(split, STEPS):
        args = (step, b["frames"], b["label"], b["wav"])
        hooks = {k: (lambda f=f, b=b, step=step: f(step, b["frames"]))
                 for k, f in hooks_for.items()}
        got, exp = eng.plan(*args, **hooks), ref.plan(*args, **hooks)
        assert (got is None) == (exp is None), step
        if exp is None:
            continue
        n_plans += 1
        _assert_arrays_equal(got.arrays, exp.arrays, f"{method} step {step}")
        np.testing.assert_array_equal(got.frames_new, exp.frames_new)
        assert got.frames_new.dtype == exp.frames_new.dtype
        data = split.data[b["indices"]]
        out, tgt = eng.apply(torch.from_numpy(data), torch.from_numpy(EYE[b["label"]]),
                             got.arrays)
        jout, jtgt = japply(jnp.asarray(data), jnp.asarray(EYE[b["label"]]), exp.arrays)
        assert out.shape == jout.shape and tgt.shape == jtgt.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6,
                                   err_msg=f"{method} step {step}")
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0, atol=1e-6)
        yield got, exp, b
    assert n_plans >= 3


@pytest.mark.parametrize("method", LC_METHODS)
def test_lc_nointrusion_plans_and_applies_equal_reference(method, split):
    cross = 0
    for got, exp, b in _check(method, split):
        assert got.aux["n_per_class"] == exp.aux["n_per_class"]
        np.testing.assert_array_equal(got.aux["cand_labels"], exp.aux["cand_labels"])
        idx1, idx2 = got.arrays["idx1"], got.arrays["idx2"]
        assert len(idx1) == 4 * B
        cross += int((b["label"][idx1] != b["label"][idx2]).sum())
    assert cross > 0  # the reference's partner draw pairs across classes


@pytest.mark.parametrize("method", SALIENCY_CUTMIX)
def test_saliency_cutmix_plans_and_applies_equal_reference(method, split):
    for got, exp, _ in _check(method, split, saliency_bins_fn=_bins_for):
        assert got.aux["quasi_lam"] == exp.aux["quasi_lam"]
        assert got.arrays["len"].shape == (B, 14)


def test_saliency_cutmix_takes_negative_raw_bins():
    """Short segments make raw bin lengths negative: placed as empty, but
    counted raw in the target weight, as the JAX engine does."""
    frames = np.array([[0, 3, 10, 11, 19], [0, 40, 41, 80, 83], [0, 1, 2, 3, 4],
                       [0, 20, 90, 100, 300]] * 2, np.int64)
    labels = np.array([0, 1] * 4)
    bins = _bins_for(1, frames)
    assert (np.diff(bins[1], axis=1) < 0).any()
    got = AugmentEngine(AugmentConfig("saliency-cutmix", B, C, T)).plan(
        5, frames, labels, saliency_bins_fn=lambda: bins)
    exp = JEngine(JConfig("saliency-cutmix", B, C, T)).plan(
        5, frames, labels, saliency_bins_fn=lambda: bins)
    _assert_arrays_equal(got.arrays, exp.arrays, "short segments")
    np.testing.assert_array_equal(got.frames_new, exp.frames_new)


def test_lc_select_equals_reference(rng):
    eng = AugmentEngine(AugmentConfig("lc-nointrusion", B, C, T))
    ref = JEngine(JConfig("lc-nointrusion", B, C, T))
    for trial in range(10):
        n = 4 * B
        losses = rng.random(n).astype(np.float32)
        losses[rng.integers(0, n, 6)] = losses[0]  # exact ties
        labels = rng.integers(0, 2, n)
        per_class = [int(rng.integers(0, 6)), int(rng.integers(0, 6))]
        got = eng.lc_select(losses, labels, per_class)
        exp = ref.lc_select(losses, labels, per_class)
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("method", LC_METHODS[:1] + SALIENCY_CUTMIX[:1])
def test_live_model_bases_have_no_identity_plan(method, split):
    _, b = next(_batches(split, 1))
    args = (0, b["frames"], b["label"], b["wav"])
    for eng in (AugmentEngine(AugmentConfig(method, B, C, T)), JEngine(JConfig(method, B, C, T))):
        with pytest.raises(NotImplementedError, match="identity"):
            eng.identity_arrays(*args, saliency_bins_fn=lambda: _bins_for(0, b["frames"]))


def _hooks_for(method):
    if "salopt" in method:
        return {"saliency_model_provider": torch_dp_runs.amplitude_saliency}
    if "closest" in method:
        return {"latent_feature_fn": torch_dp_runs.window_means}
    return {}


@pytest.fixture(scope="module")
def over_ranks():
    """Every model-in-the-loop method through ``train_model`` on two
    spawned gloo ranks (one spawn) and on one device, 3 steps each."""
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                  sig_len=T, seed=3)
    runs = [(m, dict(model="resnet9-5k", method=m, num_epochs=3, batch_size=B,
                     save_artifacts=False, device="cpu"), _hooks_for(m))
            for m in MODEL_IN_THE_LOOP]
    ranks = torch_dp_runs.spawn_in_background({"runs": ("train_runs", (ds, runs))})
    one = torch_dp_runs.train_runs(ds, runs)
    return ranks(), one


@pytest.mark.parametrize("method", MODEL_IN_THE_LOOP)
def test_data_parallel_route_takes_the_model_in_the_loop(method, over_ranks):
    """Over two ranks each rank computes its block of the saliency maps,
    bins, latents or candidate losses and the ranks gather them: both
    ranks build the same plans (lc-nointrusion: the same picks), and the
    first step's loss is the single-device run's within 1e-5."""
    (r0, r1), one = over_ranks
    got, ref = r0["runs"][method], one[method]
    assert got["perf"]["steps"] == ref["perf"]["steps"] == [1, 2, 3]
    assert abs(got["perf"]["train_loss"][0] - ref["perf"]["train_loss"][0]) < 1e-5
    assert np.isfinite(got["perf"]["train_loss"]).all()
    for key in ("plans", "picks"):
        assert len(got[key]) == len(r1["runs"][method][key])
        for p, q in zip(got[key], r1["runs"][method][key]):
            for k in (p if isinstance(p, dict) else {"sel": p}):
                a, b = (p[k], q[k]) if isinstance(p, dict) else (p, q)
                np.testing.assert_array_equal(a, b, err_msg=f"{method} {key} {k}")
    assert len(got["picks"]) == (3 if method == "lc-nointrusion" else 0)


def test_frozen_embedder_equals_reference(tmp_path, split):
    """The canonical ResCNN embedder (its depth-5 pooled features) loads a
    model.pth and gives the JAX model's features within 1e-5."""
    jmodel = jbuild("ResCNN", "PhysioNet", 2, train=False)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(4), jnp.zeros((1, C, T), jnp.float32))
    v = jax.tree_util.tree_map(np.asarray, v)
    model = build_model("ResCNN", 2, C, T)
    model.load_state_dict(jax_to_torch("ResCNN", v["params"], v["batch_stats"]))
    path = str(tmp_path / "model.pth")
    torch.save(model.state_dict(), path)
    data = split.data[:B]
    got = latent.LatentSpace(path, num_channels=C, sig_len=T, device="cpu").generate(data)
    exp = np.asarray(jax.jit(lambda x: jmodel.apply(v, x, depth=5, part="first"))(data))
    assert got.shape == (B, 128)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)


def _np(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _provider(mix_model):
    """A saliency provider both packages take: a map of the batch's
    absolute amplitudes, the same float32 values on either side."""
    def fn(data, target_ohe, frames):
        x = np.abs(_np(data)).sum(axis=1)
        return x / x.max(axis=1, keepdims=True)
    return fn


def _latents(data):
    """Latents both packages take: each channel's mean over four windows."""
    x = _np(data)
    return x.reshape(len(x), x.shape[1] * 4, -1).mean(axis=-1)


@pytest.fixture(scope="module")
def small_ds():
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                    sig_len=T, seed=3)


def _potes_without_head_dropout(monkeypatch):
    """Potes(noDropout) in both packages: the head's Dropout(0.5) off too,
    and the JAX loop's torch-seeded init the port's seeded init carried
    over (as tests/test_torch_potes.py runs it)."""
    import flax.linen as fnn

    from pcgmix_tpu.train import convert as jconvert
    from pcgmix_tpu_torch.models import potes
    from pcgmix_tpu_torch.train.convert import seeded_init

    class _NoDropout:
        def __init__(self, rate, deterministic=None, **kw):
            pass

        def __call__(self, x, *args, **kw):
            return x

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(potes, "HEAD_DROPOUT", 0.0)
    monkeypatch.setattr(jconvert, "torch_seeded_init", lambda model, C, T, k, seed: (
        jconvert.torch_potes_to_flax(seeded_init(build_model(model, k, C, T), seed).state_dict())))


# saliency-cutmix runs on Potes(noDropout): its eval forward, which the live
# saliency map reads, has no BatchNorm.  ResNet9's does, and there a conv
# bias ahead of BatchNorm has a gradient that is zero in exact arithmetic,
# whose float32 rounding Adam scales per parameter: the two packages' eval
# models part (and with them the maps and plans, from the third step on)
# while every train-mode loss agrees (the maps of one state agree within
# 1e-5, tests/test_torch_saliency.py)
@pytest.mark.parametrize("method,model,hooks", [
    ("(saloptenv)durratiomixup", "resnet9-5k", dict(saliency_model_provider=_provider)),
    ("(closestknn=2)durmixmagwarp(0.2,4)", "resnet9-5k", dict(latent_feature_fn=_latents)),
    ("lc-nointrusion", "resnet9-5k", {}),
    ("saliency-cutmix", "Potes(noDropout)", {}),
])
def test_train_model_tracks_reference(method, model, hooks, small_ds, monkeypatch):
    if model.startswith("Potes"):
        _potes_without_head_dropout(monkeypatch)
    common = dict(model=model, method=method, num_epochs=7, batch_size=B,
                  save_artifacts=False)
    ref = jtrain(JTrainConfig(**common, sig_len=T, torch_init=True, loader_parity="torch",
                              n_devices=1), small_ds, **hooks)
    got = train_model(TrainConfig(**common, device="cpu"), small_ds, **hooks)
    assert got["steps"] == ref["steps"] == list(range(1, 8))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj)).max() < 1e-3, (lt, lj)


def test_salopt_method_needs_a_provider(small_ds):
    with pytest.raises(ValueError, match="saliency"):
        train_model(TrainConfig(model="resnet9-5k", method="(saloptenv)durratiomixup",
                                num_epochs=1, batch_size=B, save_artifacts=False,
                                device="cpu"), small_ds)


def test_latent_space_dumps_equal_reference(tmp_path, small_ds):
    """``latent_space`` with an embedder dumps each augmented batch's
    features per step, as the JAX loop does."""
    class MeanPool:
        @staticmethod
        def generate(data):
            return _latents(data)

    common = dict(model="resnet9-5k", method="durratiomixup", num_epochs=3, batch_size=B,
                  save_artifacts=False, latent_space=True)
    jtrain(JTrainConfig(**common, sig_len=T, torch_init=True, loader_parity="torch",
                        n_devices=1, experiments_root=str(tmp_path / "jax")), small_ds,
           latent_space_model=MeanPool())
    train_model(TrainConfig(**common, device="cpu", experiments_root=str(tmp_path / "torch")),
                small_ds, latent_space_model=MeanPool())
    names = sorted(os.listdir(tmp_path / "jax" / "latent_space"))
    assert names == sorted(os.listdir(tmp_path / "torch" / "latent_space"))
    assert names == [f"latent_space_train_{s}.pkl" for s in range(3)]
    for name in names:
        got = utils.load_dict(str(tmp_path / "torch" / "latent_space" / name))
        exp = utils.load_dict(str(tmp_path / "jax" / "latent_space" / name))
        np.testing.assert_allclose(got["fts"], exp["fts"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["target"], exp["target"])


def _narrow(name, num_classes, C, T, **kw):
    """The runner test's models: resnet9 at the 5k preset's widths, ResCNN
    8 wide (the run-dir names keep the registry's names)."""
    if name == "ResCNN":
        return ResCNN(num_classes, nf=8, num_channels=C)
    return build_model("resnet9-5k" if name == "resnet9" else name, num_classes, C, T, **kw)


@pytest.fixture(scope="module")
def dag(tmp_path_factory):
    """The runner over a salopt '-2' method and a closest method under the
    robust schedules (resnet9: 50 epochs, one step each), narrow models."""
    import pcgmix_tpu_torch.models as models

    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "build_model", _narrow)
    mp.setattr(models, "build_model", _narrow)  # the salopt provider's
    mp.setattr(latent, "LatentSpace", _narrow_latent_space)
    root = tmp_path_factory.mktemp("dag")
    ds = synthetic_physionet_dict(num_wavs_train=20, num_wavs_test=4, segments_per_wav=2,
                                  sig_len=T, seed=2)
    base = TrainConfig(model="resnet9", batch_size=32, experiments_root=str(root / "exp"),
                       device="cpu")
    methods = ["(saloptenv-2)durratiomixup", "(closestknn=3)durmixmagwarp(0.2,4)"]
    executed = runner.run_grid(base, ds, methods, [1.0], [1], seed_datas=[1100001],
                               progress=False)
    yield {"ds": ds, "base": base, "methods": methods, "executed": executed, "mp": mp}
    mp.undo()


class _narrow_latent_space(latent.LatentSpace):
    def __init__(self, path, num_channels=4, sig_len=2500, num_classes=2, device="cuda"):
        self.model = ResCNN(num_classes, nf=8, num_channels=num_channels)
        self.model.load_state_dict(torch.load(path, weights_only=True))
        self.model.to(device).eval()
        self.device, self.depth = torch.device(device), 5


def test_runner_trains_the_dependencies_first(dag):
    executed = dag["executed"]
    jbase = JTrainConfig(model="resnet9", batch_size=32, sig_len=T,
                         experiments_root=dag["base"].experiments_root)
    want = []
    for method in dag["methods"]:
        jcfg = jrobust(dataclasses.replace(jbase, method=method, seed_data=1100001))
        deps = [jrunner._latent_dependency(jcfg), jrunner._salopt_dependency(jcfg, True)]
        want += [jexperiment_dir(d) for d in deps if d is not None] + [jexperiment_dir(jcfg)]
    assert [experiment_dir(c) for c in executed] == want
    assert [c.method for c in executed] == [
        "durmixmagwarp(0.2,4)+0.2", "(saloptenv-2)durratiomixup", "base",
        "(closestknn=3)durmixmagwarp(0.2,4)"]
    assert executed[2].model == "ResCNN" and executed[2].num_epochs == 10
    for cfg in executed:
        assert os.path.exists(os.path.join(experiment_dir(cfg), "model.pth"))


def test_runner_rerun_trains_nothing(dag, capsys):
    assert runner.run_grid(dag["base"], dag["ds"], dag["methods"], [1.0], [1],
                           seed_datas=[1100001]) == []
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(line.startswith("skip (done): ") for line in out)


def test_runner_needs_the_dependency_model_pth(dag, tmp_path):
    """A dependency dir holding only the JAX package's model.msgpack is done
    for the done-check, but the port loads model.pth: the runner refuses
    before training the method, naming the path."""
    base = dataclasses.replace(dag["base"], experiments_root=str(tmp_path))
    dep = runner._salopt_dependency(
        dataclasses.replace(base, method="(saloptenv)durratiomixup", num_epochs=50), True)
    os.makedirs(experiment_dir(dep))
    open(os.path.join(experiment_dir(dep), "model.msgpack"), "wb").close()
    with pytest.raises(FileNotFoundError, match="model.pth"):
        runner.run_grid(base, dag["ds"], ["(saloptenv)durratiomixup"], [1.0], [1],
                        seed_datas=[1100001], progress=False)
    assert os.listdir(tmp_path) == [os.path.basename(experiment_dir(dep))]


def test_runner_latent_space_option_writes_no_dumps(tmp_path, small_ds):
    """``--latent-space`` sets the flag but, as in the JAX runner, passes no
    embedder, so the run dumps nothing."""
    path = tmp_path / "p.dat"
    utils.dict2file(small_ds, str(path))
    runner.main(["--dataset-file", str(path), "--device", "cpu", "--model", "resnet9-5k",
                 "--methods", "durratiomixup", "--num-epochs", "1", "--batch-size", "8",
                 "--no-robust", "--latent-space", "--experiments-root", str(tmp_path / "exp")])
    (run_dir,) = os.listdir(tmp_path / "exp")
    assert sorted(os.listdir(tmp_path / "exp" / run_dir)) == ["model.pth", "performance.pkl"]

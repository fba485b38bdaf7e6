"""The zoo through the port's training path against pcgmix_tpu: the port's
train step (``train/steps.py::TrainStep``) against the JAX package's
(``pcgmix_tpu/train/steps.py::make_train_step``) from the same carried
weights over 3 steps of Adam (OneCycle, gradient clipping, weight decay)
with PCGmix, for FCN, Singstad_d10 (weights shared across applications),
LSTM and gMLP: loss within 1e-5 at step 0 and 1e-3 relative after;
``manifold-cutmix`` and ``latentmixup`` plans bit-equal to the JAX
engine's for the split models, their applies on FCN and ResCNN latents
within 1e-6; ``train_model`` on the CPU with zoo models and the split
methods, and the runner with Singstad_d10 on its robust schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.train.losses import init_selc_table as jinit_selc_table
from pcgmix_tpu.train.steps import TrainState, make_train_step
from pcgmix_tpu.train.steps import make_optimizer as jmake_optimizer
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import EpochIterator, physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.exp import results
from pcgmix_tpu_torch.exp.runner import main
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train.convert import jax_to_torch
from pcgmix_tpu_torch.train.losses import init_selc_table
from pcgmix_tpu_torch.train.steps import TrainStep, make_optimizer
from tests.test_torch_zoo_ref import numpy_variables
from tests.test_torch_zoo_ref import one_torch_thread  # noqa: F401 (autouse)

B, C, T = 8, 4, 128
STEPS = 3
METHOD = "durratiomixup"


@pytest.fixture(scope="module")
def split():
    ds = synthetic_physionet_dict(num_wavs_train=12, num_wavs_test=2, segments_per_wav=2,
                                  sig_len=T, seed=5)
    return physionet_split(ds, "train", train_balance=False)


def _batches(split, n_steps):
    step = 0
    while step < n_steps:
        for b in EpochIterator(split, B, 1, step, "torch"):
            yield step, b
            step += 1
            if step >= n_steps:
                return


# Singstad_d10 at the learning rate of its robust schedule (exp/robust.py):
# at 0.01 its nine applications of one module make the steps so sensitive
# that the JAX package's own float32 and float64 steps part by 0.6 % at
# step 2 (and the port lies between them)
LR = {"FCN": 0.01, "Singstad_d10": 1e-5, "LSTM": 0.01, "gMLP": 0.01}


@pytest.mark.parametrize("name", list(LR))
def test_pcgmix_steps_track_the_jax_step(name, split):
    """Three PCGmix steps from the same weights: each package's engine
    plans the batch (bit-equal plans, tests/test_torch_plans.py), its step
    mixes, runs the model, SELC's soft-target loss and the update."""
    jm = jbuild(name, train=True)
    variables = numpy_variables(jm, (B, C, T), 3)
    params, stats = variables["params"], variables.get("batch_stats", {})
    tx = jmake_optimizer("adam", LR[name], 1e-4, 0.1, STEPS, True)
    jengine = JEngine(JConfig(METHOD, B, C, T))
    jstep = make_train_step(jm, tx, selc_es=99, engine=jengine,
                            train_data=jnp.asarray(split.data),
                            train_labels=jnp.asarray(split.label))
    state = TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                       soft_labels=jinit_selc_table(split.label, 2),
                       step=jnp.asarray(0, jnp.int32))

    model = build_model(name, 2, C, T)
    model.load_state_dict(jax_to_torch(name, params, stats))
    opt, sched = make_optimizer(model, "adam", LR[name], 1e-4, STEPS, True)
    engine = AugmentEngine(AugmentConfig(METHOD, B, C, T))
    step = TrainStep(model, opt, sched, torch.from_numpy(split.data),
                     torch.from_numpy(split.label), init_selc_table(split.label, 2),
                     num_classes=2, grad_clip=0.1, selc_es=99, engine=engine)
    got, want = [], []
    for i, b in _batches(split, STEPS):
        args = (i, b["frames"], b["label"], b["wav"])
        state, out = jstep(state, {"indices": b["indices"]}, jengine.plan(*args).arrays, 1,
                           jax.random.PRNGKey(i))
        want.append(float(out["loss"]))
        got.append(float(step(b["indices"], engine.plan(*args).arrays, 1)["loss"]))
    got, want = np.asarray(got), np.asarray(want)
    assert abs(got[0] - want[0]) < 1e-5, (got, want)
    assert (np.abs(got - want) / np.abs(want)).max() < 1e-3, (got, want)


# each split model's latent shapes by depth at B × C × T (depth 0: the input)
LATENTS = {
    "FCN": {1: (B, 128, T), 2: (B, 256, T), 3: (B, 128, T), 4: (B, 128)},
    "ResCNN": {1: (B, 64, T), 2: (B, 128, T), 3: (B, 256, T), 4: (B, 128, T),
               5: (B, 128)},
    "Singstad_d10": {1: (B, 128, T), 2: (B, 128, T), 3: (B, 128, T)},
}


@pytest.mark.parametrize("method", ["manifold-cutmix", "latentmixup", "manifold-cutout"])
@pytest.mark.parametrize("model", ["FCN", "FCN(custom)", "ResCNN", "Singstad_d10"])
def test_latent_plans_and_applies_equal_reference(model, method, split, rng):
    """Plans bit-equal over six steps (FCN's latentmixup depth is 4,
    ResCNN's 5, the others drawn), and each apply on a latent of the
    plan's depth within 1e-6 of the JAX engine's."""
    eng = AugmentEngine(AugmentConfig(method, B, C, T, model=model))
    ref = JEngine(JConfig(method, B, C, T, model=model))
    shapes = {0: (B, C, T), **LATENTS["FCN" if model.startswith("FCN") else model]}
    if model == "FCN(custom)":
        shapes.update({1: (B, 64, T), 2: (B, 128, T), 3: (B, 64, T), 4: (B, 64)})
    eye, depths = np.eye(2, dtype=np.float32), []
    for i, b in _batches(split, 6):
        args = (i, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args, _force=True), ref.plan(*args, _force=True)
        assert got.latent_depth == exp.latent_depth
        depths.append(got.latent_depth)
        assert sorted(got.arrays) == sorted(exp.arrays)
        for k, v in exp.arrays.items():
            np.testing.assert_array_equal(np.asarray(got.arrays[k]), np.asarray(v), err_msg=k)
        latent = rng.normal(size=shapes[got.latent_depth]).astype(np.float32)
        target = eye[b["label"]]
        out, tgt = eng.apply(torch.from_numpy(latent), torch.from_numpy(target), got.arrays)
        jout, jtgt = ref.apply(jnp.asarray(latent), jnp.asarray(target), exp.arrays)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0, atol=1e-6)
    if method == "latentmixup" and model in ("FCN", "ResCNN"):
        assert set(depths) == {4 if model == "FCN" else 5}
    else:
        assert len(set(depths)) > 1


@pytest.fixture(scope="module")
def dataset():
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4, segments_per_wav=2,
                                    sig_len=T, seed=3)


@pytest.mark.parametrize("model,method", [
    ("FCN", "durmixmagwarp(0.2,4)"), ("LSTM", "durmixmagwarp(0.2,4)"),
    ("FCN", "manifold-cutmix"), ("ResCNN", "latentmixup")])
def test_train_model_trains_the_zoo_on_the_cpu(model, method, dataset):
    perf = train_model(TrainConfig(model=model, method=method, num_epochs=3, batch_size=8,
                                   save_artifacts=False, device="cpu"), dataset)
    assert perf["epochs"] == [1, 2, 3] and perf["steps"][-1] >= 3
    assert np.isfinite(perf["train_loss"]).all() and np.isfinite(perf["test_loss"]).all()


def test_runner_trains_singstad_d10_on_its_robust_schedule(tmp_path):
    """The runner CLI takes every registry name; Singstad_d10's robust
    schedule is 30 epochs at lr_max 1e-5 (reference read_experiments.py)."""
    ds = synthetic_physionet_dict(num_wavs_train=4, num_wavs_test=2, segments_per_wav=2,
                                  sig_len=T, seed=3)
    utils.dict2file(ds, str(tmp_path / "p.dat"))
    root = str(tmp_path / "exp")
    main(["--dataset-file", str(tmp_path / "p.dat"), "--device", "cpu",
          "--model", "Singstad_d10", "--methods", "base", "--batch-size", "8",
          "--seed-datas", "1100001", "--experiments-root", root, "--no-plot"])
    cfg = TrainConfig(model="Singstad_d10", num_epochs=30, lr_max=1e-5, batch_size=8,
                      experiments_root=root)
    perf = results.read_performance(cfg)
    assert perf["epochs"][-1] == 30  # the run dir names lr_max 1e-5 too
    assert np.isfinite(perf["train_loss"]).all()


def test_manifold_methods_refuse_a_model_without_a_split(dataset):
    cfg = TrainConfig(model="InceptionTime", method="manifold-cutmix", num_epochs=1,
                      batch_size=8, save_artifacts=False, device="cpu")
    with pytest.raises(NotImplementedError, match="split"):
        train_model(cfg, dataset)

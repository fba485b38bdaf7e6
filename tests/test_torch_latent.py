"""The split forward and the latent methods of the PyTorch port against
pcgmix_tpu: ResNet9 (a narrow preset) and Potes carry the JAX package's
weights and give its latents at every depth within 1e-5, first ∘ second
is the full forward; latentmixup's and manifold-cutout's plans are
bit-equal to the JAX engine's over 8 steps, ``latent_depth`` included, and
their applies on a latent within 1e-6; the split step updates BatchNorm
as the JAX step does; and ``train_model`` with latentmixup tracks
``pcgmix_tpu.train_model(torch_init=True, loader_parity="torch")`` at the
bar of tests/test_transplant_dynamics.py (step 0 within 1e-5, steps 0-6
within 1e-3 relative), for ResNet9 and for ``Potes(noDropout)`` with the
head's dropout off on both sides (its masks cannot match), and with
manifold-cutout for ResNet9."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.models.registry import max_latent_depth as jmax_latent_depth
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import convert as jconvert
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import EpochIterator, physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.models import build_model, max_latent_depth, potes
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train.convert import (
    jax_potes_to_torch,
    jax_resnet9_to_torch,
    seeded_init,
)
from pcgmix_tpu_torch.train.steps import TrainStep, eval_mode, make_optimizer
from tests import torch_dp_runs

B, C, T = 8, 4, 512
STEPS = 8
ATOL = 1e-5
MAX_DEPTH = {"resnet9-15k": 3, "Potes": 1}


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
    # 8 recordings × 2 segments: one batch of 8 per epoch, so each plot
    # epoch's train_loss is one step's loss
    return synthetic_physionet_dict(
        num_wavs_train=8, num_wavs_test=6, segments_per_wav=2, sig_len=T, seed=3
    )


@pytest.fixture(scope="module")
def split():
    ds = synthetic_physionet_dict(
        num_wavs_train=16, num_wavs_test=2, segments_per_wav=2, sig_len=T, seed=4
    )
    return physionet_split(ds, "train", train_balance=False)


@pytest.fixture
def no_head_dropout(monkeypatch):
    """Potes' head Dropout(0.5) off in both packages."""
    import flax.linen as fnn

    class _NoDropout:
        def __init__(self, rate, deterministic=None, **kw):
            pass

        def __call__(self, x, *args, **kw):
            return x

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(potes, "HEAD_DROPOUT", 0.0)


@functools.lru_cache(maxsize=None)
def _carried(name, seed=0):
    """A JAX model (eval), its variables (flax init, jitted), the port's
    model holding them, and one jitted run of the JAX model on the split
    tests' input (the ``rng`` fixture's first draw): the activation at
    every depth, the second part from each, and the features."""
    jmodel = jbuild(name, train=False)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, C, T), jnp.float32))
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    model = build_model(name, 2, C, T)
    if name.startswith("Potes"):
        model.load_state_dict(jax_potes_to_torch(np_vars["params"]))
    else:
        model.load_state_dict(jax_resnet9_to_torch(np_vars["params"],
                                                   np_vars["batch_stats"]))
    x = np.random.default_rng(1234).normal(size=(B, C, T)).astype(np.float32)

    def run(v, x):
        firsts = [jmodel.apply(v, x, depth=d, part="first")
                  for d in range(MAX_DEPTH[name] + 1)]
        seconds = [jmodel.apply(v, f, depth=d, part="second") for d, f in enumerate(firsts)]
        return firsts, seconds, jmodel.apply(v, x, part="latent_space")

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(run)(variables, x))
    return jmodel, variables, model.eval(), x, ref


@pytest.mark.parametrize("name,depth", [("resnet9-15k", d) for d in range(4)]
                         + [("Potes", d) for d in range(2)])
def test_split_forward_matches_reference(name, depth):
    _, _, model, x, (jfirsts, jseconds, jfeatures) = _carried(name)
    with torch.no_grad():
        latent = model(torch.from_numpy(x), depth=depth, part="first")
        full = model(torch.from_numpy(x))
        again = model(latent, depth=depth, part="second")
    jlatent = jfirsts[depth]
    assert latent.shape == jlatent.shape
    np.testing.assert_allclose(latent.numpy(), jlatent, rtol=0, atol=ATOL)
    # the second part from the JAX package's latent, and first ∘ second
    with torch.no_grad():
        second = model(torch.from_numpy(jlatent), depth=depth, part="second")
    np.testing.assert_allclose(second.numpy(), jseconds[depth], rtol=0, atol=ATOL)
    assert torch.equal(again, full)
    with torch.no_grad():
        features = model(torch.from_numpy(x), part="latent_space")
    np.testing.assert_allclose(features.numpy(), jfeatures, rtol=0, atol=ATOL)


def test_split_forward_refuses_an_unknown_part():
    with pytest.raises(ValueError, match="part"):
        build_model("resnet9-5k", 2, C, T)(torch.zeros(1, C, T), part="middle")


@pytest.mark.parametrize("name", ["resnet9", "resnet9-5k", "Potes", "Potes(noDropout)",
                                  "FCN", "ResCNN", "Singstad_d10"])
def test_max_latent_depth_equals_reference(name):
    assert max_latent_depth(name) == jmax_latent_depth(name)


@pytest.mark.parametrize("name", ["InceptionTime", "Singstad_d3"])
def test_max_latent_depth_refuses_models_without_a_split(name):
    with pytest.raises(NotImplementedError):
        max_latent_depth(name)
    with pytest.raises(NotImplementedError):
        jmax_latent_depth(name)


def _batches(split, n_steps):
    step = 0
    while True:
        for b in EpochIterator(split, B, 1, step, "torch"):
            yield step, b
            step += 1
            if step >= n_steps:
                return


@pytest.mark.parametrize("method,model", [
    ("latentmixup", "resnet9"), ("latentmixup", "Potes"), ("latentmixup+0.5", "resnet9"),
    ("(alpha=0.4)latentmixup", "resnet9-5k"), ("manifold-cutout", "resnet9"),
    ("manifold-cutout+0.6", "resnet9"), ("manifold-cutout(ch)", "Potes"),
])
def test_latent_plans_and_applies_equal_reference(method, model, split, rng):
    eng = AugmentEngine(AugmentConfig(method, B, C, T, model=model))
    ref = JEngine(JConfig(method, B, C, T, model=model))
    japply = jax.jit(ref.apply)  # one compile per latent shape
    n_plans, depths = 0, set()
    eye = np.eye(2, dtype=np.float32)
    for step, b in _batches(split, STEPS):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args), ref.plan(*args)
        assert (got is None) == (exp is None), step
        if got is None:
            continue
        n_plans += 1
        assert got.latent_depth == exp.latent_depth, step
        depths.add(got.latent_depth)
        assert sorted(got.arrays) == sorted(exp.arrays)
        for k, v in exp.arrays.items():
            g, r = np.asarray(got.arrays[k]), np.asarray(v)
            assert g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=f"{method} step {step} {k}")
        # the apply on a latent of this depth's shape ((B, C', T') or (B, D))
        shape = {0: (B, C, T), 1: (B, 16, T // 2), 2: (B, 32, T // 16),
                 3: (B, 48)}[got.latent_depth]
        if model.startswith("Potes") and got.latent_depth == 1:
            shape = (B, 20)
        if "(ch)" in method:  # a window per input channel needs the input's
            shape = (B, C, T)
        latent = rng.normal(size=shape).astype(np.float32)
        target = eye[b["label"]]
        out, tgt = eng.apply(torch.from_numpy(latent), torch.from_numpy(target), got.arrays)
        jout, jtgt = japply(jnp.asarray(latent), jnp.asarray(target), exp.arrays)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0, atol=1e-6)
    assert n_plans >= 3
    assert len(depths) > 1 or model.startswith("Potes")


def _step(model, method, split):
    eng = AugmentEngine(AugmentConfig(method, B, C, T, model="resnet9"))
    opt, sched = make_optimizer(model, "adam", 0.01, 1e-4, 4, True)
    data = torch.from_numpy(split.data)
    step = TrainStep(model, opt, sched, data, torch.from_numpy(split.label),
                     torch.zeros(len(split), 2), num_classes=2, grad_clip=0.1,
                     selc_es=99, engine=eng)
    return eng, step


@pytest.mark.parametrize("method", ["latentmixup", "manifold-cutout"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_split_step_updates_batchnorm_as_the_jax_step(method, depth, split):
    """latentmixup's first part updates its BatchNorm running statistics
    (train mode); a manifold method's reads them and updates nothing (eval,
    no gradient); the second part updates its own in both; no layer runs
    in both parts, so every BatchNorm layer is updated at most once."""
    model = seeded_init(build_model("resnet9-5k", 2, C, T), 4)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    eng, step = _step(model, method, split)
    idx = np.arange(B)
    plan = eng.plan(0, split.frames[idx], split.label[idx], _force=True)
    out = step(idx, plan.arrays, 1, depth)
    assert np.isfinite(out["loss"].item())
    first_part = {1: ("conv1", "conv2", "res1"),
                  2: ("conv1", "conv2", "res1", "conv3", "conv4", "res2"),
                  3: ("conv1", "conv2", "res1", "conv3", "conv4", "res2")}[depth]
    for name, module in model.named_modules():
        if not hasattr(module, "num_batches_tracked"):
            continue
        in_first = name.startswith(first_part)
        updated = not torch.equal(before[f"{name}.running_mean"], module.running_mean)
        expect = (in_first and method == "latentmixup") or not in_first
        assert updated == expect, (name, depth, method)
        assert int(module.num_batches_tracked) == int(expect)
    assert model.training and all(m.training for m in model.modules())


def test_eval_mode_restores_each_flag():
    model = build_model("resnet9-5k", 2, C, T).train()
    model.res1.eval()
    with eval_mode(model):
        assert not any(m.training for m in model.modules())
    assert model.training and not model.res1.training and model.conv1.training


@pytest.mark.parametrize("method", ["latentmixup", "manifold-cutout"])
def test_latent_methods_split_over_ranks(method, split):
    """On a batch split over two data-parallel ranks a rank mixes its block
    of the latent with rows of every rank's block, read from the global
    latent the ranks gather (the split step's route; the masks read their
    own rows): in rank order, the whole latent's apply, bit for bit."""
    model = build_model("resnet9-5k", 2, C, T)
    eng = AugmentEngine(AugmentConfig(method, B, C, T, model="resnet9-5k"))
    idx = np.arange(B)
    plan = eng.plan(0, split.frames[idx], split.label[idx], _force=True)
    with torch.no_grad():
        latent = model(torch.from_numpy(split.data[idx]), depth=plan.latent_depth,
                       part="first")
    target = torch.eye(2)[torch.from_numpy(split.label[idx])]
    whole, whole_t = eng.apply(latent, target, plan.arrays)
    blocks = torch_dp_runs.rank_latents(eng, latent, target, plan.arrays)
    assert torch.equal(torch.cat([d for d, _ in blocks]), whole)
    assert torch.equal(torch.cat([t for _, t in blocks]), whole_t)


def _port_seeded_init(model, num_channels=4, sig_len=2500, num_classes=2, seed=4):
    """The JAX loop's torch_seeded_init for Potes: the port's seeded init,
    carried over (the JAX package has no torch-seeded Potes init)."""
    m = seeded_init(build_model(model, num_classes, num_channels, sig_len), seed)
    return jconvert.torch_potes_to_flax(m.state_dict())


def _tracks_reference(model, method, dataset):
    """``train_model`` against ``pcgmix_tpu.train_model`` over 7 steps at
    the transplant bar."""
    common = dict(model=model, method=method, num_epochs=7, batch_size=B,
                  save_artifacts=False)
    ref = jtrain(JTrainConfig(**common, sig_len=T, torch_init=True,
                              loader_parity="torch", n_devices=1), dataset)
    got = train_model(TrainConfig(**common, device="cpu"), dataset)
    assert got["steps"] == ref["steps"] == list(range(1, 8))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj))[:7].max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


@pytest.mark.parametrize("model", ["resnet9-5k", "Potes(noDropout)"])
def test_train_model_latentmixup_tracks_reference(model, dataset, no_head_dropout,
                                                  monkeypatch):
    if model.startswith("Potes"):
        monkeypatch.setattr(jconvert, "torch_seeded_init", _port_seeded_init)
    _tracks_reference(model, "latentmixup", dataset)


def test_train_model_manifold_cutout_tracks_reference(dataset):
    """manifold-cutout's first part (depths 1-3 come up in these 7 steps)
    gets zero gradients, as under the JAX ``stop_gradient``, so Adam still
    moves it by weight decay and momentum on every step."""
    _tracks_reference("resnet9-5k", "manifold-cutout", dataset)

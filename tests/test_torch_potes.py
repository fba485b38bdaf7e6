"""Potes of the PyTorch port against pcgmix_tpu.models.potes: carried
weights give the same logits, and ``train_model`` tracks
``pcgmix_tpu.train_model(torch_init=True, loader_parity="torch")``.

Dropout masks cannot be compared: the JAX package draws them from the JAX
PRNG, the port from a torch generator (PARITY.md "Dropout masks").
``Potes(noDropout)`` drops nothing in the branch, but both packages keep
its head's Dropout(0.5) (``pcgmix_tpu/models/potes.py:67``), so the
train-mode comparisons switch that one off on both sides (the
``no_head_dropout`` fixture) and hold everything else: logits within
1e-5; loss at step 0 within 1e-5, steps 0-6 within 1e-3 relative, the
recording-level predictions identical (the bar of test_torch_train.py).
The port's own dropout is held by determinism and by its rate and scale."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.train import TrainConfig as JConfig
from pcgmix_tpu.train import convert as jconvert
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.models import MODEL_NAMES, POTES_PRESETS, build_model, potes
from pcgmix_tpu_torch.models.potes import potes_features
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train.convert import jax_potes_to_torch, seeded_init

C, T, B, EPOCHS = 4, 512, 8, 7
ATOL = 1e-5


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


def _carried(name, seed=0):
    """A JAX Potes, its variables, and the port's Potes holding them."""
    jmodel = jbuild(name, train=False)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, C, T), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = build_model(name, 2, C, T)
    model.load_state_dict(jax_potes_to_torch(params))
    return variables, model


@pytest.mark.parametrize("name", list(POTES_PRESETS))
def test_carried_logits_match_in_eval(name, rng):
    variables, model = _carried(name)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jbuild(name, train=False).apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_carried_logits_match_in_train_mode(rng, no_head_dropout):
    variables, model = _carried("Potes(noDropout)", seed=1)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jbuild("Potes(noDropout)", train=True).apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_state_dict_roundtrip_through_flax_layout():
    model = seeded_init(build_model("Potes", 2, C, T), 7)
    back = jax_potes_to_torch(jconvert.torch_potes_to_flax(model.state_dict())["params"])
    sd = model.state_dict()
    assert sorted(back) == sorted(sd) == [
        "cnn1.0.0.bias", "cnn1.0.0.weight", "cnn1.1.0.bias", "cnn1.1.0.weight",
        "dimreduc.bias", "dimreduc.weight", "linear.bias", "linear.weight"]
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def _port_seeded_init(model, num_channels=4, sig_len=2500, num_classes=2, seed=4):
    """The JAX loop's torch_seeded_init for Potes: the port's seeded init,
    carried over (the JAX package has no torch-seeded Potes init)."""
    m = seeded_init(build_model(model, num_classes, num_channels, sig_len), seed)
    return jconvert.torch_potes_to_flax(m.state_dict())


@pytest.mark.parametrize("method", ["base", "durratiomixup", "durmixmagwarp(0.2,4)"])
def test_train_model_tracks_reference(method, dataset, no_head_dropout, monkeypatch):
    monkeypatch.setattr(jconvert, "torch_seeded_init", _port_seeded_init)
    common = dict(model="Potes(noDropout)", method=method, num_epochs=EPOCHS,
                  batch_size=B, save_artifacts=False)
    ref = jtrain(JConfig(**common, sig_len=T, torch_init=True, loader_parity="torch",
                         n_devices=1), dataset)
    got = train_model(TrainConfig(**common, device="cpu"), dataset)
    assert got["steps"] == ref["steps"] == list(range(1, EPOCHS + 1))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj))[:7].max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def test_dropout_masks_follow_the_seed(rng):
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32))
    m1 = build_model("Potes", 2, C, T, seed=5).train()
    m2 = copy.deepcopy(m1)
    m3 = build_model("Potes", 2, C, T, seed=6).train()
    m3.load_state_dict(m1.state_dict())
    with torch.no_grad():
        a, b, c, again = m1(x), m2(x), m3(x), m1(x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, again)


def test_dropout_rate_and_scale():
    model = build_model("Potes", 2, C, T, seed=1).train()
    h = torch.ones(64, 4, 4, 126)
    out = model._drop(h, 0.25)
    assert abs((out == 0).float().mean().item() - 0.25) < 0.01
    assert torch.all((out == 0) | (out == 1 / 0.75))
    assert torch.equal(model.eval()._drop(h, 0.25), h)


def test_dropout_training_runs_repeat(dataset):
    cfg = dict(model="Potes", method="durmixmagwarp(0.2,4)", num_epochs=3,
               batch_size=B, save_artifacts=False, device="cpu")
    a, b = train_model(TrainConfig(**cfg), dataset), train_model(TrainConfig(**cfg), dataset)
    assert a["train_loss"] == b["train_loss"]
    assert a["test_wav_preds"] == b["test_wav_preds"]


def test_registry_knows_the_presets():
    assert set(POTES_PRESETS) <= set(MODEL_NAMES)
    for name, preset in POTES_PRESETS.items():
        model = build_model(name, 2, C, 2500)
        assert model.cnn1[1][0].out_channels == preset["layers"][1]
        assert model.dimreduc.in_features == C * preset["layers"][1] * potes_features(2500)

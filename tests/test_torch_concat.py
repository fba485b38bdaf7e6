"""The keep-duration cut, the concat family and manifold-cutmix of the
PyTorch port against pcgmix_tpu: every plan bit-equal to the JAX engine's
over several steps (``frames_new`` and the identity plans included), with
``(rand)``, ``(smooth)``, ``+cutout`` and ``+p``, in 1-D and on 32 × 32
spectrograms; every apply within 1e-6 of the JAX engine's (K1's plain
version, a zero base and explicit rows for the concat family) and of
tests/golden/engine_v1.npz, read as data; a data-parallel rank's block
(K3's plain version on rows gathered by ``idx1``/``idx2``) equal to its
rows of the whole batch, and so is a rank's block of manifold-cutmix's
latent, its rows read from the global latent; manifold-cutmix at depths 0–3 on ResNet9, Potes
and the 2-D ResNet9, whose pieces run past the latent's end (clamped, as
XLA's ``piecewise_mix``); and ``train_model`` with cutmix tracking
``pcgmix_tpu.train_model(torch_init=True, loader_parity="torch")`` at the
bar of tests/test_transplant_dynamics.py (step 0 within 1e-5, steps 0-6
within 1e-3 relative)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.augment.engine import SHARED_ARRAYS
from pcgmix_tpu_torch.data import (
    EpochIterator,
    physionet_split,
    synthetic_physionet_dict,
    synthetic_spectrogram_dict,
)
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.parallel import DataParallel
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train.convert import seeded_init
from tests import torch_dp_runs

B, C, T = 8, 4, 512
S = 32  # spectrogram side
STEPS = 10
SPEC = "PhysioNet(spec128)"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "engine_v1.npz")
GOLDEN_METHODS = [
    "durratiomixup", "(rand)durratiomixup", "durmixmagwarp(0.2,4)",
    "durratiocutmix", "mixup(same)", "mixup(mix)", "timemask(0.2)",
    "labelcutmix", "(smooth)labelcutmix", "swapsysdia", "cont-cutmix",
    "cutout", "s1s2mask", "lengthcutmix(5bins)", "magnitudewarp(0.2,4)",
    "timewarp(0.05,2)", "respiratoryscale(12,20)", "cutmix", "cutmix(ch)",
    "wavcutmix", "datasetcutmix",
]
METHODS_1D = [
    "durratiocutmix", "(rand)durratiocutmix", "wav-durratiocutmix",
    "(UMC-subset)durratiocutmix", "durratiocutmix+0.6", "cutmix", "cutmix+0.5",
    "cutmix(ch)", "cutmix(ch)+0.5", "labelcutmix", "(rand)labelcutmix",
    "(smooth)labelcutmix", "(smooth)labelcutmix+0.5",
    "labelcutmix+cutout+1.0", "(mixAll)labelcutmix", "lengthcutmix(5bins)",
    "(rand)lengthcutmix(10bins)", "datasetcutmix", "(rand)datasetcutmix",
    "wavcutmix", "(smooth)(rand)wavcutmix", "swapsysdia", "swapsysdia+0.7",
    "cont-cutmix",
]
METHODS_2D = ["cutmix", "(rand)cutmix+0.6", "(smooth)cutmix", "durratiocutmix",
              "(rand)durratiocutmix", "durratiocutmix+0.5"]
EYE = np.eye(2, dtype=np.float32)


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


@pytest.fixture(scope="module")
def spec_split():
    ds = synthetic_spectrogram_dict(num_wavs_train=24, num_wavs_test=4,
                                    segments_per_wav=2, size=S, seed=5)
    return physionet_split(ds, "train", train_balance=False, spectrogram=True)


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


def _engines(method, spectrogram=False, model="resnet9"):
    side = S if spectrogram else T
    kw = dict(spectrogram=spectrogram, spec_freq=S if spectrogram else 0, model=model)
    channels = 1 if spectrogram else C
    return (AugmentEngine(AugmentConfig(method, B, channels, side, **kw)),
            JEngine(JConfig(method, B, channels, side, **kw)))


def _check_plans_and_applies(method, split, spectrogram=False):
    """Plans, identity plans and applies over STEPS steps; returns the
    number of steps the method augmented."""
    eng, ref = _engines(method, spectrogram)
    japply = jax.jit(ref.apply)  # one compile for the method's shapes
    n_plans = 0
    for step, b in _batches(split, STEPS):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args), ref.plan(*args)
        assert (got is None) == (exp is None), step
        got_a, _ = eng.plan_arrays_or_identity(*args)
        exp_a, _ = ref.plan_arrays_or_identity(*args)
        _assert_arrays_equal(got_a, exp_a, f"{method} step {step} (or identity)")
        data = split.data[b["indices"]]
        out, tgt = eng.apply(torch.from_numpy(data), torch.from_numpy(EYE[b["label"]]),
                             got_a)
        jout, jtgt = japply(jnp.asarray(data), jnp.asarray(EYE[b["label"]]), exp_a)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6,
                                   err_msg=f"{method} step {step}")
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0, atol=1e-6)
        if exp is None:
            assert torch.equal(out, torch.from_numpy(data))  # identity plan
            continue
        n_plans += 1
        _assert_arrays_equal(got.arrays, exp.arrays, f"{method} step {step}")
        assert got.latent_depth == exp.latent_depth
        if exp.frames_new is None:
            assert got.frames_new is None
        else:
            assert got.frames_new.dtype == exp.frames_new.dtype
            np.testing.assert_array_equal(got.frames_new, exp.frames_new)
    for g, r in zip(eng.np_stream.get_state(), ref.np_stream.get_state()):
        np.testing.assert_array_equal(g, r)
    return n_plans


@pytest.mark.parametrize("method", METHODS_1D)
def test_plans_and_applies_equal_reference(method, split):
    n_plans = _check_plans_and_applies(method, split)
    assert n_plans >= (3 if "+" in method else STEPS)


@pytest.mark.parametrize("method", METHODS_2D)
def test_2d_plans_and_applies_equal_reference(method, spec_split):
    n_plans = _check_plans_and_applies(method, spec_split, spectrogram=True)
    assert n_plans >= (3 if "+" in method else STEPS)


@pytest.mark.parametrize("method", GOLDEN_METHODS)
def test_applies_match_golden(method):
    """Step 37 of tests/make_golden.py's batch, as frozen in the JAX
    package's golden file."""
    g = np.load(GOLDEN, allow_pickle=False)
    data, frames, labels = g["data"], g["frames"], g["labels"]
    n, channels, sig_len = data.shape
    wavs = [f"{'ab'[i % 2]}w{i:03d}" for i in range(n)]
    eng = AugmentEngine(AugmentConfig(method, n, channels, sig_len))
    plan = eng.plan(37, frames, labels, wavs)
    out, tgt = eng.apply(torch.from_numpy(data), torch.from_numpy(EYE[labels]), plan.arrays)
    key = method.replace("(", "_").replace(")", "_").replace(",", "-")
    # the bar of tests/test_golden_plans.py
    np.testing.assert_allclose(out.numpy(), g[f"out::{key}"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), g[f"tgt::{key}"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method,spectrogram", [
    *[(m, False) for m in ("cutmix", "cutmix(ch)", "(smooth)labelcutmix",
                           "labelcutmix+cutout+1.0", "swapsysdia", "cont-cutmix",
                           "(rand)lengthcutmix(5bins)", "durratiocutmix",
                           "(rand)wav-durratiocutmix")],
    ("cutmix", True), ("(smooth)cutmix", True), ("durratiocutmix", True),
])
def test_rank_blocks_equal_the_whole_batch(method, spectrogram, split, spec_split):
    """A data-parallel rank gathers its base rows by ``idx1`` (the concat
    family) and its partners by ``idx2`` or ``mix``, as the train step
    does, and mixes them through K3: its rows of the whole batch's apply,
    bit for bit, targets included."""
    s = spec_split if spectrogram else split
    eng, _ = _engines(method, spectrogram)
    _, b = next(_batches(s, 1))
    plan = eng.plan(3, b["frames"], b["label"], b["wav"])
    data, target = torch.from_numpy(s.data[b["indices"]]), torch.from_numpy(EYE[b["label"]])
    whole, whole_t = eng.apply(data, target, plan.arrays)
    for rank in range(2):
        dp = DataParallel(rank=rank, world=2)
        sl = dp.block(B)
        block = dp.shard_arrays(plan.arrays, B, SHARED_ARRAYS)
        base = block.get("idx1", np.arange(B)[sl])
        partner = block["idx2" if "idx2" in block else "mix"]
        out, out_t = eng.apply_prepaired(data[base], data[partner], target[base],
                                         target[partner], block)
        assert torch.equal(out, whole[sl]) and torch.equal(out_t, whole_t[sl])


@pytest.mark.parametrize("method", ["cutmix", "swapsysdia", "durratiocutmix"])
def test_concat_family_refuses_or_takes_multicycle_frames(method):
    """Frames padded with −1 (the multi-cycle variant): a concat join is
    undefined there and raises, as in the JAX engine; the cut takes them."""
    frames = np.full((B, 28), -1, np.int64)
    frames[:, :9] = np.cumsum(np.r_[0, [30, 50, 20, 90] * 2])
    labels = np.array([0, 1] * (B // 2))
    eng, ref = _engines(method)
    if method == "durratiocutmix":
        _assert_arrays_equal(eng.plan(5, frames, labels).arrays,
                             ref.plan(5, frames, labels).arrays, method)
        return
    with pytest.raises(NotImplementedError, match="5-entry"):
        eng.plan(5, frames, labels)
    with pytest.raises(NotImplementedError, match="5-entry"):
        ref.plan(5, frames, labels)


def test_manifold_cutmix_splits_over_ranks(split):
    """manifold-cutmix on a batch split over two data-parallel ranks: each
    rank mixes its block of the latent, its base and partner rows read
    from the global latent (what the ranks' gather gives) through K3 with a
    zero base; in rank order, the whole latent's apply, bit for bit."""
    eng, _ = _engines("manifold-cutmix")
    _, b = next(_batches(split, 1))
    plan = eng.plan(3, b["frames"], b["label"], b["wav"])
    latent = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, 16, T // 4)).astype(np.float32))
    target = torch.from_numpy(EYE[b["label"]])
    whole, whole_t = eng.apply(latent, target, plan.arrays)
    blocks = torch_dp_runs.rank_latents(eng, latent, target, plan.arrays)
    assert torch.equal(torch.cat([d for d, _ in blocks]), whole)
    assert torch.equal(torch.cat([t for _, t in blocks]), whole_t)


def _seeded_model(model, spectrogram):
    if spectrogram:
        m = build_model(model, 2, 1, S, dataset=SPEC, freq=S)
    else:
        m = build_model(model, 2, C, T)
    return seeded_init(m, 4).eval()


@pytest.mark.parametrize("model,spectrogram", [("resnet9-15k", False), ("Potes", False),
                                               ("resnet9", True)])
def test_manifold_cutmix_latent_applies_equal_reference(model, spectrogram, split,
                                                        spec_split):
    """The plan's depth (randint(0, 3) for every model) and pieces reckoned
    for the input's length: on a latent they run past its end, where the
    source index clamps (XLA's ``piecewise_mix``, not the Pallas wrap)."""
    s = spec_split if spectrogram else split
    method = "manifold-cutmix"
    eng, ref = _engines(method, spectrogram, model=model)
    japply = jax.jit(ref.apply)  # one compile per latent shape
    net = _seeded_model(model, spectrogram)
    depths, past_the_end = set(), 0
    for step, b in _batches(s, 24):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args), ref.plan(*args)
        _assert_arrays_equal(got.arrays, exp.arrays, f"{method} step {step}")
        assert got.latent_depth == exp.latent_depth
        depths.add(got.latent_depth)
        with torch.no_grad():
            latent = net(torch.from_numpy(s.data[b["indices"]]), depth=got.latent_depth,
                         part="first")
        a = got.arrays
        past_the_end += int(((a["dst"] + a["len"] > latent.shape[-1]) & (a["len"] > 0)).sum())
        out, tgt = eng.apply(latent, torch.from_numpy(EYE[b["label"]]), a)
        jout, jtgt = japply(jnp.asarray(latent.numpy()), jnp.asarray(EYE[b["label"]]),
                            exp.arrays)
        assert out.shape == latent.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6,
                                   err_msg=f"{model} depth {got.latent_depth}")
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0, atol=1e-6)
    assert depths == {0, 1, 2, 3}
    assert past_the_end > 0


def test_train_model_manifold_cutmix_runs_the_split_step(split):
    """manifold-cutmix through ``train_model``: depths 0–3 come up in these
    steps and the losses stay finite (its step is the one held against
    the JAX package for manifold-cutout in tests/test_torch_latent.py)."""
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4, segments_per_wav=2,
                                  sig_len=T, seed=3)
    perf = train_model(TrainConfig(model="resnet9-5k", method="manifold-cutmix",
                                   num_epochs=7, batch_size=B, save_artifacts=False,
                                   device="cpu"), ds)
    assert perf["steps"] == list(range(1, 8))
    assert np.isfinite(perf["train_loss"]).all() and np.isfinite(perf["test_loss"]).all()


def test_train_model_cutmix_tracks_reference():
    """cutmix (K1 with a zero base and explicit rows, per-row target weights)
    through ``train_model`` against the JAX package's loop over 7 steps."""
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                  sig_len=T, seed=3)
    common = dict(model="resnet9-5k", method="cutmix", num_epochs=7, batch_size=B,
                  save_artifacts=False)
    ref = jtrain(JTrainConfig(**common, sig_len=T, torch_init=True, loader_parity="torch",
                              n_devices=1), ds)
    got = train_model(TrainConfig(**common, device="cpu"), ds)
    assert got["steps"] == ref["steps"] == list(range(1, 8))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj)).max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]

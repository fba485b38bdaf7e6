"""The port's 1-D baseline bases and pairings against pcgmix_tpu.augment:
plans bit-equal over consecutive steps (``+p`` gates included, so the
NumPy mirror stream advances as the JAX engine's does), identity templates
equal, applies within 1e-6 abs in fp32 (time_warp 1e-5), the Gaussian
noise's SNR/end bit-equal with the noise itself checked statistically, the
ops (masks, time warp, pairings, cvd map) against their JAX counterparts,
and loss-trace parity of two new methods against
pcgmix_tpu.train_model(torch_init=True) at the bar of
tests/test_transplant_dynamics.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcgmix_tpu.augment import pairing as jpairing
from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.augment.methods import parse_method as jparse
from pcgmix_tpu.data.datasets import load_cvd_map as jload_cvd_map
from pcgmix_tpu.ops import masks as jmasks
from pcgmix_tpu.ops.spline import time_warp as jtime_warp
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine, parse_method
from pcgmix_tpu_torch.augment import pairing
from pcgmix_tpu_torch.augment.engine import NOISE_SEED_BASE
from pcgmix_tpu_torch.data import (
    EpochIterator,
    load_cvd_map,
    physionet_split,
    synthetic_physionet_dict,
)
from pcgmix_tpu_torch.ops import masks
from pcgmix_tpu_torch.ops.spline import time_warp
from pcgmix_tpu_torch.train import TrainConfig, train_model

B, C, T = 8, 4, 512
STEPS = 6
METHODS = [
    "mixup(same)",
    "mixup(mix)",
    "(alpha=0.4)mixup(same)+0.5",
    "timemask(0.2)",
    "timemask(0.2)+0.5",
    "respiratoryscale(12,20)",
    "durmixrespscale(12,20)",
    "durmixrespscale(12,20)+0.6",
    "magnitudewarp(0.2,4)",
    "magnitudewarp(0.2,4)+0.5",
    "timewarp(0.05,4)",
    "timewarp(0.05,4)+0.6",
    "gaussiannoise(25,40)",
    "gaussiannoise(25,40)+0.5",
    "cutout",
    "cutout(ch)",
    "s1s2mask",
    "(sameCVD)durratiomixup",
    "(sameCVD)(rand)durratiomixup+0.6",
    "(samePCG)durmixmagwarp(0.2,4)",
    "(sameDataset)durmixmagwarp(0.2,4)",
    "(mixAll)durmixmagwarp(0.2,4)",
    "(mixAll)durratiomixup+0.5",
]
# the noise tensor comes from jax.random in the JAX engine and from a torch
# generator here: its key is the one plan entry that differs by design
_JAX_ONLY, _PORT_ONLY = {"key"}, {"noise_seed"}


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
    ds = synthetic_physionet_dict(
        num_wavs_train=24, num_wavs_test=2, segments_per_wav=2, sig_len=T, seed=4
    )
    return physionet_split(ds, "train", train_balance=False)


@pytest.fixture(scope="module")
def cvd_map(split):
    names = sorted(set(split.wav))
    return {w: ("AS", "MR", "N")[i % 3] for i, w in enumerate(names)}


def _batches(split, n_steps):
    step = 0
    while True:
        for b in EpochIterator(split, B, 1, step, "torch"):
            yield step, b
            step += 1
            if step >= n_steps:
                return


def _engines(method, cvd_map):
    return (AugmentEngine(AugmentConfig(method, B, C, T, cvd_map=cvd_map)),
            JEngine(JConfig(method, B, C, T, cvd_map=cvd_map)))


def _assert_plans_equal(got, ref, where):
    assert sorted(set(got) - _PORT_ONLY) == sorted(set(ref) - _JAX_ONLY), where
    for k in set(ref) - _JAX_ONLY:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype, f"{where} {k}: {g.dtype} vs {r.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=f"{where} {k}")


@pytest.mark.parametrize("method", METHODS)
def test_plans_and_applies_equal_reference(method, split, cvd_map):
    eng, ref = _engines(method, cvd_map)
    eye = np.eye(2, dtype=np.float32)
    tol = 1e-5 if "timewarp" in method else 1e-6
    n_plans = 0
    for step, b in _batches(split, STEPS):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan_arrays_or_identity(*args)
        ref_arrays, ref_plan = ref.plan_arrays_or_identity(*args)
        assert (exp is None) == (ref_plan is None), step
        n_plans += exp is not None
        _assert_plans_equal(got, ref_arrays, f"{method} step {step}")
        if "gaussiannoise" in method:
            continue  # the noise draws differ; see test_gaussian_noise_*
        x, t = split.data[b["indices"]], eye[b["label"]]
        jx, jt = ref.apply(jnp.asarray(x), jnp.asarray(t), ref_arrays)
        tx, tt = eng.apply(torch.from_numpy(x), torch.from_numpy(t), got)
        assert np.abs(np.asarray(jx) - tx.numpy()).max() <= tol, (method, step)
        assert np.abs(np.asarray(jt) - tt.numpy()).max() <= 1e-6, (method, step)
    assert n_plans >= 1
    for g, r in zip(eng.np_stream.get_state(), ref.np_stream.get_state()):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("method", ["mixup(mix)", "timemask(0.2)", "durmixrespscale(12,20)",
                                    "timewarp(0.05,4)", "gaussiannoise(25,40)",
                                    "cutout(ch)", "s1s2mask"])
def test_identity_templates_equal_reference_and_leave_the_batch(method, split, cvd_map):
    eng, ref = _engines(method, cvd_map)
    _, b = next(_batches(split, 1))
    args = (3, b["frames"], b["label"], b["wav"])
    got = eng.identity_arrays(*args)
    _assert_plans_equal(got, ref.identity_arrays(*args), method)
    # built under a snapshot of the mirror stream: no draw was consumed
    fresh = np.random.RandomState(4).get_state()
    for g, r in zip(eng.np_stream.get_state(), fresh):
        np.testing.assert_array_equal(g, r)
    x = split.data[b["indices"]]
    t = np.eye(2, dtype=np.float32)[b["label"]]
    out, tgt = eng.apply(torch.from_numpy(x), torch.from_numpy(t), got)
    np.testing.assert_array_equal(tgt.numpy(), t)
    if method.startswith("timewarp"):
        # knots of 1 re-interpolate at the spline's rounding of t itself
        exp, _ = ref.apply(jnp.asarray(x), jnp.asarray(t), ref.identity_arrays(*args))
        assert np.abs(out.numpy() - np.asarray(exp)).max() <= 1e-5
    elif method.startswith("gaussiannoise"):
        # 300 dB: noise 1e-15 of the rms, which rounds away except on zeros
        np.testing.assert_allclose(out.numpy(), x, rtol=1e-7, atol=1e-12)
    else:
        np.testing.assert_array_equal(out.numpy(), x)


def test_gaussian_noise_level_and_tail_at_full_length(cvd_map):
    """SNR and end are the JAX plan's (test above); the noise is zero at and
    after ``end``, has the per-row std rms/10^(snr/20) within 5 % at
    T = 2500, and is the same for the same step."""
    T_full, n = 2500, 16
    ds = synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=0,
                                  segments_per_wav=1, sig_len=T_full, seed=9)
    sp = physionet_split(ds, "train", train_balance=False)
    x, frames, labels = sp.data[:n], sp.frames[:n], sp.label[:n]
    eng = AugmentEngine(AugmentConfig("gaussiannoise(25,40)", n, C, T_full))
    ref = JEngine(JConfig("gaussiannoise(25,40)", n, C, T_full))
    arrays = eng.plan(5, frames, labels).arrays
    np.testing.assert_array_equal(arrays["snr"], ref.plan(5, frames, labels).arrays["snr"])
    assert int(arrays["noise_seed"]) == NOISE_SEED_BASE + 5
    t = torch.zeros(n, 2)
    out, _ = eng.apply(torch.from_numpy(x), t, arrays)
    out = out.numpy()
    end = arrays["end"]
    for i in range(n):
        assert not out[i, :, end[i]:].any()
        noise = out[i, :, :end[i]] - x[i, :, :end[i]]
        rms = np.sqrt(np.mean(np.square(x[i], dtype=np.float64)))
        want = rms / 10 ** (arrays["snr"][i] / 20)
        assert abs(noise.std() / want - 1) < 0.05, (i, noise.std(), want)
    again, _ = eng.apply(torch.from_numpy(x), t, arrays)
    np.testing.assert_array_equal(again.numpy(), out)


def test_data_parallel_split_refuses_the_row_local_bases():
    eng = AugmentEngine(AugmentConfig("timemask(0.2)", B, C, T))
    with pytest.raises(NotImplementedError, match="data-parallel"):
        eng.check_prepaired()
    AugmentEngine(AugmentConfig("durmixrespscale(12,20)", B, C, T)).check_prepaired()


@pytest.mark.parametrize("method", [
    "timewarp(0.1,3)", "gaussiannoise", "respiratoryscale", "cutout(ch)",
    "(mixAll)durmixmagwarp(0.2,4)", "(samePCG)timemask(0.3)+0.4",
])
def test_parser_params_equal_reference(method):
    assert vars(parse_method(method)) == vars(jparse(method))


def test_pairings_equal_reference(split, cvd_map):
    rng = np.random.default_rng(3)
    for step, b in _batches(split, 4):
        labels, frames, wavs = b["label"], b["frames"], b["wav"]
        cases = [
            (pairing.same_cvd(wavs, cvd_map, step), jpairing.same_cvd(wavs, cvd_map, step)),
            (pairing.same_wav(wavs, step), jpairing.same_wav(wavs, step)),
            (pairing.same_dataset(labels, wavs, step),
             jpairing.same_dataset(labels, wavs, step)),
            (pairing.mix_all(len(labels), step), jpairing.mix_all(len(labels), step)),
        ]
        for nb in (0, 2, 5):
            bs = int(rng.integers(8, 700))
            cases.append((pairing.same_length(labels, frames, step, bs, nb),
                          jpairing.same_length(labels, frames, step, bs, nb)))
        for got, exp in cases:
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("method", [
    pytest.param("(closestknn=8)durratiomixup", id="(closestknn=8)durratiomixup-10"),
    pytest.param("(closestbins=4)durmixmagwarp(0.2,4)",
                 id="(closestbins=4)durmixmagwarp(0.2,4)-10"),
])
def test_unported_pairings_name_their_queue_item(method, rng):
    """The latent-distance pairings: without latents they raise, naming
    ``latent_fn``; with them they equal the JAX package's pairing."""
    labels = rng.integers(0, 2, 16)
    args = (parse_method(method), 3, labels, np.zeros((16, 5), int), ["a"] * 16, 16)
    with pytest.raises(ValueError, match="latent_fn"):
        pairing.build_pairing(*args)
    latent = rng.normal(size=(16, 8)).astype(np.float32)
    got = pairing.build_pairing(*args, latent_fn=lambda: latent)
    exp, _ = jpairing.build_pairing(*args, latent_fn=lambda: latent)
    np.testing.assert_array_equal(got, exp)


def test_same_cvd_needs_a_map(split):
    eng = AugmentEngine(AugmentConfig("(sameCVD)durratiomixup", B, C, T))
    _, b = next(_batches(split, 1))
    with pytest.raises(ValueError, match="cvd_map"):
        eng.plan(0, b["frames"], b["label"], b["wav"])


def test_load_cvd_map_equals_reference(tmp_path, cvd_map):
    path = tmp_path / "cvds_map.csv"
    path.write_text("wav,diagnosis\n" + "".join(f"{w},{d}\n" for w, d in cvd_map.items()))
    assert load_cvd_map(str(path)) == jload_cvd_map(str(path)) == cvd_map
    bad = tmp_path / "bad.csv"
    bad.write_text("name,dx\nx,y\n")
    with pytest.raises(ValueError, match="expected csv columns"):
        load_cvd_map(str(bad))


def test_masks_equal_reference(rng):
    x = rng.normal(size=(6, 3, 64)).astype(np.float32)
    frames = np.sort(rng.integers(0, 64, (6, 5)), axis=1)
    start = rng.integers(0, 40, 6)
    stop = start + rng.integers(0, 30, 6)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(
        masks.interval_mask(64, torch.from_numpy(start), torch.from_numpy(stop)).numpy(),
        np.asarray(jmasks.interval_mask(64, start, stop)))
    for got, exp in (
        (masks.time_mask(tx, start, stop), jmasks.time_mask(jnp.asarray(x), start, stop)),
        (masks.s1s2_mask(tx, frames), jmasks.s1s2_mask(jnp.asarray(x), frames)),
        (masks.zero_after(tx, stop), jmasks.zero_after(jnp.asarray(x), stop)),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("sigma", [0.05, 0.6])
@pytest.mark.parametrize("knot", [2, 4])
def test_time_warp_equals_reference_with_its_boundaries(rng, knot, sigma):
    """Within 1e-5 of the JAX time warp, including knots that clip the
    warped positions to 0 at the head and to T−1 at the tail (duplicate
    positions: np.interp's last-duplicate head and final-sample tail)."""
    x = rng.normal(size=(8, C, T)).astype(np.float32)
    knots = rng.normal(1.0, sigma, size=(8, knot + 2, C)).astype(np.float32)
    got = time_warp(torch.from_numpy(x), torch.from_numpy(knots)).numpy()
    exp = np.asarray(jtime_warp(jnp.asarray(x), jnp.asarray(knots)))
    assert np.abs(got - exp).max() <= 1e-5


T_TRAIN, BATCH, EPOCHS = 512, 8, 7


@pytest.fixture(scope="module")
def train_dataset():
    # 8 recordings × 2 segments: one batch of 8 per epoch, so each plot
    # epoch's train_loss is one step's loss
    return synthetic_physionet_dict(
        num_wavs_train=8, num_wavs_test=6, segments_per_wav=2, sig_len=T_TRAIN, seed=3
    )


@pytest.mark.parametrize("method", ["mixup(same)", "timewarp(0.05,4)"])
def test_train_model_tracks_reference(method, train_dataset):
    common = dict(model="resnet9-5k", method=method, num_epochs=EPOCHS,
                  batch_size=BATCH, save_artifacts=False)
    ref = jtrain(JTrainConfig(**common, sig_len=T_TRAIN, torch_init=True,
                              loader_parity="torch", n_devices=1), train_dataset)
    got = train_model(TrainConfig(**common, device="cpu"), train_dataset)
    assert got["steps"] == ref["steps"] == list(range(1, EPOCHS + 1))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj))[:7].max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]

"""Host plans of the PyTorch port against pcgmix_tpu.augment: every array of
every step bit-equal (values and dtypes), identity plans equal, and the
NumPy mirror stream in the same state after the run."""

import numpy as np
import pytest

from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.augment.methods import parse_method as jparse
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine, parse_method
from pcgmix_tpu_torch.data import EpochIterator, physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.saliency import bin_training_saliency
from tests import torch_dp_runs

B, C, T = 8, 4, 512
METHODS = [
    "durratiomixup",
    "durratiomixup(rand)",
    "durmixmagwarp(0.2,4)",
    "durmixmagwarp(0.2,4)+0.5",
    "(alpha=0.4)(rand)durmixmagwarp(0.1,3)+0.7",
]


@pytest.fixture(scope="module")
def train_split():
    ds = synthetic_physionet_dict(
        num_wavs_train=24, num_wavs_test=2, segments_per_wav=2, sig_len=T, seed=4
    )
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


@pytest.mark.parametrize("method", METHODS)
def test_plans_bit_equal_reference(method, train_split):
    eng = AugmentEngine(AugmentConfig(method, B, C, T))
    ref = JEngine(JConfig(method, B, C, T))
    n_plans = 0
    for step, b in _batches(train_split, 60):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args), ref.plan(*args)
        assert (got is None) == (exp is None), step
        if exp is not None:
            n_plans += 1
            _assert_arrays_equal(got.arrays, exp.arrays, f"step {step}")
        got_a, _ = eng.plan_arrays_or_identity(*args)
        exp_a, _ = ref.plan_arrays_or_identity(*args)
        _assert_arrays_equal(got_a, exp_a, f"step {step} (or identity)")
    assert n_plans >= 20
    for g, r in zip(eng.np_stream.get_state(), ref.np_stream.get_state()):
        np.testing.assert_array_equal(g, r)


def test_identity_arrays_equal_reference(train_split):
    _, b = next(_batches(train_split, 1))
    for method in ("durratiomixup", "durmixmagwarp(0.2,4)+0.3"):
        eng = AugmentEngine(AugmentConfig(method, B, C, T))
        ref = JEngine(JConfig(method, B, C, T))
        args = (3, b["frames"], b["label"], b["wav"])
        _assert_arrays_equal(eng.identity_arrays(*args), ref.identity_arrays(*args),
                             method)


def test_multicycle_frames_plan_equal_reference(rng):
    """27-segment frames padded with −1 (the full multi-cycle variant)."""
    frames = np.full((B, 28), -1, np.int64)
    for i in range(B):
        n = rng.integers(5, 28)
        frames[i, :n] = np.concatenate([[0], np.cumsum(rng.integers(5, 18, n - 1))])
    labels = rng.integers(0, 2, B)
    for method in ("durratiomixup(rand)", "durmixmagwarp(0.2,4)"):
        got = AugmentEngine(AugmentConfig(method, B, C, T)).plan(11, frames, labels)
        exp = JEngine(JConfig(method, B, C, T)).plan(11, frames, labels)
        _assert_arrays_equal(got.arrays, exp.arrays, method)


@pytest.mark.parametrize("method", [
    "base", "durratiomixup+0.6", "(sameCVD)(rand)durratiomixup+0.6",
    "durmixmagwarp(0.2,4)", "cutmix", "(saloptenv-1)durratiomixup", "SELC",
    "mixup(mix)", "(closestknn=8)durmixmagwarp(0.2,4)",
])
def test_method_parser_equals_reference(method):
    assert vars(parse_method(method)) == vars(jparse(method))


@pytest.mark.parametrize("method", [
    "(closestknn=8)durratiomixup", "(saloptenv)durratiomixup", "lc-nointrusion",
    "saliency-cutmix", "(closestbins=4)durmixmagwarp(0.2,4)", "(saloptsum-2)durratiomixup",
])
def test_model_in_the_loop_methods_plan_and_split_over_ranks(method, train_split):
    """The model-in-the-loop methods build and plan (their hooks given
    here, the numbers every rank holds once gathered), and each of two
    data-parallel ranks mixes its block of the plan's rows (lc-nointrusion:
    of its 4B-row pool) through the train step's route: in rank order, the
    whole batch's apply, bit for bit."""
    eng = AugmentEngine(AugmentConfig(method, B, C, T))
    _, b = next(_batches(train_split, 1))
    sal = np.random.default_rng(0).random((B, T)).astype(np.float32)
    plan = eng.plan(0, b["frames"], b["label"], b["wav"],
                    saliency_fn=lambda mix_model: sal,
                    saliency_bins_fn=lambda: bin_training_saliency(sal, b["frames"]),
                    latent_fn=lambda: sal[:, ::64])
    assert plan.arrays["len"].shape[0] == (4 * B if method == "lc-nointrusion" else B)
    torch_dp_runs.assert_ranks_equal_whole(eng, train_split.data, train_split.label,
                                           b["indices"], plan.arrays)

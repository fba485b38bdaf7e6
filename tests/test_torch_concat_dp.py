"""The keep-duration cut and the concat family on the port's data-parallel
route, on the CPU: ``train_model`` in two gloo ranks at a global batch of 8
(4 rows a rank; each rank gathers its base rows by ``idx1`` and its
partners by ``idx2`` or ``mix`` and mixes them through K3's plain
version) against the single-device run (K1's plain version) on the same
data.  Bar (tests/test_torch_train_dp.py's): step-0 loss within 1e-5,
every plot epoch's loss within 1e-3 relative, the recording-level
predictions identical.

This module imports neither JAX nor the JAX package: the spawned ranks
import it to find their entry point."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pcgmix_tpu_torch.augment import AugmentEngine
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.parallel import spawn
from pcgmix_tpu_torch.train import TrainConfig, train_model

METHODS = ("cutmix", "durratiocutmix", "(smooth)labelcutmix", "cutmix(ch)")
COMMON = dict(model="resnet9-5k", num_epochs=5, batch_size=8, save_artifacts=False,
              device="cpu")


def _dataset():
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6,
                                    segments_per_wav=2, sig_len=256, seed=3)


def _runs():
    """Every method's run and the steps that went through the rank's
    pre-paired apply: inside a group (the spawned ranks), the
    data-parallel route; outside, the single-device one."""
    ds = _dataset()
    prepaired = AugmentEngine.apply_prepaired
    calls = []

    def counted(self, *args):
        calls.append(self.spec.raw)
        return prepaired(self, *args)

    AugmentEngine.apply_prepaired = counted
    try:
        runs = {m: train_model(TrainConfig(**COMMON, method=m), ds) for m in METHODS}
    finally:
        AugmentEngine.apply_prepaired = prepaired
    for m in METHODS:
        runs[m]["prepaired_steps"] = calls.count(m)
    runs["in_group"] = dist.is_initialized()
    return runs


@pytest.fixture(scope="module")
def runs():
    dp = spawn(_runs, 2, "gloo")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' thread count: the same sum orders
    try:
        one = _runs()
    finally:
        torch.set_num_threads(threads)
    return dp, one


@pytest.mark.parametrize("method", METHODS)
def test_two_ranks_equal_single_device(method, runs):
    dp, one = runs
    got, ref = dp[method], one[method]
    assert dp["in_group"] and not one["in_group"]
    assert got["steps"] == ref["steps"]
    assert got["prepaired_steps"] == got["steps"][-1] and ref["prepaired_steps"] == 0
    lt, lr = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lr[0]) < 1e-5, (lt, lr)
    assert (np.abs(lt - lr) / np.abs(lr)).max() < 1e-3, (lt, lr)
    assert got["test_wav_preds"] == ref["test_wav_preds"]

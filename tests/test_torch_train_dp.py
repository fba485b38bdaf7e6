"""The data-parallel slice end to end: the port's
train_model(n_devices=2, device='cpu') — two gloo ranks, K3/K4's plain
versions — against pcgmix_tpu.train_model(n_devices=2) on a 2-device CPU
mesh, with torch init and the torch epoch order, on the same data.

Bar (tests/test_torch_train.py's): step-0 loss within 1e-5 absolute, every
plot epoch's loss within 1e-3 relative, the recording-level predictions
identical."""

import numpy as np
import pytest

from pcgmix_tpu.train import TrainConfig as JConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.train import TrainConfig, train_model

T, BATCH, EPOCHS = 512, 8, 7


@pytest.fixture(scope="module")
def dataset():
    # 8 recordings × 2 segments: one batch of 8 per epoch (4 rows per rank)
    return synthetic_physionet_dict(
        num_wavs_train=8, num_wavs_test=6, segments_per_wav=2, sig_len=T, seed=3
    )


@pytest.mark.parametrize("method", ["durratiomixup", "durmixmagwarp(0.2,4)"])
def test_data_parallel_train_model_tracks_the_reference_mesh(method, dataset):
    common = dict(model="resnet9-5k", method=method, num_epochs=EPOCHS,
                  batch_size=BATCH, save_artifacts=False, n_devices=2)
    ref = jtrain(JConfig(**common, sig_len=T, torch_init=True,
                         loader_parity="torch"), dataset)
    got = train_model(TrainConfig(**common, device="cpu"), dataset)
    assert got["steps"] == ref["steps"] == list(range(1, EPOCHS + 1))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj)).max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=1e-3)

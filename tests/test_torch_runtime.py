"""The runtime extras against ``pcgmix_tpu``: ``op="SGD"`` (scheduled
heavy-ball and unscheduled), the variability counter, the profiler trace
and the ``TrainConfig`` fields with the JAX package's defaults.

Bar for the loss traces (tests/test_transplant_dynamics.py's): step 0
within 1e-5 absolute, steps 0–6 within 1e-3 relative."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JAugmentConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JAugmentEngine
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu.train.counters import VariabilityCounter as JVariabilityCounter
from pcgmix_tpu_torch.augment.engine import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train.counters import VariabilityCounter

T, BATCH, EPOCHS = 512, 8, 7


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
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6,
                                    segments_per_wav=2, sig_len=T, seed=3)


@pytest.mark.parametrize("use_sched", [True, False])
def test_sgd_tracks_reference(use_sched, dataset):
    common = dict(model="resnet9-5k", method="durratiomixup", num_epochs=EPOCHS,
                  batch_size=BATCH, save_artifacts=False, op="SGD", use_sched=use_sched)
    ref = jtrain(JTrainConfig(**common, sig_len=T, torch_init=True, loader_parity="torch",
                              n_devices=1), dataset)
    got = train_model(TrainConfig(**common, device="cpu"), dataset)
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj))[:7].max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]
    np.testing.assert_allclose(got["lr_per_step"], ref["lr_per_step"], rtol=1e-5)


def test_unknown_optimizer_is_refused(dataset):
    with pytest.raises(ValueError, match="unknown optimizer 'rmsprop'"):
        train_model(TrainConfig(model="resnet9-5k", op="rmsprop", num_epochs=1,
                                batch_size=BATCH, save_artifacts=False, device="cpu"),
                    dataset)


@pytest.mark.parametrize("method", ["durratiomixup", "cutmix", "swapsysdia",
                                    "durmixmagwarp(0.2,4)+0.5", "timemask(0.1)"])
def test_variability_counter_matches_reference(method, dataset):
    """The same plans counted by both packages' counters, the plans' partner
    indices and cuts taken from each package's own plan."""
    split = physionet_split(dataset, "train")
    B = 4
    eng = AugmentEngine(AugmentConfig(method, B, 4, T))
    ref = JAugmentEngine(JAugmentConfig(method, B, 4, T))
    got, exp = VariabilityCounter(len(split)), JVariabilityCounter(len(split))
    rng = np.random.default_rng(0)
    for step in range(12):
        rows = rng.choice(len(split), B, replace=False)
        args = (split.frames[rows], split.label[rows], split.wav[rows])
        p, q = eng.plan(step, *args), ref.plan(step, *args)
        assert (p is None) == (q is None)
        got.add(rows, p.mix_indices if p else None, p.cut if p else None, step)
        exp.add(rows, q.mix_indices if q else None, q.cut if q else None, step)
    for k in ("base", "pairs", "unique", "steps", "lens_base", "lens_pairs", "lens_unique"):
        assert getattr(got, k) == getattr(exp, k), k


def test_profile_trace_and_variability_are_written(dataset, tmp_path):
    prof = tmp_path / "profile"
    cfg = TrainConfig(model="resnet9-5k", method="durratiomixup", num_epochs=3,
                      batch_size=BATCH, experiments_root=str(tmp_path / "exp"),
                      profile_dir=str(prof), track_variability=True, device="cpu")
    perf = train_model(cfg, dataset)
    traces = os.listdir(prof)
    assert traces == ["trace_epoch2.json"]
    text = (prof / traces[0]).read_text()
    assert "aten::" in text
    for span in ("epoch", "batch", "plan", "train_step", "upload", "copy", "apply", "forward",
                 "backward", "update"):
        assert f'"pcgmix.{span}"' in text, span
    with open(os.path.join(experiment_dir(cfg), "variability.pkl"), "rb") as f:
        curves = pickle.load(f)
    assert sorted(curves) == ["base", "pairs", "steps", "unique"]  # plotters.py:113-117
    assert curves["steps"] == list(range(perf["steps"][-1]))
    assert curves["pairs"][-1] > 0


def test_train_config_has_the_reference_runtime_fields():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    for name in ("track_variability", "checkpoint_every", "profile_dir",
                 "steps_per_dispatch", "device_cache"):
        assert ours[name] == ref[name], name

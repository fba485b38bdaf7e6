"""Checkpoints and exact resume on the CPU (counterpart of the JAX
package's ``tests/test_runner_ckpt.py`` resume tests).

A run crashed after its first checkpoint and rerun gives the uninterrupted
run's performance dict bit for bit: weights, BatchNorm buffers, optimizer
and scheduler, SELC table, Potes' dropout generator and the replayed plan
RNG all come back.  A finished config's rerun trains nothing.
``replay_plan_rng`` leaves the port's engine drawing the plan the JAX
engine draws after its own replay."""

import os
import pickle

import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JAugmentConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JAugmentEngine
from pcgmix_tpu.data import physionet_split as jphysionet_split
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train.loop import replay_plan_rng as jreplay_plan_rng
from pcgmix_tpu_torch.augment.engine import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.ops import build
from pcgmix_tpu_torch.train import TrainConfig, checkpoint, loop, train_model
from pcgmix_tpu_torch.train.checkpoint import CheckpointManager

T, BATCH = 512, 8


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
    return synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=4,
                                    segments_per_wav=2, sig_len=T, seed=9)


def _cfg(root, **kw):
    base = dict(model="resnet9-5k", method="magnitudewarp(0.2,4)", num_epochs=3,
                batch_size=BATCH, checkpoint_every=1, experiments_root=str(root),
                device="cpu", plot=False)
    return TrainConfig(**{**base, **kw})


def _crash_after_first_save(monkeypatch, cfg, dataset):
    orig = CheckpointManager.save

    def crashing_save(self, *a, **k):
        orig(self, *a, **k)
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(CheckpointManager, "save", crashing_save)
    with pytest.raises(RuntimeError, match="simulated crash"):
        train_model(cfg, dataset)
    monkeypatch.setattr(CheckpointManager, "save", orig)


@pytest.mark.parametrize("model,method,steps_per_dispatch", [
    ("resnet9-5k", "magnitudewarp(0.2,4)", 1), ("Potes", "durmixmagwarp(0.2,4)", 1),
    ("resnet9-5k", "durmixmagwarp(0.2,4)+0.5", 4), ("resnet9-5k", "SELC-durratiomixup", 1),
])
def test_resume_after_a_crash_equals_the_uninterrupted_run(model, method, steps_per_dispatch,
                                                           dataset, tmp_path, monkeypatch):
    kw = dict(model=model, method=method, steps_per_dispatch=steps_per_dispatch)
    ref = train_model(_cfg(tmp_path / "ref", **kw), dataset)
    cfg = _cfg(tmp_path / "run", **kw)
    _crash_after_first_save(monkeypatch, cfg, dataset)
    replayed = []
    monkeypatch.setattr(loop, "replay_plan_rng",
                        lambda *a: replayed.append(a[-1]) or replay(*a))
    resumed = train_model(cfg, dataset)
    assert replayed == [4]  # one epoch of 4 steps before the crash
    for key in ref:
        if key != "times":
            assert resumed[key] == ref[key], key
    sd, ref_sd = (torch.load(os.path.join(experiment_dir(c), "model.pth"))
                  for c in (cfg, _cfg(tmp_path / "ref", **kw)))
    assert all(torch.equal(sd[k], ref_sd[k]) for k in ref_sd)


replay = loop.replay_plan_rng


def test_finished_rerun_trains_nothing(dataset, tmp_path):
    cfg = _cfg(tmp_path, method="durmixmagwarp(0.2,4)")
    first = train_model(cfg, dataset)
    ckdir = os.path.join(experiment_dir(cfg), "checkpoints")
    assert CheckpointManager(ckdir).steps() == [8, 12]  # the newest two of 3
    build.reset_launch_counts()
    calls = []
    orig = loop.TrainStep.__call__
    loop.TrainStep.__call__ = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        again = train_model(cfg, dataset)
    finally:
        loop.TrainStep.__call__ = orig
    assert not calls and sum(build.launch_counts().values()) == 0
    assert again == first


def test_checkpoint_manager_writes_atomically(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (3, 6, 9):
        mgr.save(step, {"w": torch.full((2,), float(step))}, metrics={"step": step})
    assert mgr.steps() == [6, 9]
    # a crash in the middle of a write leaves a temporary file, not a checkpoint
    (tmp_path / "ck" / "ckpt_12.pt.123.tmp").write_bytes(b"partial")
    state, step = mgr.restore()
    assert step == 9 and torch.equal(state["w"], torch.full((2,), 9.0))
    assert mgr.restore_metrics(9) == {"step": 9} and mgr.restore_metrics(3) is None
    assert not [f for f in os.listdir(tmp_path / "ck") if f.startswith(("ckpt_3", "metrics_3"))]


_ran = []


def _run_on_load():
    _ran.append(1)
    return 0


class _Tampered:
    """Unpickling this calls ``_run_on_load``: what a tampered file would do."""

    def __reduce__(self):
        return (_run_on_load, ())


def test_restore_refuses_a_checkpoint_that_would_run_code(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, {"w": torch.zeros(2), "hook": _Tampered()})
    with pytest.raises(pickle.UnpicklingError):
        mgr.restore()
    assert not _ran


@pytest.mark.parametrize("method", ["magnitudewarp(0.2,4)", "timewarp(0.05,4)+0.5",
                                    "gaussiannoise"])
def test_replay_plan_rng_matches_reference(method, dataset):
    """After replaying 7 steps, both engines draw the same next plans."""
    cfg, jcfg = (TrainConfig(method=method, batch_size=BATCH, loader_parity="numpy"),
                 JTrainConfig(method=method, batch_size=BATCH, sig_len=T,
                              loader_parity="numpy"))
    split, jsplit = physionet_split(dataset, "train"), jphysionet_split(dataset, "train")
    eng = AugmentEngine(AugmentConfig(method, BATCH, 4, T))
    ref = JAugmentEngine(JAugmentConfig(method, BATCH, 4, T))
    loop.replay_plan_rng(eng, split, cfg, 7)
    jreplay_plan_rng(ref, jsplit, jcfg, 7)
    for g, r in zip(eng.np_stream.get_state(), ref.np_stream.get_state()):
        np.testing.assert_array_equal(g, r)
    order = np.arange(BATCH)
    for step in (7, 8):
        got = eng.plan(step, split.frames[order], split.label[order], split.wav[order])
        exp = ref.plan(step, jsplit.frames[order], jsplit.label[order], jsplit.wav[order])
        assert (got is None) == (exp is None)
        if got is not None:
            for k in ("knots", "snr"):
                if k in exp.arrays:
                    np.testing.assert_array_equal(got.arrays[k], np.asarray(exp.arrays[k]))


def test_model_in_the_loop_plans_are_not_replayed():
    for method, replayable in (("durmixmagwarp(0.2,4)", True), ("base", False),
                               ("lc-nointrusion", False), ("saliency-cutmix", False)):
        eng = AugmentEngine(AugmentConfig(method, BATCH, 4, T))
        assert loop._engine_rng_replayable(eng) is replayable, method
    assert checkpoint.CheckpointManager is CheckpointManager

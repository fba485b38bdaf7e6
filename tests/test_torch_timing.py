"""The port's tracer (``pcgmix_tpu_torch/timing.py``): spans nest and share
a step's identifier; with no profiler active only the totals move; under a
profiler every span is a ``pcgmix.<name>`` event on the profiler's clock and
a record in the buffer; a training step counts each host-to-device transfer
it makes inside a ``copy`` span, at the shapes of the benchmark's cells."""

import contextlib
import statistics

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from pcgmix_tpu_torch import timing
from pcgmix_tpu_torch.augment.engine import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import EpochIterator
from pcgmix_tpu_torch.data.datasets import ArrayDataset
from pcgmix_tpu_torch.train.losses import init_selc_table
from pcgmix_tpu_torch.train.steps import MultiStep, TrainStep, make_optimizer
from pcgmix_tpu_torch.timing import timed


@pytest.fixture(autouse=True)
def clean():
    timing.reset_host_times()
    timing.reset_spans()
    yield
    timing.reset_host_times()
    timing.reset_spans()


def _busy(seconds):
    t = timing._perf()
    while timing._perf() - t < seconds:
        pass


def test_spans_nest_with_parents_self_times_and_a_shared_step():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with timed("batch"):
                _busy(1e-4)
            with timed("train_step"):
                with timed("upload"):
                    with timed("copy"):
                        timing.count("h2d_copies.pageable")
                    timing.count("h2d_copies.pageable")
                _busy(2e-3)
                with timed("update"):
                    _busy(1e-3)
    recs = timing.spans()
    assert [r.name for r in recs] == ["batch", "train_step", "upload", "copy", "update"] * 2
    for k in (0, 5):
        batch, step, upload, copy, update = recs[k:k + 5]
        assert [r.parent for r in recs[k:k + 5]] == [-1, -1, step.id, upload.id, step.id]
        assert len({r.step for r in recs[k:k + 5]}) == 1
        # the innermost open span takes the counts
        assert copy.counts == {"h2d_copies.pageable": 1}
        assert upload.counts == {"h2d_copies.pageable": 1}
        for r in recs[k:k + 5]:
            assert 0 < r.start_ns < r.end_ns
        kids = [r for r in recs[k:k + 5] if r.parent == step.id]
        assert all(step.start_ns <= r.start_ns and r.end_ns <= step.end_ns for r in kids)
        own = (step.end_ns - step.start_ns) - sum(r.end_ns - r.start_ns for r in kids)
        assert own >= 2e6  # the step's own 2 ms
    assert recs[0].step != recs[5].step  # a closed train_step ends its step
    assert timing.counts() == {"h2d_copies.pageable": 4}


def test_no_profiler_records_nothing_but_the_totals():
    for _ in range(3):
        with timed("salopt search"):
            with timed("copy"):
                timing.count("h2d_copies.pinned", 2)
    assert timing.spans() == []
    times = timing.host_times()
    assert set(times) == {"salopt search", "copy"}
    assert times["salopt search"][1] == 3 and times["copy"][1] == 3
    assert times["salopt search"][0] >= times["copy"][0] > 0
    assert timing.counts() == {"h2d_copies.pinned": 6}
    timing.reset_host_times()
    assert timing.host_times() == {} and timing.counts() == {}


def test_profiler_events_share_the_buffers_clock():
    names = ["epoch", "batch", "plan", "train_step", "upload", "copy", "apply", "forward",
             "backward", "update", "stage", "replay"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            for name in names:
                with timed(name):
                    _busy(2e-5)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = [e for e in prof.events() if e.name.startswith("pcgmix.")]
    recs = timing.spans()
    assert sorted(e.name for e in events) == sorted("pcgmix." + r.name for r in recs)
    assert len(recs) == 5 * len(names)
    by_name = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        by_name.setdefault(e.name[len("pcgmix."):], []).append(e)
    gaps = []
    for name in names:
        mine = [r for r in recs if r.name == name]
        for r, e in zip(mine, by_name[name]):
            gaps.append(abs(r.start_ns - (start_ns + 1e3 * e.time_range.start)))
    assert statistics.median(gaps) < 100e3  # ns


def _frames(rng, n, bounds, scale):
    """[0, e1, e2, e3, e4] cycle boundaries from per-state length ranges."""
    lens = np.stack([rng.integers(lo, hi, n) for lo, hi in bounds], axis=1) / scale
    return np.concatenate([np.zeros((n, 1)), np.cumsum(lens, axis=1)], axis=1).astype(np.int64)


# the benchmark's cells: batch 64 of 4 × 2500 rows (PCGmix+), 1 × 128 × 128
# spectrograms in 17.1875-ms columns (PCGmix); the model is a stand-in
CELLS = {
    "durmixmagwarp(0.2,4)": dict(shape=(4, 2500), scale=1.0, spectrogram=False),
    "durratiomixup": dict(shape=(1, 128, 128), scale=17.1875, spectrogram=True),
}
STATES_MS = [(80, 140), (150, 350), (60, 120), (300, 700)]


def _step(method, n=128, batch=64, device="cpu"):
    c = CELLS[method]
    rng = np.random.default_rng(7)
    labels = np.arange(n) % 2
    frames = _frames(rng, n, STATES_MS, c["scale"])
    data = torch.from_numpy(rng.standard_normal((n, *c["shape"])).astype(np.float32)).to(device)
    torch.manual_seed(3)
    model = nn.Sequential(nn.Flatten(), nn.Linear(int(np.prod(c["shape"])), 2)).to(device)
    opt, sched = make_optimizer(model, "adam", 0.01, 1e-4, 100, True)
    F = c["shape"][-2] if c["spectrogram"] else 0
    engine = AugmentEngine(AugmentConfig(
        method=method, batch_size=batch, num_channels=c["shape"][0], sig_len=c["shape"][-1],
        spectrogram=c["spectrogram"], spec_freq=F))
    step = TrainStep(model, opt, sched, train_data=data,
                     train_labels=torch.from_numpy(labels).to(device),
                     soft_labels=init_selc_table(labels, 2, device), num_classes=2,
                     grad_clip=0.1, selc_es=1000, engine=engine)
    ds = ArrayDataset(data=np.zeros((n, 1), np.float32), label=labels, frames=frames,
                      wav=np.array([f"a{i:04d}" for i in range(n)]),
                      sig_qual=np.ones(n, np.int64))
    return step, engine, ds


@pytest.mark.parametrize("method, fields", [("durmixmagwarp(0.2,4)", 8), ("durratiomixup", 7)])
def test_an_eager_step_counts_its_transfers(method, fields):
    step, engine, ds = _step(method)
    with profile(activities=[ProfilerActivity.CPU]):
        batches = iter(EpochIterator(ds, 64, 1, 0))
        for s in range(2):
            b = next(batches)
            plan = engine.plan(s, b["frames"], b["label"], b["wav"])
            step(b["indices"], plan.arrays, 1)
    # the row indices and each plan array but λ (a float) staged in one
    # buffer: one pinned copy a step, no pageable one
    assert len(step._staging.layout) == fields
    assert timing.counts()["h2d_copies.pinned"] == 2
    assert "h2d_copies.pageable" not in timing.counts()
    recs = timing.spans()
    by_id = {r.id: r for r in recs}
    assert [r.name for r in recs if r.parent == -1] == ["epoch", "batch", "plan",
                                                        "train_step"] + ["batch", "plan",
                                                                         "train_step"]
    copies_seen = [r for r in recs if r.counts.get("h2d_copies.pinned")]
    assert len(copies_seen) == 2
    for r in copies_seen:
        assert r.name == "copy" and r.counts["h2d_copies.pinned"] == 1
        assert by_id[r.parent].name == "upload"
        assert by_id[by_id[r.parent].parent].name == "train_step"
    kids = {r.name for r in recs if r.parent != -1 and by_id[r.parent].name == "train_step"}
    assert kids == {"upload", "apply", "forward", "backward", "update"}
    assert "copy" in {r.name for r in recs if r.parent != -1
                      and by_id[r.parent].name == "upload"}


def test_multi_step_counts_its_staged_copies_as_pinned():
    step, engine, ds = _step("durmixmagwarp(0.2,4)", n=256)
    multi = MultiStep(step, 2)
    chunk = []
    for s, b in enumerate(EpochIterator(ds, 64, 1, 0)):
        arrays, _ = engine.plan_arrays_or_identity(s, b["frames"], b["label"], b["wav"])
        chunk.append((b["indices"], arrays))
    multi.run(chunk[:2], 1)
    multi.run(chunk[2:3], 1)  # a partial chunk: eager steps from the staged buffer
    assert timing.counts()["h2d_copies.pinned"] == 2
    assert "h2d_copies.pageable" not in timing.counts()
    times = timing.host_times()
    assert times["stage"][1] == 2 and times["copy"][1] == 2 and times["train_step"][1] == 3
    assert times["plan"][1] == 4


@pytest.mark.cuda
def test_a_graph_captured_under_the_profiler_trains_as_without_it():
    """On a card ``MultiStep`` captures its steps as a CUDA graph: captured
    inside a profile, with the spans of ``run`` entered during the capture,
    the chunks' losses equal those of a run without the profiler, and the
    profile holds the staging and the replays as ``pcgmix.*`` events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    losses = {}
    for profiled in (False, True):
        timing.reset_host_times()
        step, engine, ds = _step("durmixmagwarp(0.2,4)", n=320, device="cuda")
        multi = MultiStep(step, 2)
        chunk = []
        for s, b in enumerate(EpochIterator(ds, 64, 1, 0)):
            arrays, _ = engine.plan_arrays_or_identity(s, b["frames"], b["label"], b["wav"])
            chunk.append((b["indices"], arrays))
        tracer = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                  if profiled else contextlib.nullcontext())
        with tracer as prof:
            out = [multi.run(chunk[k:k + 2], 1)["loss"] for k in range(0, 5, 2)]
            torch.cuda.synchronize()
        losses[profiled] = torch.cat(out).cpu()
    assert torch.equal(losses[True], losses[False])
    times = timing.host_times()
    # two full chunks replayed; the partial one eager; the warm-up's two
    # eager steps before the capture
    assert times["replay"][1] == 2 and times["stage"][1] == 4
    assert timing.counts()["h2d_copies.pinned"] == 4
    names = {e.name for e in prof.events()}
    assert {"pcgmix.stage", "pcgmix.replay", "pcgmix.forward", "pcgmix.copy"} <= names
    assert [r.name for r in timing.spans() if r.name == "replay"] == ["replay"] * 2

"""The metrics that read the program's own spans: aligned to the trace's
clock by the steps, exact on a constructed timeline, and silent where the
spans are missing or cannot be aligned."""

import types

import pytest

from benchmark import harness, program_spans, trace

OFFSET_US = 1.79e12  # the program's Unix-epoch µs at the trace's 0
NAMES = ("engine_plan_ms", "copy_ms", "dispatch_ms", "h2d_copies", "copy_idle_share")


def _rec(i, name, start, end, parent=-1, shift=0.0, step=1, **counts):
    """A program span of step ``step`` at trace µs ``start``–``end``, stamped
    as the program stamps it (Unix-epoch ns), ``shift`` µs off the common
    offset."""
    ns = lambda t: int(round((t + OFFSET_US + shift) * 1e3))
    return types.SimpleNamespace(id=i, name=name, start_ns=ns(start), end_ns=ns(end),
                                 parent=parent, step=step, counts=counts)


def _records(shift_b=0.0):
    """Two steps of a slice over 0–1000 µs, each ``train_step`` 5 µs inside
    its ``bench.step`` at both ends; an earlier try's step before them."""
    b = shift_b
    return [
        _rec(0, "train_step", -5000, -4000, step=0),  # a slice profiled before
        _rec(1, "plan", 20, 90),
        _rec(2, "train_step", 100, 445),
        _rec(3, "upload", 110, 200, 2, **{"h2d_copies.pageable": 0}),
        _rec(4, "copy", 110, 150, 3, **{"h2d_copies.pageable": 1, "h2d_bytes.pageable": 512}),
        _rec(5, "copy", 160, 200, 3, **{"h2d_copies.pageable": 1, "h2d_copies.pinned": 3}),
        _rec(6, "forward", 210, 300, 2, **{"h2d_copies.pageable": 5}),  # not a copy span
        _rec(7, "plan", 470, 540, shift=b, step=2),
        _rec(8, "train_step", 550, 945, shift=b, step=2),
        _rec(9, "upload", 560, 650, 8, shift=b, step=2),
        _rec(10, "copy", 560, 600, 9, shift=b, step=2, **{"h2d_copies.pageable": 1}),
        _rec(11, "copy", 610, 650, 9, shift=b, step=2, **{"h2d_copies.pageable": 1}),
    ]


def _run():
    tr = trace.Trace(0.0, 1000.0, [(0.0, 130.0), (180.0, 500.0), (620.0, 1000.0)], {}, {}, {},
                     [("plan", 15.0, 95.0), ("step", 95.0, 450.0),
                      ("plan", 465.0, 545.0), ("step", 545.0, 950.0)])
    return types.SimpleNamespace(trace=tr, trace_steps=2)


def _read(name, run, recs, monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    return harness.metric_reader(name).read(run)


@pytest.mark.parametrize("name, value", [
    ("engine_plan_ms", 0.070),  # (70 + 70) µs over 2 steps
    ("copy_ms", 0.080),  # 4 copies of 40 µs
    ("dispatch_ms", 0.290),  # (345 + 395) µs of train_step less 160 of copies, over 2 steps
    ("h2d_copies", 2.0),  # the copy spans' 4 pageable counts
    # idle 130–180 and 500–620 (170 µs); copies cover 130–150, 160–180, 560–600, 610–620
    ("copy_idle_share", 100.0 * 90.0 / 170.0),
])
def test_readers_on_a_constructed_timeline(name, value, monkeypatch):
    assert _read(name, _run(), _records(), monkeypatch) == pytest.approx(value, abs=1e-9)


def test_offsets_within_the_spread_align_by_the_middle_of_their_range(monkeypatch):
    # step B stamped 20 µs later: the offsets' range moves by 10, the
    # plans and copies keep their lengths
    assert _read("copy_ms", _run(), _records(shift_b=20.0), monkeypatch) == pytest.approx(0.08)
    assert _read("engine_plan_ms", _run(), _records(shift_b=20.0),
                 monkeypatch) == pytest.approx(0.07)


def test_the_offset_is_the_middle_of_the_range_that_nests_each_step(monkeypatch):
    # train_step opens 25 µs after its bench.step and closes 5 µs before it
    # ends: any offset from O − 5 to O + 25 nests it, and O + 10 is taken
    run, recs = _run(), _records()
    run.trace.spans[1], run.trace.spans[3] = ("step", 75.0, 450.0), ("step", 525.0, 950.0)
    steps = [(75.0, 450.0), (525.0, 950.0)]
    least, most = program_spans.offset_range(steps, [recs[2], recs[8]])
    assert (least - OFFSET_US, most - OFFSET_US) == pytest.approx((-5.0, 25.0), abs=1e-3)
    spans = {s.id: s for s in program_spans.slice_spans(run, recs)}
    assert (spans[2].start, spans[2].end) == pytest.approx((90.0, 435.0), abs=1e-3)


def test_the_slice_holds_the_spans_of_its_steps(monkeypatch):
    # an earlier try's plan stamped inside the slice's window is not of its
    # steps; every span of the two steps is, the earlier try's step is not
    recs = _records() + [_rec(12, "plan", 300, 320, step=0)]
    spans = program_spans.slice_spans(_run(), recs)
    assert sorted(s.id for s in spans) == list(range(1, 12))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["no-spans", "spread", "fewer-steps", "no-buffer", "no-trace"])
def test_readers_are_silent_without_aligned_spans(name, case, monkeypatch):
    run, recs = _run(), _records()
    if case == "no-spans":
        recs = []
    elif case == "spread":
        recs = _records(shift_b=60.0)  # the two steps' offsets 60 µs apart
    elif case == "fewer-steps":
        recs = [r for r in recs if r.id not in (0, 8)]
    elif case == "no-trace":
        run = types.SimpleNamespace(trace=None, trace_steps=0)
    if case == "no-buffer":  # a program whose tracer keeps no spans
        from pcgmix_tpu_torch import timing

        monkeypatch.delattr(timing, "spans")
        assert program_spans.records() == []
        assert harness.metric_reader(name).read(run) is None
    else:
        assert _read(name, run, recs, monkeypatch) is None


def test_a_train_step_that_does_not_nest_in_its_bench_step_is_not_aligned(monkeypatch):
    # step B's bench.step closes 385 µs before its train_step: no offset
    # nests both steps, by far more than the spread
    run, recs = _run(), _records()
    run.trace.spans[3] = ("step", 545.0, 560.0)
    assert _read("copy_ms", run, recs, monkeypatch) is None

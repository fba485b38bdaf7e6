"""``slot_wait_ms``: the host ms a step in the program's ``slot_wait``
spans, read on a constructed timeline, and silent where the slice holds no
such span (a program whose step does not stage its uploads in a ring)."""

import pytest

from benchmark import harness, program_spans
from test_benchmark_program_spans import _rec, _records, _run


def _with_waits():
    """The two steps of ``_records``, each with a ``slot_wait`` span in its
    ``upload``: 30 µs and 10 µs; the earlier try's step has one too."""
    return _records() + [
        _rec(12, "slot_wait", -4990, -4900, 0, step=0),
        _rec(13, "slot_wait", 110, 140, 3, **{"h2d_slot_waits": 1}),
        _rec(14, "slot_wait", 560, 570, 9, step=2, **{"h2d_slot_waits": 0}),
    ]


def _read(run, recs, monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    return harness.metric_reader("slot_wait_ms").read(run)


def test_the_waits_of_the_slices_steps_over_its_steps(monkeypatch):
    assert _read(_run(), _with_waits(), monkeypatch) == pytest.approx(0.020, abs=1e-9)


@pytest.mark.parametrize("case", ["no-wait-span", "no-spans", "no-trace"])
def test_silent_without_slot_wait_spans(case, monkeypatch):
    run, recs = _run(), _with_waits()
    if case == "no-wait-span":  # the program before the ring: its spans, no slot_wait
        recs = _records()
    elif case == "no-spans":
        recs = []
    else:
        run.trace = None
    assert _read(run, recs, monkeypatch) is None

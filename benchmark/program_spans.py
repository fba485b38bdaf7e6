"""The program's own spans (``pcgmix_tpu_torch.timing``) of a traced
slice's steps, on the trace's µs clock, for the metrics that read them.

Under a profiler the program records each span into a buffer, stamped in
Unix-epoch ns and marked with its training step's identifier; the trace
keeps the benchmark's spans on its own µs clock, which starts at the
profile's start.  Each ``bench.step`` span of the slice holds one
``train_step`` span of the program, the newest ones in the buffer (a slice
profiled again leaves its earlier tries' spans before them), and the
slice's spans are those of these steps.

The clocks are aligned by the steps.  The offset (Unix µs less trace µs)
at which every ``train_step`` lies inside its ``bench.step`` is at most
the least difference of their starts and at least the largest difference
of their ends: the host's time from entering ``bench.step`` to the
program's stamp, and from the program's last stamp to leaving
``bench.step``, makes that range.  The offset taken is its middle, so a
span lands at most half the range's width from where the profiler would
put it.  The spans are not read where the counts differ, where the start
differences spread over ``MAX_SPREAD_US`` between their first and third
quartiles (so one slow call does not silence a slice), or where the range
is empty by more than ``MAX_SPREAD_US``.  A program without the buffer
(the checkout before the tracer had one) gives nothing, and so does each
metric.
"""

from __future__ import annotations

import dataclasses
import statistics

MAX_SPREAD_US = 50.0


@dataclasses.dataclass
class Span:
    """A program span on the trace's clock."""
    id: int
    name: str
    start: float  # µs
    end: float
    parent: int
    counts: dict


def records() -> list:
    """The program's recorded spans, oldest first, or [] where the program
    keeps no buffer."""
    from pcgmix_tpu_torch import timing

    read = getattr(timing, "spans", None)
    return list(read()) if read is not None else []


def offset_range(steps: list, prog: list) -> tuple:
    """(least, most) offset, Unix µs less trace µs, at which each program
    span of ``prog`` lies inside its (start, end) µs of ``steps``."""
    least = max(r.end_ns / 1e3 - e for r, (_, e) in zip(prog, steps))
    most = min(r.start_ns / 1e3 - s for r, (s, _) in zip(prog, steps))
    return least, most


def slice_spans(run, recs=None):
    """The program's spans of ``run.trace``'s steps, shifted onto the
    trace's clock, or None where they cannot be aligned."""
    tr = run.trace
    if tr is None or not run.trace_steps:
        return None
    recs = records() if recs is None else recs
    steps = sorted((s, e) for label, s, e in tr.spans if label == "step")
    prog = [r for r in recs if r.name == "train_step" and r.end_ns]
    if not steps or len(prog) < len(steps):
        return None
    prog = prog[-len(steps):]
    starts = [r.start_ns / 1e3 - s for r, (s, _) in zip(prog, steps)]
    q1, _, q3 = statistics.quantiles(starts, n=4) if len(starts) > 1 else starts * 3
    if q3 - q1 > MAX_SPREAD_US:
        return None
    least, most = offset_range(steps, prog)
    if least - most > MAX_SPREAD_US:
        return None
    off = (least + most) / 2
    ids = {r.step for r in prog}
    out = [Span(r.id, r.name, r.start_ns / 1e3 - off, r.end_ns / 1e3 - off, r.parent,
                dict(r.counts)) for r in recs if r.end_ns and r.step in ids]
    return out or None


def per_step_ms(run, spans, keep) -> float:
    """Host ms a step inside the spans that ``keep`` accepts."""
    return sum(s.end - s.start for s in spans if keep(s)) * 1e-3 / run.trace_steps


def within(span, name: str, by_id: dict) -> bool:
    """Whether ``span`` opened inside a span named ``name``."""
    parent = by_id.get(span.parent)
    while parent is not None:
        if parent.name == name:
            return True
        parent = by_id.get(parent.parent)
    return False

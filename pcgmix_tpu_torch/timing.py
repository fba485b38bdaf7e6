"""The port's tracer: host wall time per named span, and what a profiler sees.

:func:`timed` is the one span API.  Every span adds its wall time (the
device work it waits for included) to a total per name; :func:`host_times`
reads the totals and :func:`reset_host_times` sets them to 0, as the
kernels' launch counts are read and reset.  The spans sit where a training
step's work happens: ``epoch`` (the loader's reshuffle), ``batch``,
``plan``, ``train_step`` with its children ``upload``, ``apply``,
``forward``, ``backward`` and ``update``, ``stage`` and ``replay`` (a chunk
of steps staged and replayed as a CUDA graph), ``slot_wait`` (the host
waiting for a staging slot's last upload, ``train/steps.py::Staging``), and
``copy`` around every host-to-device transfer of the step's path
(:func:`to_device`).  The
model-in-the-loop phases (a saliency pass, the (salopt…) search, a latent
embedding and its TSP pairing, the candidate forward and ``lc_select``)
and the mel build have spans of their own.

While a ``torch.profiler`` profile is running (the profiler's own enabled
flag, read once a span) a span does two things more: it enters
``record_function("pcgmix.<name>")``, so the profiler's trace shows the
program's spans beside the kernels on the trace's clock, and it appends a
:class:`Span` to a bounded buffer (:func:`spans`, emptied by
:func:`reset_spans`): its name, its start and end in ns on the clock the
profiler stamps its host events with (Unix-epoch ns, ``time.time_ns``), the
id of the span it opened in, the identifier of its training step (shared
by the step's batch, plan and ``train_step`` with its children; it
advances as a ``train_step`` or a ``replay`` closes, so a read of the
buffer takes a step's spans by it), and the counter increments made while
it was the innermost open span.  With no profiler active a span costs its
totals and the flag's check.

Counters (:func:`count`) add to totals (:func:`counts`, reset with the
host times; the runner prints them per step beside the spans' host ms)
and, under a profiler, to the innermost open span.
:func:`to_device` counts each transfer as ``h2d_copies.<kind>`` and its
bytes as ``h2d_bytes.<kind>``: ``pageable`` for a blocking copy, which waits
for the device's stream to drain, ``pinned`` for a non-blocking copy from
pinned memory.  The count goes by the call, so on the CPU, where a
transfer is no copy, the count is the card's.  ``h2d_slot_waits`` counts
the stagings that found their slot's last upload unfinished.

Spans run on the host alone: they do not sync the device or allocate
tensors, and a CUDA graph's capture passes through them.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import torch

MAX_SPANS = 1 << 17  # the buffer keeps the newest spans
# a training step's identifier advances when one of these closes
STEP_ENDS = frozenset({"train_step", "replay"})

_totals: dict = {}  # name → [seconds, calls]
_counts: dict = {}
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_open: list = []  # the recorded spans open now, innermost last
_next_id = 0
_step = 0

_profiling = torch._C._autograd._profiler_enabled
_perf = time.perf_counter


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    """A span recorded under a profiler: ``start_ns`` and ``end_ns`` are
    Unix-epoch ns (``end_ns`` 0 while it is open); ``parent`` is the ``id``
    of the span it opened in (−1: none); ``counts`` holds the counter
    increments made while it was the innermost open span."""

    id: int
    name: str
    start_ns: int
    parent: int
    step: int
    end_ns: int = 0
    counts: dict = dataclasses.field(default_factory=dict)


class timed:
    """``with timed(name):`` adds the block's wall time to ``name``'s total;
    under a profiler it records the block too (see the module's doc)."""

    __slots__ = ("name", "_t0", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rec = _enter(self.name) if _profiling() else None
        self._t0 = _perf()
        return self

    def __exit__(self, *exc) -> bool:
        seconds = _perf() - self._t0
        total = _totals.get(self.name)
        if total is None:
            total = _totals[self.name] = [0.0, 0]
        total[0] += seconds
        total[1] += 1
        if self._rec is not None:
            _exit(*self._rec)
        return False


def _enter(name: str) -> tuple:
    global _next_id
    rf = torch.profiler.record_function("pcgmix." + name)
    rf.__enter__()
    rec = Span(_next_id, name, time.time_ns(), _open[-1].id if _open else -1, _step)
    _next_id += 1
    _buffer.append(rec)
    _open.append(rec)
    return rec, rf


def _exit(rec: Span, rf) -> None:
    global _step
    rec.end_ns = time.time_ns()
    rf.__exit__(None, None, None)
    if rec in _open:  # not after a reset_spans()
        _open.remove(rec)
    if rec.name in STEP_ENDS:
        _step += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and under a profiler to the innermost
    open span's counts."""
    _counts[name] = _counts.get(name, 0) + n
    if _open:
        c = _open[-1].counts
        c[name] = c.get(name, 0) + n


_COPY_COUNTERS = {kind == "pinned": (f"h2d_copies.{kind}", f"h2d_bytes.{kind}")
                  for kind in ("pageable", "pinned")}


def to_device(host: torch.Tensor, device, *, pinned: bool = False,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``host`` on ``device`` (copied into ``out`` when given), inside a
    ``copy`` span and counted: ``pinned`` is a non-blocking copy from pinned
    memory, else the copy blocks until the stream has drained."""
    copies, nbytes = _COPY_COUNTERS[pinned]
    with timed("copy"):
        count(copies)
        count(nbytes, host.numel() * host.element_size())
        if out is not None:
            return out.copy_(host, non_blocking=pinned)
        return host.to(device, non_blocking=pinned)


def host_times() -> dict:
    """{name: (total ms, calls)} since the last reset."""
    return {k: (s * 1e3, n) for k, (s, n) in _totals.items()}


def counts() -> dict:
    """{counter: total} since the last reset."""
    return dict(_counts)


def reset_host_times() -> None:
    """Set the spans' totals and the counters to 0."""
    _totals.clear()
    _counts.clear()


def spans() -> list:
    """The recorded :class:`Span` objects, oldest first (at most
    ``MAX_SPANS``)."""
    return list(_buffer)


def reset_spans() -> None:
    """Empty the buffer of recorded spans."""
    global _next_id, _step
    _buffer.clear()
    _open.clear()
    _next_id = _step = 0

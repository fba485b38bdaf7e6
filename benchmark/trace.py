"""Reading a ``torch.profiler`` trace of a slice of training steps.

The slice is bracketed by the benchmark's own spans (``record_function``):
``bench.slice`` around it, and within it ``bench.plan`` (the loader's next
batch and the host plan), ``bench.step`` (the train step's call) and
``bench.epoch`` (a new epoch's shuffle).  Device events (kernels, copies,
sets) give the busy intervals; each kernel belongs to the innermost aten
operation that launched it, and a kernel launched outside any aten
operation (the mix kernels, through ctypes) to none.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

SPAN_PREFIX = "bench."
SPAN_LABELS = {"bench.plan": "plan", "bench.step": "step", "bench.epoch": "epoch boundary"}


def span(name: str, on: bool):
    """The benchmark's span ``name`` in the profiler's trace when ``on``."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Trace:
    """What a profiled slice holds, on the profiler's µs clock."""

    start_us: float  # the slice's bounds on the trace's clock
    end_us: float
    busy: list  # merged (start, end) µs of device activity inside the slice
    kernels: dict  # kernel name → [seconds, events]
    ops: dict  # aten operation → seconds of the kernels it launched itself
    op_of_kernel: dict  # kernel name → the aten operation that launched it most
    spans: list  # (label, start, end) µs of the benchmark's host spans

    @property
    def wall_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernel_events(self, part: str) -> tuple:
        """(seconds, events) of the kernels whose name holds ``part``."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def op_seconds(self, *parts: str) -> float:
        """Device seconds of the kernels launched by the aten operations
        whose name holds any of ``parts``."""
        return sum(s for op, s in self.ops.items() if any(p in op for p in parts))

    def idle_gaps(self) -> list:
        """[(label, seconds)] of each gap between device activity inside
        the slice, labelled by the host span that overlaps it most
        ("other" where none does), longest first."""
        edges = [self.start_us] + [x for iv in self.busy for x in iv] + [self.end_us]
        gaps = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            best, label = 0.0, "other"
            for name, a, b in self.spans:
                over = min(b, e) - max(a, s)
                if over > best:
                    best, label = over, name
            gaps.append((label, (e - s) * 1e-6))
        return sorted(gaps, key=lambda g: -g[1])

    def device_ops(self, top: int = 10) -> list:
        """[(aten operation: kernel, seconds)] of the kernels that took the
        most device time."""
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return [(f"{self.op_of_kernel.get(k, 'no aten op')}: {k[:96]}", s) for k, (s, _) in rows]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def read(prof) -> Trace:
    """A :class:`Trace` of a profile that holds one ``bench.slice`` span."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    slices = [e for e in host if e.name == "bench.slice"]
    if len(slices) != 1:
        raise RuntimeError(f"the trace holds {len(slices)} bench.slice spans, not 1")
    lo, hi = slices[0].time_range.start, slices[0].time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(SPAN_PREFIX)]
    kernels = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in device:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t > s:
            intervals.append((s, t))
        kernels[e.name][0] += (e.time_range.end - e.time_range.start) * 1e-6
        kernels[e.name][1] += 1
    ops = collections.defaultdict(float)
    by_kernel = collections.defaultdict(collections.Counter)
    for e in host:
        if not e.name.startswith("aten::"):
            continue
        for k in e.kernels:
            ops[e.name] += k.duration * 1e-6
            by_kernel[k.name][e.name] += k.duration
    spans = [(SPAN_LABELS[e.name], e.time_range.start, e.time_range.end)
             for e in host if e.name in SPAN_LABELS]
    return Trace(lo, hi, _merge(intervals), dict(kernels), dict(ops),
                 {k: c.most_common(1)[0][0] for k, c in by_kernel.items()}, spans)

"""The share of the traced slice's device-idle time (the gaps between its
device activity) in which the host was inside one of the program's
``copy`` spans, the spans aligned to the trace's clock by the steps."""

from benchmark import program_spans
from benchmark.trace import _merge


def read(run):
    spans = program_spans.slice_spans(run)
    if spans is None:
        return None
    tr = run.trace
    edges = [tr.start_us] + [x for iv in tr.busy for x in iv] + [tr.end_us]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    copies = _merge([(s.start, s.end) for s in spans if s.name == "copy"])
    inside = sum(max(0.0, min(e, b) - max(s, a)) for s, e in gaps for a, b in copies)
    return 100.0 * inside / idle

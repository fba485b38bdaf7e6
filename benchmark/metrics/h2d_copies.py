"""Pageable host-to-device copies a step (each waits for the stream to
drain): the program's ``h2d_copies.pageable`` counts held by the ``copy``
spans of the traced slice."""

from benchmark import program_spans


def read(run):
    spans = program_spans.slice_spans(run)
    if spans is None:
        return None
    n = sum(s.counts.get("h2d_copies.pageable", 0) for s in spans if s.name == "copy")
    return n / run.trace_steps

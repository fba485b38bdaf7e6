"""Host ms a step inside the program's ``slot_wait`` spans: the eager
step's wait, before it writes its indices and plan into a pinned staging
slot, for that slot's last upload to leave it (the host has run that far
ahead of the device), in the traced slice, from the program's span
buffer.  Silent where the slice holds no such span: a program that stages
no upload in a ring of slots."""

from benchmark import program_spans


def read(run):
    spans = program_spans.slice_spans(run)
    if spans is None:
        return None
    waits = [s for s in spans if s.name == "slot_wait"]
    if not waits:
        return None
    return program_spans.per_step_ms(run, waits, lambda s: True)

"""Host ms a step inside the program's ``plan`` spans (``AugmentEngine.plan``)
in the traced slice, from the program's span buffer."""

from benchmark import program_spans


def read(run):
    spans = program_spans.slice_spans(run)
    if spans is None:
        return None
    return program_spans.per_step_ms(run, spans, lambda s: s.name == "plan")

"""Host ms a step inside the program's ``train_step`` spans less the time of
the ``copy`` spans inside them: the host's own work of launching the
step, in the traced slice, from the program's span buffer."""

from benchmark import program_spans


def read(run):
    spans = program_spans.slice_spans(run)
    if spans is None:
        return None
    by_id = {s.id: s for s in spans}
    return (program_spans.per_step_ms(run, spans, lambda s: s.name == "train_step")
            - program_spans.per_step_ms(run, spans, lambda s: s.name == "copy"
                                        and program_spans.within(s, "train_step", by_id)))

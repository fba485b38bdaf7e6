"""Host ms a step in ``TrainStep.__call__`` (the benchmark's span around it:
the uploads with their stream drains, the launches), mean over the traced
run's window."""


def read(run):
    spans = run.spans["step"]
    return 1e3 * sum(spans) / len(spans) if spans else None

"""Host ms a step in the loader's next batch and ``AugmentEngine.plan``
(the benchmark's span around them), mean over the traced run's window."""


def read(run):
    spans = run.spans["plan"]
    return 1e3 * sum(spans) / len(spans) if spans else None

"""Device ms a step in BatchNorm (forward, backward, the running
statistics' ``var_mean``) and max-pool (forward, backward), by the aten
operations that launched the kernels, in the traced slice."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.op_seconds("batch_norm", "var_mean", "max_pool")
    return 1e3 * s / run.trace_steps if s > 0 else None

"""The share of the measured window in which no operation ran on the
device: 1 − the device's busy seconds a step in the traced slice (the
union of its kernel, copy and set intervals) over the unprofiled window's
seconds a step.  The slice's own wall is not the denominator: the
profiler's per-launch and per-operation recording slows the host, which
stretches the gaps of a host-bound cell, while a step's device work
stays as it was."""


def read(run):
    if run.trace is None or not run.trace_steps or not run.steps or run.window_s <= 0:
        return None
    busy_step = run.trace.busy_s / run.trace_steps
    return 100.0 * (1.0 - busy_step / (run.window_s / run.steps))

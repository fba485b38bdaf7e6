"""The mix kernel's share of its roofline in the traced slice: the frozen
bound of a launch (the larger of its bytes over the HBM bandwidth and its
operations over the float32 peak, from the cell's shapes and the slice's
plans) over the kernel's mean device time.  Read where the slice launched
one mix wrapper that :mod:`benchmark.counts` counts, from a trace that
holds exactly one event for each launch that the port counted."""

from benchmark import counts


def read(run):
    launched = {k: n for k, n in run.slice_launches.items() if n}
    if (run.peaks is None or run.trace is None or len(launched) != 1 or not run.slice_plans):
        return None
    (kernel, launches), = launched.items()
    if kernel not in counts.MIX_KERNELS:
        return None
    seconds, events = run.trace.kernel_events(
        run.cell.traffic["launches"][kernel]["device_kernel"])
    if events != launches or seconds <= 0:
        return None
    *lead, length = run.cell.config["input"]
    channels = 1
    for n in lead:
        channels *= n
    plans = run.slice_plans
    covered = sum(int(p["len"].sum()) for p in plans) / len(plans)
    knots = plans[0]["knots"].shape[1] if "knots" in plans[0] else 0
    c = counts.mix_counts(kernel, run.cell.traffic["batch_size"], channels, length,
                          plans[0]["len"].shape[1], covered, knots)
    bound = counts.mix_bound_s(c, run.peaks["float32"], run.peaks["hbm_bytes_s"])
    return 100.0 * bound / (seconds / events)

"""The convolutions' share of their roofline in the traced slice: the least
time of every convolution pass (forward, input gradient, weight gradient;
each bound by its float32 operations at the peak outside the tensor cores
or by its bytes, counted from the configuration's layer table) over the
device time of the kernels that the aten convolution operations launched."""

from benchmark import counts


def read(run):
    if run.peaks is None or run.trace is None:
        return None
    device_s = run.trace.op_seconds("convolution")
    if device_s <= 0:
        return None
    bound = run.trace_steps * counts.conv_bound_s(
        run.cell.config, run.cell.traffic["batch_size"], run.peaks["float32"],
        run.peaks["hbm_bytes_s"])
    return 100.0 * bound / device_s

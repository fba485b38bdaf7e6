"""The whole step's share of the float32 peak outside the tensor cores (TF32
is off): the model's operations of every step in the traced run's window
(forward and both backward passes, 2 a multiply-add, from the
configuration's layer table) over the window's wall."""

from benchmark import counts


def read(run):
    if run.peaks is None or run.window_s <= 0:
        return None
    flops = counts.model_flops_per_sample(run.cell.config) * run.samples
    return 100.0 * flops / run.window_s / run.peaks["float32"]

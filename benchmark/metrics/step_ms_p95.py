"""95th percentile of the device ms between consecutive steps of the traced
run's window: CUDA events recorded after each step's call, read after the
window, no sync inside it."""

import numpy as np


def read(run):
    gaps = run.step_gaps_ms
    return float(np.percentile(gaps, 95)) if len(gaps) >= 20 else None

"""Saliency-optimal displacement search, on the host (counterpart:
``pcgmix_tpu/augment/salopt.py``, of which this is a copy).

Replicates the objective of optimal_displacement_max_envelope /
optimal_displacement_max_sum (reference augmentations.py:60-128): given the
saliency of the longer and shorter segment windows, find the displacement
of the shorter window (within the length gap) that maximizes the summed
saliency of the combined segment.  Both objectives reduce to windowed sums:

- max_sum, longer-d1 case:   total(d) = Σs1 − (1−λ)·W(s1)[d] + (1−λ)Σs2
  → argmax(d) = argmin of the sliding-window sum of s1;
- max_sum, shorter-d1 case:  total(d) = λΣs1 + (1−λ)·W(s2)[d]
  → argmax of the sliding-window sum of s2;
- max_envelope: a sliding-window sum of elementwise maxima; its longer-d1
  case runs in the C++ scan of :mod:`pcgmix_tpu_torch.native`.

Totals are rounded to 12 decimals before the arg-extremum, so accumulation
noise on a near-tie resolves the same way in every implementation.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from pcgmix_tpu_torch import native


def _window_sums(x: np.ndarray, w: int) -> np.ndarray:
    """Sliding-window sums of length w (len(x)-w+1 values) via cumsum."""
    c = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    return c[w:] - c[:-w]


def optimal_displacement_max_sum(s1: np.ndarray, s2: np.ndarray, lam: float) -> int:
    """argmax displacement under the λ-blend objective (augmentations.py:95-128);
    ties resolve to the first maximum, as the reference's strict ``>``."""
    n1, n2 = len(s1), len(s2)
    if n1 == n2:
        return 0
    if n1 > n2:
        return int(np.argmin(np.round(_window_sums(s1, n2), 12)))
    return int(np.argmax(np.round(_window_sums(s2, n1), 12)))


def optimal_displacement_max_envelope(s1: np.ndarray, s2: np.ndarray, lam: float) -> int:
    """argmax displacement under the max-envelope objective
    (augmentations.py:60-93)."""
    n1, n2 = len(s1), len(s2)
    if n1 == n2:
        return 0
    if n1 > n2:
        return native.opt_disp_env(s1, s2)
    # shorter-s1 case: only the overlapped window contributes
    windows = sliding_window_view(s2, n1)
    total = np.maximum(windows, s1[None, :]).sum(axis=1, dtype=np.float64)
    return int(np.argmax(np.round(total, 12)))


def salopt_displacements(
    sal: np.ndarray,
    frames: np.ndarray,
    mix: np.ndarray,
    lam: float,
    mode: str,
) -> np.ndarray:
    """Per-sample per-segment optimal displacements (B, 4).

    sal: (B, T) smoothed saliency maps; frames: (B, 5); mix: partner
    indices; mode: 'env' | 'sum'.  The segment-by-segment search of
    mixup_keepdur_multidim_tensors_salopt (augmentations.py:210-287)."""
    fn = (
        optimal_displacement_max_envelope
        if mode == "env"
        else optimal_displacement_max_sum
    )
    B = sal.shape[0]
    disp = np.zeros((B, 4), dtype=np.int64)
    for i in range(B):
        f1, f2 = frames[i], frames[mix[i]]
        s1, s2 = sal[i], sal[mix[i]]
        for k in range(4):
            a = s1[f1[k] : f1[k + 1]]
            b = s2[f2[k] : f2[k + 1]]
            if len(a) != len(b):
                disp[i, k] = fn(a, b, lam)
    return disp

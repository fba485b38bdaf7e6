"""Cubic-spline magnitude warp (counterpart: ``pcgmix_tpu/ops/spline.py``).

A not-a-knot cubic spline with fixed knot positions is linear in the knot
values, so the (T, knot+2) evaluation basis is built once with scipy and
the whole batch's envelopes are one small contraction:

    warper[b, c, t] = Σ_k basis[t, k] · knots[b, k, c]
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def cubic_spline_basis(sig_len: int, knot: int) -> np.ndarray:
    """Dense (T, knot+2) float64 evaluation basis of a not-a-knot cubic
    spline with knots at ``linspace(0, sig_len-1, knot+2)`` evaluated at
    ``arange(sig_len)`` (reference augmentations.py:676-681)."""
    from scipy.interpolate import CubicSpline

    steps = np.linspace(0, sig_len - 1.0, num=knot + 2)
    queries = np.arange(sig_len, dtype=np.float64)
    basis = np.empty((sig_len, knot + 2), dtype=np.float64)
    for k in range(knot + 2):
        unit = np.zeros(knot + 2)
        unit[k] = 1.0
        basis[:, k] = CubicSpline(steps, unit)(queries)
    return basis


def spline_envelope(basis: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """(B, C, T) float32 envelopes from a (T, K2) basis and (B, K2, C) knots."""
    return torch.einsum("tk,bkc->bct", basis.float(), knots.float())


def magnitude_warp(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Multiply each (sample, channel) of a (B, C, T) batch by its smooth
    random envelope; knots are (B, knot+2, C).  Runs in float32 and returns
    x's dtype."""
    basis = torch.as_tensor(
        cubic_spline_basis(x.shape[-1], knots.shape[1] - 2),
        dtype=torch.float32, device=x.device,
    )
    return (x.float() * spline_envelope(basis, knots.to(x.device))).to(x.dtype)

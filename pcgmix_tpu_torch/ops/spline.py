"""Cubic-spline warps, magnitude and time (counterpart:
``pcgmix_tpu/ops/spline.py``).

A not-a-knot cubic spline with fixed knot positions is linear in the knot
values, so the (T, knot+2) evaluation basis is built once with scipy and
the whole batch's envelopes are one small contraction:

    warper[b, c, t] = Σ_k basis[t, k] · knots[b, k, c]

``time_warp`` re-interpolates each row at the warped time grid with a
batched ``searchsorted``, a gather and a lerp (``np.interp``'s semantics);
the JAX package computes it in XLA (``jnp.interp``), outside any Pallas
kernel, so plain tensor code is its port.
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


_device_constants: dict = {}


def _device_constant(key: tuple, make, device) -> torch.Tensor:
    """The float32 tensor ``make()`` on ``device``, uploaded once per key and
    device and kept: a step captured as a CUDA graph cannot upload."""
    full = (*key, str(torch.device(device)))
    if full not in _device_constants:
        _device_constants[full] = torch.as_tensor(make(), dtype=torch.float32, device=device)
    return _device_constants[full]


def spline_envelope(basis: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """(B, C, T) float32 envelopes from a (T, K2) basis and (B, K2, C) knots."""
    return torch.einsum("tk,bkc->bct", basis.float(), knots.float())


def magnitude_warp(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Multiply each (sample, channel) of a (B, C, T) batch by its smooth
    random envelope; knots are (B, knot+2, C).  Runs in float32 and returns
    x's dtype."""
    T, knot = x.shape[-1], knots.shape[1] - 2
    basis = _device_constant(("basis", T, knot), lambda: cubic_spline_basis(T, knot),
                             x.device)
    return (x.float() * spline_envelope(basis, knots.to(x.device))).to(x.dtype)


def _fma_contraction(basis: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Σ_k basis[t, k] · coeffs[b, k, c] in float32 as one fused
    multiply-add chain over k = 0, 1, …: each step rounds once (the exact
    float32 product is added in float64).  A position off by one ulp moves
    the re-interpolated signal by its slope times the ulp (6e-5 at T = 512),
    so time_warp fixes its rounding order: that of XLA's CPU dot for the
    JAX package's (T, knot+2) contraction at T = 512 and 640.  At other
    lengths (T = 2500 among them) XLA's CPU dot may sum in another order
    (two interleaved chains), and positions then differ from the JAX
    package's by an ulp."""
    b64, c64 = basis.double(), coeffs.double()
    acc = None
    for k in range(basis.shape[1]):
        prod = c64[:, k, :, None] * b64[:, k]
        acc = prod.float() if acc is None else (acc.double() + prod).float()
    return acc


def time_warp(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Smoothly warp the time axis of each (sample, channel) of a (B, C, T)
    batch; knots are (B, knot+2, C) multiplicative knot values.

    The warped time curve is the cubic spline through ``warp_steps · knots``
    rescaled so its endpoint is T−1 (reference augmentations.py:685-696),
    and the signal is linearly re-interpolated at the original grid with
    ``np.interp``'s boundary semantics: queries before the first position
    take the first sample, and every query at or past the last position
    takes the last sample (the tail patch of the JAX package,
    ``pcgmix_tpu/ops/spline.py:161-165``).  Runs in float32 and returns x's
    dtype.
    """
    T = x.shape[-1]
    knot = knots.shape[1] - 2
    dev = x.device
    basis = _device_constant(("basis", T, knot), lambda: cubic_spline_basis(T, knot), dev)
    warp_steps = _device_constant(
        ("warp_steps", T, knot), lambda: np.linspace(0, T - 1.0, num=knot + 2), dev)
    scaled = knots.to(dev).float() * warp_steps[None, :, None]
    tw = _fma_contraction(basis, scaled)  # (B, C, T) warped time coordinates
    # a tensor numerator: a Python scalar over a tensor is computed as a
    # reciprocal times the scalar, which rounds twice
    scale = torch.full_like(tw[..., -1:], T - 1.0) / tw[..., -1:]
    pos = torch.clamp(scale * tw, 0.0, T - 1.0).contiguous()
    sig = x.float()
    q = torch.arange(T, dtype=torch.float32, device=dev).expand_as(pos).contiguous()
    i = torch.searchsorted(pos, q, right=True).clamp_(1, T - 1)
    xp0, xp1 = pos.gather(-1, i - 1), pos.gather(-1, i)
    fp0, fp1 = sig.gather(-1, i - 1), sig.gather(-1, i)
    dx = xp1 - xp0
    flat = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    y = torch.where(flat, fp0, fp0 + ((q - xp0) / torch.where(flat, 1.0, dx)) * (fp1 - fp0))
    y = torch.where(q < pos[..., :1], sig[..., :1], y)
    y = torch.where(q >= pos[..., -1:], sig[..., -1:], y)
    return y.to(x.dtype)

"""PCGmix+: ``durmixmagwarp(σ, knot)`` (reference augmentations.py:659-683,
:924-928): the PCGmix blend times a magnitude warp.  After λ the same NumPy
stream draws the warp's knot values N(1, σ), (B, knot+2, C); each (row,
channel) envelope is the not-a-knot cubic spline through them at
``linspace(0, T−1, knot+2)``, evaluated at every step (scipy's
``CubicSpline``, float64)."""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import CubicSpline

from benchmark.reference.keepdur import beta_lambda, blend, keepdur_plan

ALPHA = 1.0


def plan(step: int, frames, labels, numbers: tuple, channels: int) -> dict:
    sigma, knot = numbers if numbers else (0.2, 4)
    rs = np.random.RandomState(step)
    lam = beta_lambda(rs, ALPHA)
    knots = rs.normal(loc=1.0, scale=sigma, size=(len(labels), int(knot) + 2, channels))
    p = keepdur_plan(step, frames, labels, lam)
    p["knots"] = knots.astype(np.float32)
    return p


def envelope(knots: np.ndarray, length: int) -> np.ndarray:
    """(B, C, T) float64 envelopes."""
    b, k2, c = knots.shape
    at = np.linspace(0, length - 1.0, num=k2)
    y = knots.astype(np.float64).transpose(1, 0, 2).reshape(k2, b * c)
    env = CubicSpline(at, y, axis=0)(np.arange(length, dtype=np.float64))
    return env.reshape(length, b, c).transpose(1, 2, 0)


def mix(rows, plan: dict):
    env = torch.as_tensor(envelope(plan["knots"], rows.shape[-1]), device=rows.device)
    return blend(rows, plan) * env.to(rows.dtype)

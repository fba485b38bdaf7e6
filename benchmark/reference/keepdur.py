"""The keep-duration mix of PCGmix and PCGmix+ (reference
augmentations.py:289-338, :500-514, :659-683), plain.

The host plan pairs each row with a partner of its own label (a shuffle
within each label by ``random.Random(step)``; every group draws from a
fresh generator of the same seed, as the published code does), draws λ ~
Beta(α, α) from ``np.random.seed(step)``, and lays out, per segment k of
the cycle, the window both rows share: L_k = min(len1_k, len2_k) steps
from each row's segment start.  The mix copies the row and, inside each
window, takes λ·row + (1 − λ)·partner.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def same_label_partners(labels: np.ndarray, seed: int) -> np.ndarray:
    groups: dict = {}
    for i, t in enumerate(labels):
        groups.setdefault(int(t), []).append(i)
    mix = np.arange(len(labels))
    for idxs in groups.values():
        mix[idxs] = random.Random(seed).sample(list(mix[idxs]), len(idxs))
    return mix.astype(np.int32)


def keepdur_plan(step: int, frames: np.ndarray, labels: np.ndarray, lam: float) -> dict:
    """The partners and each segment's shared window, λ on every segment."""
    mix = same_label_partners(labels, step)
    f1 = np.asarray(frames, np.int64)
    f2 = f1[mix]
    len1, len2 = np.diff(f1, axis=1), np.diff(f2, axis=1)
    length = np.minimum(len1, len2)
    return {"mix": mix, "dst": f1[:, :-1], "src": f2[:, :-1], "len": length,
            "sel": np.ones_like(length), "alpha": np.full(length.shape, lam, np.float32),
            "lam": np.float32(lam)}


def beta_lambda(rs: np.random.RandomState, alpha: float) -> float:
    return float(rs.beta(alpha, alpha)) if alpha > 0.0 else 1.0


def blend(rows: torch.Tensor, plan: dict) -> torch.Tensor:
    """(B, C, T) rows mixed with their partners over each segment's window,
    window by window."""
    out = rows.clone()
    partners = rows[torch.as_tensor(plan["mix"], dtype=torch.int64, device=rows.device)]
    lam = float(plan["lam"])
    for i in range(rows.shape[0]):
        for k in range(plan["len"].shape[1]):
            d, s, n = (int(plan[a][i, k]) for a in ("dst", "src", "len"))
            if n > 0:
                out[i, :, d:d + n] = lam * rows[i, :, d:d + n] + (1.0 - lam) * partners[i, :, s:s + n]
    return out

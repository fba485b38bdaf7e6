"""Piecewise segment mix, plain PyTorch (counterpart: ``pcgmix_tpu/ops/piecewise.py``).

Every cardiac-cycle augmentation is, per sample, a set of "pieces": copy or
blend a window of a source row (the sample itself, d1, or its partner, d2)
into a window of the output:

    out[t] = base[t]                                       t uncovered
    out[t] = a_k·base[t] + (1 − a_k)·src_k[t + off_k]      t in piece k

with ``off_k = src_start_k − dst_start_k`` and ``base`` = d1 (keep-duration
methods) or 0 (concat methods).  Unused slots have ``length == 0``.

Semantics over the covering pieces are those of the JAX ``piecewise_mix``:
alpha, offset and selector are SUMMED over every piece covering ``t`` and
the source index is clamped to [0, T−1].  On the engine's disjoint,
in-range pieces this is the plain formula above.
"""

from __future__ import annotations

import numpy as np
import torch


def piecewise_mix_f32(
    d1: torch.Tensor,
    d2: torch.Tensor,
    dst_start: torch.Tensor,
    src_start: torch.Tensor,
    length: torch.Tensor,
    src_sel: torch.Tensor,
    alpha: torch.Tensor,
    *,
    base_is_d1: bool = True,
) -> torch.Tensor:
    """Apply per-row pieces to a batch of row pairs.

    Args:
      d1, d2: (N, C, T) sample rows and their partner rows.
      dst_start, src_start, length, src_sel: (N, K) integer piece arrays.
      alpha: (N, K) float — out = alpha·base + (1−alpha)·src inside a piece.
      base_is_d1: uncovered output equals d1 (True) or zero (False).

    Returns:
      (N, C, T) float32.
    """
    T = d1.shape[-1]
    dev = d1.device
    x1 = d1.float()
    x2 = d2.float()
    t = torch.arange(T, device=dev, dtype=torch.int64)
    dst = dst_start.to(dev, torch.int64)[:, :, None]
    src = src_start.to(dev, torch.int64)[:, :, None]
    ln = length.to(dev, torch.int64)[:, :, None]
    # (N, K, T) membership of every t in every piece
    inside = (t >= dst) & (t < dst + ln)
    insidef = inside.float()
    covered = inside.any(dim=1)  # (N, T)
    a = (insidef * alpha.to(dev, torch.float32)[:, :, None]).sum(dim=1)
    off = torch.where(inside, src - dst, 0).sum(dim=1)
    sel = torch.where(inside, src_sel.to(dev, torch.int64)[:, :, None], 0).sum(dim=1)

    idx = (t + off).clamp(0, T - 1)  # (N, T)
    gidx = idx[:, None, :].expand_as(x1)
    g1 = torch.gather(x1, 2, gidx)
    g2 = torch.gather(x2, 2, gidx)
    srcv = torch.where((sel != 0)[:, None, :], g2, g1)

    base = x1 if base_is_d1 else torch.zeros_like(x1)
    a = a[:, None, :]
    return torch.where(covered[:, None, :], a * base + (1.0 - a) * srcv, base)


def segment_blend_pieces(frames1, frames2, disp, lam_seg):
    """Piece arrays for keep-duration segment blending (numpy, host side).

    Translation of the slice arithmetic in the reference's
    ``mixup_keepdur_multidim_tensors`` (augmentations.py:289-338): per
    segment k, L_k = min(len1_k, len2_k); the longer side's window is
    displaced by disp_k; out[dst_k : dst_k+L_k] blends d1 and d2 by lam_seg_k.

    Args:
      frames1, frames2: (..., S+1) segment boundaries of d1 and d2.
      disp: (..., S) displacement of the longer side per segment.
      lam_seg: (..., S) per-segment blend coefficient on d1.

    Returns:
      dict of (..., S) arrays: dst_start, src_start, length, src_sel, alpha.
    """
    len1 = frames1[..., 1:] - frames1[..., :-1]
    len2 = frames2[..., 1:] - frames2[..., :-1]
    length = np.minimum(len1, len2)
    gap = len2 - len1  # >=0: d2 longer -> displace src; <0: d1 longer -> dst
    return {
        "dst_start": frames1[..., :-1] + np.where(gap < 0, disp, 0),
        "src_start": frames2[..., :-1] + np.where(gap >= 0, disp, 0),
        "length": length,
        "src_sel": np.ones_like(length),
        "alpha": lam_seg,
    }

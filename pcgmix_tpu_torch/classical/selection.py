"""The mutual-information feature selection of the classifier bench
(counterpart: ``mutual_info_classif(x, y, random_state=seed)`` and the
top-k order in ``pcgmix_tpu/classical/experiment.py:368-373``), following
scikit-learn 1.9.0's ``feature_selection/_mutual_info.py``: ``_estimate_mi``
(``scale(with_mean=False)``, then ``1e-10 · max(1, mean|x|)`` times a
standard normal draw from ``RandomState(seed)``) and ``_compute_mi_cd``
with 3 neighbours, every feature continuous and the target discrete.

The scaling and the noise are numpy's on the host, in the reference's
expressions (a class of a few points makes the counts hinge on the last
bit of the scaled values); the neighbour search, the counts and the
digamma means run on ``device`` in float64, every feature at once.  A
feature is one-dimensional, so sorting replaces the reference's trees:

- the k-th nearest same-class distance of a point lies among its k
  neighbours on either side in the class's sorted order; the distance is
  ``|x_i - x_j|``, which is what the KD-tree returns (``sqrt`` of the
  rounded square of a difference gives back its magnitude).  A class of at
  most 2k + 1 points is searched by brute force in the reference
  (``NearestNeighbors``' ``auto`` rule): there the distance is
  ``sqrt(max(x_i² − 2·x_i·x_j + x_j², 0))``, rounded as its Euclidean
  reduction rounds it, over every pair;
- the points within ``nextafter(r, 0)`` of a point are a run of the sorted
  column on each side of it, found by bisection on the reference's own test,
  the rounded square of the difference against the rounded square of the
  radius.

The scores are ``ψ(n) + ⟨ψ(k)⟩ − ⟨ψ(n_class)⟩ − ⟨ψ(m)⟩`` clipped at 0.
:func:`top_features` orders them as pandas'
``sort_values("MI", ascending=False)`` does (its ``nargsort`` over numpy's
quicksort, ties included) and keeps the first ``k``.
"""

from __future__ import annotations

import numpy as np
import torch

from pcgmix_tpu_torch.train.loop import resolve_device

N_NEIGHBORS = 3
_EPS = float(np.finfo(np.float64).eps)


def _kth_brute(col: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest of ``sqrt(max((x_i² + (−2·x_i·x_j)) + x_j², 0))``
    over the other points j of each column (``EuclideanArgKmin``).  The
    square root is numpy's, correctly rounded as libm's (torch's CPU
    kernel can land an ulp away); the class has at most 2k + 1 points."""
    sq = col * col
    d2 = (sq[:, None, :] + (-2.0 * (col[:, None, :] * col[None, :, :]))) + sq[None, :, :]
    d2 = torch.clamp_min(d2, 0.0)
    n = col.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=col.device)[:, :, None]
    d2 = d2.masked_fill(eye, float("inf"))
    kth = d2.sort(dim=1).values[:, k - 1]
    return torch.as_tensor(np.sqrt(kth.cpu().numpy()), device=col.device)


def _kth_same_class_distance(col: torch.Tensor, k: int) -> torch.Tensor:
    """(n, f) columns of one class → (n, f) distance of each point to its
    k-th nearest other point of the column."""
    n = col.shape[0]
    if k >= n // 2:
        return _kth_brute(col, k)
    vals, order = torch.sort(col, dim=0, stable=True)
    pos = torch.arange(n, device=col.device)[:, None]
    cands = []
    for step in range(1, k + 1):
        for shift in (-step, step):
            j = (pos + shift).clamp(0, n - 1).expand_as(vals)
            d = (vals - torch.gather(vals, 0, j)).abs()
            valid = ((pos + shift >= 0) & (pos + shift < n)).expand_as(vals)
            cands.append(torch.where(valid, d, torch.full_like(d, float("inf"))))
    kth = torch.stack(cands, 0).sort(dim=0).values[k - 1]
    out = torch.empty_like(kth)
    out.scatter_(0, order, kth)
    return out


def _counts_within(x: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """(n, f) count of the points j of each column with
    ``(x_j - x_i)² <= radius_i²`` (the point itself included)."""
    n = x.shape[0]
    vals, order = torch.sort(x, dim=0, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(0, order, torch.arange(n, device=x.device)[:, None].expand_as(order))
    r2 = radius * radius

    def inside(j: torch.Tensor) -> torch.Tensor:
        d = torch.gather(vals, 0, j) - x
        return d * d <= r2

    # the last index right of the point that is inside, and the first left
    lo, hi = rank.clone(), torch.full_like(rank, n - 1)
    while True:  # invariant: lo inside, hi + 1 outside or n
        open_ = lo < hi
        if not bool(open_.any()):
            break
        mid = (lo + hi + 1) // 2
        ok = inside(mid)
        lo = torch.where(open_ & ok, mid, lo)
        hi = torch.where(open_ & ~ok, mid - 1, hi)
    right = lo
    lo, hi = torch.zeros_like(rank), rank.clone()
    while True:  # invariant: hi inside, lo - 1 outside or -1
        open_ = lo < hi
        if not bool(open_.any()):
            break
        mid = (lo + hi) // 2
        ok = inside(mid)
        hi = torch.where(open_ & ok, mid, hi)
        lo = torch.where(open_ & ~ok, mid + 1, lo)
    return right - hi + 1


def mutual_info(x: np.ndarray, y: np.ndarray, *, seed: int, device="cuda") -> np.ndarray:
    """``mutual_info_classif(x, y, random_state=seed)`` with every feature
    continuous: (n, f) float64 features and (n,) integer labels → (f,)
    scores, computed on ``device``."""
    dev = resolve_device(str(device))
    X = np.array(x, dtype=np.float64)
    y = np.asarray(y)
    n, f = X.shape
    rng = np.random.RandomState(seed)
    scale = np.nanstd(X, axis=0)
    scale[scale < 10 * _EPS] = 1.0
    X /= scale
    means = np.maximum(1, np.mean(np.abs(X), axis=0))
    X += 1e-10 * means * rng.standard_normal(size=(n, f))
    X = torch.as_tensor(X, device=dev)

    radius = torch.empty_like(X)
    label_counts = np.empty(n)
    k_all = np.empty(n)
    for label in np.unique(y):
        mask = y == label
        count = int(mask.sum())
        if count > 1:
            k = min(N_NEIGHBORS, count - 1)
            rows = torch.as_tensor(np.flatnonzero(mask), device=dev)
            r = _kth_same_class_distance(X[rows], k)
            radius[rows] = torch.nextafter(r, torch.zeros_like(r))
            k_all[mask] = k
        label_counts[mask] = count
    keep = label_counts > 1
    n_kept = int(keep.sum())
    rows = torch.as_tensor(np.flatnonzero(keep), device=dev)
    m_all = _counts_within(X[rows], radius[rows]).to(torch.float64)

    def digamma_mean(v) -> torch.Tensor:
        return torch.special.digamma(torch.as_tensor(v, dtype=torch.float64, device=dev)).mean(0)

    mi = (torch.special.digamma(torch.tensor(float(n_kept), dtype=torch.float64, device=dev))
          + digamma_mean(k_all[keep]) - digamma_mean(label_counts[keep])
          - torch.special.digamma(m_all).mean(dim=0))
    return torch.clamp_min(mi, 0.0).cpu().numpy()


def top_features(names, scores: np.ndarray, k: int) -> list:
    """The first ``k`` names by descending score, in pandas'
    ``sort_values(ascending=False)`` order (``nargsort``: the reversed
    column through numpy's quicksort, reversed back)."""
    scores = np.asarray(scores, dtype=np.float64)
    idx = np.arange(len(scores))[::-1]
    order = idx[scores[::-1].argsort(kind="quicksort")][::-1]
    return [names[i] for i in order[:k]]

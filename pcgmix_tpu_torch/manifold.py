"""t-SNE for the latent-space plots (counterpart: scikit-learn 1.9.0's
``TSNE(n_components, learning_rate="auto", init="random", perplexity,
random_state)`` with its defaults, which ``pcgmix_tpu/latent.py``'s
``dim_reduc_tsne`` fits), on the card.

It follows ``sklearn/manifold/_t_sne.py`` step for step but for the
gradient:

- P, the joint probabilities: each point's k = min(n − 1, int(3·perplexity
  + 1)) nearest neighbours by Euclidean distance (float64 distance tiles of
  a chunk of rows and ``topk``), the squared distances in float32; each
  row's precision by the float32-input binary search of
  ``_utils.pyx::_binary_search_perplexity`` (float64 arithmetic, entropy
  tolerance 1e-5, at most 100 steps; all rows at once); then P + Pᵀ over
  its sum (``_joint_probabilities_nn``).
- The start: ``1e-4 · RandomState(4).standard_normal((n, k))`` in
  float32; the learning rate max(n / 12 / 4, 50).
- The optimizer: ``_gradient_descent`` (momentum, gains +0.2 / ×0.8 down to
  0.01, a check every 50 iterations) in two stages: 250 iterations at
  exaggeration 12 and momentum 0.5, then momentum 0.8 up to 1000, with
  250 and 300 iterations without progress and a gradient norm of 1e-7 as
  stops.  The embedding, the gradient and the gains are float32, the
  update float64, as numpy's promotion makes them there.
- The gradient: scikit-learn's Barnes–Hut tree (angle 0.5) approximates
  the repulsion on the host; this computes it exactly (the angle's limit
  at 0) on the card: the attraction over P's entries, the repulsion over
  every pair in tiles of a chunk of rows, O(n²) an iteration, which a
  few thousand points keep small.  Coordinates therefore differ from
  scikit-learn's; the two are held by KL divergence and trustworthiness.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERATIONS = 250
MAX_ITERATIONS = 1000
CHECK_EVERY = 50
MIN_GAIN, MIN_GRAD_NORM = 0.01, 1e-7
RANDOM_STATE = 4  # the start's seed, as the JAX package's TSNE takes it
BINARY_SEARCH_STEPS = 100
# the binary search's constants are C floats there: float32 values
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
EMPTY_ROW_SUM = float(np.float32(1e-8))
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
TILE = 1 << 22  # elements of one pairwise tile


def _row_chunk(n: int) -> int:
    """Rows of an n-column tile."""
    return max(1, min(n, TILE // max(n, 1)))


def nearest_neighbors(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distances, indices), each (n, k): every row's k nearest
    other rows of ``x`` by Euclidean distance, nearest first, from float64
    tiles ‖a‖² − 2a·b + ‖b‖² (clipped at 0, as scikit-learn reckons
    them)."""
    x = x.double()
    n = x.shape[0]
    norms = (x * x).sum(1)
    dist, idx = [], []
    step = _row_chunk(n)
    for start in range(0, n, step):
        rows = torch.arange(start, min(start + step, n), device=x.device)
        d = norms[rows, None] - 2 * (x[rows] @ x.T) + norms[None, :]
        d.clamp_(min=0)
        d[torch.arange(len(rows), device=x.device), rows] = math.inf  # not its own neighbour
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dist.append(v)
        idx.append(i)
    return torch.cat(dist), torch.cat(idx)


def conditional_probabilities(sqdist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """p_j|i (n, k) over each row's neighbours: the binary search for each
    row's precision β to the perplexity (``_binary_search_perplexity``:
    the float32 distances, float64 arithmetic), every row at once; a row's
    probabilities are those of the last β it evaluated."""
    d = sqdist.float().double()
    n = d.shape[0]
    kw = dict(dtype=torch.float64, device=d.device)
    beta = torch.ones(n, **kw)
    lo = torch.full((n,), -math.inf, **kw)
    hi = torch.full((n,), math.inf, **kw)
    p = torch.zeros_like(d)
    active = torch.ones(n, dtype=torch.bool, device=d.device)
    target = math.log(np.float32(perplexity))
    for _ in range(BINARY_SEARCH_STEPS):
        q = torch.exp(-d * beta[:, None])
        total = q.sum(1)
        total = torch.where(total == 0, torch.full_like(total, EMPTY_ROW_SUM), total)
        q = q / total[:, None]
        entropy = torch.log(total) + beta * (d * q).sum(1)
        p = torch.where(active[:, None], q, p)
        diff = entropy - target
        active = active & (diff.abs() > PERPLEXITY_TOLERANCE)
        up = diff > 0
        new_lo = torch.where(up, beta, lo)
        new_hi = torch.where(up, hi, beta)
        stepped = torch.where(
            up, torch.where(hi == math.inf, beta * 2, (beta + hi) / 2),
            torch.where(lo == -math.inf, beta / 2, (beta + lo) / 2))
        beta = torch.where(active, stepped, beta)
        lo = torch.where(active, new_lo, lo)
        hi = torch.where(active, new_hi, hi)
    return p


@dataclass
class JointProbabilities:
    """The symmetric P as its nonzero entries: ``rows``, ``cols`` (int64)
    and ``values`` (float64), summing to 1; ``n`` points."""

    rows: torch.Tensor
    cols: torch.Tensor
    values: torch.Tensor
    n: int


def joint_probabilities(sqdist: torch.Tensor, neighbors: torch.Tensor,
                        perplexity: float) -> JointProbabilities:
    """P = (C + Cᵀ) / its sum from the conditional probabilities C of each
    row's neighbours (``_joint_probabilities_nn``)."""
    n, k = neighbors.shape
    cond = conditional_probabilities(sqdist, perplexity)
    rows = torch.arange(n, device=neighbors.device).repeat_interleave(k)
    cols = neighbors.reshape(-1)
    # each entry of C + Cᵀ is the sum of at most two terms: its value does
    # not depend on the order the adds land in
    keys, where = torch.unique(torch.cat([rows * n + cols, cols * n + rows]),
                               return_inverse=True)
    values = torch.zeros(len(keys), dtype=cond.dtype, device=cond.device).index_add_(
        0, where, cond.reshape(-1).repeat(2))
    values = values / values.sum().clamp(min=float(np.finfo(np.float64).eps))
    return JointProbabilities(keys // n, keys % n, values, n)


def kl_objective(y: torch.Tensor, p: JointProbabilities, p32: torch.Tensor,
                 compute_error: bool = True) -> tuple[float, torch.Tensor]:
    """(KL(P ‖ Q), its gradient) at the embedding ``y`` (n, d) float32 for
    the Student-t Q of one degree of freedom per dimension beyond the
    first (at least one): the attraction over P's entries ``p32`` (P's
    values, exaggerated or not, in float32), the repulsion exactly over all
    pairs; the KL in float64, ``nan`` without ``compute_error``."""
    n, dims = y.shape
    dof = max(dims - 1, 1)

    def kernel(squared):  # the Student-t kernel of squared distances
        q = float(dof) / (float(dof) + squared)
        return q if dof == 1 else q ** ((dof + 1.0) / 2.0)

    diff = y.index_select(0, p.rows) - y.index_select(0, p.cols)
    w = kernel(sum(diff[:, a] * diff[:, a] for a in range(dims)))
    attract = torch.zeros_like(y).index_add_(0, p.rows, (p32 * w)[:, None] * diff)
    repel = torch.empty_like(y)
    sum_q = torch.zeros((), dtype=torch.float64, device=y.device)
    cols = y.T.contiguous()
    step = _row_chunk(n)
    for start in range(0, n, step):
        stop = min(start + step, n)
        q = kernel(sum((cols[a, start:stop, None] - cols[a, None, :]) ** 2
                       for a in range(dims)))
        q[torch.arange(stop - start, device=y.device),
          torch.arange(start, stop, device=y.device)] = 0
        sum_q += q.sum(dtype=torch.float64)
        q2 = q * q
        repel[start:stop] = q2.sum(1, keepdim=True) * y[start:stop] - q2 @ y
    sum_q = sum_q.clamp(min=float(np.finfo(np.float64).eps))
    grad = (attract - repel / sum_q.float()) * (2.0 * (dof + 1.0) / dof)
    error = math.nan
    if compute_error:
        pd = p32.double()
        qd = w.double() / sum_q
        error = float((pd * torch.log(pd.clamp(min=FLOAT32_TINY)
                                      / qd.clamp(min=FLOAT32_TINY))).sum())
    return error, grad


def gradient_descent(objective, p0: torch.Tensor, it: int, max_iter: int,
                     n_iter_without_progress: int, momentum: float, learning_rate: float):
    """scikit-learn's ``_gradient_descent`` with a check every CHECK_EVERY
    iterations, gains down to MIN_GAIN and MIN_GRAD_NORM: (parameters,
    error, last iteration).  ``objective(p, compute_error)`` → (error,
    gradient) on the float32 parameter vector; the update is kept in
    float64 and added to the parameters in float64 before their float32
    rounding, as numpy's promotion does there."""
    p = p0.clone().reshape(-1)
    update = torch.zeros_like(p, dtype=torch.float64)
    gains = torch.ones_like(p)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % CHECK_EVERY == 0
        error, grad = objective(p, compute_error=check or i == max_iter - 1)
        grad = grad.reshape(-1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.double()
        p = (p.double() + update).float()
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return p, error, i


def optimize(p: JointProbabilities, y0: torch.Tensor,
             learning_rate: float) -> tuple[torch.Tensor, float, int]:
    """The two stages of ``TSNE._tsne`` from the float32 start ``y0``:
    (embedding, KL divergence, last iteration)."""
    n, dims = y0.shape
    values = p.values * EARLY_EXAGGERATION

    def objective(params, compute_error):
        return kl_objective(params.reshape(n, dims), p, p32, compute_error)

    p32 = values.float()
    params, error, it = gradient_descent(objective, y0, 0, EXPLORATION_ITERATIONS,
                                         EXPLORATION_ITERATIONS, 0.5, learning_rate)
    values = values / EARLY_EXAGGERATION
    p32 = values.float()
    params, error, it = gradient_descent(objective, params, it + 1, MAX_ITERATIONS, 300, 0.8,
                                         learning_rate)
    return params.reshape(n, dims), error, it


def kl_divergence(p: JointProbabilities, y) -> float:
    """KL(P ‖ Q) of an embedding ``y`` (n, d) under P, exactly."""
    y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=p.values.device)
    return kl_objective(y, p, p.values.float())[0]


def tsne(x, n_components: int = 2, perplexity: float = 30.0, device="cuda") -> np.ndarray:
    """The (n, ``n_components``) float32 embedding of the rows of ``x``
    (n, d)."""
    from pcgmix_tpu_torch.train.loop import resolve_device

    dev = resolve_device(device)
    x = np.asarray(x)
    n = x.shape[0]
    if not 0 < perplexity < n:
        raise ValueError(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    k = min(n - 1, int(3.0 * perplexity + 1))
    sqdist, neighbors = nearest_neighbors(torch.as_tensor(x, device=dev), k)
    p = joint_probabilities(sqdist, neighbors, perplexity)
    y0 = 1e-4 * np.random.RandomState(RANDOM_STATE).standard_normal(
        size=(n, n_components)).astype(np.float32)
    learning_rate = max(n / EARLY_EXAGGERATION / 4, 50.0)
    return optimize(p, torch.from_numpy(y0).to(dev), learning_rate)[0].cpu().numpy()

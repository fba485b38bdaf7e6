"""The two-component Gaussian mixture behind ``plotters.plot_epoch_loss_gmm``
(counterpart: ``sklearn.mixture.GaussianMixture(n_components=2,
random_state=4)`` at scikit-learn 1.9.0's defaults, which the JAX package's
``plot_epoch_loss_gmm`` fits): full covariances, ``reg_covar`` 1e-6, EM to
a change of the mean log-likelihood below ``tol`` 1e-3 in at most 100
iterations, one initialization.

The initialization is scikit-learn's: a whole ``KMeans(n_clusters=2,
n_init=1)`` drawing from the mixture's ``RandomState(4)`` — k-means++
(``2 + int(log k)`` local trials, candidates by ``searchsorted`` on the
cumulative potential) on the data less its mean, then Lloyd iterations to
KMeans' tolerance (1e-4 times the data's mean variance) — whose labels
become one-hot responsibilities.  The arithmetic follows scikit-learn's,
operation for operation, so the fit lands on the same numbers.

It runs in numpy float64 on the host: the data are one epoch's per-sample
losses, a few thousand 1-D values, and EM's iterations are sequential, so
the card would add only its launch latency.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy import linalg

EPS = np.finfo(np.float64).eps
# scikit-learn's defaults: GaussianMixture's and its KMeans start's
TOL, REG_COVAR, MAX_ITER = 1e-3, 1e-6, 100
KMEANS_TOL, KMEANS_MAX_ITER = 1e-4, 300
# the JAX package's GaussianMixture(n_components=2, random_state=4)
COMPONENTS, RANDOM_STATE = 2, 4


def _squared_distances(a: np.ndarray, x: np.ndarray, x_squared_norms: np.ndarray):
    """‖a_i − x_j‖² as scikit-learn's ``_euclidean_distances`` reckons it
    in float64: −2 a·xᵀ + ‖a‖² + ‖x‖², clipped at 0."""
    d = -2 * (a @ x.T)
    d += np.einsum("ij,ij->i", a, a)[:, None]
    d += x_squared_norms.reshape(1, -1)
    return np.maximum(d, 0, out=d)


def kmeans_plusplus(x: np.ndarray, random_state: np.random.RandomState,
                    x_squared_norms: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(COMPONENTS centres, their row indices) by greedy k-means++ with
    ``2 + int(log k)`` local trials (scikit-learn's ``_kmeans_plusplus``,
    unit weights), drawing from ``random_state``."""
    n = x.shape[0]
    weight = np.ones(n, dtype=x.dtype)
    centers = np.empty((COMPONENTS, x.shape[1]), dtype=x.dtype)
    trials = 2 + int(np.log(COMPONENTS))
    first = random_state.choice(n, p=weight / weight.sum())
    indices = np.full(COMPONENTS, -1, dtype=int)
    centers[0], indices[0] = x[first], first
    closest = _squared_distances(centers[0, np.newaxis], x, x_squared_norms)
    potential = closest @ weight
    for c in range(1, COMPONENTS):
        draws = random_state.uniform(size=trials) * potential
        candidates = np.searchsorted(np.cumsum(weight * closest), draws)
        np.clip(candidates, None, closest.size - 1, out=candidates)
        to_candidates = _squared_distances(x[candidates], x, x_squared_norms)
        np.minimum(closest, to_candidates, out=to_candidates)
        potentials = to_candidates @ weight.reshape(-1, 1)
        best = np.argmin(potentials)
        potential, closest = potentials[best], to_candidates[best]
        centers[c], indices[c] = x[candidates[best]], candidates[best]
    return centers, indices


def _lloyd_step(x: np.ndarray, centers: np.ndarray, update: bool = True):
    """One Lloyd iteration (scikit-learn's ``lloyd_iter_chunked_dense`` on
    one thread): (labels, new centres, their centre shifts); with ``update``
    False the labels alone."""
    k = len(centers)
    distances = np.einsum("ij,ij->i", centers, centers)[None, :] - 2.0 * (x @ centers.T)
    labels = np.argmin(distances, axis=1).astype(np.int32)
    if not update:
        return labels, None, None
    weight = np.bincount(labels, minlength=k).astype(x.dtype)
    new = np.stack([np.bincount(labels, weights=x[:, f], minlength=k)
                    for f in range(x.shape[1])], 1)
    empty = np.flatnonzero(weight == 0)
    if len(empty):  # _relocate_empty_clusters_dense: the farthest points
        far = ((x - centers[labels]) ** 2).sum(axis=1)
        if far.max() != 0:
            for c, i in zip(empty, np.argpartition(far, -len(empty))[:-len(empty) - 1:-1]):
                new[labels[i]] -= x[i]
                new[c] = x[i]
                weight[c] = 1.0
                weight[labels[i]] -= 1.0
    biggest = np.argmax(weight)
    for c in range(k):
        new[c] = new[c] * (1.0 / weight[c]) if weight[c] > 0 else new[biggest]
    return labels, new, np.sqrt(((new - centers) ** 2).sum(axis=1))


@dataclass
class KMeansFit:
    centers: np.ndarray
    labels: np.ndarray
    n_iter: int


def kmeans(x: np.ndarray) -> KMeansFit:
    """scikit-learn's ``KMeans(COMPONENTS, n_init=1,
    random_state=RandomState(RANDOM_STATE))`` with the Lloyd algorithm: the
    mixture hands its own fresh generator to its KMeans start."""
    x = np.array(x, dtype=np.float64, order="C")
    tol = np.mean(np.var(x, axis=0)) * KMEANS_TOL
    mean = x.mean(axis=0)
    x -= mean
    centers, _ = kmeans_plusplus(x, np.random.RandomState(RANDOM_STATE),
                                 np.einsum("ij,ij->i", x, x))
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for i in range(KMEANS_MAX_ITER):
        labels, centers, shift = _lloyd_step(x, centers)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _lloyd_step(x, centers, update=False)[0]
    return KMeansFit(centers + mean, labels, i + 1)


def logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
    """scikit-learn's ``_logsumexp``: the largest entries counted apart
    (log1p of the rest's sum over their count)."""
    top = np.max(a, axis=axis, keepdims=True)
    is_top = a == top
    rest = np.array(a, copy=True)
    rest[is_top] = -np.inf
    m = np.sum(is_top.astype(a.dtype), axis=axis, keepdims=True, dtype=a.dtype)
    e = np.exp(rest - np.where(np.isfinite(top), top, 0))
    s = np.sum(e, axis=axis, keepdims=True, dtype=e.dtype)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + top, axis=axis)


def _parameters(x: np.ndarray, resp: np.ndarray, reg_covar: float):
    """(weights as counts, means, full covariances) of the responsibilities."""
    nk = resp.sum(axis=0) + 10 * EPS
    means = (resp.T @ x) / nk[:, np.newaxis]
    d = x.shape[1]
    covariances = np.empty((len(means), d, d), dtype=x.dtype)
    for k in range(len(means)):
        diff = x - means[k, :]
        covariances[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        covariances[k].flat[:d * d:d + 1] += reg_covar
    return nk, means, covariances


def _precision_cholesky(covariances: np.ndarray) -> np.ndarray:
    out = np.empty_like(covariances)
    eye = np.eye(covariances.shape[1])
    for k, cov in enumerate(covariances):
        try:
            chol = linalg.cholesky(cov, lower=True)
        except np.linalg.LinAlgError:
            raise ValueError("the mixture's fit failed: a component's covariance is "
                             "ill-defined (singleton or collapsed samples)") from None
        out[k] = linalg.solve_triangular(chol, eye, lower=True).T
    return out


@dataclass
class GaussianMixture:
    """A fitted mixture: ``weights``, ``means`` (k, d), ``covariances``
    (k, d, d), ``precisions_cholesky``; ``kmeans`` is its initialization."""

    weights: np.ndarray
    means: np.ndarray
    covariances: np.ndarray
    precisions_cholesky: np.ndarray
    n_iter: int
    converged: bool
    kmeans: KMeansFit

    def weighted_log_prob(self, x: np.ndarray) -> np.ndarray:
        d = x.shape[1]
        k = len(self.means)
        log_det = np.sum(np.log(self.precisions_cholesky.reshape(k, -1)[:, ::d + 1]), axis=1)
        log_prob = np.empty((x.shape[0], k), dtype=x.dtype)
        for c in range(k):
            chol = self.precisions_cholesky[c]
            y = (x @ chol) - (self.means[c] @ chol)
            log_prob[:, c] = np.sum(np.square(y), axis=1)
        return -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det + np.log(self.weights)

    def score_samples(self, x) -> np.ndarray:
        """The log-likelihood of each row of ``x`` (n, d)."""
        return logsumexp(self.weighted_log_prob(np.asarray(x, dtype=np.float64)), axis=1)


def fit_gaussian_mixture(x) -> GaussianMixture:
    """EM from the KMeans labels' one-hot responsibilities on ``x`` (n, d),
    n ≥ COMPONENTS."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n < COMPONENTS:
        raise ValueError(f"a mixture of {COMPONENTS} needs at least {COMPONENTS} samples, "
                         f"got {n}")
    init = kmeans(x)
    resp = np.zeros((n, COMPONENTS), dtype=x.dtype)
    resp[np.arange(n), init.labels] = 1
    weights, means, covariances = _parameters(x, resp, REG_COVAR)
    gm = GaussianMixture(weights / n, means, covariances, _precision_cholesky(covariances),
                         0, False, init)
    lower_bound = -np.inf
    for gm.n_iter in range(1, MAX_ITER + 1):
        previous = lower_bound
        weighted = gm.weighted_log_prob(x)
        norm = logsumexp(weighted, axis=1)
        with np.errstate(under="ignore"):
            log_resp = weighted - norm[:, np.newaxis]
        weights, gm.means, gm.covariances = _parameters(x, np.exp(log_resp), REG_COVAR)
        gm.weights = weights / np.sum(weights)
        gm.precisions_cholesky = _precision_cholesky(gm.covariances)
        lower_bound = np.mean(norm)
        if abs(lower_bound - previous) < TOL:
            gm.converged = True
            break
    return gm

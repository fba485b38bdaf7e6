"""The eight classifiers of the bench (counterpart: the estimators that
``pcgmix_tpu/classical/experiment.py:_make_classifiers`` builds from
scikit-learn), at scikit-learn 1.9.0's defaults, each with ``fit``,
``predict_proba`` and ``predict`` on float64 numpy rows and 0/1 labels.

Where each runs:

- on ``device`` (the card unless the caller asks for the CPU), in float64:
  :class:`GaussianNB` (``var_smoothing`` 1e-9 of the largest feature
  variance, the joint log-likelihood, scikit-learn's log-sum-exp) and
  :class:`KNeighborsClassifier` (5 uniform neighbours by brute force, as
  ``auto`` picks it past 15 features: the rank-preserving distance
  ``‖y‖² − 2x·y``, ties to the lower training index, as the reference's
  heap keeps them);
- on the host, in numpy with the reference's order of operations:
  :class:`LogisticRegression` (L-BFGS-B through ``scipy.optimize.minimize``
  with ``linear_model/_logistic.py``'s options on ``_linear_loss.py``'s
  loss and gradient; it stops at ``max_iter`` = 100 unconverged on
  unscaled features, so its result follows the exact optimizer path);
- on the host, in C++ (``native/src/pcgmix_bench.cpp``): the tree grower
  of :class:`DecisionTreeClassifier`, :class:`RandomForestClassifier` (100
  bootstrap trees on ``sqrt`` features) and
  :class:`GradientBoostingClassifier` (100 depth-3 squared-error trees on
  the log-loss's negative gradient, Newton leaf values), whose leaf-value
  and prediction steps stay in numpy as in ``ensemble/_gb.py``; the SGD of
  :class:`SGDClassifier` (log loss); the SMO and Platt scaling of
  :class:`SVC` (behind the standard scaler of its pipeline, here numpy).

Every draw comes from ``numpy.random.RandomState(seed)`` as the reference
makes it (each tree's ``randint(0, RAND_R_MAX)`` seeding the grower's
``rand_r``; the forest's per-tree seeds and bootstrap; the SGD's dataset
and shuffle seeds; the SVC's libsvm seed), so the same seed grows the same
trees and support vectors.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from scipy.optimize import minimize
from scipy.special import expit, logit

from pcgmix_tpu_torch import native
from pcgmix_tpu_torch.train.loop import resolve_device

MAX_INT = int(np.iinfo(np.int32).max)
RAND_R_MAX = 2147483647
_EPS = float(np.finfo(np.float64).eps)
# scikit-learn's defaults, the only values the bench uses
N_NEIGHBORS = 5
N_TREES = 100  # the forest's trees and gradient boosting's stages
GB_DEPTH, GB_LEARNING_RATE = 3, 0.1
LR_MAX_ITER, LR_TOL = 100, 1e-4  # and C = 1
SGD_ALPHA, SGD_MAX_ITER, SGD_TOL, SGD_N_ITER_NO_CHANGE = 1e-4, 1000, 1e-3, 5
SVC_TOL = 1e-3  # and C = 1


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _rows(x, dtype=np.float64) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=dtype)


def _labels(y) -> np.ndarray:
    y = np.asarray(y)
    if y.ndim != 1 or not np.isin(y, (0, 1)).all():
        raise ValueError("the bench's estimators take 0/1 labels")
    return y.astype(np.int64)


class _Estimator:
    """``predict``: the most probable class, ties to class 0."""

    def predict(self, x) -> np.ndarray:
        return np.argmax(self.predict_proba(x), axis=1)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


class GaussianNB(_Estimator):
    """``GaussianNB()``: per-class means and variances, each variance plus
    1e-9 of the largest feature variance; priors from the class counts."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(str(device))

    def fit(self, x, y) -> "GaussianNB":
        X = torch.as_tensor(_rows(x), device=self.device)
        y = _labels(y)
        epsilon = 1e-9 * X.var(dim=0, unbiased=False).max()
        theta, var, count = [], [], []
        for c in (0, 1):
            Xc = X[torch.as_tensor(y == c, device=self.device)]
            theta.append(Xc.mean(dim=0))
            var.append(Xc.var(dim=0, unbiased=False))
            count.append(float(len(Xc)))
        self.theta = torch.stack(theta)
        self.var = torch.stack(var) + epsilon
        counts = torch.tensor(count, dtype=torch.float64, device=self.device)
        self.prior = counts / counts.sum()
        return self

    def _jll(self, x) -> torch.Tensor:
        X = torch.as_tensor(_rows(x), device=self.device)
        out = []
        for i in range(2):
            n_ij = -0.5 * torch.log(2.0 * math.pi * self.var[i]).sum()
            n_ij = n_ij - 0.5 * (((X - self.theta[i]) ** 2) / self.var[i]).sum(dim=1)
            out.append(torch.log(self.prior[i]) + n_ij)
        return torch.stack(out, dim=1)

    def predict_proba(self, x) -> np.ndarray:
        jll = self._jll(x)
        # sklearn.utils._array_api._logsumexp over the classes
        top = jll.max(dim=1, keepdim=True).values
        at_top = jll == top
        rest = jll.masked_fill(at_top, -math.inf)
        m = at_top.to(jll.dtype).sum(dim=1, keepdim=True)
        shift = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
        s = torch.exp(rest - shift).sum(dim=1, keepdim=True)
        s = torch.where(s == 0, s, s / m)
        lse = torch.log1p(s) + torch.log(m) + top
        return torch.exp(jll - lse).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self._jll(x).argmax(dim=1).cpu().numpy()


class KNeighborsClassifier(_Estimator):
    """``KNeighborsClassifier()``: the class shares among the 5 nearest
    training rows by Euclidean distance."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(str(device))

    def fit(self, x, y) -> "KNeighborsClassifier":
        if len(x) < N_NEIGHBORS:
            raise ValueError(f"{N_NEIGHBORS} neighbours need as many training rows, "
                             f"not {len(x)}")
        self.X = torch.as_tensor(_rows(x), device=self.device)
        self.y = torch.as_tensor(_labels(y), device=self.device)
        self.sq_norms = (self.X * self.X).sum(dim=1)
        return self

    def predict_proba(self, x) -> np.ndarray:
        T = torch.as_tensor(_rows(x), device=self.device)
        dist = (-2.0 * (T @ self.X.T)) + self.sq_norms[None, :]
        nearest = torch.sort(dist, dim=1, stable=True).indices[:, :N_NEIGHBORS]
        labels = self.y[nearest]
        counts = torch.stack([(labels == c).sum(dim=1) for c in (0, 1)], dim=1)
        return (counts.to(torch.float64) / N_NEIGHBORS).cpu().numpy()


# --------------------------------------------------------------------------- #
# on the host
# --------------------------------------------------------------------------- #


def _half_binomial_loss_gradient(y: np.ndarray, raw: np.ndarray):
    lib = native.build_library()
    y, raw = _rows(y), _rows(raw)
    loss, grad = np.empty_like(raw), np.empty_like(raw)
    lib.pcg_half_binomial_loss_gradient(_ptr(y), _ptr(raw), len(raw), _ptr(loss), _ptr(grad))
    return loss, grad


def _half_binomial_gradient(y: np.ndarray, raw: np.ndarray) -> np.ndarray:
    lib = native.build_library()
    y, raw = _rows(y), _rows(raw)
    out = np.empty_like(raw)
    lib.pcg_half_binomial_gradient(_ptr(y), _ptr(raw), len(raw), _ptr(out))
    return out


class _Linear(_Estimator):
    """A binary linear model: ``expit(X @ coef.T + intercept)``; ``predict``
    is the decision value's sign (positive: class 1)."""

    def decision_function(self, x) -> np.ndarray:
        return (_rows(x) @ self.coef_.T + self.intercept_).ravel()

    def predict_proba(self, x) -> np.ndarray:
        p = expit(self.decision_function(x))
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (self.decision_function(x) > 0).astype(np.int64)


class LogisticRegression(_Linear):
    """``LogisticRegression(random_state=seed)``: L2, C = 1, lbfgs, 100
    iterations at most, tol 1e-4."""

    def fit(self, x, y) -> "LogisticRegression":
        X = _rows(x)
        target = _labels(y).astype(np.float64)
        n, d = X.shape
        l2 = 1.0 / n  # 1 / (C · n) with C = 1

        def loss_gradient(coef):
            weights, intercept = coef[:-1], coef[-1]
            raw = X @ weights + intercept
            loss, grad_pointwise = _half_binomial_loss_gradient(target, raw)
            loss = float(np.sum(loss) / n)
            loss += float(0.5 * l2 * (weights @ weights))
            grad_pointwise /= n
            grad = np.empty_like(coef)
            grad[:d] = X.T @ grad_pointwise + l2 * weights
            grad[-1] = np.sum(grad_pointwise)
            return loss, grad

        res = minimize(loss_gradient, np.zeros(d + 1), method="L-BFGS-B", jac=True,
                       options={"maxiter": LR_MAX_ITER, "maxls": 50, "gtol": LR_TOL,
                                "ftol": 64 * _EPS})
        coef = np.asarray(res.x).reshape(1, d + 1)
        self.coef_, self.intercept_ = coef[:, :-1], coef[:, -1]
        self.n_iter_ = int(min(res.nit, LR_MAX_ITER))
        return self


class SGDClassifier(_Linear):
    """``SGDClassifier(loss="log_loss", random_state=seed)``: alpha 1e-4,
    the "optimal" schedule, 1,000 epochs at most, tol 1e-3 over 5 epochs."""

    def __init__(self, seed: int):
        self.seed = seed

    def fit(self, x, y) -> "SGDClassifier":
        X = _rows(x)
        target = _labels(y).astype(np.float64)
        rs = np.random.RandomState(self.seed)
        rs.randint(1, MAX_INT)  # the dataset's own seed, unused when it is read in order
        shuffle_seed = rs.randint(MAX_INT)
        w, b = np.empty(X.shape[1]), np.empty(1)
        epochs = native.build_library().pcg_sgd_log_loss(
            _ptr(X), _ptr(target), X.shape[0], X.shape[1], SGD_ALPHA, SGD_MAX_ITER, SGD_TOL,
            SGD_N_ITER_NO_CHANGE, shuffle_seed, _ptr(w), _ptr(b))
        if epochs < 0:
            raise ValueError("SGD: floating-point under-/overflow; scale the features")
        self.coef_, self.intercept_, self.n_iter_ = w.reshape(1, -1), b, int(epochs)
        return self


class Tree:
    """A grown tree's arrays, laid out as scikit-learn's ``tree_``:
    ``children_left``/``children_right`` (-1 at a leaf), ``feature`` and
    ``threshold`` (-2 at a leaf), ``value`` (node x width)."""

    def __init__(self, xf: np.ndarray, y: np.ndarray, sw, n_classes: int, max_features: int,
                 max_depth: int, seed: int):
        lib = native.build_library()
        n, d = xf.shape
        cap = 2 * n + 1
        width = max(n_classes, 1)
        left, right, feature = (np.empty(cap, np.int64) for _ in range(3))
        threshold, value = np.empty(cap), np.empty((cap, width))
        y = _rows(y)
        sw = None if sw is None else _rows(sw)
        count = lib.pcg_tree_grow(
            _ptr(xf), n, d, _ptr(y), None if sw is None else _ptr(sw), n_classes,
            max_features, max_depth, seed, cap, _ptr(left), _ptr(right), _ptr(feature),
            _ptr(threshold), _ptr(value))
        if count < 0:
            raise RuntimeError("tree grower: node capacity exceeded")
        self.children_left, self.children_right = left[:count], right[:count]
        self.feature, self.threshold = feature[:count], threshold[:count]
        self.value = value[:count]

    @property
    def node_count(self) -> int:
        return len(self.feature)

    def apply(self, xf: np.ndarray) -> np.ndarray:
        out = np.empty(len(xf), np.int64)
        native.build_library().pcg_tree_apply(
            _ptr(xf), xf.shape[0], xf.shape[1], _ptr(self.children_left),
            _ptr(self.children_right), _ptr(self.feature), _ptr(self.threshold), _ptr(out))
        return out

    def predict_proba(self, xf: np.ndarray) -> np.ndarray:
        proba = self.value.take(self.apply(xf), axis=0)
        normalizer = proba.sum(axis=1)[:, np.newaxis]
        normalizer[normalizer == 0.0] = 1.0
        proba /= normalizer
        return proba


def _float32_rows(x) -> np.ndarray:
    return _rows(x, np.float32)


class DecisionTreeClassifier(_Estimator):
    """``DecisionTreeClassifier(random_state=seed)``: Gini, best splits over
    every feature, grown until pure."""

    def __init__(self, seed: int):
        self.seed = seed

    def fit(self, x, y) -> "DecisionTreeClassifier":
        xf = _float32_rows(x)
        tree_seed = np.random.RandomState(self.seed).randint(0, RAND_R_MAX)
        self.tree_ = Tree(xf, _labels(y).astype(np.float64), None, 2, xf.shape[1], MAX_INT,
                          tree_seed)
        return self

    def predict_proba(self, x) -> np.ndarray:
        return self.tree_.predict_proba(_float32_rows(x))


class RandomForestClassifier(_Estimator):
    """``RandomForestClassifier(random_state=seed)``: 100 Gini trees, each
    on a bootstrap (its counts as sample weights) and ``sqrt`` features."""

    def __init__(self, seed: int):
        self.seed = seed

    def fit(self, x, y) -> "RandomForestClassifier":
        xf = _float32_rows(x)
        target = _labels(y).astype(np.float64)
        n, d = xf.shape
        rs = np.random.RandomState(self.seed)
        seeds = [rs.randint(MAX_INT) for _ in range(N_TREES)]
        max_features = max(1, int(np.sqrt(d)))
        self.estimators_ = []
        for s in seeds:
            boot = np.random.RandomState(s).randint(0, n, n).astype(np.int32)
            sw = np.bincount(boot, minlength=n).astype(np.float64)
            tree_seed = np.random.RandomState(s).randint(0, RAND_R_MAX)
            self.estimators_.append(Tree(xf, target, sw, 2, max_features, MAX_INT, tree_seed))
        return self

    def predict_proba(self, x) -> np.ndarray:
        xf = _float32_rows(x)
        proba = np.zeros((len(xf), 2))
        for tree in self.estimators_:
            proba += tree.predict_proba(xf)
        proba /= len(self.estimators_)
        return proba


class GradientBoostingClassifier(_Estimator):
    """``GradientBoostingClassifier(random_state=seed)``: the prior's
    log-odds, then 100 stages of a depth-3 squared-error tree on the
    negative gradient with one Newton step a leaf, learning rate 0.1; the
    stages' trees draw their seeds from one ``RandomState``."""

    def __init__(self, seed: int):
        self.seed = seed

    def _raw_init(self, n: int) -> np.ndarray:
        p = np.clip(np.full(n, self.prior_[1]), _EPS, 1 - _EPS, dtype=np.float64)
        return logit(p)

    def fit(self, x, y) -> "GradientBoostingClassifier":
        xf = _float32_rows(x)
        target = _labels(y).astype(np.float64)
        n, d = xf.shape
        counts = np.bincount(_labels(y), minlength=2)
        self.prior_ = counts / counts.sum()
        raw = self._raw_init(n)
        sw = np.ones(n)
        rs = np.random.RandomState(self.seed)
        self.estimators_ = []
        for _ in range(N_TREES):
            neg_gradient = -_half_binomial_gradient(target, raw)
            tree = Tree(xf, neg_gradient, None, 0, d, GB_DEPTH, rs.randint(0, RAND_R_MAX))
            leaves = tree.apply(xf)
            for leaf in np.nonzero(tree.children_left == -1)[0]:
                idx = np.nonzero(leaves == leaf)[0]
                neg_g = neg_gradient.take(idx, axis=0)
                prob = target.take(idx, axis=0) - neg_g
                numerator = np.average(neg_g, weights=sw[idx])
                denominator = np.average(prob * (1 - prob), weights=sw[idx])
                tree.value[leaf, 0] = (0.0 if abs(denominator) < 1e-150
                                       else float(numerator) / float(denominator))
            raw += GB_LEARNING_RATE * tree.value[:, 0].take(leaves, axis=0)
            self.estimators_.append(tree)
        return self

    def decision_function(self, x) -> np.ndarray:
        xf = _float32_rows(x)
        raw = self._raw_init(len(xf))
        for tree in self.estimators_:
            raw += GB_LEARNING_RATE * tree.value[:, 0].take(tree.apply(xf), axis=0)
        return raw

    def predict_proba(self, x) -> np.ndarray:
        p = expit(self.decision_function(x))
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (self.decision_function(x) >= 0).astype(np.int64)


def _blas_ddot() -> int:
    """The address of scipy's BLAS ``ddot`` (the one scikit-learn's libsvm
    glue calls), from ``scipy.linalg.cython_blas``'s capsule."""
    import scipy.linalg.cython_blas as blas

    capsule = blas.__pyx_capi__["ddot"]
    get_name = ctypes.pythonapi.PyCapsule_GetName
    get_name.restype, get_name.argtypes = ctypes.c_char_p, [ctypes.py_object]
    get_pointer = ctypes.pythonapi.PyCapsule_GetPointer
    get_pointer.restype = ctypes.c_void_p
    get_pointer.argtypes = [ctypes.py_object, ctypes.c_char_p]
    return get_pointer(capsule, get_name(capsule))


class SVC(_Estimator):
    """``make_pipeline(StandardScaler(), SVC(probability=True, gamma="auto",
    random_state=seed))``: RBF kernel with gamma 1/n_features, C = 1,
    eps 1e-3, shrinking; probabilities by Platt scaling on 5-fold decision
    values.  ``predict`` is the decision value's sign, as libsvm's (not the
    larger probability)."""

    def __init__(self, seed: int):
        self.seed = seed

    def _scaled(self, x) -> np.ndarray:
        X = np.array(x, dtype=np.float64, order="C")
        X -= self.mean_
        X /= self.scale_
        return X

    def fit(self, x, y) -> "SVC":
        # StandardScaler.fit (utils/extmath.py:_incremental_mean_and_var) on
        # the rows in the caller's layout, which orders the column sums
        X = np.asarray(x, dtype=np.float64)
        n, d = X.shape
        new_sum = np.sum(X, axis=0)
        self.mean_ = new_sum / float(n)
        temp = X - new_sum / float(n)
        correction = np.sum(temp, axis=0)
        temp **= 2
        var = np.sum(temp, axis=0)
        var -= correction**2 / float(n)
        var = var / float(n)
        constant = var <= float(n) * _EPS * var + (float(n) * self.mean_ * _EPS) ** 2
        self.scale_ = np.where(constant, 1.0, np.sqrt(var))
        X = self._scaled(X)
        target = _labels(y).astype(np.float64)
        self.gamma_ = 1.0 / d
        random_seed = np.random.RandomState(self.seed).randint(MAX_INT)
        sv, coef, scalars = np.empty(n, np.int64), np.empty(n), np.empty(3)
        n_sv = native.build_library().pcg_svc_fit(
            _ptr(X), _ptr(target), n, d, 1.0, self.gamma_, SVC_TOL, random_seed,
            _blas_ddot(), _ptr(sv), _ptr(coef), _ptr(scalars))
        if n_sv < 0:
            raise ValueError("SVC: the training labels do not hold two classes")
        self.support_, self.dual_coef_ = sv[:n_sv], coef[:n_sv]
        self.support_vectors_ = np.ascontiguousarray(X[self.support_])
        self.rho_, self.probA_, self.probB_ = scalars
        return self

    def _decision_proba(self, x):
        T = self._scaled(x)
        dec, prob = np.empty(len(T)), np.empty((len(T), 2))
        native.build_library().pcg_svc_predict(
            _ptr(self.support_vectors_), _ptr(self.dual_coef_), len(self.support_),
            T.shape[1], self.rho_, self.probA_, self.probB_, self.gamma_, _blas_ddot(),
            _ptr(T), len(T), _ptr(dec), _ptr(prob))
        return dec, prob

    def predict_proba(self, x) -> np.ndarray:
        return self._decision_proba(x)[1]

    def predict(self, x) -> np.ndarray:
        return (self._decision_proba(x)[0] <= 0).astype(np.int64)

"""Native (C++) host kernels, loaded with ctypes (counterpart:
``pcgmix_tpu/native/__init__.py``).

``src/pcgmix_native.cpp`` and ``src/pcgmix_bench.cpp`` (the classifier
bench's tree grower, SGD and SVC solver, used by
``classical/estimators.py``) are compiled with g++ at first use into one
library in ``build/native/`` beside the package (the directory the CUDA
kernels build into), keyed by a hash of the sources and flags.  Unlike the JAX package's
shim there is no silent fallback: a failed build raises.  The NumPy scan
each entry point replaces stays here as its plain version
(:func:`opt_disp_env_plain`, :func:`sample_entropy_plain`), which the tests
hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

_SRC = Path(__file__).resolve().parent / "src" / "pcgmix_native.cpp"
_BENCH_SRC = _SRC.with_name("pcgmix_bench.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the library; raises if g++
    fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = (_SRC, _BENCH_SRC)
        digest = hashlib.sha256(" ".join(FLAGS).encode())
        for src in sources:
            digest.update(src.read_bytes())
        so = BUILD_DIR / f"libpcgmix_native_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *FLAGS, *map(str, sources), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                                   f"{', '.join(map(str, sources))}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.pcg_sample_entropy.restype = ctypes.c_double
        lib.pcg_sample_entropy.argtypes = [dp, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_double]
        lib.pcg_opt_disp_env.restype = ctypes.c_int64
        lib.pcg_opt_disp_env.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64]
        _declare_bench(lib)
        _lib = lib
        return lib


def _declare_bench(lib: ctypes.CDLL) -> None:
    """Signatures of ``src/pcgmix_bench.cpp``'s entry points."""
    i64, f64, u32, vp = ctypes.c_int64, ctypes.c_double, ctypes.c_uint32, ctypes.c_void_p
    lib.pcg_tree_grow.restype = i64
    lib.pcg_tree_grow.argtypes = [vp, i64, i64, vp, vp, i64, i64, i64, u32, i64, vp, vp, vp,
                                  vp, vp]
    lib.pcg_tree_apply.restype = None
    lib.pcg_tree_apply.argtypes = [vp, i64, i64, vp, vp, vp, vp, vp]
    lib.pcg_half_binomial_gradient.restype = None
    lib.pcg_half_binomial_gradient.argtypes = [vp, vp, i64, vp]
    lib.pcg_half_binomial_loss_gradient.restype = None
    lib.pcg_half_binomial_loss_gradient.argtypes = [vp, vp, i64, vp, vp]
    lib.pcg_sgd_log_loss.restype = i64
    lib.pcg_sgd_log_loss.argtypes = [vp, vp, i64, i64, f64, i64, f64, i64, u32, vp, vp]
    lib.pcg_svc_fit.restype = i64
    lib.pcg_svc_fit.argtypes = [vp, vp, i64, i64, f64, f64, f64, u32, vp, vp, vp, vp]
    lib.pcg_svc_predict.restype = None
    lib.pcg_svc_predict.argtypes = [vp, vp, i64, i64, f64, f64, f64, f64, vp, vp, i64, vp, vp]


def _as_double_ptr(x: np.ndarray):
    x = np.ascontiguousarray(x, np.float64)
    return x, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def opt_disp_env(s_long: np.ndarray, s_short: np.ndarray) -> int:
    """The max-envelope displacement of ``s_short`` inside the longer
    ``s_long`` (reference augmentations.py:60-93), by the C++ scan."""
    lib = build_library()
    a, pa = _as_double_ptr(s_long)
    b, pb = _as_double_ptr(s_short)
    return int(lib.pcg_opt_disp_env(pa, len(a), pb, len(b)))


def opt_disp_env_plain(s_long: np.ndarray, s_short: np.ndarray) -> int:
    """:func:`opt_disp_env`'s plain version, the NumPy scan: Σs_long with
    each window's values replaced by their max with ``s_short``, rounded to
    12 decimals, first maximum."""
    windows = sliding_window_view(s_long, len(s_short))
    total = np.sum(s_long, dtype=np.float64) - windows.sum(
        axis=1, dtype=np.float64
    ) + np.maximum(windows, s_short[None, :]).sum(axis=1, dtype=np.float64)
    return int(np.argmax(np.round(total, 12)))


def sample_entropy(y: np.ndarray, order: int, r: float) -> float:
    """antropy.sample_entropy's count with tolerance ``r`` (Chebyshev
    distance, both counts over the n − order templates): −log(A/B), NaN
    where a count is 0, by the C++ scan."""
    lib = build_library()
    a, pa = _as_double_ptr(y)
    return float(lib.pcg_sample_entropy(pa, len(a), int(order), float(r)))


def sample_entropy_plain(y: np.ndarray, order: int, r: float) -> float:
    """:func:`sample_entropy`'s plain version, the NumPy loop of the JAX
    package's fallback (``pcgmix_tpu/classical/dsp.py:193-204``)."""
    y = np.asarray(y, np.float64)
    n = len(y)
    if n <= order + 1:
        return np.nan
    tm = sliding_window_view(y, order)[: n - order]
    tm1 = sliding_window_view(y, order + 1)
    b = a = 0
    for i in range(len(tm) - 1):
        d = np.max(np.abs(tm[i + 1 :] - tm[i]), axis=1)
        b += int(np.sum(d < r))
        d1 = np.max(np.abs(tm1[i + 1 :] - tm1[i]), axis=1)
        a += int(np.sum(d1 < r))
    if a == 0 or b == 0:
        return np.nan
    return float(-np.log(a / b))

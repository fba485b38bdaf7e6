"""Native (C++) host kernels, loaded with ctypes (counterpart:
``pcgmix_tpu/native/__init__.py``).

``src/pcgmix_native.cpp`` is compiled with g++ at first use into
``build/native/`` beside the package (the directory the CUDA kernels build
into), keyed by a hash of the source and flags.  Unlike the JAX package's
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
        digest = hashlib.sha256(" ".join(FLAGS).encode() + _SRC.read_bytes())
        so = BUILD_DIR / f"libpcgmix_native_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise RuntimeError(f"g++ failed ({proc.returncode}) building {_SRC}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.pcg_sample_entropy.restype = ctypes.c_double
        lib.pcg_sample_entropy.argtypes = [dp, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_double]
        lib.pcg_opt_disp_env.restype = ctypes.c_int64
        lib.pcg_opt_disp_env.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64]
        _lib = lib
        return lib


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

"""The piecewise-mix kernels K1 and K2: wrappers, plain versions, build.

K1 ``piecewise_mix_pairs`` replaces ``pcgmix_tpu/ops/pallas_mix.py::
piecewise_mix_pairs_pallas`` (PCGmix); K2 ``pcgmix_plus_fused`` replaces
``pcgmix_plus_fused_pallas`` (PCGmix+: the same blend fused with the
cubic-spline magnitude warp).  The CUDA sources are ``csrc/mix_kernels.cu``.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version in this module; a CUDA tensor launches the kernel or raises.  Each
wrapper counts its kernel launches (:func:`launch_counts`), so a run can
show that its main path went through the kernels.

The kernels are compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``build/torch_kernels/`` beside the package,
keyed by a hash of the sources and flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from pcgmix_tpu_torch.ops.piecewise import piecewise_mix_f32
from pcgmix_tpu_torch.ops.spline import cubic_spline_basis, spline_envelope

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
MAX_PIECES = 32  # kMaxPieces in csrc/mix_kernels.cu
MAX_WARP_TERMS = 256  # kMaxWarpTerms: (knot+2)·C envelope coefficients

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_launches = {"piecewise_mix_pairs": 0, "pcgmix_plus_fused": 0}
_lib = None
_lib_lock = threading.Lock()
_basis_cache: dict = {}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


# --------------------------------------------------------------------------- #
# build and load
# --------------------------------------------------------------------------- #


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found to build the mix kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library.

    With ``verbose`` the compile line and ptxas' register/shared-memory
    report are printed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(_CSRC.iterdir()):
            digest.update(p.name.encode() + p.read_bytes())
        so = BUILD_DIR / f"libpcgmix_mix_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   *map(str, sources)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                    f"{res.stdout}{res.stderr}"
                )
            if verbose:
                print(" ".join(cmd))
                print(res.stdout + res.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pcgmix_piecewise_mix_pairs.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.pcgmix_piecewise_mix_pairs.restype = i
        lib.pcgmix_plus_fused.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.pcgmix_plus_fused.restype = i
        lib.pcgmix_max_pieces.restype = i
        lib.pcgmix_max_warp_terms.restype = i
        if (lib.pcgmix_max_pieces() != MAX_PIECES
                or lib.pcgmix_max_warp_terms() != MAX_WARP_TERMS):
            raise RuntimeError("mix kernel limits disagree with the wrapper")
        _lib = lib
        return lib


# --------------------------------------------------------------------------- #
# argument checks
# --------------------------------------------------------------------------- #


def _check(data, rows, pieces, alpha):
    """Validate (data, row-index vectors, int piece arrays, alpha); returns
    (N, K)."""
    if data.dim() != 3:
        raise ValueError(f"data must be (B, C, T), got {tuple(data.shape)}")
    if data.dtype not in _DTYPE_CODES:
        raise TypeError(f"data must be float32 or bfloat16, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    n = rows[0].shape[0]
    k = pieces[0].shape[1] if pieces[0].dim() == 2 else -1
    for r in rows:
        if r.dim() != 1 or r.shape[0] != n or r.dtype != torch.int32:
            raise ValueError("row indices must be int32 vectors of one length")
    for a in pieces:
        if a.shape != (n, k) or a.dtype != torch.int32:
            raise ValueError(f"piece arrays must be int32 ({n}, K)")
    if alpha.shape != (n, k) or alpha.dtype != torch.float32:
        raise ValueError(f"alpha must be float32 ({n}, {k})")
    if k > MAX_PIECES:
        raise ValueError(f"at most {MAX_PIECES} pieces per row, got {k}")
    for t in (*rows, *pieces, alpha):
        if t.device != data.device or not t.is_contiguous():
            raise ValueError("arguments must be contiguous, on data's device")
    return n, k


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


# --------------------------------------------------------------------------- #
# K1: piecewise mix over row pairs
# --------------------------------------------------------------------------- #


def piecewise_mix_pairs_plain(data, idx1, idx2, dst, src, length, sel, alpha,
                              *, base_is_d1: bool = True):
    """Plain version of K1: gather both rows, then the mask arithmetic."""
    d1 = data.index_select(0, idx1.long())
    d2 = data.index_select(0, idx2.long())
    return piecewise_mix_f32(
        d1, d2, dst, src, length, sel, alpha, base_is_d1=base_is_d1
    ).to(data.dtype)


def piecewise_mix_pairs(data, idx1, idx2, dst, src, length, sel, alpha,
                        *, base_is_d1: bool = True):
    """Output row i mixes data[idx1[i]] with data[idx2[i]] over K pieces.

    data (B, C, T) float32/bfloat16 contiguous; idx1, idx2 (N,) int32;
    dst, src, length, sel (N, K) int32; alpha (N, K) float32.
    Returns (N, C, T) in data's dtype, blended in float32.
    """
    n, k = _check(data, (idx1, idx2), (dst, src, length, sel), alpha)
    if data.device.type == "cpu":
        return piecewise_mix_pairs_plain(
            data, idx1, idx2, dst, src, length, sel, alpha, base_is_d1=base_is_d1
        )
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    B, C, T = data.shape
    out = torch.empty((n, C, T), dtype=data.dtype, device=data.device)
    if n == 0:
        return out
    lib = build_library()
    with torch.cuda.device(data.device):
        code = lib.pcgmix_piecewise_mix_pairs(
            data.data_ptr(), out.data_ptr(), idx1.data_ptr(), idx2.data_ptr(), dst.data_ptr(),
            src.data_ptr(), length.data_ptr(), sel.data_ptr(), alpha.data_ptr(),
            B, n, C, T, k, int(base_is_d1), _DTYPE_CODES[data.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "piecewise_mix_pairs")
    _launches["piecewise_mix_pairs"] += 1
    return out


# --------------------------------------------------------------------------- #
# K2: PCGmix+ (blend with data[mix] + magnitude warp)
# --------------------------------------------------------------------------- #


def warp_basis(sig_len: int, knot: int, device) -> torch.Tensor:
    """(T, knot+2) float32 spline basis on ``device``, built once per key."""
    key = (sig_len, knot, str(device))
    if key not in _basis_cache:
        _basis_cache[key] = torch.as_tensor(
            np.asarray(cubic_spline_basis(sig_len, knot), np.float32),
            device=device,
        )
    return _basis_cache[key]


def pcgmix_plus_fused_plain(data, mix, dst, src, length, sel, alpha, knots):
    """Plain version of K2: keep-duration blend of data and data[mix], times
    the spline envelope, all in float32, cast once."""
    B, C, T = data.shape
    blend = piecewise_mix_f32(
        data, data.index_select(0, mix.long()), dst, src, length, sel, alpha,
        base_is_d1=True,
    )
    basis = warp_basis(T, knots.shape[1] - 2, data.device)
    return (blend * spline_envelope(basis, knots)).to(data.dtype)


def pcgmix_plus_fused(data, mix, dst, src, length, sel, alpha, knots):
    """PCGmix+ in one pass: row i blends data[i] with data[mix[i]] over its
    pieces and multiplies by Σ_j basis[t, j]·knots[i, j, c].

    data (B, C, T) float32/bfloat16; mix (B,) int32; pieces (B, K) int32;
    alpha (B, K) float32; knots (B, knot+2, C) float32.
    """
    n, k = _check(data, (mix,), (dst, src, length, sel), alpha)
    B, C, T = data.shape
    if n != B:
        raise ValueError(f"mix must have one entry per row ({B}), got {n}")
    if (knots.dim() != 3 or knots.shape[0] != B or knots.shape[2] != C
            or knots.shape[1] < 2 or knots.dtype != torch.float32
            or knots.device != data.device or not knots.is_contiguous()):
        raise ValueError(
            f"knots must be contiguous float32 ({B}, knot+2, {C}) on data's "
            "device"
        )
    if knots.shape[1] * C > MAX_WARP_TERMS:
        raise ValueError(f"(knot+2)·C must be at most {MAX_WARP_TERMS}")
    if data.device.type == "cpu":
        return pcgmix_plus_fused_plain(data, mix, dst, src, length, sel, alpha, knots)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    out = torch.empty_like(data)
    if B == 0:
        return out
    lib = build_library()
    basis = warp_basis(T, knots.shape[1] - 2, data.device)
    with torch.cuda.device(data.device):
        code = lib.pcgmix_plus_fused(
            data.data_ptr(), out.data_ptr(), mix.data_ptr(), dst.data_ptr(), src.data_ptr(),
            length.data_ptr(), sel.data_ptr(), alpha.data_ptr(), knots.data_ptr(), basis.data_ptr(),
            B, C, T, k, knots.shape[1], _DTYPE_CODES[data.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "pcgmix_plus_fused")
    _launches["pcgmix_plus_fused"] += 1
    return out

"""The piecewise-mix kernels K1–K4: wrappers and plain versions.

K1 ``piecewise_mix_pairs`` replaces ``pcgmix_tpu/ops/pallas_mix.py::
piecewise_mix_pairs_pallas`` (PCGmix); K2 ``pcgmix_plus_fused`` replaces
``pcgmix_plus_fused_pallas`` (PCGmix+: the same blend fused with the
cubic-spline magnitude warp).  K3 ``piecewise_mix_prepaired`` and K4
``pcgmix_plus_fused_prepaired`` replace ``piecewise_mix_prepaired_pallas``
and ``pcgmix_plus_fused_prepaired_pallas``: K1 and K2 on rows whose
partners were gathered beforehand, the kernels of the data-parallel path.
The CUDA sources are ``csrc/mix_kernels.cu``.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version in this module; a CUDA tensor launches the kernel or raises.  Each
wrapper counts its kernel launches (:func:`launch_counts`), so a run can
show that its main path went through the kernels.

K1–K4 are one kernel body, in which each thread owns 16 bytes of
consecutive steps in every channel where the rows allow it and are long
enough to fill a block (:func:`_warp_vector_width`), else one step (the
kernel's scalar edge path); K2/K4 add the envelope.  :func:`piecewise_mix_batch` is K1 with
row i of the batch as each output row's base (the main path's PCGmix),
launched without a row index.  The kernels are compiled at first use,
with K5's, into one shared library (``ops/build.py``).

A launch covers at most :data:`MAX_LAUNCH_ROWS` output rows (the kernel
takes its row from ``blockIdx.y``).  A gang's batch of S·B rows
(``train/gang.py``) can pass that: K1, K3 and K4 then launch once per
chunk of rows (K1 without a row index through its explicit-row form), and
K2, whose partner indices address the whole batch, raises naming the limit.
"""

from __future__ import annotations

import numpy as np
import torch

from pcgmix_tpu_torch.ops.build import (  # noqa: F401  (re-exported)
    BUILD_DIR,
    MAX_PIECES,
    MAX_WARP_TERMS,
    WARP_BASIS_CHUNK,
    WARP_THREADS,
    build_library,
    is_plain,
    launch,
    launch_counts,
    reset_launch_counts,
    warm_up_counts,
)
from pcgmix_tpu_torch.ops.piecewise import piecewise_mix_f32
from pcgmix_tpu_torch.ops.spline import cubic_spline_basis, spline_envelope

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LAUNCH_ROWS = 65535  # gridDim.y: the output rows of one K1–K4 launch
_basis_cache: dict = {}


# --------------------------------------------------------------------------- #
# argument checks and launch
# --------------------------------------------------------------------------- #


def _check_rows(*rows):
    """Validate (B, C, T) row tensors: contiguous, of one dtype, shape and
    device."""
    first = rows[0]
    for r in rows:
        if r.dim() != 3:
            raise ValueError(f"rows must be (B, C, T), got {tuple(r.shape)}")
        if r.dtype not in _DTYPE_CODES:
            raise TypeError(f"rows must be float32 or bfloat16, got {r.dtype}")
        if not r.is_contiguous():
            raise ValueError("rows must be contiguous")
        if (r.dtype, r.shape, r.device) != (first.dtype, first.shape, first.device):
            raise ValueError("row tensors must share dtype, shape and device")


def _check(data, rows, pieces, alpha):
    """Validate (data, row-index vectors, int piece arrays, alpha); returns
    (N, K).  With no index vectors, N is data's batch."""
    _check_rows(data)
    n = rows[0].shape[0] if rows else data.shape[0]
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


def _check_knots(knots, n, C, device):
    if (knots.dim() != 3 or knots.shape[0] != n or knots.shape[2] != C
            or knots.shape[1] < 2 or knots.dtype != torch.float32
            or knots.device != device or not knots.is_contiguous()):
        raise ValueError(
            f"knots must be contiguous float32 ({n}, knot+2, {C}) on data's "
            "device"
        )
    if knots.shape[1] * C > MAX_WARP_TERMS:
        raise ValueError(f"(knot+2)·C must be at most {MAX_WARP_TERMS}")


def _warp_vector_width(T: int, dtype: torch.dtype, *tensors) -> int:
    """Time steps per thread of K1–K4: 16 bytes of ``dtype`` where T is a
    multiple of that, a block's tile of WARP_THREADS·V steps fits in a row,
    and every tensor's data starts on a 16-byte boundary (so does every
    row); else 1, the kernel's scalar edge path.

    A block takes one tile of one row and walks all its channels, so on a
    short row a wide tile leaves most of the block idle and the grid on a
    few SMs: ResNet9's depth-2 latent (64 × 512 × 312) in bf16 takes one
    1024-step tile a row at V = 8 (39 of 128 threads busy, 64 blocks), and
    three 128-step tiles at V = 1."""
    v = 16 // (torch.finfo(dtype).bits // 8)
    if (T % v == 0 and T >= WARP_THREADS * v
            and all(t.data_ptr() % 16 == 0 for t in tensors)):
        return v
    return 1


def _chunks(n: int):
    """(start, stop) of each launch's rows: one launch up to
    :data:`MAX_LAUNCH_ROWS` rows, else chunks of at most that many."""
    return [(a, min(a + MAX_LAUNCH_ROWS, n)) for a in range(0, n, MAX_LAUNCH_ROWS)]


def _launch(name: str, out: torch.Tensor, *args) -> torch.Tensor:
    """Launch wrapper ``name``'s kernel (:func:`build.launch`) unless the
    batch is empty; returns ``out``."""
    if out.shape[0] > 0:
        launch(name, out.device, *args)
    return out


# --------------------------------------------------------------------------- #
# K1: piecewise mix over row pairs; K3: over pre-gathered rows
# --------------------------------------------------------------------------- #


def piecewise_mix_prepaired_plain(d1_rows, d2_rows, dst, src, length, sel, alpha,
                                  *, base_is_d1: bool = True):
    """Plain version of K3: the mask arithmetic in float32, cast once."""
    return piecewise_mix_f32(
        d1_rows, d2_rows, dst, src, length, sel, alpha, base_is_d1=base_is_d1
    ).to(d1_rows.dtype)


def piecewise_mix_pairs_plain(data, idx1, idx2, dst, src, length, sel, alpha,
                              *, base_is_d1: bool = True):
    """Plain version of K1: gather both rows, then the mask arithmetic."""
    return piecewise_mix_prepaired_plain(
        data.index_select(0, idx1.long()), data.index_select(0, idx2.long()),
        dst, src, length, sel, alpha, base_is_d1=base_is_d1,
    )


def piecewise_mix_batch_plain(data, mix, dst, src, length, sel, alpha,
                              *, base_is_d1: bool = True):
    """Plain version of :func:`piecewise_mix_batch`: K1's with idx1 = arange."""
    idn = torch.arange(data.shape[0], dtype=torch.int32, device=data.device)
    return piecewise_mix_pairs_plain(data, idn, mix, dst, src, length, sel, alpha,
                                     base_is_d1=base_is_d1)


def _mix_pairs(data, idx1, idx2, n, k, pieces, alpha, base_is_d1):
    """Launch K1 (``idx1`` None: row i is output row i's base row)."""
    B, C, T = data.shape
    out = torch.empty((n, C, T), dtype=data.dtype, device=data.device)
    if n > MAX_LAUNCH_ROWS and idx1 is None:  # chunks name their base rows
        idx1 = torch.arange(n, dtype=torch.int32, device=data.device)
    for a, b in _chunks(n):
        o = out[a:b]
        _launch(
            "piecewise_mix_pairs", o, data, o, None if idx1 is None else idx1[a:b],
            idx2[a:b], *(p[a:b] for p in pieces), alpha[a:b], B, b - a, C, T, k,
            int(base_is_d1), _warp_vector_width(T, data.dtype, data, o),
            _DTYPE_CODES[data.dtype],
        )
    return out


def piecewise_mix_pairs(data, idx1, idx2, dst, src, length, sel, alpha,
                        *, base_is_d1: bool = True):
    """Output row i mixes data[idx1[i]] with data[idx2[i]] over K pieces.

    data (B, C, T) float32/bfloat16 contiguous; idx1, idx2 (N,) int32;
    dst, src, length, sel (N, K) int32; alpha (N, K) float32.
    Returns (N, C, T) in data's dtype, blended in float32.
    """
    n, k = _check(data, (idx1, idx2), (dst, src, length, sel), alpha)
    if is_plain(data):
        return piecewise_mix_pairs_plain(
            data, idx1, idx2, dst, src, length, sel, alpha, base_is_d1=base_is_d1
        )
    return _mix_pairs(data, idx1, idx2, n, k, (dst, src, length, sel), alpha,
                      base_is_d1)


def piecewise_mix_batch(data, mix, dst, src, length, sel, alpha,
                        *, base_is_d1: bool = True):
    """Output row i mixes data[i] with data[mix[i]] over K pieces: K1 with
    idx1 = arange (``pcgmix_tpu/ops/pallas_mix.py::
    piecewise_mix_batch_pallas``), launched without a row index.

    data (B, C, T) float32/bfloat16 contiguous; mix (B,) int32;
    dst, src, length, sel (B, K) int32; alpha (B, K) float32.
    Launches count under ``"piecewise_mix_pairs"``.
    """
    n, k = _check(data, (mix,), (dst, src, length, sel), alpha)
    if n != data.shape[0]:
        raise ValueError(f"mix must have one entry per row ({data.shape[0]}), got {n}")
    if is_plain(data):
        return piecewise_mix_batch_plain(
            data, mix, dst, src, length, sel, alpha, base_is_d1=base_is_d1
        )
    return _mix_pairs(data, None, mix, n, k, (dst, src, length, sel), alpha,
                      base_is_d1)


def piecewise_mix_prepaired(d1_rows, d2_rows, dst, src, length, sel, alpha,
                            *, base_is_d1: bool = True):
    """Output row i mixes d1_rows[i] with d2_rows[i] over K pieces: K1 on
    partner rows gathered beforehand (the data-parallel path's PCGmix).

    d1_rows, d2_rows (N, C, T) float32/bfloat16 contiguous, of one dtype;
    dst, src, length, sel (N, K) int32; alpha (N, K) float32.
    Returns (N, C, T) in the rows' dtype, blended in float32.
    """
    _check_rows(d1_rows, d2_rows)
    n, k = _check(d1_rows, (), (dst, src, length, sel), alpha)
    if is_plain(d1_rows):
        return piecewise_mix_prepaired_plain(
            d1_rows, d2_rows, dst, src, length, sel, alpha, base_is_d1=base_is_d1
        )
    _, C, T = d1_rows.shape
    out = torch.empty_like(d1_rows)
    for a, b in _chunks(n):
        d1, d2, o = d1_rows[a:b], d2_rows[a:b], out[a:b]
        _launch(
            "piecewise_mix_prepaired", o, d1, d2, o, dst[a:b], src[a:b], length[a:b],
            sel[a:b], alpha[a:b], b - a, C, T, k, int(base_is_d1),
            _warp_vector_width(T, d1_rows.dtype, d1, d2, o), _DTYPE_CODES[d1_rows.dtype],
        )
    return out


# --------------------------------------------------------------------------- #
# K2: PCGmix+ (blend with data[mix] + magnitude warp); K4: pre-gathered rows
# --------------------------------------------------------------------------- #


def warp_basis(sig_len: int, knot: int, device, *, columns: int = 1) -> torch.Tensor:
    """(T, knot+2) float32 spline basis on ``device``, built once per key;
    with ``columns``, zero columns pad its width to a multiple of it."""
    key = (sig_len, knot, str(device), columns)
    if key not in _basis_cache:
        basis = np.asarray(cubic_spline_basis(sig_len, knot), np.float32)
        basis = np.pad(basis, ((0, 0), (0, -basis.shape[1] % columns)))
        _basis_cache[key] = torch.as_tensor(basis, device=device)
    return _basis_cache[key]


def pcgmix_plus_fused_prepaired_plain(d1_rows, d2_rows, dst, src, length, sel,
                                      alpha, knots):
    """Plain version of K4: keep-duration blend of d1_rows and d2_rows, times
    the spline envelope, all in float32, cast once."""
    blend = piecewise_mix_f32(
        d1_rows, d2_rows, dst, src, length, sel, alpha, base_is_d1=True
    )
    basis = warp_basis(d1_rows.shape[-1], knots.shape[1] - 2, d1_rows.device)
    return (blend * spline_envelope(basis, knots)).to(d1_rows.dtype)


def pcgmix_plus_fused_plain(data, mix, dst, src, length, sel, alpha, knots):
    """Plain version of K2: K4's on data and data[mix]."""
    return pcgmix_plus_fused_prepaired_plain(
        data, data.index_select(0, mix.long()), dst, src, length, sel, alpha, knots
    )


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
    _check_knots(knots, B, C, data.device)
    if is_plain(data):
        return pcgmix_plus_fused_plain(data, mix, dst, src, length, sel, alpha, knots)
    if B > MAX_LAUNCH_ROWS:
        raise ValueError(
            f"pcgmix_plus_fused takes at most {MAX_LAUNCH_ROWS} rows per launch (the "
            f"kernel's row is blockIdx.y, and its partners address the whole batch); "
            f"got {B}: train a smaller gang")
    basis = warp_basis(T, knots.shape[1] - 2, data.device,
                       columns=WARP_BASIS_CHUNK)
    out = torch.empty_like(data)
    return _launch(
        "pcgmix_plus_fused", out, data, out, mix, dst, src, length, sel, alpha,
        knots, basis, B, C, T, k, knots.shape[1],
        _warp_vector_width(T, data.dtype, data, out), _DTYPE_CODES[data.dtype],
    )


def pcgmix_plus_fused_prepaired(d1_rows, d2_rows, dst, src, length, sel, alpha,
                                knots):
    """PCGmix+ on pre-gathered partners: row i blends d1_rows[i] with
    d2_rows[i] over its pieces and multiplies by Σ_j basis[t, j]·knots[i, j, c]
    (the data-parallel path's PCGmix+).

    d1_rows, d2_rows (N, C, T) float32/bfloat16; pieces (N, K) int32;
    alpha (N, K) float32; knots (N, knot+2, C) float32.
    """
    _check_rows(d1_rows, d2_rows)
    n, k = _check(d1_rows, (), (dst, src, length, sel), alpha)
    _, C, T = d1_rows.shape
    _check_knots(knots, n, C, d1_rows.device)
    if is_plain(d1_rows):
        return pcgmix_plus_fused_prepaired_plain(
            d1_rows, d2_rows, dst, src, length, sel, alpha, knots
        )
    basis = warp_basis(T, knots.shape[1] - 2, d1_rows.device,
                       columns=WARP_BASIS_CHUNK)
    out = torch.empty_like(d1_rows)
    for a, b in _chunks(n):
        d1, d2, o = d1_rows[a:b], d2_rows[a:b], out[a:b]
        _launch(
            "pcgmix_plus_fused_prepaired", o, d1, d2, o, dst[a:b], src[a:b],
            length[a:b], sel[a:b], alpha[a:b], knots[a:b], basis, b - a, C, T, k,
            knots.shape[1], _warp_vector_width(T, d1_rows.dtype, d1, d2, o),
            _DTYPE_CODES[d1_rows.dtype],
        )
    return out

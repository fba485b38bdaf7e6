"""K5: the k=3 'same' convolution fused with BatchNorm's statistics.

``conv3_bn_stats`` replaces the TPU kernel of
``scripts/bench_conv_bn_fused.py::make_arms`` (``pallas_call`` and
``pallas_call_flat``, one function in two TPU block shapes): y = conv(x, w)
in bf16 and, with stats, the per-channel Σacc and Σacc² of the fp32
accumulator.  It keeps the JAX layout: x (B, T, Cin) NWC, w (3, Cin, Cout)
WIO.  The CUDA source is ``csrc/conv_bn_stats.cu`` (wgmma fed by TMA
through a ring of stages); it builds into the one library of
``ops/build.py`` with K1–K4.  TMA reads rows of 16-byte multiples from
16-byte-aligned bases, so where Cin or Cout is not a multiple of 8, or a
pointer is not aligned, the wrapper launches on zero-padded copies
(:func:`pad_channels`) and slices the result back; other shapes take no
copy.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version in this module; a CUDA tensor launches the kernel or raises.  K5
has no backward in the JAX package, so it has none here.
"""

from __future__ import annotations

import torch

from pcgmix_tpu_torch.ops.build import (
    CONV3_CHUNK_ROWS,
    CONV3_CHUNKS_PER_TILE,
    is_plain,
    launch,
)

CHANNEL_ALIGN = 8  # bf16 channels in TMA's 16 bytes


def conv3_acc_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fp32 accumulator of K5: three shifted matmuls widened to fp32,
    with a zero row where t±1 leaves the sample, summed in the Pallas
    kernel's order (centre tap, then t−1, then t+1).  (B, T, Cout)."""
    xf, wf = x.float(), w.float()
    zero = xf.new_zeros(xf.shape[0], 1, xf.shape[2])
    prev = torch.cat([zero, xf[:, :-1]], dim=1)
    nxt = torch.cat([xf[:, 1:], zero], dim=1)
    acc = torch.matmul(xf, wf[1])
    acc = acc + torch.matmul(prev, wf[0])
    return acc + torch.matmul(nxt, wf[2])


def conv3_bn_stats_plain(x: torch.Tensor, w: torch.Tensor, with_stats: bool = True):
    """Plain version of K5: (y bf16, s1, s2), s1/s2 None without stats."""
    acc = conv3_acc_plain(x, w)
    y = acc.to(torch.bfloat16)
    if not with_stats:
        return y, None, None
    return y, acc.sum(dim=(0, 1)), (acc * acc).sum(dim=(0, 1))


def conv3_partial_rows(B: int, T: int) -> int:
    """Rows of the kernel's fp32 partial-sum scratch: one per block, and a
    block holds CONV3_CHUNKS_PER_TILE chunks of CONV3_CHUNK_ROWS rows of y
    that never cross a sample."""
    chunks = B * -(-T // CONV3_CHUNK_ROWS)
    return -(-chunks // CONV3_CHUNKS_PER_TILE)


def pad_channels(x: torch.Tensor, w: torch.Tensor):
    """x (B, T, Cin) and w (3, Cin, Cout) with Cin and Cout rounded up to a
    multiple of CHANNEL_ALIGN by zero channels, in new (aligned) tensors.
    A zero channel adds exact zeros to acc, and a zero column of w gives a
    column of y that is sliced off."""
    B, T, Cin = x.shape
    Cout = w.shape[2]
    cin, cout = (-(-n // CHANNEL_ALIGN) * CHANNEL_ALIGN for n in (Cin, Cout))
    xp = x.new_zeros((B, T, cin))
    xp[..., :Cin] = x
    wp = w.new_zeros((3, cin, cout))
    wp[:, :Cin, :Cout] = w
    return xp, wp


def _tma_ready(t: torch.Tensor) -> bool:
    return t.shape[-1] % CHANNEL_ALIGN == 0 and t.data_ptr() % 16 == 0


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be (B, T, Cin) and w (3, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bfloat16, got {x.dtype} and {w.dtype}")
    if w.shape[0] != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"w must be (3, {x.shape[2]}, Cout), got {tuple(w.shape)}")
    if min(*x.shape, w.shape[2]) < 1:
        raise ValueError("every dimension must be at least 1")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def conv3_bn_stats(x: torch.Tensor, w: torch.Tensor, with_stats: bool = True):
    """y[b,t] = x[b,t−1]·w[0] + x[b,t]·w[1] + x[b,t+1]·w[2] with per-sample
    zero padding, accumulated in fp32 and rounded to bf16 once; with stats
    also s1 = Σ_{b,t} acc and s2 = Σ_{b,t} acc², fp32 (Cout,), from the
    accumulator.

    x (B, T, Cin) and w (3, Cin, Cout), bfloat16, contiguous, on one
    device.  Returns (y (B, T, Cout) bf16, s1, s2); s1 and s2 are None
    without stats."""
    _check(x, w)
    if is_plain(x):
        return conv3_bn_stats_plain(x, w, with_stats)
    Cout = w.shape[2]
    if not (_tma_ready(x) and _tma_ready(w)):
        x, w = pad_channels(x, w)
    B, T, cin = x.shape
    cout = w.shape[2]
    y = torch.empty((B, T, cout), dtype=torch.bfloat16, device=x.device)
    partial = s1 = s2 = None
    if with_stats:
        partial = torch.empty((conv3_partial_rows(B, T), 2, cout), dtype=torch.float32,
                              device=x.device)
        s1 = torch.empty(cout, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    launch("conv3_bn_stats", x.device, x, w, y, partial, s1, s2, B, T, cin, cout,
           int(with_stats))
    if cout != Cout:
        y = y[..., :Cout].contiguous()
        if with_stats:
            s1, s2 = s1[:Cout], s2[:Cout]
    return y, s1, s2

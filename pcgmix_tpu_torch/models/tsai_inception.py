"""InceptionTime and XceptionTime from the reference's tsai zoo
(counterpart: ``pcgmix_tpu/models/tsai_inception.py``; reference
train_model.py:314-321).  The JAX package reimplements tsai 0.3.x's
architectures (tsai is not a dependency); this is that reimplementation in
torch, and the "Plus" names map to the same classes, as there.

- InceptionTime: six inception modules (a 1×1 bottleneck where the input
  has more than one channel, parallel convs k = 39, 19, 9 over it, a
  max-pool(3, stride 1) → 1×1 branch over the input; concat → BatchNorm →
  ReLU), a residual every three (BatchNorm shortcut where the width holds,
  else a 1×1 ConvBlock), global average pool, linear head ``fc``.
- XceptionTime: four xception modules (bottleneck → parallel depthwise
  separable convs k = 39, 19, 9 ∥ max-pool → 1×1, concat, no BatchNorm)
  of widths 4·16·2^d, a 1×1 ConvBlock residual every two, then an
  adaptive average pool to 50 steps and three 1×1 ConvBlocks (512 → 256 →
  128 → classes) and a global average pool.

No split forward; ``part="latent_space"`` gives the features before the
head.

``compute_dtype=torch.bfloat16`` (JAX ``dtype``): every convolution and
BatchNorm of both trunks and XceptionTime's head computes in bf16;
InceptionTime's ``fc`` is built without a dtype (float32 logits), and
XceptionTime's pooled head output is cast to float32, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.models.layers import (
    BatchNorm1d,
    Conv1d,
    ConvBNAct,
    Linear,
    check_part,
    gap_1d,
)


def _odd_ks(ks: int) -> tuple[int, int, int]:
    """tsai's kernel ladder: ks//1, ks//2, ks//4, each made odd."""
    out = []
    for i in range(3):
        k = ks // (2**i)
        out.append(k - 1 if k % 2 == 0 else k)
    return tuple(out)


def max_pool_same_1d(x: torch.Tensor) -> torch.Tensor:
    """MaxPool1d(3, stride=1, padding=1) on (B, C, T)."""
    return F.max_pool1d(x, 3, 1, padding=1)


class SeparableConv1d(nn.Module):
    """Depthwise (groups = channels) then pointwise 1×1, both bias-free."""

    def __init__(self, ni: int, nf: int, kernel_size: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.depthwise = Conv1d(ni, ni, kernel_size, bias=False, groups=ni, compute_dtype=dt)
        self.pointwise = Conv1d(ni, nf, 1, bias=False, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class InceptionModule(nn.Module):
    """Bottleneck → convs k = 39, 19, 9 ∥ max-pool → 1×1, concat →
    BatchNorm → ReLU; 4·nf channels out."""

    def __init__(self, ni: int, nf: int, ks: int = 40, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        if ni > 1:
            self.bottleneck = Conv1d(ni, nf, 1, bias=False, compute_dtype=dt)
        nb = nf if ni > 1 else ni
        for i, k in enumerate(_odd_ks(ks)):
            self.add_module(f"conv{i}", Conv1d(nb, nf, k, bias=False, compute_dtype=dt))
        self.mp_conv = Conv1d(ni, nf, 1, bias=False, compute_dtype=dt)
        self.bn = BatchNorm1d(4 * nf, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bottleneck(x) if hasattr(self, "bottleneck") else x
        out = torch.cat([self.conv0(h), self.conv1(h), self.conv2(h),
                         self.mp_conv(max_pool_same_1d(x))], dim=1)
        return torch.relu(self.bn(out))


class InceptionTime(nn.Module):
    """tsai InceptionTime(c_in, c_out): six modules, a residual every three.
    Input (B, C, T); returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, nf: int = 32, depth: int = 6,
                 num_channels: int = 4, compute_dtype=None):
        super().__init__()
        self.depth = depth
        dt = compute_dtype
        width = num_channels
        for d in range(depth):
            self.add_module(f"inception{d}", InceptionModule(width, nf, compute_dtype=dt))
            if d % 3 == 2:
                res = num_channels if d == 2 else 4 * nf
                self.add_module(
                    f"shortcut{d // 3}",
                    BatchNorm1d(4 * nf, compute_dtype=dt) if res == 4 * nf
                    else ConvBNAct(res, 4 * nf, 1, act=None, compute_dtype=dt))
            width = 4 * nf
        self.fc = Linear(4 * nf, num_classes)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "InceptionTime")
        h = res = x
        for d in range(self.depth):
            h = getattr(self, f"inception{d}")(h)
            if d % 3 == 2:
                h = res = torch.relu(h + getattr(self, f"shortcut{d // 3}")(res))
        h = gap_1d(h)
        return h if part == "latent_space" else self.fc(h)


class XceptionModule(nn.Module):
    """Bottleneck → separable convs k = 39, 19, 9 ∥ max-pool → 1×1, concat
    (no BatchNorm or activation inside); 4·nf channels out."""

    def __init__(self, ni: int, nf: int, ks: int = 40, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.bottleneck = Conv1d(ni, nf, 1, bias=False, compute_dtype=dt)
        for i, k in enumerate(_odd_ks(ks)):
            self.add_module(f"sepconv{i}", SeparableConv1d(nf, nf, k, compute_dtype=dt))
        self.mp_conv = Conv1d(ni, nf, 1, bias=False, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bottleneck(x)
        return torch.cat([self.sepconv0(h), self.sepconv1(h), self.sepconv2(h),
                          self.mp_conv(max_pool_same_1d(x))], dim=1)


class XceptionTime(nn.Module):
    """tsai XceptionTime(c_in, c_out, nf=16).  Input (B, C, T); returns (B,
    num_classes) logits."""

    def __init__(self, num_classes: int = 2, nf: int = 16, depth: int = 4,
                 num_channels: int = 4, compute_dtype=None):
        super().__init__()
        self.depth = depth
        dt = compute_dtype
        width = res = num_channels
        for d in range(depth):
            self.add_module(f"xception{d}", XceptionModule(width, nf * 2**d, compute_dtype=dt))
            width = 4 * nf * 2**d
            if d % 2 == 1:
                self.add_module(f"shortcut{d // 2}",
                                ConvBNAct(res, width, 1, act=None, compute_dtype=dt))
                res = width
        head_nf = nf * 4 * 2 ** (depth - 1)  # 512 at nf=16
        self.head1 = ConvBNAct(width, head_nf // 2, 1, compute_dtype=dt)
        self.head2 = ConvBNAct(head_nf // 2, head_nf // 4, 1, compute_dtype=dt)
        self.head3 = ConvBNAct(head_nf // 4, num_classes, 1, compute_dtype=dt)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "XceptionTime")
        h = res = x
        for d in range(self.depth):
            h = getattr(self, f"xception{d}")(h)
            if d % 2 == 1:
                h = res = torch.relu(h + getattr(self, f"shortcut{d // 2}")(res))
        h = self.head2(self.head1(F.adaptive_avg_pool1d(h, 50)))
        if part == "latent_space":
            return gap_1d(h)
        # float32 logits, as every Dense-headed model's
        return gap_1d(self.head3(h)).float()

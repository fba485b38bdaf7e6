"""XResNet1d18 from the reference's tsai zoo (counterpart:
``pcgmix_tpu/models/tsai_xresnet.py``; reference train_model.py:308-311,
XResNet1d18 and XResNet1d18Plus, one class here as there).

The "bag of tricks" xresnet18: a stem of three 3-tap conv-BN-ReLU blocks
(c_in → 32 at stride 2, 32 → 32, 32 → 64) and MaxPool(3, stride 2, pad 1);
four stages of two BasicBlocks, widths 64/128/256/512, stride 2 at each
stage's entry but the first; a BasicBlock is conv-BN-ReLU(3, stride) →
conv-BN(3), added to its shortcut (ResNet-D: AvgPool(2, ceil) where it
strides, a 1×1 ConvBlock where the width changes), then ReLU; global
average pool, linear head ``fc``.  No split forward.

``compute_dtype=torch.bfloat16`` (JAX ``XResNet1d18.dtype``): every
convolution and BatchNorm computes in bf16; ``fc`` is built without a
dtype, so the logits are float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def _avg_pool_ceil(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """AvgPool1d(window, ceil_mode=True) on (B, C, T): the ragged last bin
    averages only the steps it holds."""
    return F.avg_pool1d(x, window, ceil_mode=True)


class BasicBlock(nn.Module):
    def __init__(self, ni: int, nf: int, stride: int, compute_dtype=None):
        super().__init__()
        self.stride = stride
        dt = compute_dtype
        self.convpath1_conv = Conv1d(ni, nf, 3, padding=1, stride=stride, bias=False,
                                     compute_dtype=dt)
        self.convpath1_bn = BatchNorm1d(nf, compute_dtype=dt)
        self.convpath2 = ConvBNAct(nf, nf, 3, act=None, compute_dtype=dt)
        if ni != nf:
            self.idpath = ConvBNAct(ni, nf, 1, act=None, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convpath2(torch.relu(self.convpath1_bn(self.convpath1_conv(x))))
        sc = _avg_pool_ceil(x, self.stride) if self.stride > 1 else x
        if hasattr(self, "idpath"):
            sc = self.idpath(sc)
        return torch.relu(h + sc)


class XResNet1d18(nn.Module):
    """Input (B, C, T); returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, widths: Sequence[int] = (64, 128, 256, 512),
                 blocks_per_stage: int = 2, num_channels: int = 4, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.stem0_conv = Conv1d(num_channels, 32, 3, padding=1, stride=2, bias=False,
                                 compute_dtype=dt)
        self.stem0_bn = BatchNorm1d(32, compute_dtype=dt)
        self.stem1 = ConvBNAct(32, 32, 3, compute_dtype=dt)
        self.stem2 = ConvBNAct(32, 64, 3, compute_dtype=dt)
        self.blocks = []
        ni = 64
        for s, nf in enumerate(widths):
            for b in range(blocks_per_stage):
                name = f"stage{s}_block{b}"
                self.add_module(name, BasicBlock(ni, nf, 2 if (s > 0 and b == 0) else 1,
                                                 compute_dtype=dt))
                self.blocks.append(name)
                ni = nf
        self.fc = Linear(ni, num_classes)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "XResNet1d18")
        h = torch.relu(self.stem0_bn(self.stem0_conv(x)))
        h = F.max_pool1d(self.stem2(self.stem1(h)), 3, 2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = gap_1d(h)
        return h if part == "latent_space" else self.fc(h)

"""ResNet time-series classifier (counterpart:
``pcgmix_tpu/models/resnet_ts.py``; reference models.py:812-863, tsai's
ResNet, and ResNetPlus at its defaults).

Three residual blocks (ConvBlocks k = 7, 5, 3, the last without
activation; the shortcut a BatchNorm where the width holds, else a 1×1
ConvBlock without activation; then ReLU) of widths ``nf``, 2·nf, 2·nf,
global average pool, linear head ``fc``.  No split forward, as in the
reference (``resnet_ts.py:5``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcgmix_tpu_torch.models.layers import BatchNorm1d, ConvBNAct, check_part, gap_1d


class ResBlock(nn.Module):
    def __init__(self, ni: int, nf: int):
        super().__init__()
        self.convblock1 = ConvBNAct(ni, nf, 7)
        self.convblock2 = ConvBNAct(nf, nf, 5)
        self.convblock3 = ConvBNAct(nf, nf, 3, act=None)
        if ni == nf:
            self.shortcut_bn = BatchNorm1d(nf)
        else:
            self.shortcut = ConvBNAct(ni, nf, 1, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convblock3(self.convblock2(self.convblock1(x)))
        sc = self.shortcut_bn(x) if hasattr(self, "shortcut_bn") else self.shortcut(x)
        return torch.relu(h + sc)


class ResNetTS(nn.Module):
    """Input (B, C, T); returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, nf: int = 64, num_channels: int = 4):
        super().__init__()
        self.resblock1 = ResBlock(num_channels, nf)
        self.resblock2 = ResBlock(nf, nf * 2)
        self.resblock3 = ResBlock(nf * 2, nf * 2)
        self.fc = nn.Linear(nf * 2, num_classes)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "ResNet")
        h = gap_1d(self.resblock3(self.resblock2(self.resblock1(x))))
        return h if part == "latent_space" else self.fc(h)

"""ResCNN time-series classifier (counterpart:
``pcgmix_tpu/models/rescnn.py``; reference models.py:720-810, tsai's ResCNN).

A residual block (ConvBlocks k = 7, 5, 3 over ``nf`` channels, the last
without activation, plus a 1×1 conv and BatchNorm shortcut, then ReLU),
then ConvBlocks with LeakyReLU(0.2), a PReLU (one slope, 0.25 at init) and
ELU(0.3), global average pool, linear head ``lin``.  The split forward
(``rescnn.py:62-95``): depths 1–4 are the (B, C, T) activations after each
of the four blocks, depth 5 the pooled (B, 128) features, the embedding
the JAX package's latent-space subsystem takes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pcgmix_tpu_torch.models.layers import BatchNorm1d, Conv1d, ConvBNAct, check_part


class ResCNNBlock(nn.Module):
    def __init__(self, ni: int, nf: int):
        super().__init__()
        self.convblock1 = ConvBNAct(ni, nf, 7)
        self.convblock2 = ConvBNAct(nf, nf, 5)
        self.convblock3 = ConvBNAct(nf, nf, 3, act=None)
        self.shortcut_conv = Conv1d(ni, nf, 1)
        self.shortcut_bn = BatchNorm1d(nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convblock3(self.convblock2(self.convblock1(x)))
        return torch.relu(h + self.shortcut_bn(self.shortcut_conv(x)))


class ResCNN(nn.Module):
    """Input (B, C, T); returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, nf: int = 64, num_channels: int = 4):
        super().__init__()
        self.block1 = ResCNNBlock(num_channels, nf)
        self.block2 = ConvBNAct(nf, nf * 2, 3, act=nn.LeakyReLU(0.2))
        self.block3 = ConvBNAct(nf * 2, nf * 4, 3, act=None)
        self.block3_prelu = nn.PReLU(1, init=0.25)
        self.block4 = ConvBNAct(nf * 4, nf * 2, 3, act=nn.ELU(0.3))
        self.lin = nn.Linear(nf * 2, num_classes)

    def _run(self, h: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        """The blocks of index [start, stop)."""
        blocks = (self.block1, self.block2,
                  lambda z: self.block3_prelu(self.block3(z)), self.block4)
        for i in range(max(start, 0), stop):
            h = blocks[i](h)
        return h

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "ResCNN", split=True)
        if part == "first":
            if depth == 0:
                return x
            h = self._run(x, 0, min(depth, 4))
            if depth <= 4:
                return h
            h = h.mean(dim=-1)
            return h if depth == 5 else self.lin(h)
        if part == "second":
            h = self._run(x, depth, 4)
            if depth <= 4:
                h = h.mean(dim=-1)
            return self.lin(h)
        h = self._run(x, 0, 4).mean(dim=-1)
        return h if part == "latent_space" else self.lin(h)

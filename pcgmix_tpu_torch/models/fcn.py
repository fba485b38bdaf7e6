"""FCN time-series classifier (counterpart: ``pcgmix_tpu/models/fcn.py``;
reference models.py:591-718, tsai's FCN).

Three ConvBlocks (kernels 7, 5, 3; widths 128/256/128, or 64/128/64 for
``FCN(custom)``), global average pool, linear head ``fc``.  The split
forward (``pcgmix_tpu/models/fcn.py:30-56``): depths 1–3 are the (B, C, T)
activations after each block, depth 4 the pooled (B, C) features.  tsai's
FCNPlus is this model at its defaults.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pcgmix_tpu_torch.models.layers import ConvBNAct, check_part, gap_1d


class FCN(nn.Module):
    """Input (B, C, T); returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, layers: Sequence[int] = (128, 256, 128),
                 kss: Sequence[int] = (7, 5, 3), num_channels: int = 4):
        super().__init__()
        widths = (num_channels, *layers)
        for i in range(3):
            self.add_module(f"convblock{i + 1}",
                            ConvBNAct(widths[i], widths[i + 1], kss[i]))
        self.fc = nn.Linear(layers[-1], num_classes)

    def _block(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"convblock{i + 1}")(h)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "FCN", split=True)
        if part == "first":
            if depth == 0:
                return x
            h = x
            for i in range(3):
                h = self._block(i, h)
                if depth == i + 1:
                    return h
            h = gap_1d(h)
            return h if depth == 4 else self.fc(h)
        if part == "second":
            h = x
            for i in range(max(depth, 0), 3):
                h = self._block(i, h)
            if depth <= 3:
                h = gap_1d(h)
            return self.fc(h)
        h = x
        for i in range(3):
            h = self._block(i, h)
        h = gap_1d(h)
        return h if part == "latent_space" else self.fc(h)

"""Singstad's InceptionTime variants d3, d6 and d10 (counterpart:
``pcgmix_tpu/models/singstad.py``; reference models.py:18-336).

The inception module (models.py:18-59): a 1×1 bottleneck (where the input
has more than one channel), three parallel convs k = 40, 20, 10 over it
(even kernels: XLA's "SAME" split, (19, 20), (9, 10), (4, 5)), a
max-pool(3, stride 1) → 1×1 conv branch over the input, concatenated to
4 × 32 channels, BatchNorm, ReLU.

The weights are shared, as in the reference (models.py:84-184): the model
owns ONE module at the input's width, ``deep1``, and ONE at 128 channels,
``deep2``, which it applies again and again (nine times in d10), and the
shortcut ``shortcut2`` twice.  So the same submodule instances are called:
their gradients add up over the applications, and their BatchNorm running
statistics update once per application, as flax's do.

    block1(x) = relu(deep2(deep2(deep1(x))) + shortcut1(x))
    block2(x) = relu(deep2(deep2(deep2(x))) + shortcut2(x))
    d3:  head(mean(block1(x)))
    d6:  head(mean(block2(block1(x))))
    d10: head(mean(deep2(block2(block2(block1(x))))))

Only d10 has the split forward (``singstad.py:97-125``): depths 1–3 are the
(B, 128, T) activations after block1, block2 and block2 again.  d3 and d6
take no ``part`` (the reference comments their pass_part branches out):
as in the JAX package, their output is the logits whatever ``part`` asks,
and "first"/"second" are refused.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.models.layers import BatchNorm1d, Conv1d, check_part


class InceptionModule(nn.Module):
    def __init__(self, ni: int, bottleneck_size: int = 32, nb_filters: int = 32,
                 kernel_size: int = 40):
        super().__init__()
        if ni > 1:
            self.conv1 = Conv1d(ni, bottleneck_size, 1, bias=False)
        nb = bottleneck_size if ni > 1 else ni
        for i in range(3):
            self.add_module(f"conv_s{i + 1}",
                            Conv1d(nb, nb_filters, kernel_size // 2 ** i, bias=False))
        self.conv6 = Conv1d(ni, nb_filters, 1, bias=False)
        self.batchnorm = BatchNorm1d(4 * nb_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = self.conv1(x) if hasattr(self, "conv1") else x
        h = torch.cat([self.conv_s1(xc), self.conv_s2(xc), self.conv_s3(xc),
                       self.conv6(F.max_pool1d(x, 3, 1, padding=1))], dim=1)
        return torch.relu(self.batchnorm(h))


class Shortcut(nn.Module):
    def __init__(self, ni: int, nf: int):
        super().__init__()
        self.conv = Conv1d(ni, nf, 1, bias=False)
        self.bn = BatchNorm1d(nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class SingstadInceptionTime(nn.Module):
    """``depth_variant`` 3, 6 or 10; input (B, C, T); returns (B,
    num_classes) logits."""

    def __init__(self, num_classes: int = 2, depth_variant: int = 10,
                 nb_filters: int = 32, num_channels: int = 4):
        super().__init__()
        if depth_variant not in (3, 6, 10):
            raise ValueError(f"Singstad depth variant must be 3, 6 or 10, got {depth_variant}")
        self.depth_variant = depth_variant
        width = 4 * nb_filters
        self.deep1 = InceptionModule(num_channels, nb_filters=nb_filters)
        self.deep2 = InceptionModule(width, nb_filters=nb_filters)
        self.shortcut1 = Shortcut(num_channels, width)
        if depth_variant > 3:  # d3 never applies it, so it has no weights
            self.shortcut2 = Shortcut(width, width)
        self.linear = nn.Linear(width, num_classes)

    def block1(self, x: torch.Tensor) -> torch.Tensor:
        z = self.deep2(self.deep2(self.deep1(x)))
        return torch.relu(z + self.shortcut1(x))

    def block2(self, x: torch.Tensor) -> torch.Tensor:
        w = self.deep2(self.deep2(self.deep2(x)))
        return torch.relu(w + self.shortcut2(x))

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        name = f"Singstad_d{self.depth_variant}"
        check_part(part, name, split=self.depth_variant == 10)
        if self.depth_variant == 3:
            return self.linear(self.block1(x).mean(dim=-1))
        if self.depth_variant == 6:
            return self.linear(self.block2(self.block1(x)).mean(dim=-1))
        if part == "first":
            if depth == 0:
                return x
            h = self.block1(x)
            for d in (2, 3):
                if depth < d:
                    return h
                h = self.block2(h)
            if depth == 3:
                return h
            return self.linear(self.deep2(h).mean(dim=-1))
        if part == "second":
            h = x
            if depth <= 0:
                h = self.block1(h)
            if depth <= 1:
                h = self.block2(h)
            if depth <= 2:
                h = self.block2(h)
            return self.linear(self.deep2(h).mean(dim=-1))
        h = self.deep2(self.block2(self.block2(self.block1(x)))).mean(dim=-1)
        return h if part == "latent_space" else self.linear(h)

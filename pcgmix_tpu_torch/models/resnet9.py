"""1-D ResNet9 (myrtle-style) (counterpart: ``pcgmix_tpu/models/resnet9.py``).

Structure (reference models.py:520-589), input (B, C, T):

  conv1(k3) → conv2(k3, pool2) → res1(2×conv) + skip     [depth 1]
  conv3(k3, pool2) → conv4(k3, pool2) → res2 + skip      [depth 2]
  maxpool4 → flatten                                     [depth 3]
  linear → logits

Module names follow the reference (``conv1.0`` conv, ``conv1.1`` BN, …,
``res2.1``, ``linear``), so state_dict keys match its checkpoints.

The split forward of latentmixup and the manifold methods
(:class:`ResNet9Stages`): ``part="first"`` returns the activation at
``depth`` (0 the input, 1 and 2 after a stage, (B, C', T'); 3 the
flattened features, (B, D)), ``part="second"`` runs the rest from there;
first ∘ second is the full forward.  The activations are laid out as the
JAX package returns them after its transposes back to channel-first.

``compute_dtype=torch.bfloat16`` (JAX ``ResNet9_1D.dtype``): every conv
block computes in bf16 (the BatchNorm in float32, cast back once), so the
split forward's latents and the residual adds are bf16; the ``linear`` head
is built without a dtype, as in the JAX package, and gives float32 logits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# BatchNorm1d/2d live in layers.py; they are imported from here too
from pcgmix_tpu_torch.models.layers import (  # noqa: F401
    BatchNorm1d,
    BatchNorm2d,
    Linear,
    check_part,
    conv1d,
)


class ResNet9Stages(nn.Module):
    """The stages and the depth/part protocol shared by the 1-D and 2-D
    ResNet9 (``pcgmix_tpu/models/resnet9.py:79-115``); a subclass builds
    conv1 … res2, ``pool`` and ``linear``."""

    def stage1(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        return self.res1(x) + x

    def stage2(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv4(self.conv3(x))
        return self.res2(x) + x

    def stage3(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flatten(self.pool(x), 1)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, type(self).__name__, split=True)
        if part == "first":
            if depth == 0:
                return x
            h = self.stage1(x)
            if depth == 1:
                return h
            h = self.stage2(h)
            if depth == 2:
                return h
            h = self.stage3(h)
            if depth == 3:
                return h
            return self.linear(h)
        if part == "second":
            h = x
            if depth <= 0:
                h = self.stage1(h)
            if depth <= 1:
                h = self.stage2(h)
            if depth <= 2:
                h = self.stage3(h)
            return self.linear(h)
        h = self.stage3(self.stage2(self.stage1(x)))
        if part == "latent_space":
            return h
        return self.linear(h)


def conv_block(ci: int, co: int, pool: bool = False, conv_impl: str = "xla",
               compute_dtype=None) -> nn.Sequential:
    layers = [conv1d(ci, co, 3, 1, conv_impl, compute_dtype),
              BatchNorm1d(co, compute_dtype=compute_dtype), nn.ReLU()]
    if pool:
        layers.append(nn.MaxPool1d(2))
    return nn.Sequential(*layers)


class ResNet9_1D(ResNet9Stages):
    """Input (B, C, T) channel-first; returns (B, num_classes) logits.
    ``conv_impl="matmul"``: the convolutions as shifted matmuls
    (:class:`pcgmix_tpu_torch.models.layers.MatmulConv1d`); ``compute_dtype``
    the conv blocks' dtype."""

    def __init__(self, num_classes: int = 2, filters=(64, 128, 256, 512),
                 num_channels: int = 4, sig_len: int = 2500, conv_impl: str = "xla",
                 compute_dtype=None):
        super().__init__()
        f = filters

        def block(ci, co, pool=False):
            return conv_block(ci, co, pool, conv_impl, compute_dtype)

        # construction order = the reference's, which seeded init relies on
        self.conv1 = block(num_channels, f[0])
        self.conv2 = block(f[0], f[1], pool=True)
        self.res1 = nn.Sequential(block(f[1], f[1]), block(f[1], f[1]))
        self.conv3 = block(f[1], f[2], pool=True)
        self.conv4 = block(f[2], f[3], pool=True)
        self.res2 = nn.Sequential(block(f[3], f[3]), block(f[3], f[3]))
        self.pool = nn.MaxPool1d(4)
        self.linear = Linear(f[3] * (sig_len // 2 // 2 // 2 // 4), num_classes)


# Width presets (reference train_model.py:341-358).
RESNET9_PRESETS = {
    "resnet9": (64, 128, 256, 512),
    "resnet9-5k": (2, 4, 8, 16),
    "resnet9-15k": (4, 8, 16, 32),
    "resnet9-50k": (8, 16, 32, 64),
    "resnet9-150k": (16, 32, 64, 128),
    "resnet9-600k": (32, 64, 128, 256),
    "resnet9-1.4m": (64, 128, 192, 384),
    "resnet9-2.3m": (64, 128, 256, 512),
    "resnet9-5m": (96, 192, 384, 768),
    "resnet9-9m": (128, 256, 512, 1024),
}

"""2-D ResNet9 for mel-spectrogram inputs (counterpart:
``pcgmix_tpu/models/resnet9_2d.py``; reference models2d.py:13-87).

The 1-D flagship's topology with 2-D convs and pools on one input
channel, input (B, 1, F, T):

  conv1(3×3) → conv2(3×3, pool2) → res1(2×conv) + skip   [depth 1]
  conv3(3×3, pool2) → conv4(3×3, pool2) → res2 + skip    [depth 2]
  maxpool4 → flatten (C, F, T order)                     [depth 3]
  linear → logits

The classifier's input size falls out of the input resolution: 8192 for
128 × 128, 2048 for 64 × 64.  Every BatchNorm is the biased-variance
:class:`~pcgmix_tpu_torch.models.resnet9.BatchNorm2d`, global under data
parallelism as the 1-D one is.  The stages and the split forward are the 1-D
model's (:class:`~pcgmix_tpu_torch.models.resnet9.ResNet9Stages`), and so is
``compute_dtype``: bf16 conv blocks, a float32 ``linear`` head.
"""

from __future__ import annotations

from torch import nn

from pcgmix_tpu_torch.models.layers import Conv2d, Linear
from pcgmix_tpu_torch.models.resnet9 import BatchNorm2d, ResNet9Stages


def conv_block_2d(ci: int, co: int, pool: bool = False, compute_dtype=None) -> nn.Sequential:
    layers = [Conv2d(ci, co, 3, padding=1, compute_dtype=compute_dtype),
              BatchNorm2d(co, compute_dtype=compute_dtype), nn.ReLU()]
    if pool:
        layers.append(nn.MaxPool2d(2))
    return nn.Sequential(*layers)


def _pooled(n: int) -> int:
    """A side after the three 2-pools and the 4-pool (floor division)."""
    return n // 2 // 2 // 2 // 4


class ResNet9_2D(ResNet9Stages):
    """Input (B, 1, F, T) channel-first; returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, filters=(64, 128, 256, 512),
                 freq: int = 128, sig_len: int = 128, compute_dtype=None):
        super().__init__()
        f = filters

        def block(ci, co, pool=False):
            return conv_block_2d(ci, co, pool, compute_dtype)

        # construction order = the reference's, which seeded init relies on
        self.conv1 = block(1, f[0])
        self.conv2 = block(f[0], f[1], pool=True)
        self.res1 = nn.Sequential(block(f[1], f[1]), block(f[1], f[1]))
        self.conv3 = block(f[1], f[2], pool=True)
        self.conv4 = block(f[2], f[3], pool=True)
        self.res2 = nn.Sequential(block(f[3], f[3]), block(f[3], f[3]))
        self.pool = nn.MaxPool2d(4)
        self.linear = Linear(f[3] * _pooled(freq) * _pooled(sig_len), num_classes)

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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.parallel.dist import current_batch_rows


class _BiasedBatchNorm:
    """BatchNorm whose running variance follows the JAX package, for 1-D
    (B, C, T) and 2-D (B, C, F, T) activations.

    flax's BatchNorm (momentum 0.9, eps 1e-5) folds the *biased* batch
    variance into its running average; ``nn.BatchNorm1d``/``2d`` fold the
    unbiased one, which would make eval after training drift by n/(n−1).
    Training normalizes with the biased batch statistics as both do, and
    the running buffers are updated here explicitly, without gradient.

    Under data parallelism (a ``torch.distributed`` process group is
    initialized) the statistics are those of the global batch, as GSPMD
    gives flax's BatchNorm on the JAX package's mesh: the per-channel Σx,
    Σx² and count are all-reduced with the differentiable all-reduce, and
    x is normalized with the global mean and the global biased variance
    E[x²] − E[x]², as flax computes it.  On a batch that every rank holds
    whole (replicated, :func:`pcgmix_tpu_torch.parallel.batch_rows`) the
    local statistics are the global ones, and the all-reduce is skipped.
    It would give the same numbers over ``world`` copies of the batch (its
    backward sums the ranks' equal statistics gradients, but the count it
    divides by grew by the same factor); skipping it saves a collective per
    layer and computes what the JAX package's replicated step computes.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps,
            )
        rows = current_batch_rows()
        if (dist.is_available() and dist.is_initialized()
                and (rows is None or not rows.replicated)):
            return self._global_batch_norm(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=_reduced(x), correction=0)
            self._update_running(mean, var)
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        dims = _reduced(x)
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
        # one collective per layer: [Σx (C), Σx² (C), count]; its backward
        # all-reduces the statistics' gradients, so each rank's parameter
        # gradients are its share of the global batch's
        sums = all_reduce(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (xf - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self._update_running(mean, var)
        return y.to(x.dtype)


def _reduced(x: torch.Tensor) -> tuple:
    """The axes BatchNorm reduces over: every one but the channels'."""
    return (0, *range(2, x.dim()))


class BatchNorm1d(_BiasedBatchNorm, nn.BatchNorm1d):
    """Biased-variance BatchNorm over (B, C, T) (see :class:`_BiasedBatchNorm`)."""


class BatchNorm2d(_BiasedBatchNorm, nn.BatchNorm2d):
    """Biased-variance BatchNorm over (B, C, F, T) (see :class:`_BiasedBatchNorm`)."""


SPLIT_PARTS = (None, "first", "second", "latent_space")


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
        if part not in SPLIT_PARTS:
            raise ValueError(f"part must be one of {SPLIT_PARTS}, got {part!r}")
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


def conv_block(ci: int, co: int, pool: bool = False) -> nn.Sequential:
    layers = [nn.Conv1d(ci, co, 3, padding=1), BatchNorm1d(co), nn.ReLU()]
    if pool:
        layers.append(nn.MaxPool1d(2))
    return nn.Sequential(*layers)


class ResNet9_1D(ResNet9Stages):
    """Input (B, C, T) channel-first; returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, filters=(64, 128, 256, 512),
                 num_channels: int = 4, sig_len: int = 2500):
        super().__init__()
        f = filters
        # construction order = the reference's, which seeded init relies on
        self.conv1 = conv_block(num_channels, f[0])
        self.conv2 = conv_block(f[0], f[1], pool=True)
        self.res1 = nn.Sequential(conv_block(f[1], f[1]), conv_block(f[1], f[1]))
        self.conv3 = conv_block(f[1], f[2], pool=True)
        self.conv4 = conv_block(f[2], f[3], pool=True)
        self.res2 = nn.Sequential(conv_block(f[3], f[3]), conv_block(f[3], f[3]))
        self.pool = nn.MaxPool1d(4)
        self.linear = nn.Linear(f[3] * (sig_len // 2 // 2 // 2 // 4), num_classes)


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

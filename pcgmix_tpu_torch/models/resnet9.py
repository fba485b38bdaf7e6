"""1-D ResNet9 (myrtle-style) (counterpart: ``pcgmix_tpu/models/resnet9.py``).

Structure (reference models.py:520-589), input (B, C, T):

  conv1(k3) → conv2(k3, pool2) → res1(2×conv) + skip
  conv3(k3, pool2) → conv4(k3, pool2) → res2 + skip
  maxpool4 → flatten → linear → logits

Module names follow the reference (``conv1.0`` conv, ``conv1.1`` BN, …,
``res2.1``, ``linear``), so state_dict keys match its checkpoints.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.parallel.dist import current_batch_rows


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm whose running variance follows the JAX package.

    flax's BatchNorm (momentum 0.9, eps 1e-5) folds the *biased* batch
    variance into its running average; ``nn.BatchNorm1d`` folds the
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
            var, mean = torch.var_mean(x, dim=(0, 2), correction=0)
            self._update_running(mean, var)
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        count = torch.full((1,), x.shape[0] * x.shape[2], dtype=xf.dtype,
                           device=x.device)
        # one collective per layer: [Σx (C), Σx² (C), count]; its backward
        # all-reduces the statistics' gradients, so each rank's parameter
        # gradients are its share of the global batch's
        sums = all_reduce(torch.cat([xf.sum((0, 2)), (xf * xf).sum((0, 2)), count]))
        c = x.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None]) * scale[None, :, None] + self.bias[None, :, None]
        with torch.no_grad():
            self._update_running(mean, var)
        return y.to(x.dtype)


def conv_block(ci: int, co: int, pool: bool = False) -> nn.Sequential:
    layers = [nn.Conv1d(ci, co, 3, padding=1), BatchNorm1d(co), nn.ReLU()]
    if pool:
        layers.append(nn.MaxPool1d(2))
    return nn.Sequential(*layers)


class ResNet9_1D(nn.Module):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        x = self.res1(x) + x
        x = self.conv4(self.conv3(x))
        x = self.res2(x) + x
        return self.linear(torch.flatten(self.pool(x), 1))


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

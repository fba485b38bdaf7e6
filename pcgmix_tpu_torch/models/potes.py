"""Potes 1-D CNN (counterpart: ``pcgmix_tpu/models/potes.py``; reference
models.py:358-465).

Input (B, C, T).  One shared branch ``cnn1`` runs every band: Conv1d k=5
pad=1 → ReLU → MaxPool(2) → Conv1d k=5 pad=1 → ReLU → MaxPool(2) →
Dropout.  The bands' outputs are flattened in torch order and concatenated,
then ``dimreduc`` (→ 20) → ReLU → Dropout(0.5) → ``linear``.  The bands run
as one batch of B·C single-channel rows.

Module names give the reference state_dict keys (``cnn1.0.0``,
``cnn1.1.0``, ``dimreduc``, ``linear``), the ones
``pcgmix_tpu/train/convert.py::torch_potes_to_flax`` reads.  The reference
also defines ``cnn2``–``cnn4``, which its forward never uses (dead
parameters, as the JAX package notes); a reference checkpoint loads here
without them (``load_state_dict(..., strict=False)``).

Dropout draws its masks from the model's own ``torch.Generator`` on the
CPU, seeded at construction (the run's ``seed``), and copies them to the
activations' device: two runs with the same seed see the same masks, on
the card and on the CPU alike.  They cannot equal the JAX package's, which
come from the JAX PRNG (PARITY.md "Dropout masks").  During a data-parallel
step (:func:`pcgmix_tpu_torch.parallel.batch_rows`) every rank draws the
global batch's masks from an identically seeded generator and keeps its own
rows, so the ranks' generators stay in step and the step equals the
single-device one.  The draws go through
:func:`pcgmix_tpu_torch.models.layers.host_uniform`, so a train step
captured as a CUDA graph takes them from buffers drawn ahead in the same
order (``train/steps.py::MultiStep``).

``compute_dtype=torch.bfloat16`` (JAX ``PotesCNN.dtype``): the branch's
convolutions compute in bf16; ``dimreduc`` and ``linear`` are built without
a dtype, as in the JAX package, so the features and logits are float32.
The dropout masks are the same draws in either dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pcgmix_tpu_torch.models.layers import Linear, check_part, conv1d, host_uniform
from pcgmix_tpu_torch.parallel.dist import current_batch_rows

HIDDEN = 20  # dimreduc's width (models.py:379)
HEAD_DROPOUT = 0.5  # after dimreduc, in every preset (models.py:380)


def potes_features(sig_len: int) -> int:
    """Length of a band after the branch: two (k=5, pad=1) convs, each
    followed by MaxPool(2) with floor division."""
    return ((sig_len - 2) // 2 - 2) // 2


class Potes(nn.Module):
    """Input (B, C, T) channel-first; returns (B, num_classes) logits.
    ``conv_impl="matmul"``: the branch's convolutions as shifted matmuls;
    ``compute_dtype`` their dtype."""

    def __init__(self, num_classes: int = 2, layers: Sequence[int] = (8, 4),
                 dropout: float = 0.25, num_channels: int = 4, sig_len: int = 2500,
                 seed: int = 0, conv_impl: str = "xla", compute_dtype=None):
        super().__init__()
        l0, l1 = layers
        dt = compute_dtype
        self.cnn1 = nn.Sequential(
            nn.Sequential(conv1d(1, l0, 5, 1, conv_impl, dt), nn.ReLU(), nn.MaxPool1d(2)),
            nn.Sequential(conv1d(l0, l1, 5, 1, conv_impl, dt), nn.ReLU(), nn.MaxPool1d(2)),
        )
        self.dimreduc = Linear(num_channels * l1 * potes_features(sig_len), HIDDEN)
        self.linear = Linear(HIDDEN, num_classes)
        self.dropout = dropout
        self.generator = torch.Generator().manual_seed(seed)

    def _drop(self, h: torch.Tensor, p: float) -> torch.Tensor:
        """Dropout with rate ``p`` in training: kept values scaled by
        1/(1−p), as flax's nn.Dropout does."""
        if not self.training or p == 0.0:
            return h
        rows = current_batch_rows()
        n, sl = (rows.n, rows.rows) if rows is not None else (h.shape[0], slice(None))
        keep = host_uniform(self.generator, (n, *h.shape[1:]), h.device)[sl] >= p
        return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The 20-d hidden features after the head's dropout: depth 1 of
        the split forward."""
        B, C, T = x.shape
        h = self.cnn1(x.reshape(B * C, 1, T))
        h = self._drop(h.reshape(B, C, *h.shape[1:]), self.dropout)
        h = torch.relu(self.dimreduc(h.reshape(B, -1)))
        return self._drop(h, HEAD_DROPOUT)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        """Logits, or with ``part`` the split forward of latentmixup
        (``pcgmix_tpu/models/potes.py:71-85``): ``"first"`` returns the
        input at depth 0 and the features at depth 1, ``"second"`` runs
        the rest from there, ``"latent_space"`` returns the features."""
        check_part(part, "Potes", split=True)
        if part == "first":
            return x if depth == 0 else self.features(x)
        if part == "second":
            return self.linear(self.features(x) if depth <= 0 else x)
        h = self.features(x)
        return h if part == "latent_space" else self.linear(h)


# Width presets (reference models.py:339-356).
POTES_PRESETS = {
    "Potes": dict(layers=(8, 4), dropout=0.25),
    "Potes(noDropout)": dict(layers=(8, 4), dropout=0.0),
    "PotesBig128and64": dict(layers=(128, 64), dropout=0.25),
    "PotesBig64and32": dict(layers=(64, 32), dropout=0.25),
    "Potes0.1": dict(layers=(2, 1), dropout=0.25),
    "Potes0.02": dict(layers=(1, 1), dropout=0.25),
}

"""Model factory keyed by the reference's model-name strings
(counterpart: ``pcgmix_tpu/models/registry.py``).  The port knows the
ResNet9 and Potes presets; the rest of the zoo comes with later slices."""

from __future__ import annotations

from torch import nn

from pcgmix_tpu_torch.models.potes import POTES_PRESETS, Potes
from pcgmix_tpu_torch.models.resnet9 import RESNET9_PRESETS, ResNet9_1D

MODEL_NAMES = tuple(RESNET9_PRESETS) + tuple(POTES_PRESETS)


def build_model(name: str, num_classes: int = 2, num_channels: int = 4,
                sig_len: int = 2500, *, seed: int = 0) -> nn.Module:
    """Instantiate a 1-D model by its reference name; ``seed`` seeds the
    model's own random draws (Potes' dropout masks)."""
    if name in RESNET9_PRESETS:
        return ResNet9_1D(num_classes, RESNET9_PRESETS[name], num_channels, sig_len)
    if name in POTES_PRESETS:
        return Potes(num_classes, num_channels=num_channels, sig_len=sig_len,
                     seed=seed, **POTES_PRESETS[name])
    raise NotImplementedError(
        f"model {name!r} is not ported yet; available: {', '.join(MODEL_NAMES)}"
    )


def count_parameters(model: nn.Module) -> int:
    """Trainable-parameter count (reference train_model.py:162-163)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)

"""Model factory keyed by the reference's model-name strings
(counterpart: ``pcgmix_tpu/models/registry.py``).  This slice knows the
ResNet9 presets; the rest of the zoo comes with later slices."""

from __future__ import annotations

from torch import nn

from pcgmix_tpu_torch.models.resnet9 import RESNET9_PRESETS, ResNet9_1D

MODEL_NAMES = tuple(RESNET9_PRESETS)


def build_model(name: str, num_classes: int = 2, num_channels: int = 4,
                sig_len: int = 2500) -> nn.Module:
    """Instantiate a 1-D model by its reference name."""
    if name in RESNET9_PRESETS:
        return ResNet9_1D(num_classes, RESNET9_PRESETS[name], num_channels, sig_len)
    raise NotImplementedError(
        f"model {name!r} is not ported yet; available: {', '.join(MODEL_NAMES)}"
    )


def count_parameters(model: nn.Module) -> int:
    """Trainable-parameter count (reference train_model.py:162-163)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)

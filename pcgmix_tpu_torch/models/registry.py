"""Model factory keyed by the reference's model-name strings
(counterpart: ``pcgmix_tpu/models/registry.py``).  The port knows the
ResNet9 and Potes presets and, for the spectrogram datasets, the 2-D
ResNet9; the rest of the zoo comes with later slices."""

from __future__ import annotations

from typing import Optional

from torch import nn

from pcgmix_tpu_torch.models.potes import POTES_PRESETS, Potes
from pcgmix_tpu_torch.models.resnet9 import RESNET9_PRESETS, ResNet9_1D
from pcgmix_tpu_torch.models.resnet9_2d import ResNet9_2D

MODEL_NAMES = tuple(RESNET9_PRESETS) + tuple(POTES_PRESETS)

#: the datasets of (N, 1, F, T) mel spectrograms, which take the 2-D ResNet9
SPECTROGRAM_DATASETS = ("PhysioNet(spec128)", "UMC(spec128)", "UMC(spec64)")


def build_model(name: str, num_classes: int = 2, num_channels: int = 4,
                sig_len: int = 2500, *, seed: int = 0, dataset: str = "PhysioNet",
                freq: Optional[int] = None) -> nn.Module:
    """Instantiate a model by its reference name; ``seed`` seeds the
    model's own random draws (Potes' dropout masks).  A spectrogram
    ``dataset`` selects the 2-D variant of ``"resnet9"`` for inputs of
    ``freq`` × ``sig_len`` (square when ``freq`` is None)."""
    if dataset in SPECTROGRAM_DATASETS:
        if name != "resnet9":
            raise ValueError(f"2-D dataset {dataset!r} supports model 'resnet9' only")
        return ResNet9_2D(num_classes, RESNET9_PRESETS[name],
                          sig_len if freq is None else freq, sig_len)
    if name in RESNET9_PRESETS:
        return ResNet9_1D(num_classes, RESNET9_PRESETS[name], num_channels, sig_len)
    if name in POTES_PRESETS:
        return Potes(num_classes, num_channels=num_channels, sig_len=sig_len,
                     seed=seed, **POTES_PRESETS[name])
    raise NotImplementedError(
        f"model {name!r} is not ported yet; available: {', '.join(MODEL_NAMES)}"
    )


def max_latent_depth(name: str) -> int:
    """Largest depth of latentmixup's depth draw (reference
    augmentations.py:1484-1494; the JAX package's table, whose FCN, ResCNN
    and Singstad_d10 entries wait for those models here).  Raises for a
    model without a split (part='first'/'second') forward."""
    if name in ("FCN", "FCN(custom)"):
        return 4
    if name.startswith("Potes"):
        return 1
    if name == "ResCNN":
        return 5
    if name in RESNET9_PRESETS or name == "Singstad_d10":
        return 3
    raise NotImplementedError(
        f"latentmixup needs a split (part='first'/'second') forward, which "
        f"{name!r} does not implement (nor does the reference's); supported: "
        "resnet9 presets, Potes presets, FCN(+custom), ResCNN, Singstad_d10"
    )


def count_parameters(model: nn.Module) -> int:
    """Trainable-parameter count (reference train_model.py:162-163)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)

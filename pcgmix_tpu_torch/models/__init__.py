"""Models: all 39 names of the JAX package's registry (the ResNet9 and
Potes presets, FCN, ResCNN, ResNet, Singstad d3/d6/d10 and the tsai zoo),
and the 2-D ResNet9."""

from pcgmix_tpu_torch.models.potes import POTES_PRESETS, Potes
from pcgmix_tpu_torch.models.registry import (
    MODEL_NAMES,
    SPECTROGRAM_DATASETS,
    build_model,
    count_parameters,
    max_latent_depth,
)
from pcgmix_tpu_torch.models.resnet9 import RESNET9_PRESETS, ResNet9_1D
from pcgmix_tpu_torch.models.resnet9_2d import ResNet9_2D

__all__ = ["MODEL_NAMES", "SPECTROGRAM_DATASETS", "build_model", "count_parameters",
           "max_latent_depth", "POTES_PRESETS", "Potes", "RESNET9_PRESETS",
           "ResNet9_1D", "ResNet9_2D"]

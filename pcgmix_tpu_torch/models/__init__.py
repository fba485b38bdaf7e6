"""Models: the ResNet9 1-D and Potes presets."""

from pcgmix_tpu_torch.models.potes import POTES_PRESETS, Potes
from pcgmix_tpu_torch.models.registry import MODEL_NAMES, build_model, count_parameters
from pcgmix_tpu_torch.models.resnet9 import RESNET9_PRESETS, ResNet9_1D

__all__ = ["MODEL_NAMES", "build_model", "count_parameters", "POTES_PRESETS", "Potes",
           "RESNET9_PRESETS", "ResNet9_1D"]

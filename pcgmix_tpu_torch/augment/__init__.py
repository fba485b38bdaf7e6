"""Method-string DSL, host plans and the device apply of the augmentations."""

from pcgmix_tpu_torch.augment.engine import AugmentConfig, AugmentEngine, Plan
from pcgmix_tpu_torch.augment.methods import MethodSpec, parse_method

__all__ = ["AugmentConfig", "AugmentEngine", "Plan", "MethodSpec", "parse_method"]

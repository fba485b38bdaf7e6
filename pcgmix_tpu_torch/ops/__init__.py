"""Tensor ops: the piecewise mix, the spline warp and their CUDA kernels."""

from pcgmix_tpu_torch.ops.mix_kernels import (
    launch_counts,
    pcgmix_plus_fused,
    pcgmix_plus_fused_prepaired,
    piecewise_mix_pairs,
    piecewise_mix_prepaired,
    reset_launch_counts,
)
from pcgmix_tpu_torch.ops.piecewise import piecewise_mix_f32, segment_blend_pieces
from pcgmix_tpu_torch.ops.spline import cubic_spline_basis, magnitude_warp

__all__ = [
    "launch_counts",
    "pcgmix_plus_fused",
    "pcgmix_plus_fused_prepaired",
    "piecewise_mix_pairs",
    "piecewise_mix_prepaired",
    "reset_launch_counts",
    "piecewise_mix_f32",
    "segment_blend_pieces",
    "cubic_spline_basis",
    "magnitude_warp",
]

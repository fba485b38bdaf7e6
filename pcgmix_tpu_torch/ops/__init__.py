"""Tensor ops: the piecewise mix, the spline warp, the k=3 conv with
BatchNorm statistics, and their CUDA kernels."""

from pcgmix_tpu_torch.ops.build import launch_counts, reset_launch_counts
from pcgmix_tpu_torch.ops.conv_bn import conv3_bn_stats, conv3_bn_stats_plain
from pcgmix_tpu_torch.ops.mix_kernels import (
    pcgmix_plus_fused,
    pcgmix_plus_fused_prepaired,
    piecewise_mix_batch,
    piecewise_mix_pairs,
    piecewise_mix_prepaired,
)
from pcgmix_tpu_torch.ops.piecewise import piecewise_mix_f32, segment_blend_pieces
from pcgmix_tpu_torch.ops.spline import cubic_spline_basis, magnitude_warp

__all__ = [
    "conv3_bn_stats",
    "conv3_bn_stats_plain",
    "launch_counts",
    "pcgmix_plus_fused",
    "pcgmix_plus_fused_prepaired",
    "piecewise_mix_batch",
    "piecewise_mix_pairs",
    "piecewise_mix_prepaired",
    "reset_launch_counts",
    "piecewise_mix_f32",
    "segment_blend_pieces",
    "cubic_spline_basis",
    "magnitude_warp",
]

"""Bench harnesses of the port's kernels, run on the card:
``python -m pcgmix_tpu_torch.bench.conv_bn_fused`` (K5),
``python -m pcgmix_tpu_torch.bench.mix_warp_ablation`` (K2's steps, beside
K1) and ``python -m pcgmix_tpu_torch.bench.mix_kernel_times`` (K1–K4
through their wrappers)."""

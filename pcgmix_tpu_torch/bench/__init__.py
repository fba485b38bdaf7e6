"""Bench harnesses of the port's kernels, run on the card:
``python -m pcgmix_tpu_torch.bench.conv_bn_fused`` (K5)."""

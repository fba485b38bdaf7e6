"""Data parallelism over torch.distributed (counterpart: ``pcgmix_tpu/parallel``)."""

from pcgmix_tpu_torch.parallel.dist import DataParallel, batch_rows, init_group, spawn

__all__ = ["DataParallel", "batch_rows", "init_group", "spawn"]

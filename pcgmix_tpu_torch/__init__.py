"""pcgmix_tpu_torch: the PyTorch/CUDA port of pcgmix_tpu for NVIDIA Hopper.

Same datasets, method-string DSL, step-seeded plans, models, training
recipe and run-directory contract as ``pcgmix_tpu``; the TPU's Pallas
kernels are rewritten as CUDA kernels (``ops/csrc``), and the JAX mesh's
data parallelism is ``torch.distributed`` (``parallel``).  This package
never imports JAX or ``pcgmix_tpu``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

from pcgmix_tpu_torch.train import TrainConfig, train_model

__all__ = ["TrainConfig", "train_model"]

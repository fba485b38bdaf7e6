"""Training runtime: steps, losses, metrics, weight carry-over, the loop."""

from pcgmix_tpu_torch.train.loop import TrainConfig, train_model

__all__ = ["TrainConfig", "train_model"]

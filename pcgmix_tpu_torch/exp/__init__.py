"""Experiment plumbing: the run-directory naming contract."""

from pcgmix_tpu_torch.exp.dirs import experiment_already_done, experiment_dir

__all__ = ["experiment_already_done", "experiment_dir"]

"""Datasets, the PhysioNet split pipeline, loaders and synthetic fixtures."""

from pcgmix_tpu_torch.data.datasets import ArrayDataset, bands_to_channels, load_cvd_map
from pcgmix_tpu_torch.data.loader import EpochIterator, epoch_permutation, eval_batches
from pcgmix_tpu_torch.data.physionet import physionet_split
from pcgmix_tpu_torch.data.synthetic import (
    synthetic_effect_dict,
    synthetic_physionet_dict,
    synthetic_spectrogram_dict,
)

__all__ = [
    "ArrayDataset",
    "bands_to_channels",
    "EpochIterator",
    "epoch_permutation",
    "eval_batches",
    "load_cvd_map",
    "physionet_split",
    "synthetic_effect_dict",
    "synthetic_physionet_dict",
    "synthetic_spectrogram_dict",
]

"""Datasets, the PhysioNet and UMC split pipelines, loaders and synthetic
fixtures."""

from pcgmix_tpu_torch.data.datasets import ArrayDataset, bands_to_channels, load_cvd_map
from pcgmix_tpu_torch.data.loader import EpochIterator, epoch_permutation, eval_batches
from pcgmix_tpu_torch.data.physionet import physionet_split
from pcgmix_tpu_torch.data.synthetic import (
    synthetic_effect_dict,
    synthetic_physionet_dict,
    synthetic_physionet_full_dict,
    synthetic_spectrogram_dict,
    synthetic_umc_dict,
)
from pcgmix_tpu_torch.data.umc import umc_split

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
    "synthetic_physionet_full_dict",
    "synthetic_spectrogram_dict",
    "synthetic_umc_dict",
    "umc_split",
]

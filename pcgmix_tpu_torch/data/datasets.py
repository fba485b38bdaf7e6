"""Packed in-memory dataset container (counterpart: ``pcgmix_tpu/data/datasets.py``).

Data contract: reference dataset dicts map ``{'data': {band: [N × T]},
'label': [N], 'frames': [N × 5], 'wav': [N], 'sig_qual': [N]}`` with a
'train'/'test' level for PhysioNet; a UMC dict is one level and adds the
patient ``'id'`` and ``'excluded'``; a spectrogram dict's ``'data'`` is
one (N, F, T) array of mel spectrograms, its frames in spectrogram
columns.  The multi-cycle variant's frames are (N, 28), padded with −1.
Splits stay numpy on the host; the training loop uploads the train split
to the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# The four model input bands and the wide band, in channel order
# (reference dataloader_physionet.py:29-35).
MODEL_BANDS = ("25-45", "45-80", "80-200", "200-400")
WIDE_BAND = "25-400"


def load_cvd_map(csv_path: str) -> dict:
    """Load the wav → cardiovascular-diagnosis map used by the (sameCVD)
    pairing constraint.  The reference reads this csv at import time from a
    hardcoded out-of-repo path (augmentations.py:26-28, columns 'wav' and
    'diagnosis'); here it is an explicit input."""
    import csv

    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        fields = reader.fieldnames or []
    if "wav" not in fields or "diagnosis" not in fields:
        raise ValueError(
            f"{csv_path}: expected csv columns 'wav' and 'diagnosis' "
            "(cvds_map.csv contract, augmentations.py:26-28)"
        )
    if not rows:
        raise ValueError(f"{csv_path}: header is valid but the csv has no rows")
    return {r["wav"]: r["diagnosis"] for r in rows}


def bands_to_channels(data_dict: dict, num_channels: int,
                      classical_space: bool = False) -> np.ndarray:
    """Stack band arrays into (N, C, T) float32: the wide band alone for
    num_channels=1, the four narrow bands for num_channels=4;
    ``classical_space`` adds the wide band as a 5th channel (reference
    dataloader_physionet.py:49-55), which only the 4-band layout takes."""
    if num_channels == 1 and not classical_space:
        return np.asarray(data_dict[WIDE_BAND], np.float32)[:, None, :]
    if num_channels != 4:
        raise ValueError(
            f"num_channels must be 1 (wide band) or 4 (narrow bands), "
            f"got {num_channels}"
        )
    bands = list(MODEL_BANDS) + ([WIDE_BAND] if classical_space else [])
    return np.stack([np.asarray(data_dict[b], np.float32) for b in bands], axis=1)


@dataclasses.dataclass
class ArrayDataset:
    """One split, fully materialized."""

    data: np.ndarray  # (N, C, T) float32, or (N, 1, F, T) for spectrograms
    label: np.ndarray  # (N,) int64
    frames: np.ndarray  # (N, 5) int64
    wav: np.ndarray  # (N,) object (recording names)
    sig_qual: np.ndarray  # (N,) int64
    ids: Optional[np.ndarray] = None  # (N,) object: UMC patient ids
    rows: Optional[np.ndarray] = None  # provenance: the row ids of the
                                       # from_dict base this split was
                                       # take()n from (a gang gathers its
                                       # members' batches from one base)

    def __len__(self) -> int:
        return len(self.label)

    def take(self, indices) -> "ArrayDataset":
        indices = np.asarray(indices, dtype=np.int64)
        return ArrayDataset(
            data=self.data[indices],
            label=self.label[indices],
            frames=self.frames[indices],
            wav=self.wav[indices],
            sig_qual=self.sig_qual[indices],
            ids=None if self.ids is None else self.ids[indices],
            rows=None if self.rows is None else self.rows[indices],
        )

    @classmethod
    def from_dict(cls, d: dict, num_channels: int, classical_space: bool = False,
                  spectrogram: bool = False) -> "ArrayDataset":
        """A split of a dataset dict: the bands stacked as channels (with
        ``classical_space`` the wide band as a 5th), or a spectrogram dict's
        (N, F, T) data as one channel."""
        if spectrogram:
            data = np.asarray(d["data"], np.float32)[:, None, :, :]
        else:
            data = bands_to_channels(d["data"], num_channels, classical_space)
        return cls(
            data=data,
            label=np.asarray(d["label"], np.int64),
            frames=np.asarray(d["frames"], np.int64),
            wav=np.asarray(d["wav"], object),
            sig_qual=np.asarray(d["sig_qual"], np.int64),
            ids=np.asarray(d["id"], object) if "id" in d else None,
            rows=np.arange(len(np.asarray(d["label"])), dtype=np.int64),
        )

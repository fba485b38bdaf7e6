"""Epoch iteration and batching (counterpart: ``pcgmix_tpu/data/loader.py``).

The reference shuffles with DataLoader(shuffle=True, drop_last=True) after
reseeding torch's RNG to ``seed·635410 + step_count`` every epoch
(train_model.py:497), and evaluates in sequential batches of 1000
(dataloader_physionet.py:247-251).  An epoch here is one permutation of
indices; the training step gathers its rows on the device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from pcgmix_tpu_torch.data.datasets import ArrayDataset
from pcgmix_tpu_torch.timing import timed


def epoch_permutation(n: int, seed: int, step_count: int, parity: str = "torch"):
    """Shuffle order for one epoch.

    parity='torch' reproduces the reference order exactly: a CPU generator
    seeded with ``seed·635410 + step_count`` drawing ``randperm(n)`` (what
    RandomSampler draws; a CUDA generator would give another permutation).
    parity='numpy' is a deterministic alternative with the same seeding.
    """
    s = seed * 635410 + step_count
    if parity == "torch":
        g = torch.Generator().manual_seed(s)
        return torch.randperm(n, generator=g).numpy()
    return np.random.RandomState(s % (2**32)).permutation(n)


class EpochIterator:
    """Training batches for one epoch: host metadata (label, frames, wav,
    sig_qual) plus ``indices``, the split-local row ids the device step
    gathers by and the SELC table scatters by."""

    def __init__(
        self,
        ds: ArrayDataset,
        batch_size: int,
        seed: int,
        step_count: int,
        parity: str = "torch",
    ):
        self.ds = ds
        self.batch_size = batch_size
        with timed("epoch"):
            self.order = epoch_permutation(len(ds), seed, step_count, parity)

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size  # drop_last=True

    def __iter__(self) -> Iterator[dict]:
        bs = self.batch_size
        for b in range(len(self)):
            with timed("batch"):
                idx = self.order[b * bs : (b + 1) * bs]
                batch = {
                    "label": self.ds.label[idx],
                    "frames": self.ds.frames[idx],
                    "wav": self.ds.wav[idx],
                    "sig_qual": self.ds.sig_qual[idx],
                    "indices": idx,
                }
            yield batch


def eval_batches(ds: ArrayDataset, batch_size: int = 1000) -> Iterator[dict]:
    """Sequential eval batches; the last one is ragged, as in the reference."""
    n = len(ds)
    for b in range(0, n, batch_size):
        sl = slice(b, min(b + batch_size, n))
        yield {
            "data": ds.data[sl],
            "label": ds.label[sl],
            "frames": ds.frames[sl],
            "wav": ds.wav[sl],
        }

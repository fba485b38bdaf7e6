"""PhysioNet-2016 split logic (counterpart: ``pcgmix_tpu/data/physionet.py``).

Bit-exact reimplementation of the reference selection pipeline
(dataloader_physionet.py:60-149):

  1. drop sig_qual==0 recordings,
  2. bucket unique wavs into 12 groups (6 subset letters × 2 classes),
  3. train_balance: per-subset class balancing subsample (seed 18),
  4. n_fraction: per-class shuffled (seed_data) prefix of the unique wavs,
  5. valid: interleaved 5-fold CV partitions over wavs, fold = seed−1.
"""

from __future__ import annotations

import random

import numpy as np

from pcgmix_tpu_torch.data.datasets import ArrayDataset

_SUBSETS = "abcdef"


def _keep_by_wavlist(ds: ArrayDataset, wavlist) -> ArrayDataset:
    wavset = set(wavlist)
    return ds.take([i for i, w in enumerate(ds.wav) if w in wavset])


def _bucket_wavs(ds: ArrayDataset, num_classes: int = 2) -> list[list]:
    """12 buckets of unique wavs keyed by (subset letter, label), in order of
    first appearance."""
    buckets = [[] for _ in range(6 * num_classes)]
    seen = set()
    for w, t in zip(ds.wav, ds.label):
        if w not in seen:
            seen.add(w)
            buckets[_SUBSETS.index(w[0]) + 6 * int(t)].append(w)
    return buckets


def physionet_split(
    dataset: dict,
    mode: str,
    *,
    num_channels: int = 4,
    seed_data: int = 1100001,
    n_fraction: float = 1.0,
    seed: int = 1,
    train_balance: bool = True,
    valid: bool = False,
    tbal_seed: int = 18,
    classical_space: bool = False,
    spectrogram: bool = False,
) -> ArrayDataset:
    """Materialize one split of a PhysioNet dataset dict.

    mode='test' returns the held-out test set untouched; mode='train'/'valid'
    runs the selection pipeline and returns the train remainder / the
    validation fold.  ``spectrogram`` reads a spectrogram dict (the 2-D
    loader, reference dataloader_physionet2d.py, runs the same steps).
    ``classical_space`` adds the wide band as a 5th channel to the train
    side only: the test split never carries it (reference
    dataloader_physionet.py:246).
    """
    if mode == "test":
        return ArrayDataset.from_dict(dataset["test"], num_channels, spectrogram=spectrogram)

    ds = ArrayDataset.from_dict(dataset["train"], num_channels, classical_space,
                                spectrogram)
    ds = ds.take(np.nonzero(ds.sig_qual)[0])

    buckets = _bucket_wavs(ds)
    if train_balance:
        max_wavs = [min(len(buckets[i]), len(buckets[i + 6])) for i in range(6)] * 2
        buckets = [
            random.Random(tbal_seed).sample(b, m) for b, m in zip(buckets, max_wavs)
        ]
        keep = np.sort(np.array([w for b in buckets for w in b], object))
        ds = _keep_by_wavlist(ds, keep)

    if n_fraction < 1.0:
        flat0 = sorted(w for b in buckets[:6] for w in b)
        flat1 = sorted(w for b in buckets[6:] for w in b)
        random.Random(seed_data).shuffle(flat0)
        random.Random(seed_data).shuffle(flat1)
        n_per_label = int(np.ceil(n_fraction * len(set(ds.wav)) / 2))
        keep = np.sort(np.array(flat0[:n_per_label] + flat1[:n_per_label], object))
        ds = _keep_by_wavlist(ds, keep)

    if valid:
        k_folds = 5
        if seed not in range(1, k_folds + 1):
            raise ValueError(
                f"seed must be in 1..{k_folds} for {k_folds}-fold CV, got {seed}"
            )
        flat0, flat1, seen = [], [], set()
        for w, t in zip(ds.wav, ds.label):
            if w not in seen:
                seen.add(w)
                (flat0 if t == 0 else flat1).append(w)
        parts0 = [flat0[i::k_folds] for i in range(k_folds)]
        parts1 = [flat1[i::k_folds] for i in range(k_folds)]
        folds = [parts0[i] + parts1[k_folds - i - 1] for i in range(k_folds)]
        wavs_valid = folds[seed - 1]
        if mode == "valid":
            return _keep_by_wavlist(ds, wavs_valid)
        vset = set(wavs_valid)
        ds = _keep_by_wavlist(
            ds, [w for fold in folds for w in fold if w not in vset]
        )
    elif mode == "valid":
        raise ValueError("mode='valid' requires valid=True")

    return ds

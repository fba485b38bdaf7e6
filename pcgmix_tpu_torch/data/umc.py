"""UMC heart-failure dataset splits (counterpart: ``pcgmix_tpu/data/umc.py``).

The reference's dataloader_umc.py:26-150 (and dataloader_umc2d.py): the
label swap, the exclusion filter, the hardcoded 10-fold patient
cross-validation, the signal-quality filter, and the inner 3-fold
validation split over the old and new recording subsets.

The reference hardcodes ten 33/34-patient train folds
(dataloader_umc.py:63-72).  Each is "all 37 patients minus one held-out
group", and the ten held-out groups partition the cohort, so the compact
group table below is all a split needs (only ``id in fold`` is ever
asked, so order is immaterial).
"""

from __future__ import annotations

import numpy as np

from pcgmix_tpu_torch.data.datasets import ArrayDataset

# Held-out patient groups; train fold i (1-based) = all patients except
# HELDOUT_GROUPS[i-1] (dataloader_umc.py:63-72).
HELDOUT_GROUPS = [
    ["ID_002", "ID_1", "ID_19", "ID_2"],
    ["ID_013", "ID_16", "ID_9"],
    ["ID_008", "ID_10", "ID_22"],
    ["ID_000", "ID_15", "ID_3"],
    ["ID_003", "ID_007", "ID_11", "ID_12"],
    ["ID_004", "ID_014", "ID_14", "ID_23"],
    ["ID_001", "ID_009", "ID_4", "ID_8"],
    ["ID_011", "ID_012", "ID_24", "ID_7"],
    ["ID_005", "ID_006", "ID_13", "ID_6"],
    ["ID_010", "ID_015", "ID_20", "ID_5"],
]
ALL_PATIENTS = sorted({p for g in HELDOUT_GROUPS for p in g})
FOLDS = range(1, 11)  # seed_data: the train fold
INNER_FOLDS = 3  # seed: the inner validation fold, 1..3


def swap_umc_labels(labels: np.ndarray) -> np.ndarray:
    """The rekomp=0/dekomp=1 class swap applied right after from_dict
    (dataloader_umc.py:42)."""
    return np.where((labels == 0) | (labels == 1), labels ^ 1, labels)


def _train_fold(seed_data: int) -> set:
    if seed_data not in FOLDS:
        raise ValueError(f"seed_data must be in 1..10 (10-fold CV), got {seed_data}")
    held = set(HELDOUT_GROUPS[seed_data - 1])
    return {p for p in ALL_PATIENTS if p not in held}


def umc_split(
    dataset: dict,
    mode: str,
    *,
    num_channels: int = 4,
    seed_data: int = 1,
    seed: int = 1,
    valid: bool = False,
    classical_space: bool = False,
    spectrogram: bool = False,
) -> ArrayDataset:
    """One split of a UMC dataset dict (a single dict, no train/test level:
    the splits are by patient folds); ``classical_space`` adds the wide
    band as a 5th channel (the loop asks for it on the train split only)."""
    ds = ArrayDataset.from_dict(dataset, num_channels, classical_space, spectrogram)
    ds.label = swap_umc_labels(ds.label)
    # keep the recordings marked excluded == 1 (sic, dataloader_umc.py:48-56)
    ds = ds.take([i for i, ex in enumerate(np.asarray(dataset["excluded"])) if ex == 1])

    fold = _train_fold(seed_data)
    if mode == "test":
        return ds.take([i for i, pid in enumerate(ds.ids) if pid not in fold])

    ds = ds.take([i for i, pid in enumerate(ds.ids) if pid in fold])
    # the signal-quality filter, train side only (dataloader_umc.py:103-110)
    ds = ds.take(np.nonzero(ds.sig_qual)[0])

    if valid:
        # 'new' patient ids have 6 characters (ID_xxx), 'old' ones fewer
        # (dataloader_umc.py:111-123)
        old_ids, new_ids, seen = [], [], set()
        for pid in ds.ids:
            if pid not in seen:
                seen.add(pid)
                (new_ids if len(pid) == 6 else old_ids).append(pid)
        k = INNER_FOLDS
        if seed not in range(1, k + 1):
            raise ValueError(f"seed must be in 1..{k} (3-fold CV), got {seed}")
        parts_old = [old_ids[i::k] for i in range(k)]
        parts_new = [new_ids[i::k] for i in range(k)]
        folds = [parts_old[i] + parts_new[k - i - 1] for i in range(k)]
        ids_valid = set(folds[seed - 1])
        if mode == "valid":
            return ds.take([i for i, pid in enumerate(ds.ids) if pid in ids_valid])
        tset = {p for f in folds for p in f if p not in ids_valid}
        return ds.take([i for i, pid in enumerate(ds.ids) if pid in tset])
    if mode == "valid":
        raise ValueError("mode='valid' requires valid=True")
    return ds

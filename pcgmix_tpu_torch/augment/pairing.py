"""Mix-pair selection (counterpart: ``pcgmix_tpu/augment/pairing.py``).

Builds, on the host, the within-batch partner permutation of the mixing
methods with the reference's ``random.Random(step)`` protocol: the
same-label shuffle of PCGmix and PCGmix+, the constrained shuffles
(same diagnosis, recording, dataset, UMC subset, or length bin) and the
unconstrained one.  The latent-distance pairings (closestknn/closestbins)
need a model in the loop; they come with the slice that ports it and
raise here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pcgmix_tpu_torch import rng as prng

PORTED_PAIRINGS = ("same_label", "same_cvd", "same_wav", "same_dataset",
                   "same_umc_subset", "same_length", "mix_all")
# pairing → the ROADMAP queue 1 item that it waits for
WAITING = {"closestknn": 10, "closestbins": 10}


def same_label(labels: np.ndarray, seed: int) -> np.ndarray:
    """Shuffle within class labels (reference augmentations.py:500-514)."""
    return prng.grouped_shuffle([int(t) for t in labels], seed)


def same_cvd(wavs: Sequence[str], cvd_map: dict, seed: int) -> np.ndarray:
    """Shuffle within cardiovascular-disease groups (augmentations.py:516-526).

    ``cvd_map`` maps wav name → diagnosis (the reference reads this from an
    out-of-repo cvds_map.csv, augmentations.py:26-28)."""
    return prng.grouped_shuffle([cvd_map[w] for w in wavs], seed)


def same_wav(wavs: Sequence[str], seed: int) -> np.ndarray:
    """Shuffle within recordings (augmentations.py:528-540)."""
    return prng.grouped_shuffle(list(wavs), seed)


def same_dataset(labels: np.ndarray, wavs: Sequence[str], seed: int) -> np.ndarray:
    """Shuffle within (PhysioNet subset letter, label) groups
    (augmentations.py:542-556)."""
    keys = [f"{w[0]}_{int(t)}" for w, t in zip(wavs, labels)]
    return prng.grouped_shuffle(keys, seed)


def same_umc_subset(labels: np.ndarray, wavs: Sequence[str], seed: int) -> np.ndarray:
    """Shuffle within (UMC old/new subset, label) groups
    (augmentations.py:632-653): 3-digit patient ids are 'new'."""
    keys = [
        f"{'new' if len(w.split('_')[0]) == 3 else 'old'}_{int(t)}"
        for w, t in zip(wavs, labels)
    ]
    return prng.grouped_shuffle(keys, seed)


def same_length(
    labels: np.ndarray,
    frames: np.ndarray,
    seed: int,
    batch_size: int,
    num_bins: int = 0,
) -> np.ndarray:
    """Shuffle within (label, heartbeat-length bin) groups
    (augmentations.py:558-582).  num_bins=0 → batch_size//100 default."""
    lengths = [int(f[-1]) for f in frames]
    lo, hi = np.min(lengths), np.max(lengths)
    nb = max(num_bins if num_bins else batch_size // 100, 1)
    bins = np.linspace(lo - 1, hi + 1, nb + 1)
    binned = np.digitize(lengths, bins)
    keys = [f"{int(t)}_{b}" for t, b in zip(labels, binned)]
    return prng.grouped_shuffle(keys, seed)


def mix_all(size: int, seed: int) -> np.ndarray:
    """Unconstrained shuffle (augmentations.py:950-951)."""
    return prng.py_shuffled_permutation(seed, size)


def build_pairing(
    spec,
    step: int,
    labels: np.ndarray,
    frames: np.ndarray,
    wavs: Optional[Sequence[str]],
    batch_size: int,
    cvd_map: Optional[dict] = None,
) -> np.ndarray:
    """Partner indices for one batch, by ``spec.pairing``."""
    if spec.pairing == "same_label":
        return same_label(labels, step)
    if spec.pairing == "same_cvd":
        if cvd_map is None:
            raise ValueError("(sameCVD) pairing requires a cvd_map (wav→diagnosis)")
        return same_cvd(wavs, cvd_map, step)
    if spec.pairing == "same_wav":
        return same_wav(wavs, step)
    if spec.pairing == "same_dataset":
        return same_dataset(labels, wavs, step)
    if spec.pairing == "same_umc_subset":
        return same_umc_subset(labels, wavs, step)
    if spec.pairing == "same_length":
        return same_length(labels, frames, step, batch_size, spec.pairing_param)
    if spec.pairing == "mix_all":
        return mix_all(len(labels), step)
    if spec.pairing in WAITING:
        raise NotImplementedError(
            f"pairing {spec.pairing!r} is not ported yet "
            f"(ROADMAP queue 1 item {WAITING[spec.pairing]})"
        )
    raise ValueError(f"unknown pairing {spec.pairing!r}")

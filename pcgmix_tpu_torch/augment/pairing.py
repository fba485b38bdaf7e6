"""Mix-pair selection (counterpart: ``pcgmix_tpu/augment/pairing.py``).

Builds, on the host, the within-batch partner permutation of the mixing
methods with the reference's ``random.Random(step)`` protocol: the
same-label shuffle of PCGmix and PCGmix+, the constrained shuffles
(same diagnosis, recording, dataset, UMC subset, or length bin) and the
unconstrained one; and the latent-distance pairings (closestknn,
closestbins, reference augmentations.py:386-498), which solve a small TSP
per class over the distances between latent embeddings of a frozen model
(``latent.py``) and pair each row with its tour successor.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from pcgmix_tpu_torch import rng as prng
from pcgmix_tpu_torch.augment.tsp import solve_tsp_greedy, solve_tsp_local_search
from pcgmix_tpu_torch.timing import timed

LATENT_PAIRINGS = ("closestknn", "closestbins")
PORTED_PAIRINGS = ("same_label", "same_cvd", "same_wav", "same_dataset",
                   "same_umc_subset", "same_length", "mix_all") + LATENT_PAIRINGS


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


def _rankings(dist: np.ndarray, k: int) -> np.ndarray:
    """Distance→ranking matrix with the k nearest collapsed to rank 1
    (distances_to_rankings, augmentations.py:372-384)."""
    m = dist.shape[0]
    r = np.zeros_like(dist, dtype=int)
    for i in range(m):
        order = np.argsort(dist[i])
        r[i, order] = np.arange(m)
        r[i, order[1 : k + 1]] = 1
        r[i, order[k + 1 :]] -= k - 1
    return r


def _tsp_pairing_per_label(
    labels: np.ndarray, dist_by_label: dict, refine: bool
) -> np.ndarray:
    """Solve a TSP per class and pair each element with its tour successor
    (augmentations.py:422-433)."""
    groups: dict = {}
    for i, t in enumerate(labels):
        groups.setdefault(int(t), []).append(i)
    mix = np.arange(len(labels))
    for label, dist in dist_by_label.items():
        path = solve_tsp_greedy(dist)
        if refine:
            path, _ = solve_tsp_local_search(dist, path[:-1])
            path = path + [path[0]]
        first = np.array(path[:-1])
        second = np.roll(path[:-1], -1)
        members = np.array(groups[label])
        mix[members[first]] = mix[members[second]]
    return mix


def _class_distances(labels: np.ndarray, latent: np.ndarray) -> dict:
    """{label: (members, Euclidean distance matrix of their latents)} for
    the classes 0 and 1 with two members or more (a lone row stays
    unpaired)."""
    out = {}
    for label in (0, 1):
        members = [i for i, t in enumerate(labels) if int(t) == label]
        if len(members) < 2:
            continue
        fts = latent[members]
        out[label] = (members, np.linalg.norm(fts[:, None] - fts[None, :], axis=-1))
    return out


def closest_knn(
    labels: np.ndarray,
    latent: np.ndarray,
    k_num: int,
    seed: int,
    batch_size: int,
) -> tuple[np.ndarray, float]:
    """kNN-ranked latent-distance TSP pairing (augmentations.py:386-438).
    Returns (mix indices, total latent distance of the pairing)."""
    if k_num >= batch_size:
        mix = same_label(labels, seed)
        return mix, _total_distance(latent, mix)
    dist_by_label = {label: _rankings(d, k_num)
                     for label, (_, d) in _class_distances(labels, latent).items()}
    mix = _tsp_pairing_per_label(labels, dist_by_label, refine=True)
    return mix, _total_distance(latent, mix)


def closest_bins(
    labels: np.ndarray, latent: np.ndarray, num_bins: int, seed: int
) -> tuple[np.ndarray, float]:
    """Binned latent-distance TSP pairing (augmentations.py:440-498): the
    distances of both classes binned on one linspace of their range."""
    if num_bins == 1:
        mix = same_label(labels, seed)
        return mix, _total_distance(latent, mix)
    dists = {label: d for label, (_, d) in _class_distances(labels, latent).items()}
    if not dists:
        mix = np.arange(len(labels))
        return mix, _total_distance(latent, mix)
    upper = {l: d[np.triu_indices_from(d, k=1)] for l, d in dists.items()}
    all_max = max(u.max() for u in upper.values())
    all_min = min(u.min() for u in upper.values())
    edges = np.linspace(all_min, all_max, num_bins + 1)
    dist_by_label = {}
    for label, d in dists.items():
        b = np.clip(np.digitize(d, edges, right=True), 1, num_bins)
        np.fill_diagonal(b, 0)
        dist_by_label[label] = b
    mix = _tsp_pairing_per_label(labels, dist_by_label, refine=False)
    return mix, _total_distance(latent, mix)


def _total_distance(latent: np.ndarray, mix: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(latent - latent[mix], axis=1)))


def build_pairing(
    spec,
    step: int,
    labels: np.ndarray,
    frames: np.ndarray,
    wavs: Optional[Sequence[str]],
    batch_size: int,
    cvd_map: Optional[dict] = None,
    latent_fn: Optional[Callable[[], np.ndarray]] = None,
) -> np.ndarray:
    """Partner indices for one batch, by ``spec.pairing``.  ``latent_fn``
    computes the batch's (B, D) latent embeddings, called only for the
    latent-distance pairings."""
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
    if spec.pairing in LATENT_PAIRINGS:
        if latent_fn is None:
            raise ValueError(f"({spec.pairing}=…) pairing needs latent_fn, the "
                             "batch's latent embeddings")
        latent = latent_fn()
        with timed("tsp pairing"):
            if spec.pairing == "closestknn":
                return closest_knn(labels, latent, spec.pairing_param, step, batch_size)[0]
            return closest_bins(labels, latent, spec.pairing_param, step)[0]
    raise ValueError(f"unknown pairing {spec.pairing!r}")

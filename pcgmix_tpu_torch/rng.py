"""Reference-exact RNG protocol.

The reference mixes three RNG families, all (re)seeded from the global step
counter (SURVEY.md §2.5):

- ``random.Random(step)``       — apply-probability draws, pairing shuffles,
                                  random displacements (augmentations.py:936,
                                  :309, :500-514, ...)
- ``np.random.seed(step)``      — λ ~ Beta(α, α) (augmentations.py:659-666)
                                  followed (for durmixmagwarp) by the
                                  magnitude-warp knot values drawn from the
                                  *continuing* global NumPy stream
                                  (augmentations.py:674-683, :924-928)
- torch RNG                     — epoch data order (train_model.py:497)

All of these are O(batch) scalar work, so this module reproduces them
bit-exactly on the host; the resulting small integer/float arrays are
uploaded to the device kernels.  It is a copy of ``pcgmix_tpu/rng.py``
(random + numpy only), kept here so the port never imports the JAX package.
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Python stdlib `random.Random(seed)` draws — bit-exact by construction.
# ---------------------------------------------------------------------------


def py_uniform(seed: int, lo: float = 0.0, hi: float = 1.0) -> float:
    """First ``uniform(lo, hi)`` draw of ``random.Random(seed)``."""
    return random.Random(seed).uniform(lo, hi)


def py_randint(seed: int, lo: int, hi: int) -> int:
    """First ``randint(lo, hi)`` draw of ``random.Random(seed)``."""
    return random.Random(seed).randint(lo, hi)


def py_sample(seed: int, seq: Sequence, k: int) -> list:
    """First ``sample(seq, k)`` of ``random.Random(seed)``."""
    return random.Random(seed).sample(list(seq), k)


def py_shuffled_permutation(seed: int, n: int) -> np.ndarray:
    """``random.Random(seed).sample(range(n), n)`` as an int array.

    This is the permutation used by `(mixAll)` pairing
    (augmentations.py:950-951).
    """
    return np.asarray(py_sample(seed, np.arange(n), n), dtype=np.int32)


def py_sorted_uniform_pair(step: int) -> tuple[float, float]:
    """``sorted([Random(step + i*131071).uniform(0,1) for i in range(2)])``.

    Cut-fraction pair used by cutout/cont-cutmix variants
    (augmentations.py:1141, :1371, :1593).
    """
    draws = [py_uniform(step + i * 131071) for i in range(2)]
    lo, hi = sorted(draws)
    return lo, hi


def py_masked_region(step: int, region_max: float) -> tuple[float, float]:
    """Gap/start draw used by timemask & plain cutout (augmentations.py:820-822,
    :1604-1607): gap ~ U(0, region_max) @ seed step+131071, then
    frac1 ~ U(0, 1-gap) @ seed step+13119, frac2 = frac1 + gap."""
    gap = py_uniform(step + 131071, 0, region_max)
    frac1 = py_uniform(step + 13119, 0, 1.0 - gap)
    return frac1, frac1 + gap


# ---------------------------------------------------------------------------
# NumPy global-stream draws — bit-exact via the legacy RandomState seeding the
# reference relies on (np.random.seed).
# ---------------------------------------------------------------------------


def np_beta_lambda(alpha: float, seed: int) -> float:
    """λ draw of ``get_lambda`` (augmentations.py:659-666)."""
    if alpha > 0.0:
        rs = np.random.RandomState(seed)
        return float(rs.beta(alpha, alpha))
    return 1.0


def np_lambda_then_magwarp_knots(
    alpha: float, seed: int, size: int, knot: int, num_channels: int, sigma: float
) -> tuple[float, np.ndarray]:
    """λ followed by magnitude-warp knot values from the same stream.

    Replicates the durmixmagwarp ordering: ``np.random.seed(step)`` +
    ``beta(α,α)`` inside get_lambda (augmentations.py:661-663), then
    ``np.random.normal(1.0, σ, (B, knot+2, C))`` inside magnitude_warp
    (augmentations.py:677) consuming the *continuing* global stream.
    """
    rs = np.random.RandomState(seed)
    lam = float(rs.beta(alpha, alpha)) if alpha > 0.0 else 1.0
    knots = rs.normal(loc=1.0, scale=sigma, size=(size, knot + 2, num_channels))
    return lam, knots.astype(np.float32)


def np_magwarp_knots_unseeded(
    rs: np.random.RandomState, size: int, knot: int, num_channels: int, sigma: float
) -> np.ndarray:
    """Knot draws for standalone magnitudewarp/timewarp methods, which use the
    ambient NumPy stream without reseeding (augmentations.py:1043-1046)."""
    return rs.normal(loc=1.0, scale=sigma, size=(size, knot + 2, num_channels)).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# Grouped shuffles (the pairing primitive).
# ---------------------------------------------------------------------------


def grouped_shuffle(keys: Sequence, seed: int) -> np.ndarray:
    """Shuffle indices *within* groups of equal ``keys``.

    Exact reimplementation of the reference pairing pattern
    (get_same_label_mix_indices augmentations.py:500-514 and its cvd/wav/
    dataset/length/umc-subset variants :516-653): groups are keyed in order
    of first appearance, and every group is shuffled by a FRESH
    ``random.Random(seed)`` (same seed for each group — a quirk the
    reference has; we reproduce it).
    """
    size = len(keys)
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    mix = np.arange(size)
    for k in groups:
        idxs = groups[k]
        mix[idxs] = py_sample(seed, mix[idxs], len(idxs))
    return mix.astype(np.int32)

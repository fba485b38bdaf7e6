"""Mix-pair selection (counterpart: ``pcgmix_tpu/augment/pairing.py``).

Builds, on the host, the within-batch partner permutation of the mixing
methods with the reference's ``random.Random(step)`` protocol.  This slice
ports the same-label shuffle, the pairing of PCGmix and PCGmix+; the
constrained, unconstrained and latent-distance pairings come with the
methods that use them.
"""

from __future__ import annotations

import numpy as np

from pcgmix_tpu_torch import rng as prng


def same_label(labels: np.ndarray, seed: int) -> np.ndarray:
    """Shuffle within class labels (reference augmentations.py:500-514)."""
    return prng.grouped_shuffle([int(t) for t in labels], seed)


def build_pairing(spec, step: int, labels: np.ndarray) -> np.ndarray:
    """Partner indices for one batch, by ``spec.pairing``."""
    if spec.pairing == "same_label":
        return same_label(labels, step)
    raise NotImplementedError(
        f"pairing {spec.pairing!r} is not ported yet; only 'same_label' is"
    )

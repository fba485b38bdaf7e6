"""The variability counter (counterpart: ``pcgmix_tpu/train/counters.py``;
reference variability_counter_class, train_model.py:111-160).

It tracks how many distinct original samples, (sample, partner) pairs and
(sample, partner, cut) combinations augmentation has produced, for the
sample-diversity analysis.  The reference defines it and leaves its
per-step update commented out (train_model.py:578-579); here, as in the
JAX package, it is opt-in through ``TrainConfig.track_variability``.
"""

from __future__ import annotations

import numpy as np


class VariabilityCounter:
    def __init__(self, base_original: int = 0):
        self.base_original = base_original
        self.base: set = set()
        self.pairs: set = set()
        self.unique: set = set()
        self.steps: list[int] = []
        self.lens_base: list[int] = []
        self.lens_pairs: list[int] = []
        self.lens_unique: list[int] = []

    def add(self, indices, mix_indices, cut, step: int) -> None:
        """Record one batch (train_model.py:131-160): no mixing → base
        samples; mixed with itself → base; otherwise the unordered pair and
        the (ordered pair, cut) combination."""
        indices = np.asarray(indices)
        if mix_indices is None or len(mix_indices) == 0:
            self.base.update(int(i) for i in indices)
        else:
            partners = indices[np.asarray(mix_indices)]
            for a, b in zip(indices, partners):
                if a == b:
                    self.base.add(int(a))
                else:
                    self.pairs.add((min(int(a), int(b)), max(int(a), int(b))))
                    self.unique.add((int(a), int(b), cut))
        self.steps.append(step)
        self.lens_base.append(len(self.base))
        self.lens_pairs.append(len(self.pairs))
        self.lens_unique.append(len(self.unique))

    def curves(self) -> dict:
        """The cumulative counts per step, under the keys of the JAX
        package's ``variability.pkl`` (``exp/plotters.py:113-117``)."""
        return {"base": self.lens_base, "pairs": self.lens_pairs,
                "unique": self.lens_unique, "steps": self.steps}

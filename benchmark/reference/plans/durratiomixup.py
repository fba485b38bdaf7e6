"""PCGmix: ``durratiomixup`` (reference augmentations.py:289-338), λ ~ Beta(1, 1)."""

from __future__ import annotations

import numpy as np

from benchmark.reference.keepdur import beta_lambda, blend, keepdur_plan

ALPHA = 1.0


def plan(step: int, frames, labels, numbers: tuple, channels: int) -> dict:
    lam = beta_lambda(np.random.RandomState(step), ALPHA)
    return keepdur_plan(step, frames, labels, lam)


def mix(rows, plan: dict):
    return blend(rows, plan)

"""The comparison that decides ``correct``.

The program's first training steps (set-up drives them through the
window's own call, on rows that all differ) are held against the plain
reference (:mod:`benchmark.reference`) following the same steps from the
same corpus and first weights.  Each number has a limit of its own
(``limits/<cell>.json``, with the readings it was set from):

- ``plan``: entries of the host plans (batch rows, partners, λ, segment
  windows, warp knots) that differ from the reference's; exact, limit 0.
- ``mix``: the largest gap between the batch the model took (the mix
  kernel's output) and the reference's mix, over the reference's largest
  value, over the steps.
- ``loss1``: the relative gap of the first step's loss.  The later steps'
  losses are not judged: the first update moves every weight by about the
  learning rate (Adam's first step is the gradient's sign), the loss jumps
  5–20-fold, and the second and third losses swing with the rounding of
  that step (``loss_steps``).
- ``grad1_median``: per leaf, the gap between the norms of the first
  gradient as the optimizer takes it (the program's worked out from Adam's
  first moment after one step), over the larger of the reference's norm
  of that leaf and of the median leaf; the median over leaves.  The worst
  leaf (``grad1_worst``) is a BatchNorm scale or shift, whose gradient sums
  80,000–160,000 terms that cancel, so that float32 rounds it by up to
  about 1e-3 and the worst leaf swings from seed to seed.
- ``change``: the same gap of each leaf's change over the steps, as the
  next step finds it, the worst leaf.  Leaves whose raw reference gradient
  is under a thousandth of the median leaf's (a bias before a BatchNorm,
  whose gradient is nought to rounding and which Adam moves by round-off)
  are left out.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("plan", "mix", "loss1", "grad1_median", "change")
ROUNDING_LEAF = 1e-3  # a leaf whose raw gradient is under this share of the median's


def plan_mismatches(observed: list, reference: list) -> int:
    """Entries of the observed plans (dicts of arrays) that differ from the
    reference's; a missing or misshapen array counts whole."""
    bad = 0
    for got, ref in zip(observed, reference):
        for k, r in ref.items():
            r = np.asarray(r)
            g = got.get(k)
            if g is None or np.shape(g) != r.shape:
                bad += max(r.size, 1)
            else:
                bad += int(np.count_nonzero(np.asarray(g) != r))
    for ref in reference[len(observed):]:  # steps the program never planned
        bad += sum(max(np.asarray(r).size, 1) for r in ref.values())
    return bad


def _worst_leaf(got: dict, ref: dict, keep=None) -> float:
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return float("inf")
    median = float(np.median([ref[k] for k in ref]))
    worst = 0.0
    for k in names:
        g = got.get(k)
        if g is None or not np.isfinite(g):
            return float("inf")
        worst = max(worst, abs(g - ref[k]) / max(ref[k], median))
    return worst


def _median_leaf(got: dict, ref: dict, keep=None) -> float:
    """The median over leaves of the gap that :func:`_worst_leaf` takes the
    worst of."""
    names = [k for k in ref if keep is None or k in keep]
    if not names or any(got.get(k) is None for k in names):
        return float("inf")
    median = float(np.median([ref[k] for k in ref]))
    return float(np.median([abs(got[k] - ref[k]) / max(ref[k], median) for k in names]))


def readings(obs: dict, ref: dict) -> dict:
    """The numbers of an observed record against the reference's.

    Both records hold ``plans`` (list of dicts), ``mixed`` (list of
    arrays), ``losses``, ``grad1`` and ``change`` (leaf → norm); the
    reference's also ``grad1_raw``.  The judged numbers are :data:`NUMBERS`;
    the others are what the look at their spread reads."""
    mix = 0.0
    for got, want in zip(obs["mixed"], ref["mixed"]):
        scale = float(np.abs(want).max()) or 1.0
        mix = max(mix, float(np.abs(got.astype(np.float64) - want).max()) / scale)
    if len(obs["mixed"]) != len(ref["mixed"]):
        mix = float("inf")
    steps = [abs(g - r) / abs(r) for g, r in zip(obs["losses"], ref["losses"])]
    if len(steps) != len(ref["losses"]) or not np.all(np.isfinite(steps)):
        steps = [float("inf")] * len(ref["losses"])
    raw = ref["grad1_raw"]
    floor = ROUNDING_LEAF * float(np.median(list(raw.values())))
    moved = {k for k, v in raw.items() if v >= floor}
    grad1, change = obs.get("grad1") or {}, obs.get("change") or {}
    return {
        "plan": float(plan_mismatches(obs["plans"], ref["plans"])),
        "mix": mix,
        "loss1": float(steps[0]),
        "grad1_median": _median_leaf(grad1, ref["grad1"]),
        "change": _worst_leaf(change, ref["change"], moved),
        # not judged: the numbers whose spread the look read (see the docstring)
        "loss_steps": [float(x) for x in steps],
        "grad1_worst": _worst_leaf(grad1, ref["grad1"]),
        "change_median": _median_leaf(change, ref["change"], moved),
    }


def judge(values: dict, limits: dict) -> bool:
    """Every number at or under its limit (a number that is not finite
    fails)."""
    return all(np.isfinite(values[k]) and values[k] <= limit for k, limit in limits.items())

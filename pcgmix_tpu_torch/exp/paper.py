"""Headline paper-table assembly (counterpart: ``pcgmix_tpu/exp/paper.py``;
results_final_full.ipynb cells 4/17), without pandas.

The reference's final-results notebook reads pre-aggregated
``*_all_seeds_Accuracy-{mean,std}.csv`` grids (method rows x n_fraction
columns), computes each method's relative improvement over the vanilla row
with propagated error, melts everything per model, and joins the columns
into the published table layout
``N frac | Method | <model> acc | <model> ri | ...``.

Here the aggregation feeds directly from finished run dirs
(:func:`pcgmix_tpu_torch.exp.results.read_experiments_all_dataseeds`).
Tables are plain rows (:mod:`pcgmix_tpu_torch.exp.results` formats them);
the CSVs are written with the ``csv`` module in pandas' ``to_csv`` layout.
The ADSI column of the JAX package's ``paper_table`` has no producer and is
left out.
"""

from __future__ import annotations

import copy
import csv
import math
import os
from typing import Mapping, Sequence

import numpy as np

from pcgmix_tpu_torch.exp.results import read_experiments_all_dataseeds

#: display renames applied to the final table (results_final_full.ipynb cell 4)
PAPER_METHOD_RENAMES = {
    "Vanilla": "Vanilla (no aug.)",
    "PCGmix": "PCGmix (ours)",
    "PCGmix+": "PCGmix+ (ours)",
}


def propagate_error(a, da, b, db):
    """Relative error of the quotient c = a/b from the relative errors of a
    and b (results_final_full.ipynb cell 4): sqrt((da/a)^2 + (db/b)^2)."""
    a, da, b, db = (np.asarray(x, np.float64) for x in (a, da, b, db))
    return np.sqrt((da / a) ** 2 + (db / b) ** 2)


def relative_improvement_over_vanilla(
    mean: np.ndarray, std: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell relative improvement (%) of each method row over the vanilla
    row (row 0), with propagated standard deviation, rounded to 2 decimals
    as the notebook rounds them; NaN on row 0 and wherever an input is NaN.
    """
    mean = np.asarray(mean, np.float64)
    std = np.asarray(std, np.float64)
    if mean.shape != std.shape or mean.ndim != 2:
        raise ValueError(f"mean/std must be equal 2-D grids, got {mean.shape} vs {std.shape}")
    ri_mean = np.full(mean.shape, np.nan)
    ri_std = np.full(mean.shape, np.nan)
    b, db = mean[0], std[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(1, len(mean)):
            a, da = mean[i], std[i]
            re = propagate_error(a, da, b, db)
            ri_mean[i] = np.round((a / b - 1.0) * 100.0, 2)
            ri_std[i] = np.round(re * a / b * 100.0, 2)
    return ri_mean, ri_std


def method_grid(
    cfg,
    methods: Sequence[str],
    n_fractions: Sequence[float],
    metric: str = "Accuracy",
    robust: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """(n_methods, n_fractions) mean/std grids over the published seed grids;
    NaN where no finished run exists."""
    shape = (len(methods), len(n_fractions))
    mean = np.full(shape, np.nan)
    std = np.full(shape, np.nan)
    for i, method in enumerate(methods):
        run = copy.deepcopy(cfg)
        run.method = method
        res = read_experiments_all_dataseeds(run, n_fractions, metric, robust=robust)
        for j, nf in enumerate(n_fractions):
            if nf in res.n_fractions:
                k = res.n_fractions.index(nf)
                mean[i, j] = res.mean[k]
                std[i, j] = res.std[k]
    return mean, std


def _labels(methods, method_labels):
    labels = list(method_labels) if method_labels is not None else list(methods)
    if len(labels) != len(methods):
        raise ValueError("method_labels must align 1:1 with methods")
    return labels


def export_all_seeds_csvs(
    cfg,
    methods: Sequence[str],
    n_fractions: Sequence[float],
    metric: str = "Accuracy",
    out_dir: str = ".",
    robust: bool = True,
    method_labels: Sequence[str] | None = None,
    grid: tuple[np.ndarray, np.ndarray] | None = None,
) -> list[str]:
    """Write the ``{dataset}_{model}_all_seeds_{metric}-{mean,std}.csv``
    grids that results_final_full.ipynb cells 4/17 read (columns
    ``Method, <str(n_frac)>, ...``; a missing cell is empty, as pandas
    writes NaN).  ``grid``: a precomputed :func:`method_grid` result.
    Returns the two paths, mean first."""
    labels = _labels(methods, method_labels)
    os.makedirs(out_dir, exist_ok=True)
    mean, std = grid if grid is not None else method_grid(
        cfg, methods, n_fractions, metric, robust)
    paths = []
    for arr, kind in ((mean, "mean"), (std, "std")):
        path = os.path.join(
            out_dir, f"{cfg.dataset}_{cfg.model}_all_seeds_{metric}-{kind}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["Method", *(str(x) for x in n_fractions)])
            for label, row in zip(labels, np.asarray(arr, np.float64)):
                w.writerow([label, *("" if math.isnan(v) else repr(float(v))
                                     for v in row)])
        paths.append(path)
    return paths


def _pm(m: float, s: float) -> str:
    # the notebook replaces 'nan \pm nan' cells with '-'
    if math.isnan(m) or math.isnan(s):
        return "-"
    return f"{m:.2f} ± {s:.2f}"


def paper_table(
    cfg_by_model: Mapping[str, object],
    methods: Sequence[str],
    n_fractions: Sequence[float],
    metric: str = "Accuracy",
    robust: bool = True,
    method_labels: Sequence[str] | None = None,
    grids_by_model: Mapping[str, tuple] | None = None,
) -> list[dict]:
    """The published headline table (results_final_full.ipynb cells 4/17)
    straight from finished run dirs.

    cfg_by_model: display name -> TrainConfig template; ``methods[0]`` must
    be the vanilla baseline; ``method_labels`` display names per method
    (``PAPER_METHOD_RENAMES`` applied on top); ``grids_by_model`` optional
    precomputed :func:`method_grid` results.  Returns rows in the notebook's
    order (n_fraction outer, method inner) keyed
    ``N frac, Method, <model> acc, <model> ri, ...``.
    """
    labels = _labels(methods, method_labels)
    per_model = {}
    for model, cfg in cfg_by_model.items():
        if grids_by_model is not None and model in grids_by_model:
            mean, std = grids_by_model[model]
        else:
            mean, std = method_grid(cfg, methods, n_fractions, metric, robust)
        ri_m, ri_s = relative_improvement_over_vanilla(mean, std)
        per_model[model] = (mean, std, ri_m, ri_s)
    rows = []
    for j, nf in enumerate(n_fractions):
        for i, lab in enumerate(labels):
            row = {"N frac": nf, "Method": PAPER_METHOD_RENAMES.get(lab, lab)}
            for model, (mean, std, ri_m, ri_s) in per_model.items():
                row[f"{model} acc"] = _pm(mean[i, j], std[i, j])
                row[f"{model} ri"] = _pm(ri_m[i, j], ri_s[i, j])
            rows.append(row)
    return rows

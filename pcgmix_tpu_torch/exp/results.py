"""Results reading and aggregation over seed grids (counterpart:
``pcgmix_tpu/exp/results.py``).

Parity target: read_experiments.read_experiments_all_dataseeds
(read_experiments.py:10-107): for each n_fraction, iterate its seed_data
grid (and test seeds {1..5} at n_fraction 1.0 for 1-D, {1..3} for
spectrograms), read performance.pkl of finished runs, pull the final value
of the requested metric, and aggregate mean/min/max/std.

The card's machine has no pandas, so tables here are plain rows (a list of
dicts, one per table row, keys in column order) with formatters of their
own (:func:`to_markdown`, :func:`to_string`).  The values are the JAX
package's.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Sequence

import numpy as np

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.exp.dirs import experiment_already_done, experiment_dir
from pcgmix_tpu_torch.exp.robust import SEED_DATA_GRIDS, hyperparameters_robust

_METRIC_KEYS = {
    "Accuracy": ("test_accuracy", 1.0),
    "ROC AUC": ("test_rocauc", 100.0),
    "F1 score": ("test_f1", 100.0),
    "Specificity": ("test_specificity", 1.0),
    "Sensitivity": ("test_sensitivity", 1.0),
    "Precision": ("test_precision", 100.0),
    "Recall": ("test_recall", 100.0),
}


def read_performance(cfg) -> dict:
    """Load a run's performance.pkl."""
    return utils.load_dict(os.path.join(experiment_dir(cfg), "performance.pkl"))


@dataclasses.dataclass
class GridResult:
    n_fractions: list
    mean: list
    lower: list
    upper: list
    std: list
    num_runs: list


def results_table(
    cfg,
    methods: Sequence[str],
    n_fractions: Sequence[float],
    metric: str = "Accuracy",
    robust: bool = True,
) -> list[dict]:
    """Aggregate grid table: one 'mean±SD' column per method, one row per
    n_fraction — the layout of the paper's headline tables
    (results_final_full.ipynb cells 4/17).  Rows are dicts keyed
    ``n_frac, <method>, ...``."""
    rows = [{"n_frac": nf} for nf in n_fractions]
    for method in methods:
        run = copy.deepcopy(cfg)
        run.method = method
        res = read_experiments_all_dataseeds(run, n_fractions, metric, robust=robust)
        for row, nf in zip(rows, n_fractions):
            if nf in res.n_fractions:
                i = res.n_fractions.index(nf)
                row[method] = f"{res.mean[i]:.2f}±{res.std[i]:.2f}"
            else:
                row[method] = "—"
    return rows


def read_experiments_all_dataseeds(
    cfg,
    n_fractions: Sequence[float],
    metric: str = "Accuracy",
    robust: bool = True,
) -> GridResult:
    """Aggregate a method's published-grid results (read_experiments.py:10-107).

    cfg is a TrainConfig-like template; its seed_data/seed/n_fraction/method
    fields are varied over the grid; with ``robust`` (default) the '+cp'
    schedule is applied per n_fraction as the reference's reader does —
    pass robust=False to read dirs produced by ``--no-robust``.  An
    n_fraction outside the published grids falls back to the template's own
    seed_data, as ``run_grid`` does.
    """
    key, scale = _METRIC_KEYS[metric]
    spect = cfg.dataset == "PhysioNet(spec128)"
    out = GridResult([], [], [], [], [], [])
    for n_frac in n_fractions:
        if n_frac in SEED_DATA_GRIDS:
            grid_1d, grid_2d = SEED_DATA_GRIDS[n_frac]
            seed_datas = grid_2d if spect else grid_1d
        else:
            seed_datas = [cfg.seed_data]
        if n_frac == 1.0:
            seeds = [1, 2, 3] if spect else [1, 2, 3, 4, 5]
        else:
            seeds = [1]
        accs = []
        for seed_data in seed_datas:
            run = copy.deepcopy(cfg)
            run.n_fraction = n_frac
            run.seed_data = seed_data
            if robust:
                run = hyperparameters_robust(run)
            for seed in seeds:
                run.seed = seed
                if not experiment_already_done(run):
                    continue
                perf = read_performance(run)
                accs.append(perf[key][-1] * scale)
        if accs:
            out.n_fractions.append(n_frac)
            out.mean.append(float(np.mean(accs)))
            out.lower.append(float(np.min(accs)))
            out.upper.append(float(np.max(accs)))
            out.std.append(float(np.std(accs)))
            out.num_runs.append(len(accs))
    return out


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return f"{float(v):g}"
    return str(v)


def _columns(rows: list[dict]):
    """(headers, cells by column, right-aligned flags) of a row table."""
    headers = list(rows[0]) if rows else []
    cols = [[_cell(r[h]) for r in rows] for h in headers]
    numeric = [all(isinstance(r[h], (int, float, np.number)) for r in rows)
               for h in headers]
    widths = [max([len(h)] + [len(c) for c in col]) for h, col in zip(headers, cols)]
    return headers, cols, numeric, widths


def to_markdown(rows: list[dict]) -> str:
    """A pipe table of the rows: numbers right-aligned, text left-aligned."""
    headers, cols, numeric, widths = _columns(rows)

    def line(cells):
        return "| " + " | ".join(
            c.rjust(w) if num else c.ljust(w)
            for c, w, num in zip(cells, widths, numeric)) + " |"

    rule = "|" + "|".join(
        ("-" * (w + 1) + ":") if num else (":" + "-" * (w + 1))
        for w, num in zip(widths, numeric)) + "|"
    body = [line([col[i] for col in cols]) for i in range(len(rows))]
    return "\n".join([line(headers), rule, *body])


def to_string(rows: list[dict]) -> str:
    """The rows as aligned plain-text columns (a header line, then a line
    per row), for a terminal."""
    headers, cols, _, widths = _columns(rows)
    lines = [headers] + [[col[i] for col in cols] for i in range(len(rows))]
    return "\n".join("  ".join(c.rjust(w) for c, w in zip(cells, widths))
                     for cells in lines)


def main(argv=None):
    """Results-table CLI: the reference's results notebook flow
    (results_final_full.ipynb cells 4/17) as one command.

        python -m pcgmix_tpu_torch.exp.results --experiments-root experiments \\
            --methods base durratiomixup "durmixmagwarp(0.2,4)" \\
            --n-fractions 0.1 1.0 --metric Accuracy
    """
    import argparse

    from pcgmix_tpu_torch.train import TrainConfig

    ap = argparse.ArgumentParser(
        description="Aggregate finished runs into the paper's grid tables"
    )
    ap.add_argument("--experiments-root", default="experiments")
    ap.add_argument("--dataset", default="PhysioNet")
    ap.add_argument("--model", default="resnet9")
    ap.add_argument("--methods", nargs="+", required=True)
    ap.add_argument("--n-fractions", nargs="+", type=float, default=[1.0])
    ap.add_argument("--metric", default="Accuracy", choices=sorted(_METRIC_KEYS))
    ap.add_argument("--num-epochs", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr-max", type=float, default=0.01)
    ap.add_argument("--op", default="adam")
    ap.add_argument("--num-channels", type=int, default=4)
    ap.add_argument("--valid", action="store_true")
    ap.add_argument("--no-robust", action="store_true",
                    help="read dirs produced by the runner's --no-robust "
                         "(no '+cp' method rewrite)")
    ap.add_argument("--paper", action="store_true",
                    help="emit the melted paper table instead: acc ± sd and "
                         "relative improvement over the FIRST method "
                         "(results_final_full.ipynb cells 4/17)")
    ap.add_argument("--models", nargs="+", default=None,
                    help="with --paper or --export-csv: one table column "
                         "group / CSV pair per model (default: just --model)")
    ap.add_argument("--method-labels", nargs="+", default=None,
                    help="with --paper/--export-csv: display names per method "
                         "(e.g. Vanilla PCGmix PCGmix+)")
    ap.add_argument("--export-csv", metavar="DIR", default=None,
                    help="also write the notebook-input "
                         "{dataset}_{model}_all_seeds_{metric}-{mean,std}.csv "
                         "grids to DIR")
    args = ap.parse_args(argv)

    def cfg_for(model):
        return TrainConfig(
            dataset=args.dataset, model=model, num_epochs=args.num_epochs,
            batch_size=args.batch_size, lr_max=args.lr_max, op=args.op,
            num_channels=args.num_channels, valid=args.valid,
            experiments_root=args.experiments_root,
        )

    models = args.models or [args.model]
    grids = None
    if args.paper or args.export_csv:
        # aggregate the run dirs once per model, shared by table and export
        from pcgmix_tpu_torch.exp.paper import method_grid

        grids = {m: method_grid(cfg_for(m), args.methods, args.n_fractions,
                                args.metric, not args.no_robust)
                 for m in models}
    if args.paper:
        from pcgmix_tpu_torch.exp.paper import paper_table

        table = paper_table(
            {m: cfg_for(m) for m in models}, args.methods, args.n_fractions,
            args.metric, robust=not args.no_robust,
            method_labels=args.method_labels, grids_by_model=grids,
        )
    else:
        table = results_table(cfg_for(args.model), args.methods,
                              args.n_fractions, args.metric,
                              robust=not args.no_robust)
    print(to_string(table))
    if args.export_csv:
        from pcgmix_tpu_torch.exp.paper import export_all_seeds_csvs

        for m in models:
            for p in export_all_seeds_csvs(
                cfg_for(m), args.methods, args.n_fractions, args.metric,
                out_dir=args.export_csv, robust=not args.no_robust,
                method_labels=args.method_labels, grid=grids[m],
            ):
                print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

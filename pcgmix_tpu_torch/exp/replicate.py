"""Synthetic-corpus replication of the PCGmix effect on the port
(counterpart: ``scripts/replicate_synthetic.py``).

It builds :func:`pcgmix_tpu_torch.data.synthetic_effect_dict` — class
signal carried by a systolic murmur, label-independent per-recording
confounders that a small-n model memorizes — runs the mini paper grid
through :func:`pcgmix_tpu_torch.exp.runner.run_grid` (sequential runs), and
assembles the published table shape (results_final_full.ipynb cell 4: acc
mean±SD + relative improvement over vanilla with propagated error).

Grid (the reference campaign's mechanics, read_experiments.py:20-59):

* methods: base (Vanilla), durratiomixup (PCGmix), durmixmagwarp(0.2,4)
  (PCGmix+), robust '+cp' schedules applied as published;
* n_fraction 0.1: seed_datas 1010001..101000N (subset draws), seed 1 —
  where the effect lives;
* n_fraction 1.0: seed_data 1100001, seeds 1..5 — where it should fade;
* model: 1-D ResNet9, reference config (50 epochs, Adam, OneCycle 0.01,
  batch 64, grad-clip 0.1, train_balance), fp32; ``--compute-dtype
  bfloat16`` trains it in the bf16 compute mode, as the JAX script does
  (``scripts/replicate_synthetic.py:146``), into run dirs of its own
  (``replication_runs_torch_bf16``: a run dir's name does not encode the
  dtype).

Usage:
    python -m pcgmix_tpu_torch.exp.replicate                      # on the card
    python -m pcgmix_tpu_torch.exp.replicate --mini --device cpu  # CPU smoke
    python -m pcgmix_tpu_torch.exp.replicate --compute-dtype bfloat16 \
        --out artifacts/replication_synthetic_torch_bf16.md       # the JAX run's dtype

Writes ``artifacts/replication_synthetic_torch.md`` (+ the raw per-run JSON,
with the JAX script's keys) and exits 1 if the effect is absent (paired
mean improvement of PCGmix over vanilla at the low n_fraction <= 0).  The
report sets the paired deltas beside the JAX package's
``artifacts/replication_synthetic.json`` where that file exists.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
METHODS = ["base", "durratiomixup", "durmixmagwarp(0.2,4)"]
LABELS = ["Vanilla", "PCGmix", "PCGmix+"]
JAX_REPORT = REPO / "artifacts" / "replication_synthetic.json"


def per_seed_accuracies(cfg, method, n_frac, seed_datas, seeds, robust=True):
    """Final recording-level test accuracy of each finished (seed_data,
    seed) run, keyed so methods can be compared PAIRED on the same draw."""
    from pcgmix_tpu_torch.exp.dirs import experiment_already_done
    from pcgmix_tpu_torch.exp.results import read_performance
    from pcgmix_tpu_torch.exp.robust import hyperparameters_robust

    out = {}
    for sd in seed_datas:
        for seed in seeds:
            run = copy.deepcopy(cfg)
            run.method = method
            run.n_fraction = n_frac
            run.seed_data = sd
            run.seed = seed
            if robust:
                run = hyperparameters_robust(run)
            if experiment_already_done(run):
                perf = read_performance(run)
                out[(sd, seed)] = float(perf["test_accuracy"][-1])
    return out


def _card(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name where there is no card."""
    if not device.startswith("cuda"):
        return f"device {device}"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(0)} (power limit not read)"


def _t(mean, se):
    return mean / se if se and se > 0 else float("nan")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mini", action="store_true",
                    help="CPU-sized smoke: tiny corpus/model, 2 seed_datas")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on ('cpu' only when asked for)")
    ap.add_argument("--seed-datas", type=int, default=8,
                    help="number of low-n_fraction subset draws")
    ap.add_argument("--full-seeds", type=int, default=5,
                    help="number of training seeds at n_fraction 1.0")
    ap.add_argument("--segs", type=int, default=16,
                    help="cycles per recording (the JAX script's default)")
    ap.add_argument("--test-wavs", type=int, default=800,
                    help="test-set recordings (the JAX script's default)")
    ap.add_argument("--experiments-root", default=None)
    ap.add_argument("--out", default=str(
        REPO / "artifacts" / "replication_synthetic_torch.md"))
    ap.add_argument("--murmur-amp", type=float, default=0.55)
    ap.add_argument("--confounder-amp", type=float, default=1.2)
    ap.add_argument("--noise-amp", type=float, default=0.25)
    ap.add_argument("--model", default=None,
                    help="override the grid model (resnet9 | Potes)")
    ap.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="bfloat16: the bf16 compute mode the JAX script runs")
    args = ap.parse_args(argv)

    from pcgmix_tpu_torch.data import synthetic_effect_dict
    from pcgmix_tpu_torch.exp.paper import (
        method_grid, paper_table, relative_improvement_over_vanilla)
    from pcgmix_tpu_torch.exp.results import to_markdown
    from pcgmix_tpu_torch.exp.runner import run_grid
    from pcgmix_tpu_torch.train import TrainConfig
    from pcgmix_tpu_torch.train.loop import resolve_device

    resolve_device(args.device)
    if args.mini:
        corpus_kw = dict(num_wavs_train=48, num_wavs_test=24,
                         segments_per_wav=2, sig_len=640)
        model, epochs_note = "resnet9-5k", "mini"
        args.seed_datas = min(args.seed_datas, 2)
        args.full_seeds = min(args.full_seeds, 2)
    else:
        corpus_kw = dict(num_wavs_train=240, num_wavs_test=args.test_wavs,
                         segments_per_wav=args.segs, sig_len=2500)
        model, epochs_note = "resnet9", "full"
    if args.model:
        model = args.model

    dataset = synthetic_effect_dict(
        seed=7, murmur_amp=args.murmur_amp,
        confounder_amp=args.confounder_amp, noise_amp=args.noise_amp,
        **corpus_kw)

    bf16 = args.compute_dtype == "bfloat16"
    root = args.experiments_root or str(
        REPO / "artifacts" / ("replication_runs_torch" + ("_bf16" if bf16 else "")
                              + ("_mini" if args.mini else "")))
    base_cfg = TrainConfig(
        dataset="PhysioNet", model=model, experiments_root=root,
        loader_parity="numpy", save_artifacts=True, device=args.device,
        compute_dtype=args.compute_dtype,
    )
    if args.mini:
        base_cfg.num_epochs = 12
        base_cfg.batch_size = 8  # n_frac 0.1 of the mini corpus is 12 rows

    low_nf, full_nf = 0.1, 1.0
    low_sds = list(range(1010001, 1010001 + args.seed_datas))
    full_seeds = list(range(1, args.full_seeds + 1))
    robust = not args.mini
    methods = list(METHODS)
    if args.mini:
        # the robust '+cp' rewrite requires model in {resnet9, Potes};
        # mini mode bakes the cp suffix into the method strings instead
        methods = ["base", "durratiomixup+1.0", "durmixmagwarp(0.2,4)+1.0"]

    t0 = time.time()
    executed = run_grid(base_cfg, dataset, methods, [low_nf], seeds=[1],
                        seed_datas=low_sds, robust=robust)
    executed += run_grid(base_cfg, dataset, methods, [full_nf], seeds=full_seeds,
                         seed_datas=[1100001], robust=robust)
    grid_wall = time.time() - t0

    # ---- aggregate: paired per-seed + paper-shape table -------------------
    raw = {}
    for method, label in zip(methods, LABELS):
        raw[label] = {
            "low": per_seed_accuracies(
                base_cfg, method, low_nf, low_sds, [1], robust),
            "full": per_seed_accuracies(
                base_cfg, method, full_nf, [1100001], full_seeds, robust),
        }

    def paired_improvement(label):
        keys = sorted(set(raw["Vanilla"]["low"]) & set(raw[label]["low"]))
        if not keys:
            found = {k: sorted(v["low"]) for k, v in raw.items()}
            raise SystemExit(
                f"replication runs missing — no paired ({label}, Vanilla) "
                f"draws finished at n_frac {low_nf}; found: {found}"
            )
        d = np.array([raw[label]["low"][k] - raw["Vanilla"]["low"][k]
                      for k in keys])
        return d, keys

    mean, std = method_grid(base_cfg, methods, [low_nf, full_nf], robust=robust)
    ri_m, ri_s = relative_improvement_over_vanilla(mean, std)
    table = paper_table({model: base_cfg}, methods, [low_nf, full_nf],
                        robust=robust, method_labels=LABELS)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    d_mix, keys = paired_improvement("PCGmix")
    d_plus, _ = paired_improvement("PCGmix+")
    card = _card(args.device)
    lines = [
        "# Synthetic-corpus replication of the PCGmix effect (PyTorch port)",
        "",
        "Generated by `python -m pcgmix_tpu_torch.exp.replicate` "
        f"({epochs_note} config; corpus `synthetic_effect_dict` "
        f"murmur={args.murmur_amp} confounder={args.confounder_amp} "
        f"noise={args.noise_amp}; model {model}, {'bf16' if bf16 else 'fp32'}; "
        f"{len(low_sds)} subset draws at n_frac {low_nf}, "
        f"{len(full_seeds)} seeds at n_frac {full_nf}; sequential runs).",
        "",
        f"Ran on: {card}. {len(executed)} runs trained in this call, "
        f"{grid_wall:.1f} s of grid wall time.",
        "",
        "**Scope: this is a MECHANISM replication, not a paper-number "
        "replication** — the corpus is built so segment-aligned mixing "
        "provably adds information; it shows whether the port reproduces "
        "the paper's *effect* end to end.  The published PhysioNet/UMC "
        "accuracies (BASELINE.md) need the real corpora.",
        "",
        "Table shape matches results_final_full.ipynb cell 4 "
        "(acc mean±SD, relative improvement over vanilla with propagated "
        "error):",
        "",
        to_markdown(table),
        "",
        "## Paired per-draw improvement at n_frac "
        f"{low_nf} (same seed_data subset, PCGmix − Vanilla)",
        "",
        "| seed_data | Vanilla | PCGmix | Δ PCGmix | PCGmix+ | Δ PCGmix+ |",
        "|---|---|---|---|---|---|",
    ]
    for k in keys:
        v = raw["Vanilla"]["low"][k]
        m = raw["PCGmix"]["low"][k]
        p = raw["PCGmix+"]["low"].get(k, float("nan"))
        lines.append(
            f"| {k[0]} | {v:.2f} | {m:.2f} | {m - v:+.2f} | "
            f"{p:.2f} | {p - v:+.2f} |")
    effect_present = d_mix.mean() > 0

    def se_of(d):
        return d.std(ddof=1) / np.sqrt(len(d)) if len(d) > 1 else float("nan")

    def stats_line(label, d):
        se = se_of(d)
        return (f"**Paired mean Δ ({label} − Vanilla) at n_frac {low_nf}: "
                f"{d.mean():+.2f} pt (SD {d.std(ddof=1):.2f}, SE {se:.2f}, "
                f"paired t = {_t(d.mean(), se):.2f} over {len(d)} draws, "
                f"{int((d > 0).sum())}/{len(d)} draws positive).**")

    lines += [
        "",
        stats_line("PCGmix", d_mix),
        stats_line("PCGmix+", d_plus),
        "",
        ("The paired mean improvement of PCGmix over Vanilla is positive; "
         "its paired t says how far the draws support it." if effect_present else
         "**EFFECT ABSENT in this configuration** — the paired "
         "improvement is not positive."),
    ]
    if JAX_REPORT.exists() and not args.mini:
        ref = json.loads(JAX_REPORT.read_text())
        lines += [
            "",
            "## Beside the JAX package's run",
            "",
            "`artifacts/replication_synthetic.json` (the JAX package, bf16, "
            "on a TPU; its own draw count) against this run:",
            "",
            "| | draws | Δ PCGmix | t | positive | Δ PCGmix+ | t | positive |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for name, r in (("JAX package", ref), ("this run", None)):
            if r is None:
                r = {"n_draws": len(d_mix),
                     "paired_mean_delta_pcgmix": float(d_mix.mean()),
                     "paired_se_pcgmix": float(se_of(d_mix)),
                     "draws_positive_pcgmix": int((d_mix > 0).sum()),
                     "paired_mean_delta_pcgmixplus": float(d_plus.mean()),
                     "paired_se_pcgmixplus": float(se_of(d_plus)),
                     "draws_positive_pcgmixplus": int((d_plus > 0).sum())}
            n = r["n_draws"]
            lines.append(
                f"| {name} | {n} "
                f"| {r['paired_mean_delta_pcgmix']:+.2f} "
                f"| {_t(r['paired_mean_delta_pcgmix'], r['paired_se_pcgmix']):.2f} "
                f"| {r['draws_positive_pcgmix']}/{n} "
                f"| {r['paired_mean_delta_pcgmixplus']:+.2f} "
                f"| {_t(r['paired_mean_delta_pcgmixplus'], r['paired_se_pcgmixplus']):.2f} "
                f"| {r['draws_positive_pcgmixplus']}/{n} |")
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(args.out.replace(".md", ".json"), "w") as f:
        json.dump({
            "raw": {k: {"low": {f"{a}/{b}": v for (a, b), v in d["low"].items()},
                        "full": {f"{a}/{b}": v for (a, b), v in d["full"].items()}}
                    for k, d in raw.items()},
            "paired_mean_delta_pcgmix": float(d_mix.mean()),
            "paired_mean_delta_pcgmixplus": float(d_plus.mean()),
            "paired_se_pcgmix": float(d_mix.std(ddof=1) / np.sqrt(len(d_mix))),
            "paired_se_pcgmixplus": float(
                d_plus.std(ddof=1) / np.sqrt(len(d_plus))),
            "draws_positive_pcgmix": int((d_mix > 0).sum()),
            "draws_positive_pcgmixplus": int((d_plus > 0).sum()),
            "n_draws": len(d_mix),
            "mean_grid": mean.tolist(), "std_grid": std.tolist(),
            "ri_mean": ri_m.tolist(), "ri_std": ri_s.tolist(),
        }, f, indent=1)
    print("\n".join(lines))

    if d_mix.mean() <= 0:
        print("\nEFFECT ABSENT: paired PCGmix improvement <= 0", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

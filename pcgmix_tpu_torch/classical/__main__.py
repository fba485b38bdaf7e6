"""The classical pipeline's CLI on the port: features → prune → aggregate
→ classifier bench.

    python -m pcgmix_tpu_torch.classical --dataset-file zbytes_physionet.dat \
        --out-dir classical_out [--device cpu]

Writes ``features.csv`` (one row a segment) and ``aggregated.csv`` (one row
a recording window) into ``--out-dir``, byte-equal to what ``python -m
pcgmix_tpu.classical`` writes there for the same arguments, then benches
the eight classifiers on ``aggregated.csv`` (``run_experiment``: the
mutual-information selection, Gaussian NB and k-NN on the card unless
``--device cpu``; the trees, SGD, SVC and logistic regression on the host)
and writes ``results.csv``, one metrics row a classifier, with the JAX
CLI's columns and rows; the table goes to stdout as well.

Resume: a ``features.csv`` in ``--out-dir`` is loaded as it is.  A crashed
extraction leaves ``features.partial.csv`` (written every 2,000 segments);
a rerun refuses it unless ``--start-counter`` says where to resume, and
then folds it in (keyed on wav, segment and split) after saving it as
``features.partial.prev.csv``, so that a third run after a second crash
folds both checkpoints in.  The checkpoints are removed once
``features.csv`` is written.
"""

from __future__ import annotations

import argparse
import os
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pcgmix_tpu_torch.classical",
        description="PCG classical-ML pipeline: features, pruning, aggregation and the "
                    "classifier bench",
    )
    ap.add_argument("--dataset-file", required=True,
                    help="packed dataset dict (.dat from pcgmix-torch-build)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--band", default="25-400",
                    help="signal band used for feature extraction (classical.py:49-55)")
    ap.add_argument("--window", type=int, default=2,
                    help="rolling aggregation window; 0 = single-vector per recording")
    ap.add_argument("--no-prune", action="store_true",
                    help="skip the mean-envelope segment outlier removal")
    ap.add_argument("--std-factor", type=float, default=1.4)
    ap.add_argument("--kb-num", type=int, default=40,
                    help="mutual-information top-K feature count")
    ap.add_argument("--seed", type=int, default=4, help="the bench's seed")
    ap.add_argument("--start-counter", type=int, default=0,
                    help="resume feature extraction from this segment counter "
                         "(classical.py:71)")
    ap.add_argument("--skip", type=int, nargs="*", default=(),
                    help="segment counters to skip (classical.py:87)")
    ap.add_argument("--train-wavs", default=None,
                    help="txt of train recordings to keep in the bench (an n_fraction "
                         "subset file, classical.py:1424-1428)")
    ap.add_argument("--export-subsets", nargs="*", type=float, default=None,
                    metavar="NFRAC",
                    help="instead, write the per-(seed_data, n_fraction) train-wav "
                         "subset files for these n_fractions into --out-dir "
                         "(classical.ipynb cell 21) and exit")
    ap.add_argument("--device", default="cuda",
                    help="where the bench's mutual information, Gaussian NB and k-NN run "
                         "(cpu: on the CPU)")
    return ap


def _without(table, keys, other):
    """The rows of ``table`` whose (wav, segment, split) ``other`` lacks."""
    import numpy as np

    have = set(other.keys(keys))
    return table.take(np.array([k not in have for k in table.keys(keys)], dtype=bool))


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from pcgmix_tpu_torch import utils
    from pcgmix_tpu_torch.classical.experiment import (
        aggregate_features_rolling,
        aggregate_features_single,
        export_nfrac_wav_subsets,
        remove_segments_mean_envelope,
        run_experiment,
    )
    from pcgmix_tpu_torch.classical.features import extract_features
    from pcgmix_tpu_torch.classical.table import Table, concat
    from pcgmix_tpu_torch.train.loop import resolve_device

    if args.export_subsets is not None:
        dataset = utils.file2dict(args.dataset_file)
        paths = export_nfrac_wav_subsets(dataset, args.out_dir, args.export_subsets)
        print(f"wrote {len(paths)} subset files to {args.out_dir}", file=sys.stderr)
        return 0

    resolve_device(args.device)  # before the extraction: "cuda" without a card raises
    keys = ["wav", "segment", "split"]
    os.makedirs(args.out_dir, exist_ok=True)
    feats_path = os.path.join(args.out_dir, "features.csv")
    partial_path = os.path.join(args.out_dir, "features.partial.csv")
    prev_path = os.path.join(args.out_dir, "features.partial.prev.csv")
    if os.path.exists(feats_path):
        print(f"resume: loading existing {feats_path}", file=sys.stderr)
        feats = Table.read_csv(feats_path)
    else:
        if os.path.exists(partial_path) and not args.start_counter:
            with open(partial_path) as f:
                n = sum(1 for _ in f) - 1
            raise SystemExit(
                f"{partial_path} holds a partial extraction ({n} segments). "
                f"Re-run with --start-counter to resume past it, or delete "
                f"it to start over."
            )
        prev = None
        if args.start_counter and os.path.exists(partial_path):
            prev = Table.read_csv(partial_path)
            if os.path.exists(prev_path):
                older = Table.read_csv(prev_path)
                prev = concat([_without(older, keys, prev), prev])
            # the re-extraction overwrites features.partial.csv with the new
            # rows only: keep the merged history for a second crash
            prev.to_csv(prev_path)
        dataset = utils.file2dict(args.dataset_file)
        splits = [s for s in ("train", "test") if s in dataset]
        feats = Table.from_rows(extract_features(
            dataset, splits=splits, band=args.band, start_counter=args.start_counter,
            skip=args.skip, save_path=partial_path))
        if prev is not None:
            feats = concat([_without(prev, keys, feats), feats])
        feats.to_csv(feats_path)
        for stale in (partial_path, prev_path):
            if os.path.exists(stale):
                os.remove(stale)
    print(f"{len(feats)} segments x {len(feats.columns)} columns", file=sys.stderr)

    if not args.no_prune:
        feats = remove_segments_mean_envelope(feats, std_factor=args.std_factor)
        print(f"after envelope pruning: {len(feats)} segments", file=sys.stderr)
    agg = (aggregate_features_rolling(feats, window=args.window) if args.window > 0
           else aggregate_features_single(feats))
    agg.to_csv(os.path.join(args.out_dir, "aggregated.csv"))

    train_wavs = None
    if args.train_wavs:
        with open(args.train_wavs) as f:
            train_wavs = [ln.strip() for ln in f if ln.strip()]
        print(f"n_fraction subset: {len(train_wavs)} train recordings", file=sys.stderr)
    results = run_experiment(agg, kb_num=args.kb_num, seed=args.seed, train_wavs=train_wavs,
                             device=args.device)
    results.to_csv(os.path.join(args.out_dir, "results.csv"))
    print(format_results(results))
    return 0


def format_results(results) -> str:
    """The metrics table as aligned text, one classifier a line."""
    cols = results.columns
    cells = [[str(v) if c == "Classifier" else f"{v:.6f}" for v in results[c].tolist()]
             for c in cols]
    widths = [max(len(c), *(len(v) for v in col)) for c, col in zip(cols, cells)]
    lines = ["  ".join(c.rjust(w) for c, w in zip(cols, widths))]
    lines += ["  ".join(col[i].rjust(w) for col, w in zip(cells, widths))
              for i in range(len(results))]
    return "\n".join(lines)


if __name__ == "__main__":
    raise SystemExit(main())

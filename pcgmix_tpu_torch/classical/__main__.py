"""The classical pipeline's CLI on the port: features → prune → aggregate.

    python -m pcgmix_tpu_torch.classical --dataset-file zbytes_physionet.dat \
        --out-dir classical_out

Writes ``features.csv`` (one row a segment) and ``aggregated.csv`` (one row
a recording window) into ``--out-dir``, byte-equal to what ``python -m
pcgmix_tpu.classical`` writes there for the same arguments.  The classifier
bench needs sklearn, which the GPU machine lacks: the CLI ends by printing,
on stderr, the JAX package's command with the same arguments, which finds
this ``features.csv`` and writes ``results.csv`` from it.

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
import shlex
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pcgmix_tpu_torch.classical",
        description="PCG classical-ML pipeline: features, pruning and aggregation "
                    "(the sklearn bench runs with python -m pcgmix_tpu.classical)",
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
                    help="mutual-information top-K feature count (passed on to the "
                         "bench's command)")
    ap.add_argument("--seed", type=int, default=4,
                    help="the bench's seed (passed on to its command)")
    ap.add_argument("--start-counter", type=int, default=0,
                    help="resume feature extraction from this segment counter "
                         "(classical.py:71)")
    ap.add_argument("--skip", type=int, nargs="*", default=(),
                    help="segment counters to skip (classical.py:87)")
    ap.add_argument("--train-wavs", default=None,
                    help="txt of train recordings to keep in the bench (an n_fraction "
                         "subset file; passed on to the bench's command)")
    ap.add_argument("--export-subsets", nargs="*", type=float, default=None,
                    metavar="NFRAC",
                    help="instead, write the per-(seed_data, n_fraction) train-wav "
                         "subset files for these n_fractions into --out-dir "
                         "(classical.ipynb cell 21) and exit")
    return ap


def _without(table, keys, other):
    """The rows of ``table`` whose (wav, segment, split) ``other`` lacks."""
    import numpy as np

    have = set(other.keys(keys))
    return table.take(np.array([k not in have for k in table.keys(keys)], dtype=bool))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)

    from pcgmix_tpu_torch import utils
    from pcgmix_tpu_torch.classical.experiment import (
        aggregate_features_rolling,
        aggregate_features_single,
        export_nfrac_wav_subsets,
        remove_segments_mean_envelope,
    )
    from pcgmix_tpu_torch.classical.features import extract_features
    from pcgmix_tpu_torch.classical.table import Table, concat

    if args.export_subsets is not None:
        dataset = utils.file2dict(args.dataset_file)
        paths = export_nfrac_wav_subsets(dataset, args.out_dir, args.export_subsets)
        print(f"wrote {len(paths)} subset files to {args.out_dir}", file=sys.stderr)
        return 0

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
    print(f"classifier bench (sklearn; writes results.csv from this features.csv): "
          f"{bench_command(argv)}", file=sys.stderr)
    return 0


def bench_command(argv: list) -> str:
    """The JAX package's CLI with the same arguments: it loads the
    ``features.csv`` found in ``--out-dir`` and runs the classifier bench."""
    return shlex.join(["python", "-m", "pcgmix_tpu.classical", *argv])


if __name__ == "__main__":
    raise SystemExit(main())

"""The readings that the limits of ``correct`` are set from (run on the card,
at the cell's own size; the benchmark's runs never run this).

    python3 benchmark/calibrate.py --workload <name> --seeds 101-112 \
        [--controls 3] [--out build/calibrate.jsonl]

For each seed the program's first steps are held against the reference,
with no measured window: the lower readings.  On the first ``--controls``
seeds, also the upper ones: the reference computed with TF32 operands put
in the program's place (the nearest precision below the configuration's
float32 with TF32 off), the program with ``compute_dtype="bfloat16"``, and
each fault of :mod:`benchmark.faults`.  One JSON line a reading goes to
``--out`` and to standard output.
"""

from __future__ import annotations

import json
import os
import sys
import time


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,13")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default="build/calibrate.jsonl")
    p.add_argument("--leaves", action="store_true",
                   help="also each leaf's norms, the program's and the reference's")
    args = p.parse_args(argv)

    import torch

    from benchmark import check, faults, harness, inputs
    from benchmark.reference import common

    if not torch.cuda.is_available():
        harness.log("calibration runs on a CUDA card")
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # a limit of +inf: every reading is recorded, none judged
    open_limits = {k: float("inf") for k in (*check.NUMBERS, "launches")}

    def emit(kind: str, seed: int, values: dict, **extra) -> None:
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                           "values": values, **extra})
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    def program(seed, kind, **kw):
        t = time.perf_counter()
        out = harness.measure(cell, seed, 0.0, False, device, limits=open_limits, **kw)
        extra = {}
        if args.leaves:
            o, r = out["_observed"], out["_reference"]
            extra = {"leaves": {k: [(o["grad1"] or {}).get(k), r["grad1"][k], r["grad1_raw"][k],
                                    o["change"].get(k), r["change"][k]] for k in r["change"]},
                     "losses": [o["losses"], r["losses"]]}
        emit(kind, seed, out["_values"], seconds=time.perf_counter() - t, **extra)
        return out

    for i, seed in enumerate(seeds_of(args.seeds)):
        out = program(seed, "program")
        if i >= args.controls:
            continue
        t = time.perf_counter()
        dataset = inputs.make_dataset(cell.config, cell.traffic, seed, device)
        weights = {k: v.cpu() for k, v in inputs.make_weights(cell.config, seed, device).items()}
        control = harness.reference_record(cell, dataset, weights, device,
                                           common.Ops(tf32=True))
        emit("control_tf32", seed, check.readings(control, out["_reference"]),
             seconds=time.perf_counter() - t)
        del dataset, control
        program(seed, "control_bf16", compute_dtype="bfloat16")
        for name, fault in faults.FAULTS.items():
            program(seed, f"fault_{name}", faults=(fault,))
    return 0


if __name__ == "__main__":
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]
    sys.path.insert(0, os.path.dirname(_here))
    sys.exit(main())

"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(there is no CPU fallback).  With ``--trace 0`` the result carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, the
device's busy seconds and a breakdown.  The last line of standard output
is the result (JSON); the last lines of standard error, and the result's
``checks``, give each number compared with its limit.  The exit code is
not 0, and no result is printed, when a card is missing, when the run
fails, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _offset() -> float:
    """The process's age minus ``time.perf_counter()``."""
    from benchmark.harness import process_seconds

    return process_seconds() - time.perf_counter()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    offset = _offset()

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} CUDA card(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    torch.set_num_threads(2)
    out = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), clock_offset=offset)
    bad = sorted(set(out["_forbidden"]) | set(harness.forbidden_modules()))
    if bad:
        harness.log(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    for name, c in out["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(harness.result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    # run as a script, the benchmark's own folder leads sys.path, where its
    # module names would shadow others (``trace``): the checkout's root
    # takes its place
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]
    sys.path.insert(0, os.path.dirname(_here))
    sys.exit(main())

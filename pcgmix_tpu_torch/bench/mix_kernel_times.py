"""Device time of the mix kernels K1–K4 at the main path's shape, through
their public wrappers, on the card.

    python -m pcgmix_tpu_torch.bench.mix_kernel_times [--windows N] [--reps R]

B=64, C=4, T=2500, fp32, plans from the engine (PCGmix for K1/K3, PCGmix+
for K2/K4), as in chip_smoke.py's phase 2.  Each wrapper is timed by the
profiler's kernel time over ``reps`` calls and by CUDA events around
windows of ``reps`` back-to-back calls (queued behind a device sleep).
K1 is timed both ways it is called: ``k1_pairs`` with an explicit row
index (idx1 = arange) and ``k1_batch`` without one
(``piecewise_mix_batch``, the main path's call where the package has it).

The wrappers' signatures are shared by every version of the package, so
the script also times another checkout's kernels: run it as a file with
that checkout first on the path,

    PYTHONPATH=<checkout> python pcgmix_tpu_torch/bench/mix_kernel_times.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

B, C, T = 64, 4, 2500


def main_path_inputs(device, method: str):
    """The main path's batch and a plan of ``method`` on ``device``."""
    from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
    from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict

    ds = synthetic_physionet_dict(num_wavs_train=36, num_wavs_test=12,
                                  segments_per_wav=8, sig_len=T, seed=11)
    split = physionet_split(ds, "train")
    plan = AugmentEngine(AugmentConfig(method, B, C, T)).plan(
        7, split.frames[:B], split.label[:B])
    x = torch.from_numpy(split.data[:B]).to(device)
    return x, AugmentEngine.device_arrays(plan.arrays, device)


def arms(device) -> dict:
    """name → a closure that launches one kernel on the main path's inputs."""
    from pcgmix_tpu_torch.ops import mix_kernels as mk

    x, p = main_path_inputs(device, "durratiomixup")
    _, q = main_path_inputs(device, "durmixmagwarp(0.2,4)")
    pieces = lambda a: (a["dst"], a["src"], a["len"], a["sel"], a["alpha"])
    idn = torch.arange(B, dtype=torch.int32, device=device)
    d2p, d2q = (x.index_select(0, a["mix"].long()) for a in (p, q))
    out = {
        "k1_pairs": lambda: mk.piecewise_mix_pairs(x, idn, p["mix"], *pieces(p)),
        "k2": lambda: mk.pcgmix_plus_fused(x, q["mix"], *pieces(q), q["knots"]),
        "k3": lambda: mk.piecewise_mix_prepaired(x, d2p, *pieces(p)),
        "k4": lambda: mk.pcgmix_plus_fused_prepaired(x, d2q, *pieces(q), q["knots"]),
    }
    if hasattr(mk, "piecewise_mix_batch"):
        out["k1_batch"] = lambda: mk.piecewise_mix_batch(x, p["mix"], *pieces(p))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=9)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mix_kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    from pcgmix_tpu_torch.bench.conv_bn_fused import (
        card_name,
        kernel_reading,
        kernel_times,
        reading_text,
        time_ms,
    )

    card = card_name()
    report = {}
    for name, fn in arms(torch.device("cuda")).items():
        ms = statistics.median(time_ms(fn, args.windows, args.reps))
        # each arm launches one mix_warp_kernel a call
        kernel_us, events = kernel_reading(kernel_times(fn, args.reps), "mix_warp_kernel",
                                           args.reps)
        report[name] = {"ms": ms, "kernel_us": kernel_us}
        print(f"{name}: profiler kernel time {reading_text(kernel_us, events, args.reps)}, "
              f"{ms * 1e3:.3f} us a call in windows of {args.reps}, on {card}", flush=True)
    print(json.dumps({"card": card, "shape": [B, C, T], "arms": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

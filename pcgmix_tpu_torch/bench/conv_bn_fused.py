"""Does fusing BatchNorm's statistics into the k=3 conv pay on this card?
(counterpart: ``scripts/bench_conv_bn_fused.py``, whose Pallas kernel K5
``ops/conv_bn.py`` ports.)

    python -m pcgmix_tpu_torch.bench.conv_bn_fused [--windows N] [--reps R] [--profile]
    python -m pcgmix_tpu_torch.bench.conv_bn_fused --check

Two shapes, the full-width ResNet9 layers at T = 2500 that carry most of
its conv FLOPs: res2a 64×312×512→512 and conv3 64×1250×128→256, x in NWC,
w in WIO, bf16, from a numpy seed.  Arms, each timed with CUDA events over
``--windows`` windows of ``--reps`` calls, every window queued behind a
device sleep so host launch overhead stays out (median and min per call,
TFLOP/s at the min, spread):

  cudnn_conv            F.conv1d in bf16 on the same data in the layout
                        cuDNN takes (NCW, OIW; transposed outside the
                        timed window): the yardstick for the conv alone
  cudnn_conv_stats      the same plus fp32 Σy and Σy² over (B, T), what
                        BatchNorm's training forward adds
  kernel_conv           K5 without stats
  kernel_fused          K5 with stats
  plain                 K5's plain PyTorch version (fp32 matmuls)
  cudnn_conv_stats_ctrl cudnn_conv_stats again, a trailing control for
                        drift within the run

``--profile`` adds, per shape, the device time of each kernel that K5
with stats and without launches (torch.profiler): the conv kernel and the
second pass over the statistics' partial sums.

Decision rule (the script's :19-21): if kernel_fused cannot beat
cudnn_conv_stats, fusing the statistics into the conv does not pay yet on
this card.  The cuDNN arms are yardsticks, timed here and in chip_smoke.py
only; the port never calls them.

Before timing, every shape (and a small odd one) holds K5 against its
plain version on the card (:func:`check_against_plain`).  ``--check`` runs
only the plain version, on the CPU, against ``F.conv1d`` in fp32.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from pcgmix_tpu_torch.ops.conv_bn import conv3_acc_plain, conv3_bn_stats, conv3_bn_stats_plain

SHAPES = {"res2a": (64, 312, 512, 512), "conv3": (64, 1250, 128, 256)}
SMALL_ODD = (3, 37, 44, 70)  # ragged M and N edges, Cin not a multiple of 8
ARMS = ("cudnn_conv", "cudnn_conv_stats", "kernel_conv", "kernel_fused", "plain",
        "cudnn_conv_stats_ctrl")

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# dense bf16 tensor-core FLOP/s and device-memory bytes/s.
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

# y against the plain version: one bf16 ulp of the larger magnitude, plus
# fp32 accumulation error where the sum cancels: the kernel and the plain
# version add the 3·Cin products in other orders, each product is exact,
# and the difference is bounded by 256 fp32 units (2^-24 each) of Σ|x·w|
# for the element (the worst case for 3·Cin = 1536 terms is 1536 units, a
# random walk about 40).
Y_ACC_UNITS = 2.0 ** -16


def work(B: int, T: int, Cin: int, Cout: int) -> tuple[int, int]:
    """(FLOP, bytes) of one call: 2·M·N·K multiply-adds; x and y moved
    once, w once, and the two fp32 statistics."""
    flops = 2 * B * T * Cin * Cout * 3
    nbytes = 2 * (B * T * Cin + B * T * Cout + 3 * Cin * Cout) + 2 * 4 * Cout
    return flops, nbytes


def bound(B: int, T: int, Cin: int, Cout: int) -> tuple[float, str]:
    """The least time on an H100 SXM, in ms, and what bounds it."""
    flops, nbytes = work(B, T, Cin, Cout)
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def inputs(B: int, T: int, Cin: int, Cout: int, device, seed: int = 0):
    """x (B, T, Cin) and w (3, Cin, Cout), bf16, from a numpy seed (the
    script's scales: standard normal x, 0.05·normal w)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, Cin), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, Cin, Cout), np.float32) * 0.05)
    return x.bfloat16().to(device), w.bfloat16().to(device)


def compare(y, s1, s2, acc, x, w) -> dict:
    """Errors of (y, s1, s2) against the fp32 accumulator ``acc`` of the
    same inputs, beside their bars:

    - y: |Δ| ≤ 2^-7·max(|y|, |y_ref|) + 2^-16·Σ|x·w| (see Y_ACC_UNITS);
      how many elements need the second term is reported too;
    - s1: |Δ| ≤ 1e-5·Σ|acc| per column, since s1 can cancel;
    - s2: relative 1e-5."""
    y_ref = acc.to(torch.bfloat16).float()
    yf = y.float()
    d = (yf - y_ref).abs()
    ulp = torch.maximum(yf.abs(), y_ref.abs()) * 2.0 ** -7
    absacc = conv3_acc_plain(x.abs(), w.abs())
    out = {"y_max_abs_err": d.max().item(),
           "y_n_diff": int((d > 0).sum().item()),
           "y_n_over_one_ulp": int((d > ulp).sum().item()),
           "y_n": d.numel(),
           "y_ok": bool((d <= ulp + Y_ACC_UNITS * absacc).all().item())}
    if s1 is not None:
        r1 = ((s1 - acc.sum((0, 1))).abs() / acc.abs().sum((0, 1))).max().item()
        s2_ref = (acc * acc).sum((0, 1))
        r2 = ((s2 - s2_ref).abs() / s2_ref.abs()).max().item()
        out.update(s1_err_per_abs_sum=r1, s2_rel_err=r2,
                   stats_ok=r1 <= 1e-5 and r2 <= 1e-5)
    return out


def check_against_plain(x, w) -> dict:
    """K5 (the wrapper on x's device) against its plain version: the bars
    of :func:`compare`, and y without stats bit-equal to y with them.
    Raises AssertionError on a miss; returns the errors."""
    y, s1, s2 = conv3_bn_stats(x, w)
    y_conv, none1, none2 = conv3_bn_stats(x, w, with_stats=False)
    errs = compare(y, s1, s2, conv3_acc_plain(x, w), x, w)
    errs["no_stats_bit_equal"] = bool(torch.equal(y, y_conv)) and none1 is none2 is None
    if not (errs["y_ok"] and errs["stats_ok"] and errs["no_stats_bit_equal"]):
        raise AssertionError(f"K5 disagrees with its plain version at "
                             f"{tuple(x.shape)}→{w.shape[2]}: {errs}")
    return errs


def make_arms(x, w) -> dict:
    """The arms as zero-argument callables on (x, w); the cuDNN layout is
    made here, outside any timed window."""
    x_ncw = x.permute(0, 2, 1).contiguous()
    w_oiw = w.permute(2, 1, 0).contiguous()

    def cudnn_conv():
        return F.conv1d(x_ncw, w_oiw, padding=1)

    def cudnn_conv_stats():
        y = cudnn_conv()
        yf = y.float()
        return y, yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))

    arms = {"cudnn_conv": cudnn_conv, "cudnn_conv_stats": cudnn_conv_stats,
            "kernel_conv": lambda: conv3_bn_stats(x, w, with_stats=False),
            "kernel_fused": lambda: conv3_bn_stats(x, w),
            "plain": lambda: conv3_bn_stats_plain(x, w)}
    arms["cudnn_conv_stats_ctrl"] = cudnn_conv_stats
    return arms


def time_ms(fn, windows: int, reps: int, sleep_cycles: int = 20_000_000) -> list:
    """Device time per call of ``fn`` in each of ``windows`` windows of
    ``reps`` calls (CUDA events; each window queued behind a device sleep)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def kernel_times(fn, reps: int) -> dict:
    """{kernel: (device ms per call, events)} of each kernel in
    torch.profiler's trace of ``reps`` calls of ``fn``
    (:func:`event_times`); read it with :func:`kernel_reading`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return event_times(prof.key_averages(), reps)


def event_times(events, reps: int) -> dict:
    """{key: (self device ms per call, event count)} of the profiler's
    ``key_averages()`` over ``reps`` calls."""
    return {e.key: (e.self_device_time_total / reps / 1e3, e.count) for e in events}


def kernel_reading(times: dict, kernel: str, expected: int) -> tuple:
    """(device µs per call, events) of the kernels whose name holds
    ``kernel`` in :func:`kernel_times`' ``times``, and only those: the µs
    are None unless the trace holds exactly ``expected`` events of them
    (the calls times the launches a call makes) with device time, since a
    trace that lost or gained events reads a wrong time."""
    hits = [v for k, v in times.items() if kernel in k]
    events = sum(n for _, n in hits)
    total = sum(ms for ms, _ in hits)
    if events != expected or total <= 0:
        return None, events
    return total * 1e3, events


def reading_text(us, events: int, expected: int) -> str:
    """A :func:`kernel_reading` for a report line."""
    if us is None:
        return f"not measured ({events} of {expected} events)"
    return f"{us:.3f} us"


def bench_shape(tag: str, shape, windows: int, reps: int, device,
                profile: bool = False) -> dict:
    """Every arm at one shape; prints a line per arm and the decision
    (with ``profile``, also K5's device time per kernel)."""
    x, w = inputs(*shape, device)
    flops, nbytes = work(*shape)
    bound_ms, bound_by = bound(*shape)
    out = {"shape": list(shape), "flop": flops, "bytes": nbytes,
           "bound_ms": bound_ms, "bound_by": bound_by, "arms": {}}

    def timed(fn):
        t = time_ms(fn, windows, reps)
        med, lo = statistics.median(t), min(t)
        return {"ms": med, "min_ms": lo, "tflops_at_min": flops / (lo * 1e-3) / 1e12,
                "spread_pct": 100 * (max(t) - lo) / med}

    arms = make_arms(x, w)
    for name, fn in arms.items():
        out["arms"][name] = r = timed(fn)
        print(f"{tag} {name}: {r}", flush=True)
    for name in ("kernel_conv", "kernel_fused") if profile else ():
        times = kernel_times(arms[name], reps)
        under_test = ("conv3_kernel", "stats_reduce_kernel") if name == "kernel_fused" else (
            "conv3_kernel",)
        r = {}
        for kernel in under_test:  # each launched once a call
            us, events = kernel_reading(times, kernel, reps)
            r[kernel] = None if us is None else us / 1e3
            print(f"{tag} {name} {kernel}: {reading_text(us, events, reps)} a call",
                  flush=True)
        out[f"{name}_kernels_ms"] = r
    a = out["arms"]
    fused, yard = a["kernel_fused"]["min_ms"], a["cudnn_conv_stats"]["min_ms"]
    out["fused_beats_cudnn_conv_stats"] = fused < yard
    print(f"{tag} decision: kernel_fused {fused:.6f} ms "
          f"{'beats' if fused < yard else 'does not beat'} cudnn_conv_stats "
          f"{yard:.6f} ms (x{fused / yard:.3f}); kernel_conv / cudnn_conv "
          f"x{a['kernel_conv']['min_ms'] / a['cudnn_conv']['min_ms']:.3f}; bound "
          f"{bound_ms:.6f} ms ({bound_by})", flush=True)
    return out


def card_name() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def check_plain_on_cpu() -> dict:
    """The plain version on the CPU against F.conv1d in fp32, at the
    script's check shape (B=4, T=96, Cin=Cout=128)."""
    x, w = inputs(4, 96, 128, 128, "cpu")
    acc = F.conv1d(x.float().permute(0, 2, 1), w.float().permute(2, 1, 0),
                   padding=1).permute(0, 2, 1)
    y, s1, s2 = conv3_bn_stats_plain(x, w)
    errs = compare(y, s1, s2, acc, x, w)
    if not (errs["y_ok"] and errs["stats_ok"]):
        raise AssertionError(f"the plain version disagrees with F.conv1d: {errs}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check", action="store_true",
                    help="the plain version against F.conv1d on the CPU only")
    ap.add_argument("--profile", action="store_true",
                    help="also K5's device time per kernel (torch.profiler)")
    args = ap.parse_args(argv)
    if args.check:
        print(json.dumps({"check": "ok", **check_plain_on_cpu()}))
        return 0
    if not torch.cuda.is_available():
        print("conv_bn_fused: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_name()
    print(card)
    out = {"device": torch.cuda.get_device_name(0), "card": card, "check": {}}
    for tag, shape in (("small_odd", SMALL_ODD), *SHAPES.items()):
        out["check"][tag] = errs = check_against_plain(*inputs(*shape, dev))
        print(f"{tag} check: {errs}", flush=True)
    for tag, shape in SHAPES.items():
        out[tag] = bench_shape(tag, shape, args.windows, args.reps, dev, args.profile)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

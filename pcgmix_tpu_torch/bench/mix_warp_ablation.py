"""Where K2's time goes: the warp kernel beside copies of itself with one
step taken out, and beside K1 on the same kernel body, at the main path's
shape, on the card.

    python -m pcgmix_tpu_torch.bench.mix_warp_ablation [--windows N] [--reps R]

Each ablation is ``ops/csrc/mix_kernels.cu`` with a few lines replaced
(``ABLATIONS``), built with nvcc into a library of its own under
``build/`` and called through K2's C entry point on the main path's
inputs (B=64, C=4, T=2500, fp32, a PCGmix+ plan from the engine).  The
ablations' outputs are wrong by design: they measure what a step costs.
The ``k1`` arm calls K1's entry point in the unedited library as the main
path does (no row index, a PCGmix plan), the body's instantiation without
the envelope, beside ``no_envelope``; ``k1_64_threads`` does so in the
64-thread library.
Each is timed by CUDA events around windows of back-to-back calls (queued
behind a device sleep) and by the profiler's kernel time; beside them a
one-element ``zero_()`` and a device copy of the batch, which moves K2's
bytes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys

import torch

from pcgmix_tpu_torch.bench.conv_bn_fused import (
    card_name,
    kernel_reading,
    kernel_times,
    reading_text,
    time_ms,
)
from pcgmix_tpu_torch.bench.mix_kernel_times import B, C, T, main_path_inputs
from pcgmix_tpu_torch.ops import build
from pcgmix_tpu_torch.ops.mix_kernels import WARP_BASIS_CHUNK, warp_basis

_SOURCE_LOAD = "? ldg_f32(srow[v], (int64_t)(c0 + g) * Tlen + ti[v])"
_NO_SOURCE_LOAD = (_SOURCE_LOAD, "? x1[g][v]")
_NO_ENVELOPE = ("y[v] = __fmul_rn(val, w[g][v]);", "y[v] = val;")
ABLATIONS = {
    "kernel": (),
    "64_threads": (("constexpr int kWarpThreads = 128;", "constexpr int kWarpThreads = 64;"),),
    "no_source_loads": (_NO_SOURCE_LOAD,),
    "no_envelope": (_NO_ENVELOPE,),
    "neither": (_NO_SOURCE_LOAD, _NO_ENVELOPE),
    # K2/K4 with the base row's loads after the barrier, as K1/K3 (the
    # basis rows stay before it)
    "base_after_barrier": (
        ("constexpr bool kBaseBeforeBarrier = kWarp;", "constexpr bool kBaseBeforeBarrier = false;"),
        ("      load_group<T, V>(src1.base + (int64_t)row * row_len, 0, C, Tlen, t0, x1);\n", ""),
        ("  if constexpr (kBaseBeforeBarrier) {", "  if constexpr (kWarp) {"),
    ),
}


def sources() -> dict:
    """Each ablation's source text; raises where an edit no longer matches
    the kernel's source."""
    kernel = (build._CSRC / "mix_kernels.cu").read_text()
    out = {}
    for name, edits in ABLATIONS.items():
        text = kernel
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"ablation {name}: {old!r} is not in mix_kernels.cu once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_ablations() -> dict:
    """Compile every ablation (one nvcc each, started together); returns
    name → its library."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, text in sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs.append(build._start([build._nvcc(), *build.COMPILE_FLAGS, "-shared",
                                   str(cu), "-o", str(out_dir / f"{name}.so")]))
    build._run(procs)
    return {name: ctypes.CDLL(str(out_dir / f"{name}.so")) for name in ABLATIONS}


def entry(lib, wrapper: str):
    """``wrapper``'s C entry point in ``lib``, typed as ``build`` types it."""
    name, n_ptr, n_int = build._ENTRIES[wrapper]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=9)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mix_warp_ablation: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_name()
    libs = build_ablations()
    x, a = main_path_inputs(dev, "durmixmagwarp(0.2,4)")
    _, p = main_path_inputs(dev, "durratiomixup")
    basis = warp_basis(T, a["knots"].shape[1] - 2, dev, columns=WARP_BASIS_CHUNK)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        args = [t.data_ptr() if isinstance(t, torch.Tensor) else t for t in args]
        if fn(*args, stream) != 0:
            raise RuntimeError(f"{fn.__name__} refused its launch")
        return lambda: fn(*args, stream)

    def k2(lib):
        return call(entry(lib, "pcgmix_plus_fused"), x, out, a["mix"], a["dst"],
                    a["src"], a["len"], a["sel"], a["alpha"], a["knots"], basis,
                    B, C, T, a["dst"].shape[1], a["knots"].shape[1], 4, 0)

    one, copy = torch.zeros(1, device=dev), torch.empty_like(x)
    arms = {name: k2(lib) for name, lib in libs.items()}
    for name, lib in (("k1", libs["kernel"]), ("k1_64_threads", libs["64_threads"])):
        arms[name] = call(entry(lib, "piecewise_mix_pairs"), x, out, None, p["mix"],
                          p["dst"], p["src"], p["len"], p["sel"], p["alpha"],
                          B, B, C, T, p["dst"].shape[1], 1, 4, 0)
    arms |= {"zero_1": one.zero_, "copy_batch": lambda: copy.copy_(x)}
    # the kernel under test of each arm, launched once a call
    under_test = {"zero_1": "FillFunctor", "copy_batch": "Memcpy DtoD"}
    report = {}
    for name, fn in arms.items():
        ms = statistics.median(time_ms(fn, args.windows, args.reps))
        kernel_us, events = kernel_reading(kernel_times(fn, args.reps),
                                           under_test.get(name, "mix_warp_kernel"), args.reps)
        report[name] = {"ms": ms, "kernel_us": kernel_us}
        print(f"{name}: {ms * 1e3:.3f} us a call in windows of {args.reps}, profiler "
              f"kernel time {reading_text(kernel_us, events, args.reps)}, on {card}",
              flush=True)
    print(json.dumps({"card": card, "shape": [B, C, T], "arms": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

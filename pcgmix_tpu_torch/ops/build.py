"""Build, load and launch the port's CUDA kernels K1–K5.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` for ``sm_90a``:
one ``nvcc -c`` per source, all started together, then one link into a
single shared library with a plain C interface under ``build/torch_kernels/``
beside the package, keyed by a hash of the sources and flags, and loaded
with ctypes.  Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises if that is not 0 and
counts the launch under its wrapper's name (:func:`launch_counts`), so a
run can show that its main path went through the kernels.  A launch made
while a CUDA graph is captured (:func:`capturing`) launches nothing then:
it is counted each time the graph is replayed (:func:`count_replay`).  The
real launches of a graph's warm-up, whose steps are undone before the
capture, are counted apart (:func:`warm_up_counts`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

MAX_PIECES = 32  # kMaxPieces in csrc/mix_kernels.cu
MAX_WARP_TERMS = 256  # kMaxWarpTerms: (knot+2)·C envelope coefficients
WARP_THREADS = 128  # kWarpThreads: threads per K1–K4 block, V steps each
WARP_BASIS_CHUNK = 8  # kBasisChunk: K2/K4's basis columns are padded to a multiple
CONV3_CHUNK_ROWS = 64  # kChunkRows in csrc/conv_bn_stats.cu: rows of y per chunk
CONV3_CHUNKS_PER_TILE = 2  # kChunksPerTile: chunks per block (a statistics row each)

# wrapper name → (C entry point, pointer arguments, int arguments); every
# entry point takes the stream last
_ENTRIES = {
    "piecewise_mix_pairs": ("pcgmix_piecewise_mix_pairs", 9, 8),
    "pcgmix_plus_fused": ("pcgmix_plus_fused", 10, 7),
    "piecewise_mix_prepaired": ("pcgmix_piecewise_mix_prepaired", 8, 7),
    "pcgmix_plus_fused_prepaired": ("pcgmix_plus_fused_prepaired", 10, 7),
    "conv3_bn_stats": ("pcgmix_conv3_bn_stats", 6, 5),
}
# C functions that report a compiled-in limit → the value the wrappers use
_LIMITS = {
    "pcgmix_max_pieces": MAX_PIECES,
    "pcgmix_max_warp_terms": MAX_WARP_TERMS,
    "pcgmix_warp_threads": WARP_THREADS,
    "pcgmix_warp_basis_chunk": WARP_BASIS_CHUNK,
    "pcgmix_conv3_chunk_rows": CONV3_CHUNK_ROWS,
    "pcgmix_conv3_chunks_per_tile": CONV3_CHUNKS_PER_TILE,
}
_launches = dict.fromkeys(_ENTRIES, 0)
_warm_ups = dict.fromkeys(_ENTRIES, 0)  # launches of CUDA-graph warm-ups
_captured = None  # within capturing(): where launches are counted instead
_lib = None
_lib_lock = threading.Lock()


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return dict(_launches)


def warm_up_counts() -> dict:
    """Launches per wrapper of CUDA-graph warm-ups since the last reset:
    real launches whose steps are undone before the capture, so they are
    not in :func:`launch_counts`."""
    return dict(_warm_ups)


def reset_launch_counts() -> None:
    for counts in (_launches, _warm_ups):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def capturing(warm_up: bool = False):
    """Within: launches counted into the yielded dict and not into
    :func:`launch_counts`: those a CUDA graph capture records, or with
    ``warm_up`` a graph warm-up's, counted into :func:`warm_up_counts`."""
    global _captured
    prev, _captured = _captured, _warm_ups if warm_up else dict.fromkeys(_ENTRIES, 0)
    try:
        yield _captured
    finally:
        _captured = prev


def count_replay(captured: dict) -> None:
    """Count one replay of a graph that recorded ``captured`` launches."""
    for k, n in captured.items():
        _launches[k] += n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run(procs) -> str:
    """Wait for every (command, process), then raise on the first failure;
    return their joined output."""
    done = [(cmd, *p.communicate()) for cmd, p in procs]
    done = [(cmd, p.returncode, out, err) for (cmd, out, err), (_, p) in zip(done, procs)]
    for cmd, code, out, err in done:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}{err}")
    return "\n".join(f"{' '.join(cmd)}\n{out}{err}" for cmd, _, out, err in done)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library.

    With ``verbose`` the compile lines and ptxas' register/shared-memory
    report are printed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
        for p in sorted(_CSRC.iterdir()):
            digest.update(p.name.encode() + p.read_bytes())
        tag = digest.hexdigest()[:16]
        so = BUILD_DIR / f"libpcgmix_kernels_{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            pid = os.getpid()
            objs = [BUILD_DIR / f"{src.stem}_{tag}.{pid}.o"
                    for src in sorted(_CSRC.glob("*.cu"))]
            log = _run([_start([_nvcc(), *COMPILE_FLAGS, "-Xptxas", "-v", "-c",
                                str(src), "-o", str(obj)])
                        for src, obj in zip(sorted(_CSRC.glob("*.cu")), objs)])
            tmp = so.with_name(f"{so.name}.{pid}.tmp")
            log += _run([_start([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                                 *map(str, objs)])])
            if verbose:
                print(log)
            os.replace(tmp, so)
            for obj in objs:
                obj.unlink()
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry, n_ptr, n_int in _ENTRIES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = i
        for name, value in _LIMITS.items():
            fn = getattr(lib, name)
            fn.restype = i
            if fn() != value:
                raise RuntimeError(f"{name}() = {fn()} disagrees with the wrapper's {value}")
        _lib = lib
        return lib


def is_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (a wrapper runs its plain version); False for
    a CUDA tensor (it launches its kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def launch(name: str, device: torch.device, *args) -> None:
    """Call wrapper ``name``'s C entry point on ``device``'s current stream;
    tensors among ``args`` pass as their data pointers, None as NULL.
    Raises on a refused launch, and counts the launch."""
    lib = build_library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        code = getattr(lib, _ENTRIES[name][0])(
            *c_args, torch.cuda.current_stream().cuda_stream
        )
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
    (_launches if _captured is None else _captured)[name] += 1

"""Operations and bytes: the yardstick's arithmetic.

Everything here is computed from a configuration (``configs/<name>.json``)
or from a mix kernel's shapes and plan, never from the program, so a later
change to the program cannot move it.  A model's operations are its
family's count (``reference/models/<family>.py::forward_macs``); the
convolution passes, which only the convolution cells read, come from the
configuration's layer table.

Convolutions count 2 operations a multiply-add.  A training step runs each
convolution forward, for its weight gradient and, where its input needs
one (every layer but the first), for its input gradient; each of these
passes does the forward's multiply-adds.  A pass moves its two operands
and its result once, in float32.

The mix kernels' counts are frozen from the port's chip smoke script
(``chip_smoke.py``, phase 2): each row buffer read once, the output written
once, 4 bytes of row index an output row, the five piece arrays (and
K2's knots and spline basis) read once; 4 operations a blended element,
and K2 adds ``2·(knot+2) + 1`` a element for the envelope.
"""

from __future__ import annotations

import math

from benchmark.reference import load

FLOAT_BYTES = 4
PIECE_ARRAYS = 5  # dst, src, len, sel, alpha
INDEX_BYTES = 4  # int32 partner index an output row


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def conv_macs(layer: dict) -> int:
    """Multiply-adds of one convolution's forward for one sample."""
    return (layer["out"] * layer["in"] * _prod(layer["kernel"])
            * _prod(layer["size"]))


def forward_macs(config: dict) -> int:
    """Multiply-adds of the model's forward for one sample, as the
    configuration's model family counts them."""
    return load("models", config["family"]).forward_macs(config)


def model_flops_per_sample(config: dict) -> int:
    """A training step's model operations for one sample: forward and the
    two backward passes, each the forward's, 2 operations a multiply-add
    (the convention of ``step_mfu``)."""
    return 3 * 2 * forward_macs(config)


def conv_passes(config: dict, batch: int) -> list:
    """(layer, pass, operations, bytes) of every convolution pass of one
    training step on ``batch`` samples."""
    out = []
    for l in config["layers"]:
        flops = 2 * conv_macs(l) * batch
        x = batch * l["in"] * _prod(l["size"]) * FLOAT_BYTES
        y = batch * l["out"] * _prod(l["size"]) * FLOAT_BYTES
        w = l["out"] * l["in"] * _prod(l["kernel"]) * FLOAT_BYTES
        out.append((l["conv"], "forward", flops, x + w + y))
        out.append((l["conv"], "weight_grad", flops, x + y + w))
        if l["input_grad"]:
            out.append((l["conv"], "input_grad", flops, y + w + x))
    return out


def conv_flops(config: dict, batch: int) -> int:
    """Convolution operations of one training step."""
    return sum(f for _, _, f, _ in conv_passes(config, batch))


def conv_bound_s(config: dict, batch: int, peak_flops: float, peak_bytes_s: float) -> float:
    """The least time one step's convolutions can take: each pass bound by
    its operations or its bytes, whichever is slower."""
    return sum(max(f / peak_flops, b / peak_bytes_s)
               for _, _, f, b in conv_passes(config, batch))


MIX_KERNELS = ("piecewise_mix_pairs", "pcgmix_plus_fused")  # wrappers with counts


def mix_counts(kernel: str, rows: int, channels: int, length: int, pieces: int,
               covered: int, knots: int = 0) -> tuple:
    """(bytes, operations) of one mix kernel launch.

    ``kernel``: ``piecewise_mix_pairs`` (K1, batch form: base row i) or
    ``pcgmix_plus_fused`` (K2); ``rows`` × ``channels`` × ``length`` float32
    rows in and out; ``pieces`` per row; ``covered``: the summed piece
    lengths of the launch (Σ len over rows and pieces); ``knots``: K2's
    knot+2."""
    if kernel not in MIX_KERNELS:
        raise ValueError(f"no counts for kernel {kernel!r}")
    elements = rows * channels * length
    nbytes = (2 * elements * FLOAT_BYTES + INDEX_BYTES * rows
              + rows * pieces * PIECE_ARRAYS * 4)
    ops = 4 * covered * channels
    if kernel == "pcgmix_plus_fused":
        if knots < 2:
            raise ValueError("K2 needs its knot count (knot + 2)")
        nbytes += rows * knots * channels * 4 + length * knots * 4
        ops += (2 * knots + 1) * elements
    return nbytes, ops


def mix_bound_s(counts: tuple, peak_flops: float, peak_bytes_s: float) -> float:
    """The least time of a launch of ``counts`` = (bytes, operations)."""
    nbytes, ops = counts
    return max(nbytes / peak_bytes_s, ops / peak_flops)

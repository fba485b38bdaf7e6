"""Shared building blocks of the port's models (counterpart:
``pcgmix_tpu/models/layers.py``).

- :class:`BatchNorm1d` and :class:`BatchNorm2d`: BatchNorm whose running
  variance follows flax's (biased), global under data parallelism.  Every
  BatchNorm of every model goes through them.
- :class:`Conv1d`: a 1-D convolution that pads explicitly, with XLA's split
  for "SAME" at stride 1 (lo = (k−1)//2, hi = k//2, which differ for an
  even kernel), so the split is stated rather than left to torch's
  ``padding="same"``.
- :class:`ConvBNAct`: tsai's ConvBlock, Conv(SAME, no bias) → BatchNorm →
  activation, the block of FCN, ResCNN, ResNet and the tsai zoo.
- :class:`MatmulConv1d` and :func:`conv1d`: ``nn.Conv1d`` computed as K
  shifted matmuls, the ``conv_impl="matmul"`` path of the ResNet9 and
  Potes presets.
- :func:`gap_1d`: the global average pool over time.
- :func:`host_uniform`: a module's uniform draws from its CPU generator
  (Potes' dropout masks), which a captured train step takes from
  buffers drawn ahead (:func:`record_draws`, :func:`feed_draws`).

Inits are torch's defaults, which the JAX package draws too
(kaiming-uniform(a=√5), i.e. U(±1/√fan_in), for conv and linear weights
and their biases); ``train/convert.py::seeded_init`` redraws them from a
seed.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.parallel.dist import current_batch_rows

_draws = None  # ("record", list) or ("feed", iterator) within a context


def host_uniform(generator: torch.Generator, shape: tuple,
                 device: torch.device) -> torch.Tensor:
    """U[0, 1) of ``shape`` from the CPU ``generator``, on ``device``.

    Within :func:`record_draws` the (generator, shape) of each call is
    logged too; within :func:`feed_draws` the call draws nothing and
    returns the next of the tensors given there, which were drawn ahead in
    the same order, so a replayed CUDA graph sees each step's own draws.
    Inside a graph capture without them it raises: the capture would
    freeze one draw for every replay."""
    if _draws is not None and _draws[0] == "feed":
        return next(_draws[1])
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a host draw inside a CUDA graph capture needs its "
                           "values drawn ahead (feed_draws)")
    if _draws is not None:
        _draws[1].append((generator, tuple(shape)))
    u = torch.rand(shape, generator=generator, pin_memory=device.type == "cuda")
    return u.to(device, non_blocking=True)


@contextlib.contextmanager
def record_draws():
    """Within: :func:`host_uniform` draws as usual and logs each call's
    (generator, shape) into the yielded list."""
    global _draws
    log = []
    prev, _draws = _draws, ("record", log)
    try:
        yield log
    finally:
        _draws = prev


@contextlib.contextmanager
def feed_draws(tensors):
    """Within: :func:`host_uniform` returns ``tensors`` one by one."""
    global _draws
    prev, _draws = _draws, ("feed", iter(tensors))
    try:
        yield
    finally:
        _draws = prev


#: the ``part`` values of a model with a split forward (latentmixup and the
#: manifold methods); a model without one takes None and "latent_space"
SPLIT_PARTS = (None, "first", "second", "latent_space")


def check_part(part: Optional[str], name: str, split: bool = False) -> None:
    """Refuse a ``part`` the model ``name`` does not have: "first" and
    "second" need a split forward, as in the JAX package's registry."""
    if part not in SPLIT_PARTS:
        raise ValueError(f"part must be one of {SPLIT_PARTS}, got {part!r}")
    if not split and part in ("first", "second"):
        raise NotImplementedError(
            f"{name} has no split (part='first'/'second') forward, nor has the "
            "reference's; latentmixup and the manifold methods need one"
        )


class _BiasedBatchNorm:
    """BatchNorm whose running variance follows the JAX package, for 1-D
    (B, C, T) and 2-D (B, C, F, T) activations.

    flax's BatchNorm (momentum 0.9, eps 1e-5) folds the *biased* batch
    variance into its running average; ``nn.BatchNorm1d``/``2d`` fold the
    unbiased one, which would make eval after training drift by n/(n−1).
    Training normalizes with the biased batch statistics as both do, and
    the running buffers are updated here explicitly, without gradient.  A
    layer applied several times in one forward (Singstad's shared blocks)
    updates them once per application, as flax's does.

    Under data parallelism (a ``torch.distributed`` process group is
    initialized) the statistics are those of the global batch, as GSPMD
    gives flax's BatchNorm on the JAX package's mesh: the per-channel Σx,
    Σx² and count are all-reduced with the differentiable all-reduce, and
    x is normalized with the global mean and the global biased variance
    E[x²] − E[x]², as flax computes it.  On a batch that every rank holds
    whole (replicated, :func:`pcgmix_tpu_torch.parallel.batch_rows`) the
    local statistics are the global ones, and the all-reduce is skipped.
    It would give the same numbers over ``world`` copies of the batch (its
    backward sums the ranks' equal statistics gradients, but the count it
    divides by grew by the same factor); skipping it saves a collective per
    layer and computes what the JAX package's replicated step computes.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps,
            )
        rows = current_batch_rows()
        if (dist.is_available() and dist.is_initialized()
                and (rows is None or not rows.replicated)):
            return self._global_batch_norm(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=_reduced(x), correction=0)
            self._update_running(mean, var)
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        dims = _reduced(x)
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
        # one collective per layer: [Σx (C), Σx² (C), count]; its backward
        # all-reduces the statistics' gradients, so each rank's parameter
        # gradients are its share of the global batch's
        sums = all_reduce(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (xf - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self._update_running(mean, var)
        return y.to(x.dtype)


def _reduced(x: torch.Tensor) -> tuple:
    """The axes BatchNorm reduces over: every one but the channels'."""
    return (0, *range(2, x.dim()))


class BatchNorm1d(_BiasedBatchNorm, nn.BatchNorm1d):
    """Biased-variance BatchNorm over (B, C, T) (see :class:`_BiasedBatchNorm`)."""


class BatchNorm2d(_BiasedBatchNorm, nn.BatchNorm2d):
    """Biased-variance BatchNorm over (B, C, F, T) (see :class:`_BiasedBatchNorm`)."""


def same_padding(kernel_size: int) -> tuple[int, int]:
    """XLA's "SAME" padding of a stride-1 convolution: k − 1 in all, the
    larger half after the row."""
    return (kernel_size - 1) // 2, kernel_size // 2


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` on (B, C, T) that pads explicitly: ``padding`` is
    "same" (XLA's split, :func:`same_padding`), an int on both sides, or a
    (lo, hi) pair."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: Union[str, int, Sequence[int]] = "same", stride: int = 1,
                 bias: bool = True, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, bias=bias, groups=groups)
        if padding == "same":
            if stride != 1:
                raise ValueError("'same' padding is defined here at stride 1 only")
            padding = same_padding(kernel_size)
        elif isinstance(padding, int):
            padding = (padding, padding)
        self.pad = tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pad):
            x = F.pad(x, self.pad)
        return super().forward(x)


class MatmulConv1d(nn.Conv1d):
    """``nn.Conv1d`` (same parameters, same state_dict keys) computed as K
    shifted matmuls, ``y = Σ_k W[:, :, k] @ x_pad[..., k::stride] + b``
    (``pcgmix_tpu/models/layers.py::_MatmulConv1d``): under ``vmap`` over
    stacked weights each product is a batched matmul, where a convolution
    becomes a grouped one.  The terms are summed in k order, then the bias,
    as the JAX package sums them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.dilation != (1,) or isinstance(self.padding, str):
            raise ValueError("conv_impl='matmul' takes groups 1, dilation 1 and int padding")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k,), (stride,), (pad,) = self.kernel_size, self.stride, self.padding
        xp = F.pad(x, (pad, pad)) if pad else x
        t_out = (xp.shape[-1] - k) // stride + 1
        span = (t_out - 1) * stride + 1
        y = None
        for i in range(k):
            yi = torch.matmul(self.weight[:, :, i], xp[..., i:i + span:stride])
            y = yi if y is None else y + yi
        return y if self.bias is None else y + self.bias[:, None]


CONV_IMPLS = ("xla", "matmul")


def conv1d(in_channels: int, out_channels: int, kernel_size: int, padding: int = 0,
           impl: str = "xla") -> nn.Conv1d:
    """``nn.Conv1d(..., padding=padding)``, or with ``impl="matmul"`` its
    :class:`MatmulConv1d` (the JAX ``Conv1d.impl``; "xla" names the
    library convolution, as there)."""
    if impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {impl!r}")
    cls = MatmulConv1d if impl == "matmul" else nn.Conv1d
    return cls(in_channels, out_channels, kernel_size, padding=padding)


class ConvBNAct(nn.Module):
    """tsai's ConvBlock: Conv1d(SAME, no bias) → BatchNorm1d → ``act``
    (ReLU unless given; None: no activation)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 act: Union[nn.Module, None, str] = "relu"):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, bias=False)
        self.bn = BatchNorm1d(out_channels)
        self.act = nn.ReLU() if act == "relu" else act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


def gap_1d(x: torch.Tensor) -> torch.Tensor:
    """Global average pool over time: (B, C, T) → (B, C)."""
    return x.mean(dim=-1)

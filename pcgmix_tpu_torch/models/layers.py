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
- :class:`Conv2d`, :class:`Linear` and :class:`LayerNorm`: torch's, with
  the compute dtype below.
- :func:`gap_1d`: the global average pool over time.
- :func:`host_uniform`: a module's uniform draws from its CPU generator
  (Potes' dropout masks), which a captured train step takes from
  buffers drawn ahead (:func:`record_draws`, :func:`feed_draws`).

The compute dtype (``TrainConfig.compute_dtype``, JAX ``layers.py``'s
``dtype``): a convolution or linear layer built with ``compute_dtype=
torch.bfloat16`` casts its input, weight and bias to bf16 at use, as flax's
``promote_dtype`` does, and adds the bias in bf16 after the product, as
flax does; its parameters stay float32, and autograd returns their
gradients in float32.  Without one (None, the default and the parity
route) a layer computes in the promotion of its input's dtype and its
weight's: float32 for a bf16 activation, as a flax ``Dense`` built
without a dtype promotes it (the heads of ResNet9, Potes and the zoo).
BatchNorm and LayerNorm reduce and normalize in float32 at least and cast
their output once, to the compute dtype where there is one.

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
from pcgmix_tpu_torch.timing import to_device

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
    return to_device(u, device, pinned=True)


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


#: ``TrainConfig.compute_dtype``'s names → the layers' compute dtype (None:
#: float32, no casts); None is the float32 default
COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The layers' compute dtype for a compute-dtype name, resolved once at
    an entry point (``TrainConfig``, ``build_model``); any name but float32
    or bfloat16 raises."""
    try:
        return COMPUTE_DTYPES[name]
    except (KeyError, TypeError):
        raise ValueError("compute_dtype must be 'float32' or 'bfloat16', got "
                         f"{name!r}") from None


def promote(compute_dtype: Optional[torch.dtype], x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None):
    """flax's ``promote_dtype``: (x, weight, bias) cast to ``compute_dtype``,
    or without one to the promotion of x's dtype and the weight's.  A tensor
    already of that dtype passes as it is (no cast, no copy)."""
    dt = compute_dtype or torch.promote_types(x.dtype, weight.dtype)
    return x.to(dt), weight.to(dt), None if bias is None else bias.to(dt)


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

    ``compute_dtype`` (flax's ``nn.BatchNorm(dtype=...)``): a bf16 input is
    upcast to float32 for the statistics, the running buffers' update and
    the normalization, and the output is cast once, to ``compute_dtype``
    where there is one, else to the promotion of the input's dtype and the
    weight's (float32).  The buffers and parameters stay float32.
    """

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return self._normalize(x.to(torch.promote_types(x.dtype, torch.float32))).to(out)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
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
        """The global batch's normalization of ``x`` (float32 at least, so the
        all-reduced Σx and Σx² are never taken on bf16 values)."""
        from torch.distributed.nn.functional import all_reduce

        dims = _reduced(x)
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
        # one collective per layer: [Σx (C), Σx² (C), count]; its backward
        # all-reduces the statistics' gradients, so each rank's parameter
        # gradients are its share of the global batch's
        sums = all_reduce(torch.cat([x.sum(dims), (x * x).sum(dims), count]))
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self._update_running(mean, var)
        return y


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


class _CastConv:
    """A torch convolution (mixed in before ``nn.Conv1d``/``nn.Conv2d``) that
    computes in ``compute_dtype``: flax's ``nn.Conv(dtype=...)``, the product
    in the compute dtype, then the bias added in it.  Without one, and on
    operands of one dtype, it is torch's convolution as it is."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _conv_forward(self, x, weight, bias):
        if self.compute_dtype is None and x.dtype == weight.dtype:
            return super()._conv_forward(x, weight, bias)
        x, weight, bias = promote(self.compute_dtype, x, weight, bias)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            # oneDNN's bf16 convolution, torch's CPU route, returns wrong
            # values for some shapes (4 channels under a 40- or 64-step
            # kernel, as in XCM; 8 under 8 steps or more); the float32
            # product of the bf16 operands, rounded once, is a bf16
            # convolution that accumulates in float32, as cuDNN's and XLA's
            y = super()._conv_forward(x.float(), weight.float(), None).to(x.dtype)
        else:
            y = super()._conv_forward(x, weight, None)
        # flax's ``y += bias``: rounded in the compute dtype after the product
        return y if bias is None else y + bias.view(-1, *(1,) * (y.dim() - 2))


class TorchConv1d(_CastConv, nn.Conv1d):
    """``nn.Conv1d`` with a compute dtype (torch's own padding)."""


class Conv2d(_CastConv, nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype (flax ``Conv2d``/``nn.Conv`` over
    an image)."""


class Conv1d(_CastConv, nn.Conv1d):
    """``nn.Conv1d`` on (B, C, T) that pads explicitly: ``padding`` is
    "same" (XLA's split, :func:`same_padding`), an int on both sides, or a
    (lo, hi) pair; with a compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: Union[str, int, Sequence[int]] = "same", stride: int = 1,
                 bias: bool = True, groups: int = 1, compute_dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, bias=bias, groups=groups, compute_dtype=compute_dtype)
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


class MatmulConv1d(_CastConv, nn.Conv1d):
    """``nn.Conv1d`` (same parameters, same state_dict keys) computed as K
    shifted matmuls, ``y = Σ_k W[:, :, k] @ x_pad[..., k::stride] + b``
    (``pcgmix_tpu/models/layers.py::_MatmulConv1d``): under ``vmap`` over
    stacked weights each product is a batched matmul, where a convolution
    becomes a grouped one.  The terms are summed in k order, then the bias,
    as the JAX package sums them, each in the compute dtype."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.dilation != (1,) or isinstance(self.padding, str):
            raise ValueError("conv_impl='matmul' takes groups 1, dilation 1 and int padding")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k,), (stride,), (pad,) = self.kernel_size, self.stride, self.padding
        x, weight, bias = promote(self.compute_dtype, x, self.weight, self.bias)
        xp = F.pad(x, (pad, pad)) if pad else x
        t_out = (xp.shape[-1] - k) // stride + 1
        span = (t_out - 1) * stride + 1
        y = None
        for i in range(k):
            yi = torch.matmul(weight[:, :, i], xp[..., i:i + span:stride])
            y = yi if y is None else y + yi
        return y if bias is None else y + bias[:, None]


CONV_IMPLS = ("xla", "matmul")


def conv1d(in_channels: int, out_channels: int, kernel_size: int, padding: int = 0,
           impl: str = "xla", compute_dtype=None) -> nn.Conv1d:
    """``nn.Conv1d(..., padding=padding)`` (:class:`TorchConv1d`), or with
    ``impl="matmul"`` its :class:`MatmulConv1d` (the JAX ``Conv1d.impl``;
    "xla" names the library convolution, as there); either computes in
    ``compute_dtype``."""
    if impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {impl!r}")
    cls = MatmulConv1d if impl == "matmul" else TorchConv1d
    return cls(in_channels, out_channels, kernel_size, padding=padding,
               compute_dtype=compute_dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with a compute dtype (flax ``Dense``): with one, the
    product in it, then the bias added in it; without one, in the promotion
    of the input's dtype and the weight's, so a bf16 activation meets a
    float32 head in float32 and the logits are float32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = promote(self.compute_dtype, x, self.weight, self.bias)
        if self.compute_dtype is None or bias is None:
            return F.linear(x, weight, bias)
        return F.linear(x, weight) + bias


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` as flax's, built without a dtype: statistics and
    output in the promotion of the input's dtype and the weight's (float32
    for a bf16 activation)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


class ConvBNAct(nn.Module):
    """tsai's ConvBlock: Conv1d(SAME, no bias) → BatchNorm1d → ``act``
    (ReLU unless given; None: no activation), in ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 act: Union[nn.Module, None, str] = "relu", compute_dtype=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, bias=False,
                           compute_dtype=compute_dtype)
        self.bn = BatchNorm1d(out_channels, compute_dtype=compute_dtype)
        self.act = nn.ReLU() if act == "relu" else act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


def gap_1d(x: torch.Tensor) -> torch.Tensor:
    """Global average pool over time: (B, C, T) → (B, C)."""
    return x.mean(dim=-1)

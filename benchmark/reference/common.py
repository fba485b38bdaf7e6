"""Plain training arithmetic: the layers every model shares, the loss, the
update and the schedule, and :func:`follow`, the first training steps.

Departures from the published description (reference ``train_model.py``
and ``models.py``):

- BatchNorm normalizes with the biased batch variance, as the published
  models do in training mode; the running statistics are not kept, since a
  training step does not read them.
- The loss is the soft-target cross-entropy alone: SELC's label
  correction starts only for a method named with ``SELC`` (after 40 % of
  the epochs), which no cell here is.
- :class:`Ops` computes in float64 by default: the port's float32 is then
  judged against a reference that is exact to far below its rounding.
  With ``tf32=True`` it computes in float32 with every convolution and
  matrix product taking TF32 operands (forward and backward), the
  lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32In(torch.autograd.Function):
    """An operand rounded to TF32 going in; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _TF32GradOut(torch.autograd.Function):
    """The identity going in; the gradient rounded to TF32 coming back, as
    the backward products take it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Ops:
    """The products a model computes, in ``dtype`` (float64 by default), or
    in float32 with TF32 operands (``tf32=True``)."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else dtype

    def _io(self, fn, x, *ws):
        if not self.tf32:
            return fn(x, *ws)
        return _TF32GradOut.apply(fn(_TF32In.apply(x), *(_TF32In.apply(w) for w in ws)))

    def conv(self, x, w, b, padding: int):
        conv = F.conv1d if x.dim() == 3 else F.conv2d
        return self._io(lambda x, w: conv(x, w, padding=padding), x, w) + b.view(
            1, -1, *([1] * (x.dim() - 2)))

    def linear(self, x, w, b):
        return self._io(lambda x, w: x @ w.t(), x, w) + b


def batch_norm(x, weight, bias, eps: float):
    """Training-mode BatchNorm over every axis but the channels'."""
    dims = (0, *range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    shape = (1, -1, *([1] * (x.dim() - 2)))
    return (x - mean) / torch.sqrt(var + eps) * weight.view(shape) + bias.view(shape)


def max_pool(x, k: int):
    """Non-overlapping max-pool of window ``k`` over the one or two spatial
    axes (floor: a ragged tail is dropped).  The gradient goes to the first
    largest value of a window in row-major order, as ``MaxPool`` gives it
    (a zero-padded tail makes windows of equal values)."""
    b, c, *sizes = x.shape
    n = [s // k for s in sizes]
    x = x[(slice(None), slice(None), *(slice(0, m * k) for m in n))]
    if len(sizes) == 1:
        win = x.reshape(b, c, n[0], k)
    else:
        win = (x.reshape(b, c, n[0], k, n[1], k).permute(0, 1, 2, 4, 3, 5)
               .reshape(b, c, n[0], n[1], k * k))
    first = win.argmax(dim=-1, keepdim=True)
    return win.gather(-1, first).squeeze(-1)


def soft_cross_entropy(logits, target):
    """Mean over rows of −Σ target · log softmax(logits)."""
    return -(torch.log_softmax(logits, dim=1) * target).sum(dim=1).mean()


def onecycle(recipe: dict, total_steps: int, step: int) -> tuple:
    """(learning rate, Adam's β₁) of the ``step``-th update (0-based):
    OneCycle with cosine annealing, two phases, β₁ cycled opposite."""
    lr_max = recipe["lr_max"]
    initial = lr_max / recipe["div_factor"]
    final = initial / recipe["final_div_factor"]
    m_hi, m_lo = recipe["max_momentum"], recipe["base_momentum"]
    end1 = float(recipe["pct_start"] * total_steps) - 1
    phases = ((0.0, end1, initial, lr_max, m_hi, m_lo),
              (end1, total_steps - 1, lr_max, final, m_lo, m_hi))
    for i, (start, end, lr0, lr1, mo0, mo1) in enumerate(phases):
        if step <= end or i == len(phases) - 1:
            pct = (step - start) / (end - start)
            cos = math.cos(math.pi * pct) + 1
            return lr1 + (lr0 - lr1) / 2.0 * cos, mo1 + (mo0 - mo1) / 2.0 * cos
    raise AssertionError("unreachable")


def epoch_order(n: int, seed: int, step_count: int) -> np.ndarray:
    """The loader's shuffle of an epoch (reference train_model.py:497):
    ``randperm(n)`` of a CPU generator seeded ``seed·635410 + step_count``."""
    g = torch.Generator().manual_seed(seed * 635410 + step_count)
    return torch.randperm(n, generator=g).numpy()


def follow(recipe: dict, total_steps: int, forward, params0: dict, batches: list,
           ops: Ops) -> dict:
    """Run the first ``len(batches)`` training steps from ``params0``.

    ``forward(params, x, ops)`` gives the logits; ``batches`` are (mixed
    input, soft target) pairs.  Each step: loss, gradients, clip to
    ±grad_clip, Adam with weight decay added to the gradient, OneCycle's
    learning rate and β₁.  Returns the losses, per leaf the first raw
    gradient's norm and the first gradient as the optimizer takes it (its
    norm), and each leaf's change over all the steps (its norm)."""
    clip, wd, eps = recipe["grad_clip"], recipe["weight_decay"], recipe["eps"]
    beta2 = recipe["betas"][1]
    p0 = {k: v.to(ops.dtype) for k, v in params0.items()}
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    out = {"losses": []}
    for t, (x, target) in enumerate(batches, start=1):
        lr, beta1 = onecycle(recipe, total_steps, t - 1)
        loss = soft_cross_entropy(forward(p, x.to(ops.dtype), ops), target.to(ops.dtype))
        grads = torch.autograd.grad(loss, list(p.values()))
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                if t == 1:
                    out.setdefault("grad1_raw", {})[k] = float(g.double().norm())
                g = g.clamp(-clip, clip) + wd * w
                if t == 1:
                    out.setdefault("grad1", {})[k] = float(g.double().norm())
                m[k].mul_(beta1).add_(g, alpha=1 - beta1)
                v2[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (v2[k].sqrt() / math.sqrt(1 - beta2 ** t)).add_(eps)
                w.addcdiv_(m[k], denom, value=-lr / (1 - beta1 ** t))
    out["change"] = {k: float((p[k].detach() - p0[k]).double().norm()) for k in p}
    return out

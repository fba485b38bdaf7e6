"""Train and eval steps (counterpart: ``pcgmix_tpu/train/steps.py`` and
``train/schedule.py``).

One train step: gather the batch from the device-resident corpus → apply
the augmentation plan (mix kernels) → forward → SELC / soft-target CE →
backward → gradient value clipping → Adam with L2 weight decay → OneCycle
(lr and cycled β₁).  The reference runs the same sequence
(train_model.py:498-582); the only per-step host work is the plan.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.train.losses import selc_update


def make_optimizer(model: nn.Module, op: str, lr_max: float, weight_decay: float,
                   num_steps: int, use_sched: bool):
    """torch optimizer + optional OneCycleLR at the reference's defaults
    (train_model.py:404-412): pct_start 0.3, cosine, div 25, final div 1e4,
    β₁ cycled 0.95 → 0.85 → 0.95."""
    if op != "adam":
        raise NotImplementedError(f"optimizer {op!r} is not ported yet (use 'adam')")
    opt = torch.optim.Adam(model.parameters(), lr=lr_max, weight_decay=weight_decay)
    sched = (
        torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=lr_max, total_steps=num_steps)
        if use_sched else None
    )
    return opt, sched


class TrainStep:
    """A train step over a corpus held on the device.

    ``train_data`` (N, C, T) and ``train_labels`` (N,) live on the model's
    device; a step receives the batch's row ``indices`` and an optional
    augmentation plan, and returns device tensors (loss, preds, target)."""

    def __init__(self, model: nn.Module, opt, sched, train_data: torch.Tensor,
                 train_labels: torch.Tensor, soft_labels: torch.Tensor, *,
                 num_classes: int, grad_clip: float, selc_es: int, engine=None):
        self.model = model
        self.opt = opt
        self.sched = sched
        self.train_data = train_data
        self.train_labels = train_labels
        self.soft_labels = soft_labels
        self.num_classes = num_classes
        self.grad_clip = grad_clip
        self.selc_es = selc_es
        self.engine = engine

    def __call__(self, indices, plan_arrays: Optional[dict], epoch: int) -> dict:
        dev = self.train_data.device
        rows = torch.from_numpy(indices.astype("int64")).to(dev)
        data = self.train_data.index_select(0, rows)
        target = F.one_hot(
            self.train_labels.index_select(0, rows), self.num_classes
        ).to(data.dtype)
        if plan_arrays is not None:
            data, target = self.engine.apply(data, target, plan_arrays)
        self.model.train()
        out = self.model(data)
        loss = selc_update(self.soft_labels, out, target, rows, epoch, self.selc_es)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.grad_clip:
            nn.utils.clip_grad_value_(self.model.parameters(), self.grad_clip)
        self.opt.step()
        if self.sched is not None:
            self.sched.step()
        return {
            "loss": loss.detach(),
            "preds": out.detach().argmax(dim=1),
            "target": target.argmax(dim=1),
        }


@torch.no_grad()
def eval_step(model: nn.Module, data: torch.Tensor, target_ohe: torch.Tensor):
    """Softmax probabilities and per-sample CE of an eval batch."""
    model.eval()
    out = model(data)
    logp = F.log_softmax(out, dim=1)
    return F.softmax(out, dim=1), -(logp * target_ohe).sum(dim=1)

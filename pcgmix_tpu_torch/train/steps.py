"""Train and eval steps (counterpart: ``pcgmix_tpu/train/steps.py`` and
``train/schedule.py``).

One train step: gather the batch from the device-resident corpus → apply
the augmentation plan (``AugmentEngine.apply``: the mix kernels for the
keep-duration blends and cut and the concat family, tensor code for the
1-D baselines) → forward → SELC /
soft-target CE →
backward → gradient value clipping → Adam with L2 weight decay → OneCycle
(lr and cycled β₁).  The reference runs the same sequence
(train_model.py:498-582); the only per-step host work is the plan.

Under data parallelism (the JAX package's mesh step) a rank runs the same
step on its block of the global batch: it gathers its rows (for the concat
family: the base rows its block of the plan names) and its partners'
rows from the corpus it holds, mixes them through K3/K4, and averages the
gradients over the ranks before clipping, so the update is
the global batch's.  Loss, predictions and targets come back global.  A
global batch that does not divide over the ranks is replicated instead:
every rank runs the single-device step on all of it (K1/K2), BatchNorm
takes local statistics, and the gradients come out equal on every rank
(the JAX package's unsharded fallback, ``pcgmix_tpu/augment/engine.py:
914-916``, ``:943-944``).  A batch split over the ranks takes the
per-row bases (the keep-duration blends and cut, the concat family); the
1-D baselines and the latent methods raise there
(``AugmentEngine.check_prepaired``).

Latent methods (latentmixup, ``manifold-cutout``, ``manifold-cutmix``) split the forward at the
plan's depth (JAX ``train/steps.py:192-224``): the model's first part gives
the latent, the engine's apply mixes or masks it, the second part runs
from there in train mode.  latentmixup's first pass is differentiable and
in train mode, so its BatchNorm layers update their running statistics; a
manifold method's first pass runs in eval mode under ``torch.no_grad()``
(the JAX ``stop_gradient``), its BatchNorm reading the running statistics
and updating nothing; its parameters get zero gradients, not none, so Adam
moves them by weight decay and momentum as optax does.  The in-place
updates of the first pass are the flax ``bs1`` that the second pass starts
from; a layer that runs in both parts (Singstad_d10's shared ``deep2`` and
``shortcut2``) updates its statistics in the first part's applications and
then in the second's, the order in which flax threads ``bs1``.  The step
takes any registry model with a split forward (ResNet9, Potes, FCN,
ResCNN, Singstad_d10); the others refuse ``part="first"``.

``lc-nointrusion`` trains on rows it picked from a candidate pool rather
than on corpus rows (JAX ``loop.py:572-595``): :func:`candidate_losses`
scores the pool under eval mode, and :meth:`TrainStep.train_on` takes the
picked rows' data, one-hot targets and the corpus rows their SELC entries
belong to.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.augment.engine import SHARED_ARRAYS
from pcgmix_tpu_torch.parallel import DataParallel, batch_rows
from pcgmix_tpu_torch.train.losses import selc_share_rows, selc_update


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


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """Within: ``module`` and its submodules in eval mode; on leaving, each
    gets back its own training flag."""
    flags = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield module
    finally:
        for m, training in flags:
            m.training = training


class TrainStep:
    """A train step over a corpus held on the device.

    ``train_data`` (N, C, T) and ``train_labels`` (N,) live on the model's
    device; a step receives the global batch's row ``indices`` and an
    optional augmentation plan, and returns device tensors (loss, preds,
    target) of the global batch.  With ``dp`` the step is this rank's share
    of a data-parallel step.  ``latent_depth`` (a latent method's plan)
    splits the forward there."""

    def __init__(self, model: nn.Module, opt, sched, train_data: torch.Tensor,
                 train_labels: torch.Tensor, soft_labels: torch.Tensor, *,
                 num_classes: int, grad_clip: float, selc_es: int, engine=None,
                 dp: Optional[DataParallel] = None):
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
        self.dp = dp

    def _rows(self, indices):
        """(rows, data, one-hot target) of corpus rows ``indices`` (numpy)."""
        rows = torch.from_numpy(indices.astype("int64")).to(self.train_data.device)
        data = self.train_data.index_select(0, rows)
        target = F.one_hot(
            self.train_labels.index_select(0, rows), self.num_classes
        ).to(data.dtype)
        return rows, data, target

    def _inputs(self, indices, plan_arrays: Optional[dict], sharded: bool):
        """This step's (rows, data, target): the whole batch, or when
        ``sharded`` this rank's block of it, mixed by the plan."""
        if not sharded:
            rows, data, target = self._rows(indices)
            if plan_arrays is not None:
                data, target = self.engine.apply(data, target, plan_arrays)
            return rows, data, target
        rows, data, target = self._rows(indices[self.dp.block(len(indices))])
        if plan_arrays is not None:
            block = self.dp.shard_arrays(plan_arrays, len(indices), SHARED_ARRAYS)
            self.engine.check_prepaired()
            # the concat family names its base rows (idx1) and partners
            # (idx2); the blends and the cut mix a row with block["mix"]
            if "idx1" in block:
                _, data, target = self._rows(indices[block["idx1"]])
            _, d2, t2 = self._rows(indices[block["idx2" if "idx2" in block else "mix"]])
            data, target = self.engine.apply_prepaired(data, d2, target, t2, block)
        return rows, data, target

    def _split_forward(self, data, target, plan_arrays: dict, depth: int):
        """First part → the engine's apply on the latent → second part."""
        if self.engine.spec.manifold:
            with torch.no_grad(), eval_mode(self.model):
                latent = self.model(data, depth=depth, part="first")
        else:
            latent = self.model(data, depth=depth, part="first")
        latent, target = self.engine.apply(latent, target, plan_arrays)
        return self.model(latent, depth=depth, part="second"), target

    def batch(self, indices):
        """(rows, data, one-hot target) of the global batch, unmixed."""
        return self._rows(indices)

    def train_on(self, data: torch.Tensor, target: torch.Tensor, indices, epoch: int) -> dict:
        """One step on given rows: ``data`` and its one-hot ``target``, whose
        SELC entries are the corpus rows ``indices``; no plan."""
        if self.dp is not None:
            raise NotImplementedError(
                "a step on given rows runs on one device only (ROADMAP queue 1 item 9)")
        rows = torch.from_numpy(np.asarray(indices, np.int64)).to(data.device)
        return self._update(rows, data, target, None, epoch, None, len(rows), False)

    def __call__(self, indices, plan_arrays: Optional[dict], epoch: int,
                 latent_depth: Optional[int] = None) -> dict:
        n = len(indices)
        sharded = self.dp is not None and self.dp.divides(n)
        latent = plan_arrays is not None and latent_depth is not None
        if latent and sharded:
            self.engine.check_prepaired()  # raises: latent methods are row-global
        rows, data, target = self._inputs(indices, None if latent else plan_arrays,
                                          sharded)
        return self._update(rows, data, target, plan_arrays if latent else None, epoch,
                            latent_depth, n, sharded)

    def _update(self, rows, data, target, latent_plan: Optional[dict], epoch: int,
                latent_depth: Optional[int], n: int, sharded: bool) -> dict:
        """Forward (split at ``latent_depth`` with ``latent_plan``), SELC loss,
        backward and update on this step's rows (``n`` rows in the global
        batch; this rank's block of them when ``sharded``)."""
        latent = latent_plan is not None
        self.model.train()
        rows_held = self.dp.block(n) if sharded else slice(0, n)
        with batch_rows(n, rows_held, replicated=self.dp is not None and not sharded):
            if latent:
                out, target = self._split_forward(data, target, latent_plan, latent_depth)
            else:
                out = self.model(data)
        loss = selc_update(self.soft_labels, out, target, rows, epoch, self.selc_es)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if latent and self.engine.spec.manifold:
            # the JAX stop_gradient gives the first part zero gradients, and
            # Adam still moves those parameters by weight decay and momentum;
            # torch's Adam would skip a parameter whose grad is None
            for p in self.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if self.dp is not None:
            # replicated: the gradients are equal already, and averaging
            # them keeps the replicas equal where a kernel is not
            # deterministic
            self.dp.average_gradients(self.model.parameters())
        if self.grad_clip:
            nn.utils.clip_grad_value_(self.model.parameters(), self.grad_clip)
        self.opt.step()
        if self.sched is not None:
            self.sched.step()
        loss, preds, target = loss.detach(), out.detach().argmax(dim=1), target.argmax(dim=1)
        if sharded:
            if epoch > self.selc_es:
                selc_share_rows(self.soft_labels, rows, self.dp.gather)
            loss, preds, target = (
                self.dp.mean(loss), self.dp.gather(preds), self.dp.gather(target)
            )
        return {"loss": loss, "preds": preds, "target": target}


@torch.no_grad()
def candidate_losses(model: nn.Module, data: torch.Tensor,
                     target_ohe: torch.Tensor) -> torch.Tensor:
    """Per-row CE of a candidate pool under eval mode (JAX
    ``train/steps.py:300-309``; reference augmentations.py:1264-1266): no
    BatchNorm statistics move, and the model gets its flags back."""
    with eval_mode(model):
        logp = F.log_softmax(model(data), dim=1)
    return -(logp * target_ohe).sum(dim=1)


@torch.no_grad()
def eval_step(model: nn.Module, data: torch.Tensor, target_ohe: torch.Tensor):
    """Softmax probabilities and per-sample CE of an eval batch."""
    model.eval()
    out = model(data)
    logp = F.log_softmax(out, dim=1)
    return F.softmax(out, dim=1), -(logp * target_ohe).sum(dim=1)

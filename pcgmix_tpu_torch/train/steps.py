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
family: the base rows its block of the plan names) and its partners' rows
from the corpus it holds, mixes them through K3/K4 (the bases that read
their own row alone, through the same tensor code on its block), and
averages the gradients over the ranks before clipping, so the update is
the global batch's.  Loss, predictions and targets come back global.  A
global batch that does not divide over the ranks is replicated instead:
every rank runs the single-device step on all of it (K1/K2), BatchNorm
takes local statistics, and the gradients come out equal on every rank
(the JAX package's unsharded fallback, ``pcgmix_tpu/augment/engine.py:
914-916``, ``:943-944``).  A latent method's first part runs on the rank's
block, and a mix that reads other rows reads them from the global latent
(``DataParallel.gather_grad`` for latentmixup, whose backward gives each
rank the gradient of every rank's use of its rows; a plain gather for the
manifold methods, whose first part takes no gradient).

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
belong to; under data parallelism a rank builds and scores its block of
the pool and trains on its block of the picked rows
(:meth:`TrainStep.mix_rows`).
"""

from __future__ import annotations

import contextlib
import copy
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.augment.engine import SHARED_ARRAYS, gaussian_noise_draw
from pcgmix_tpu_torch.models.layers import feed_draws, record_draws
from pcgmix_tpu_torch.ops.build import capturing, count_replay
from pcgmix_tpu_torch.parallel import DataParallel, batch_rows
from pcgmix_tpu_torch.train.losses import selc_share_rows, selc_update


def make_optimizer(model: nn.Module, op: str, lr_max: float, weight_decay: float,
                   num_steps: int, use_sched: bool):
    """torch optimizer + optional OneCycleLR at the reference's defaults
    (train_model.py:404-412): pct_start 0.3, cosine, div 25, final div 1e4,
    β₁ cycled 0.95 → 0.85 → 0.95.

    ``op="SGD"`` is torch's SGD built with momentum 0, as the reference
    builds it (train_model.py:405); OneCycleLR then writes the cycled
    momentum into it every step, so scheduled SGD is heavy-ball with
    momentum 0.95 → 0.85 → 0.95, and unscheduled SGD has none (the JAX
    package's chain, ``pcgmix_tpu/train/steps.py:61-72``).  Weight decay is
    added to the gradient after the value clip, as there."""
    if op == "adam":
        opt = torch.optim.Adam(model.parameters(), lr=lr_max, weight_decay=weight_decay)
    elif op == "SGD":
        opt = torch.optim.SGD(model.parameters(), lr=lr_max, momentum=0.0,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {op!r} (use 'adam' or 'SGD')")
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
    splits the forward there.

    :meth:`__call__` takes host indices and a host plan and uploads them;
    :meth:`run` is the step on device tensors alone, the body that a CUDA
    graph captures (:class:`MultiStep`).  With ``fed`` set (a
    :class:`ScalarFedUpdate`) the update reads the learning rate and
    momentum from a device tensor rather than from the optimizer's
    parameter group, and the scheduler is stepped by the caller."""

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
        self.fed: Optional[ScalarFedUpdate] = None
        self.last_lr: Optional[float] = None  # the learning rate of the last eager update

    def upload(self, indices) -> torch.Tensor:
        """Host row indices as an int64 tensor on the corpus' device."""
        return torch.from_numpy(np.asarray(indices).astype("int64")).to(self.train_data.device)

    def _gather(self, rows: torch.Tensor):
        """(data, one-hot target) of corpus rows ``rows`` (a device tensor)."""
        data = self.train_data.index_select(0, rows)
        target = F.one_hot(
            self.train_labels.index_select(0, rows), self.num_classes
        ).to(data.dtype)
        return data, target

    def _rows(self, indices):
        """(rows, data, one-hot target) of corpus rows ``indices`` (numpy)."""
        rows = self.upload(indices)
        return (rows, *self._gather(rows))

    def inputs(self, idx: torch.Tensor, plan: Optional[dict], sharded: bool):
        """This step's (rows, data, target): the whole batch, or when
        ``sharded`` this rank's block of it, mixed by the plan (device
        arrays)."""
        if not sharded:
            data, target = self._gather(idx)
            if plan is not None:
                data, target = self.engine.apply(data, target, plan)
            return idx, data, target
        rows = idx[self.dp.block(len(idx))]
        if plan is None:
            return (rows, *self._gather(rows))
        return (rows, *self.mix_rows(idx, plan))

    def mix_rows(self, idx: torch.Tensor, plan: dict):
        """(data, one-hot target) of this rank's block of a plan's output
        rows: of the global batch ``idx`` (corpus rows), or of another
        number of output rows that the plan's arrays lead with (an
        ``lc-nointrusion`` pool of 4B candidates, or the B it picked)."""
        n = len(plan["idx1"]) if "idx1" in plan else len(idx)
        block = self._block_plan(plan, n, self.train_data)
        return self._mix_block(lambda pos: self._gather(idx.index_select(0, pos.long())),
                               lambda: self._gather(idx[self.dp.block(n)]), block)

    def _block_plan(self, plan: dict, n: int, like: torch.Tensor) -> dict:
        """This rank's block of a plan over ``n`` output rows (the shared
        arrays whole); ``gaussiannoise``'s noise is the global batch's draw
        from the plan's seed, its rows kept, as one device draws it."""
        block = self.dp.shard_arrays(plan, n, SHARED_ARRAYS)
        if "noise_seed" in block and "noise" not in block:
            noise = gaussian_noise_draw(block.pop("noise_seed"), (n, *like.shape[1:]),
                                        like.device, like.dtype)
            block["noise"] = noise[self.dp.block(n)]
        return block

    def _mix_block(self, fetch, own, block: dict):
        """Mix this rank's block: ``own()`` gives its rows' (data, target)
        and ``fetch(positions)`` those of any rows of the global batch.  A
        base that reads a partner row takes its base rows (its own, or
        ``idx1``'s) and partners (``idx2``'s or ``mix``'s) through
        ``apply_prepaired``; the others take ``apply`` on its own rows."""
        pairs = "idx2" if "idx2" in block else "mix" if "mix" in block else None
        if pairs is None:
            return self.engine.apply(*own(), block)
        data, target = fetch(block["idx1"]) if "idx1" in block else own()
        d2, t2 = fetch(block[pairs])
        return self.engine.apply_prepaired(data, d2, target, t2, block)

    def _split_forward(self, data, target, plan_arrays: dict, depth: int,
                       idx: Optional[torch.Tensor] = None):
        """First part → the engine's apply on the latent → second part; with
        the global batch ``idx``, this rank's block of it (a split batch)."""
        manifold = self.engine.spec.manifold
        if manifold:
            with torch.no_grad(), eval_mode(self.model):
                latent = self.model(data, depth=depth, part="first")
        else:
            latent = self.model(data, depth=depth, part="first")
        if idx is None:
            latent, target = self.engine.apply(latent, target, plan_arrays)
        else:
            n = len(idx)
            block = self._block_plan(plan_arrays, n, latent)
            cache = []

            def fetch(pos):  # rows of the global latent (gathered once)
                if not cache:
                    cache.append(self.dp.gather(latent) if manifold
                                 else self.dp.gather_grad(latent))
                    cache.append(F.one_hot(self.train_labels.index_select(0, idx),
                                           self.num_classes).to(target.dtype))
                pos = pos.long()
                return cache[0].index_select(0, pos), cache[1].index_select(0, pos)

            mixed = latent, target
            latent, target = self._mix_block(fetch, lambda: mixed, block)
        return self.model(latent, depth=depth, part="second"), target

    def batch(self, indices):
        """(rows, data, one-hot target) of the global batch, unmixed."""
        return self._rows(indices)

    def train_on(self, data: torch.Tensor, target: torch.Tensor, indices, epoch: int) -> dict:
        """One step on given rows: ``data`` and its one-hot ``target``, whose
        SELC entries are the corpus rows ``indices``; no plan.  Under data
        parallelism, on rows that divide over the ranks, ``data`` and
        ``target`` are this rank's block of them (:meth:`mix_rows`) and
        ``indices`` all of theirs."""
        rows = torch.from_numpy(np.asarray(indices, np.int64)).to(data.device)
        n = len(rows)
        sharded = self.dp is not None and self.dp.divides(n)
        if sharded:
            rows = rows[self.dp.block(n)]
        return self._update(rows, data, target, None, epoch, None, n, sharded)

    def __call__(self, indices, plan_arrays: Optional[dict], epoch: int,
                 latent_depth: Optional[int] = None) -> dict:
        idx = self.upload(indices)
        plan = (None if plan_arrays is None
                else self.engine.device_arrays(plan_arrays, idx.device))
        return self.run(idx, plan, epoch, latent_depth)

    def run(self, idx: torch.Tensor, plan: Optional[dict], epoch: int,
            latent_depth: Optional[int] = None,
            scalars: Optional[torch.Tensor] = None) -> dict:
        """The step on device tensors: row indices ``idx`` of the global
        batch, the plan's device arrays, and with :attr:`fed` this step's
        optimizer ``scalars`` (:meth:`ScalarFedUpdate.host_scalars`)."""
        n = len(idx)
        sharded = self.dp is not None and self.dp.divides(n)
        latent = plan is not None and latent_depth is not None
        rows, data, target = self.inputs(idx, None if latent else plan, sharded)
        return self._update(rows, data, target, plan if latent else None, epoch,
                            latent_depth, n, sharded, scalars, idx)

    def _update(self, rows, data, target, latent_plan: Optional[dict], epoch: int,
                latent_depth: Optional[int], n: int, sharded: bool,
                scalars: Optional[torch.Tensor] = None,
                idx: Optional[torch.Tensor] = None) -> dict:
        """Forward (split at ``latent_depth`` with ``latent_plan``), SELC loss,
        backward and update on this step's rows (``n`` rows in the global
        batch ``idx``; this rank's block of them when ``sharded``)."""
        latent = latent_plan is not None
        self.model.train()
        rows_held = self.dp.block(n) if sharded else slice(0, n)
        with batch_rows(n, rows_held, replicated=self.dp is not None and not sharded):
            if latent:
                out, target = self._split_forward(data, target, latent_plan, latent_depth,
                                                  idx if sharded else None)
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
        if scalars is not None:
            self.fed.apply(scalars)
        else:
            self.last_lr = self.opt.param_groups[0]["lr"]
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


def schedule_values(opt, sched) -> tuple[float, float]:
    """The learning rate and momentum term (Adam's β₁, SGD's momentum) that
    the optimizer's next eager step reads, then the scheduler stepped past
    them: for a caller that feeds them to :class:`ScalarFedUpdate`."""
    group = opt.param_groups[0]
    lr = group["lr"]
    momentum = group["betas"][0] if "betas" in group else group["momentum"]
    if sched is not None:
        with warnings.catch_warnings():
            # the scheduler warns once that no optimizer.step() came first:
            # this update does not go through optimizer.step()
            warnings.filterwarnings("ignore", message=".*lr_scheduler.step.*")
            sched.step()
    return lr, momentum


class ScalarFedUpdate:
    """The optimizer's update, Adam or SGD as torch's eager step computes it,
    with the per-step scalars read from a device tensor: a CUDA graph
    replays it with each step's learning rate and momentum, where torch's
    optimizer would bake the Python floats of the capture into the graph.

    The state is the optimizer's own (``exp_avg``/``exp_avg_sq``/``step``,
    ``momentum_buffer``), so its ``state_dict`` checkpoints either route.
    :meth:`host_scalars` computes, in float64 on the host as torch does,
    Adam's (1 − β₁, −lr/(1 − β₁ᵗ), √(1 − β₂ᵗ)) or SGD's (momentum, −lr, 0);
    the device work is torch's foreach sequence with those three as 0-d
    tensors.  SGD's momentum buffer starts at zero rather than at the first
    gradient, the same numbers (0·μ + g = g)."""

    def __init__(self, opt):
        if len(opt.param_groups) != 1:
            raise ValueError("one parameter group is supported")
        self.opt = opt
        self.group = opt.param_groups[0]
        self.adam = isinstance(opt, torch.optim.Adam)
        if not self.adam and not isinstance(opt, torch.optim.SGD):
            raise TypeError(f"{type(opt).__name__} is not Adam or SGD")
        if self.group.get("amsgrad") or self.group.get("nesterov") or self.group.get(
                "maximize") or self.group.get("dampening"):
            raise ValueError("amsgrad, nesterov, maximize and dampening are not supported")
        self.params = list(self.group["params"])
        for p in self.params:
            st = opt.state[p]
            if self.adam and "step" not in st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            elif not self.adam and st.get("momentum_buffer") is None:
                st["momentum_buffer"] = torch.zeros_like(p)
        self.t = int(opt.state[self.params[0]]["step"]) if self.adam else 0

    def host_scalars(self, lr: float, momentum: float) -> tuple:
        """The next step's three scalars; advances Adam's step count."""
        if not self.adam:
            return momentum, -lr, 0.0
        self.t += 1
        for p in self.params:
            self.opt.state[p]["step"].fill_(self.t)
        t, beta2 = float(self.t), self.group["betas"][1]
        return 1.0 - momentum, -(lr / (1.0 - momentum ** t)), (1.0 - beta2 ** t) ** 0.5

    @torch.no_grad()
    def apply(self, s: torch.Tensor) -> None:
        """Update the parameters from their gradients; ``s`` holds the three
        scalars of :meth:`host_scalars` on the parameters' device, or one
        row of them per gang member, (S, 3), for parameters stacked on a
        leading member axis (``train/gang.py``)."""
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        wd = self.group["weight_decay"]
        if wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        state = [self.opt.state[p] for p in params]

        def col(j, like):  # scalar j, broadcast over ``like``'s member axis
            return s[j] if s.dim() == 1 else s[:, j].view(-1, *(1,) * (like.dim() - 1))

        if self.adam:
            beta2, eps = self.group["betas"][1], self.group["eps"]
            ms = [st["exp_avg"] for st in state]
            vs = [st["exp_avg_sq"] for st in state]
            for m, g in zip(ms, grads):
                m.lerp_(g, col(0, m))
            torch._foreach_mul_(vs, beta2)
            torch._foreach_addcmul_(vs, grads, grads, value=1.0 - beta2)
            den = torch._foreach_sqrt(vs)
            for d in den:
                d.div_(col(2, d))
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(ms, den)
        else:
            upd = [st["momentum_buffer"] for st in state]
            for b in upd:
                b.mul_(col(0, b))
            torch._foreach_add_(upd, grads)
        for p, u in zip(params, upd):
            p.addcmul_(u, col(1, p))


class MultiStep:
    """K train steps per dispatch, ``TrainConfig.steps_per_dispatch`` (JAX
    ``make_multi_step``, its ``lax.scan`` fusion).

    :meth:`run` takes a chunk of up to K steps, each (host row indices,
    host plan arrays: identity plans for gated-off steps), and stages all
    of it in one host buffer, pinned on a card, uploaded with one
    non-blocking copy into a device buffer whose views every step reads:
    the indices (K, B), each plan array (K, …), λ as a (K,) column, the
    host draws of the model (Potes' dropout uniforms, drawn here in the
    order the eager steps draw them), and on a card each step's optimizer
    scalars.  ``gaussiannoise``'s noise is drawn per step from its seed
    into a device buffer beside it.

    On a CUDA device the K steps are one captured CUDA graph, replayed per
    chunk.  Before the first chunk on each side of the SELC turnpoint
    (SELC's loss is a Python branch on the epoch) the chunk runs once as K
    real eager steps on a side stream, the warm-up, whose effects are then
    undone; the K steps are captured, at most one graph per side, and every
    full chunk, the first included, is a replay.  The update is
    :class:`ScalarFedUpdate`, its scalars computed on the host from the
    scheduler that the eager route steps.  A chunk of fewer than K steps
    (an epoch's end) runs as eager steps.  A capture that fails raises;
    nothing falls back.  On the CPU the chunk
    runs as K eager steps with the optimizer's own step, the plain version,
    bit-equal to one step per dispatch.

    The K steps' loss, predictions and targets go to (K, …) output slots,
    copied out per chunk; a launch recorded in the capture counts once per
    replay (``ops/build.py::count_replay``), and the warm-up's launches
    count apart (``warm_up_counts``)."""

    def __init__(self, step: TrainStep, k: int):
        if k < 2:
            raise ValueError(f"a chunk takes at least 2 steps, got {k}")
        self.step, self.k = step, k
        self.device = step.train_data.device
        self.graph = self.device.type == "cuda"
        if self.graph and step.fed is None:  # a gang's step brings its own
            step.fed = ScalarFedUpdate(step.opt)
        self._layout: Optional[dict] = None  # field → (np dtype, per-step shape)
        self._draws: Optional[list] = None  # the host draws of one step
        self._graphs: dict = {}  # SELC side → (graph, launches it recorded)
        self._host: list = []
        self._events: list = []
        self._flip = 0
        self._stream = torch.cuda.Stream(self.device) if self.graph else None
        self.out: Optional[dict] = None  # the K steps' output slots
        self.noise: Optional[torch.Tensor] = None  # gaussiannoise's draws (K, B, …)

    # -- staging ----------------------------------------------------------
    def _fields(self, chunk: list, lrs: list) -> dict:
        """Every staged field of ``chunk`` as a host array (r, …)."""
        fields = {"idx": np.stack([np.asarray(i, np.int64) for i, _ in chunk])}
        for name, v in chunk[0][1].items():
            if name == "noise_seed":
                continue
            dtype = np.float32 if np.asarray(v).dtype.kind == "f" else np.int32
            try:
                fields["plan:" + name] = np.stack([np.asarray(a[name], dtype)
                                                   for _, a in chunk])
            except ValueError as e:
                raise ValueError(
                    f"plan array {name!r} changes shape between the steps of a chunk; "
                    "run with steps_per_dispatch=1") from e
        if self.graph:
            scal = []
            for _ in chunk:
                lr, momentum = schedule_values(self.step.opt, self.step.sched)
                lrs.append(lr)
                scal.append(self.step.fed.host_scalars(lr, momentum))
            fields["scalars"] = np.asarray(scal, np.float32)
        if self._draws:
            drawn = [[torch.rand(shape, generator=gen).numpy() for gen, shape in self._draws]
                     for _ in chunk]
            for j in range(len(self._draws)):
                fields[f"draw:{j}"] = np.stack([d[j] for d in drawn])
        return fields

    def _allocate(self, layout: dict) -> None:
        """Host and device buffers for ``layout``, every field 16-byte
        aligned, and the device views of each field."""
        if self._graphs:
            raise ValueError("the staged plan arrays changed layout after a CUDA graph "
                             "was captured; run with steps_per_dispatch=1")
        offsets, total = {}, 0
        for name, (dtype, shape) in layout.items():
            offsets[name] = total
            total += -(-self.k * int(np.prod(shape)) * np.dtype(dtype).itemsize // 16) * 16
        pin = self.graph
        self._host = [torch.empty(total, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(2 if self.graph else 1)]
        self._events = [None] * len(self._host)
        self._dev = (torch.empty(total, dtype=torch.uint8, device=self.device)
                     if self.graph else self._host[0])
        self._layout, self._offsets = layout, offsets
        self.views = {name: self._view(self._dev, name) for name in layout}

    def _view(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        """Field ``name`` of a staging buffer as a (K, …) tensor."""
        dtype, shape = self._layout[name]
        n = self.k * int(np.prod(shape)) * np.dtype(dtype).itemsize
        t = buf[self._offsets[name]:self._offsets[name] + n]
        return t.view(getattr(torch, np.dtype(dtype).name)).view(self.k, *shape)

    def _stage(self, chunk: list, lrs: list) -> None:
        fields = self._fields(chunk, lrs)
        layout = {name: (a.dtype, a.shape[1:]) for name, a in fields.items()}
        if layout != self._layout:
            self._allocate(layout)
        i = self._flip
        if self._events[i] is not None:
            self._events[i].synchronize()  # its last upload has left the buffer
        host = self._host[i]
        for name, a in fields.items():
            self._view(host, name)[:len(a)] = torch.from_numpy(a)
        if self.graph:
            self._dev.copy_(host, non_blocking=True)
            self._events[i] = torch.cuda.Event()
            self._events[i].record()
            self._flip = 1 - i
        seeds = [a["noise_seed"] for _, a in chunk if "noise_seed" in a]
        if seeds:
            shape = (len(chunk[0][0]), *self.step.train_data.shape[1:])
            if self.noise is None:
                self.noise = torch.zeros((self.k, *shape), device=self.device)
            for j, seed in enumerate(seeds):
                self.noise[j].copy_(gaussian_noise_draw(seed, shape, self.device))

    # -- execution --------------------------------------------------------
    def _run_step(self, j: int, epoch: int) -> None:
        """Step ``j`` of the staged chunk; the host draws come from the
        staged buffers once the layout holds them, else live."""
        v = self.views
        plan = {name[5:]: t[j] for name, t in v.items() if name.startswith("plan:")}
        if self.noise is not None:
            plan["noise"] = self.noise[j]
        draws = ([v[f"draw:{i}"][j] for i in range(len(self._draws))]
                 if "draw:0" in v else None)
        with feed_draws(draws) if draws is not None else contextlib.nullcontext():
            out = self.step.run(v["idx"][j], plan or None, epoch,
                                scalars=v["scalars"][j] if self.graph else None)
        if self.out is None:  # the K steps' output slots, shaped as a step's
            self.out = {name: t.new_zeros((self.k, *t.shape)) for name, t in out.items()}
        for name, t in out.items():
            self.out[name][j].copy_(t)

    def _eager(self, r: int, epoch: int, lrs: list) -> None:
        for j in range(r):
            if self._draws is None:  # the run's first step: log its host draws
                with record_draws() as log:
                    self._run_step(j, epoch)
                self._draws = log
            else:
                self._run_step(j, epoch)
            if not self.graph:
                lrs.append(self.step.last_lr)

    def _snapshot(self) -> dict:
        """What a warm-up chunk changes: weights and buffers, optimizer and
        scheduler state, the SELC table, the model's generators."""
        st = self.step
        return {
            "model": {k: v.clone() for k, v in st.model.state_dict().items()},
            "opt": {p: {k: v.clone() if torch.is_tensor(v) else v
                        for k, v in st.opt.state[p].items()} for p in st.fed.params},
            # the scheduler writes the group's lr and momentum; its own state
            # does not hold them
            "group": {k: copy.deepcopy(v) for k, v in st.opt.param_groups[0].items()
                      if k != "params"},
            "sched": copy.deepcopy(st.sched.state_dict()) if st.sched is not None else None,
            "soft": st.soft_labels.clone(),
            "gens": [(g, g.get_state()) for g in generators(st.model).values()],
            "t": st.fed.t,
        }

    @torch.no_grad()
    def _restore(self, snap: dict) -> None:
        """Put back a snapshot in place: a graph captures the addresses."""
        st = self.step
        for k, v in st.model.state_dict().items():
            v.copy_(snap["model"][k])
        for p, saved in snap["opt"].items():
            for k, v in saved.items():
                if torch.is_tensor(v):
                    st.opt.state[p][k].copy_(v)
        st.opt.param_groups[0].update(snap["group"])
        if st.sched is not None:
            st.sched.load_state_dict(snap["sched"])
        st.soft_labels.copy_(snap["soft"])
        for g, state in snap["gens"]:
            g.set_state(state)
        st.fed.t = snap["t"]
        for p in st.fed.params if st.fed.adam else ():
            st.opt.state[p]["step"].fill_(st.fed.t)

    def _warm_up(self, chunk: list, epoch: int) -> None:
        """Run ``chunk``'s K steps for real on the side stream (lazy
        initialization: cuBLAS and cuDNN handles, NCCL communicators, the
        optimizer state, the host draws' shapes), their launches counted
        apart (``ops/build.py::warm_up_counts``), then undo them: every
        step of the run is then the graph's."""
        snap = self._snapshot()
        self._stage(chunk, [])
        s, cur = self._stream, torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s), capturing(warm_up=True):
            self._eager(self.k, epoch, [])
        cur.wait_stream(s)
        self._restore(snap)

    def _capture(self, epoch: int, side: bool) -> None:
        """Capture the staged chunk's K steps for this side of the SELC
        turnpoint; raise if the capture fails."""
        graph = torch.cuda.CUDAGraph()
        try:
            with capturing() as launches, torch.cuda.graph(graph, stream=self._stream):
                for j in range(self.k):
                    self._run_step(j, epoch)
        except RuntimeError as e:
            where = ("the data-parallel step (its collectives inside the graph; "
                     "ROADMAP queue 1 item 14)" if self.step.dp is not None
                     else "the train step")
            raise RuntimeError(f"capturing {where} as a CUDA graph failed: {e}") from e
        self._graphs[side] = (graph, launches)

    def run(self, chunk: list, epoch: int) -> dict:
        """Run ``chunk`` (at most K (indices, plan arrays) pairs) at ``epoch``;
        returns the steps' device outputs, (r,) losses and (r·B,)
        predictions and targets, and ``lr``, the r learning rates."""
        r, lrs = len(chunk), []
        if not 0 < r <= self.k:
            raise ValueError(f"a chunk of {r} steps (K = {self.k})")
        side = epoch > self.step.selc_es
        graphed = self.graph and r == self.k
        if graphed and side not in self._graphs:
            self._warm_up(chunk, epoch)
            self._stage(chunk, lrs)
            self._capture(epoch, side)
        else:
            self._stage(chunk, lrs)
        if graphed:
            graph, launches = self._graphs[side]
            graph.replay()
            count_replay(launches)
        else:
            self._eager(r, epoch, lrs)
        out = {name: t[:r].clone().reshape(-1) for name, t in self.out.items()}
        return {**out, "lr": lrs}


def generators(model: nn.Module) -> dict:
    """Every module's own ``torch.Generator`` (Potes' dropout), by name."""
    return {name: m.generator for name, m in model.named_modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)}


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

"""Gang training: one vmapped program trains a seed grid at once
(counterpart: ``pcgmix_tpu/train/gang.py``).

The paper's numbers are means over seed grids, about ten runs per (model,
method, n_fraction) that differ only in ``seed_data`` and ``seed``.  A gang
trains S such members as one program on one device:

- the members' splits are row subsets of one base corpus
  (``ArrayDataset.rows``), which is uploaded once; a step gathers every
  member's batch from it by base row;
- the state is one module's parameters and buffers stacked on a leading
  member axis, run through ``torch.func.functional_call`` under
  ``torch.func.vmap`` (a convolution becomes a grouped one); the members
  start from the same init (the grid shares ``seed_fix``) and diverge
  through their data order and plans; BatchNorm's in-place updates land in
  the stacked buffers, and one backward of the members' summed losses
  gives each member its own gradients;
- each member's plan comes from its own engine, so it equals its
  standalone run's bit for bit; the plans are concatenated with their row
  indices offset by s·B and applied **outside** the vmapped function, one
  K1 or K2 launch on the (S·B, C, T) batch a step (the kernels have no
  vmap rule); the split-forward methods run the vmapped first part, K1
  (or the plain apply) on the S·B latent rows, and the vmapped second part;
- the update is :class:`ScalarFedUpdate` with one row of scalars per
  member, (S, 3); Potes' dropout draws come from each member's own
  generator, seeded as its standalone run seeds it, stacked and fed in;
- members with unequal train sizes or test folds (UMC's ten folds) train
  in lockstep epochs of the longest member: an idle member re-feeds its
  last batch, draws nothing, and every bit of its state (parameters, Adam
  moments, BatchNorm buffers and counters, SELC rows, step count) is put
  back after the step (``torch.where``); each member's OneCycle values
  come from its own step count;
- each member writes its own run directory (``performance.pkl``,
  ``model.pth``) as its own ``train_model`` run would; ``times`` is the
  gang's wall clock.

The model-in-the-loop methods (JAX ``gang.py:533-617``, ``:735-931``)
dispatch one gang step at a time:

- the frozen-model hooks: a ``(salopt…)`` member plans with its own
  pretrained saliency provider (``saliency_model_providers``, one per
  member), a ``(closestknn/closestbins)`` member with the shared frozen
  embedder (``latent_feature_fn``; by default the canonical ResCNN run,
  as ``train_model`` resolves it); each hook runs on the member's batch
  gathered from the base corpus, so the plans equal the standalone runs'
  bit for bit, and the one apply on S·B rows follows;
- the live-model mode, on the equal path only: ``saliency-cutmix`` takes
  one vmapped eval-mode saliency pass over the stacked state (only where
  the member-uniform ``+p`` gate lets the plan ask for it), bins each
  member's maps on the host and applies the members' splices in one K1
  launch; ``lc-nointrusion`` joins every member's pool of 4B candidates
  in one K1 launch (S·4B rows, zero base), scores them with one vmapped
  eval-mode forward, picks each member's rows with its own ``lc_select``
  and trains on the picks gathered from the scored pool, their SELC rows
  the picks' source rows.

With ``steps_per_dispatch`` K > 1 the equal path runs K gang steps as one
CUDA graph (``train/steps.py::MultiStep`` over :class:`GangStep`), except
for those methods.  With ``n_devices`` > 1 the members are split over that
many spawned ranks, each training S/n whole members (and their providers)
with no collectives.  The dumps (``latent_space``, ``track_variability``)
and the recurrent models are not ganged: :func:`gang_ineligible_reason`
says why, and the runner trains them through ``train_model``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, grad, stack_module_state, vmap

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.augment.engine import (
    LIVE_MODEL_BASES,
    SHARED_ARRAYS,
    AugmentConfig,
    AugmentEngine,
    gaussian_noise_draw,
)
from pcgmix_tpu_torch.augment.methods import parse_method
from pcgmix_tpu_torch.augment.pairing import LATENT_PAIRINGS
from pcgmix_tpu_torch.data import EpochIterator, eval_batches
from pcgmix_tpu_torch.data.datasets import ArrayDataset, load_cvd_map
from pcgmix_tpu_torch.data.umc import swap_umc_labels
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.models import build_model, count_parameters
from pcgmix_tpu_torch.models.layers import feed_draws, host_uniform, record_draws
from pcgmix_tpu_torch.parallel import spawn
from pcgmix_tpu_torch.parallel.dist import batch_rows
from pcgmix_tpu_torch.saliency import (
    TRAINING_KERNEL,
    bin_training_saliency,
    hard_targets,
    smoothed_saliency,
)
from pcgmix_tpu_torch.timing import timed
from pcgmix_tpu_torch.train.checkpoint import CheckpointManager
from pcgmix_tpu_torch.train.convert import seeded_init
from pcgmix_tpu_torch.train.losses import init_selc_table
from pcgmix_tpu_torch.train.loop import (
    TrainConfig,
    _engine_rng_replayable,
    _picklable,
    _plot_epoch,
    _putter,
    _selc_turnpoint,
    _start_profile,
    _stop_profile,
    add_eval,
    build_splits,
    replay_plan_rng,
    resolve_device,
    stage_eval,
)
from pcgmix_tpu_torch.train.metrics import PerformanceTracker, segment_accuracy
from pcgmix_tpu_torch.train.steps import (
    MultiStep,
    ScalarFedUpdate,
    eval_mode,
    generators,
    make_optimizer,
    schedule_values,
)

# the config fields gang members may differ in: seed_data picks the train
# subset, seed the epoch order (and Potes' dropout stream)
_MEMBER_FIELDS = ("seed_data", "seed")
# torch has no vmap batching rule for its recurrent layers
RECURRENT_MODELS = ("RNN", "LSTM", "GRU")
# plan arrays that index the batch's rows: a member's are offset by s·B
_ROW_INDEX = ("mix", "idx1", "idx2")


def gang_ineligible_reason(cfg: TrainConfig, model_hooks: bool = False) -> Optional[str]:
    """Why ``cfg`` cannot train in a gang (None: it can), from the config
    alone, so that the runner groups a grid before it loads data (JAX
    ``gang.py:105-151``, its reasons word for word).  ``model_hooks=True``
    says the caller wires the frozen-model hooks (one saliency provider per
    member, the embedder), which makes the ``(salopt…)`` methods and the
    closest pairings eligible; the live-model methods always are.  The
    port adds one reason: the recurrent models."""
    if cfg.classical_space:
        return "classical_space dumps need host-side batch tensors"
    if cfg.latent_space:
        return "latent_space dumps need host-side batch tensors"
    if cfg.track_variability:
        return "variability tracking reads per-member host batches"
    if cfg.model in RECURRENT_MODELS:
        return (f"{cfg.model}: torch has no vmap batching rule for its recurrent "
                "layer, so it trains sequentially")
    spec = parse_method(cfg.method, spectrogram=cfg.spectrogram)
    if spec.salopt is not None and not model_hooks:
        return ("saliency planning needs per-member pretrained providers "
                "(train_gang(saliency_model_providers=…); the runner's "
                "--gang wires them)")
    if spec.pairing in LATENT_PAIRINGS and not model_hooks:
        return ("latent pairing needs the frozen embedding model "
                "(train_gang auto-resolves it once its canonical run "
                "exists; the runner's --gang trains it first)")
    return None


def _member_free(cfg: TrainConfig) -> dict:
    d = dataclasses.asdict(cfg)
    for f in _MEMBER_FIELDS:
        d.pop(f)
    return d


def _validate_members(cfgs: list) -> None:
    base = _member_free(cfgs[0])
    for cfg in cfgs[1:]:
        d = _member_free(cfg)
        if d != base:
            diff = [k for k in d if d[k] != base[k]]
            raise ValueError(f"gang members may differ only in {_MEMBER_FIELDS}; "
                             f"got differing fields {diff}")


def group_gangable(cfgs: list, model_hooks: bool = False) -> list:
    """Bucket configs into gangs: two share a bucket when they differ only
    in ``seed_data``/``seed`` and are eligible (``model_hooks`` as in
    :func:`gang_ineligible_reason`); an ineligible config is a bucket of
    its own.  Split sizes never split a bucket (the ragged path takes
    them).  Buckets follow first appearance; members keep input order."""
    groups: dict = {}
    for cfg in cfgs:
        if gang_ineligible_reason(cfg, model_hooks) is not None:
            key = ("ineligible", id(cfg))
        else:
            key = (repr(sorted(_member_free(cfg).items(), key=lambda kv: kv[0])),)
        groups.setdefault(key, []).append(cfg)
    return list(groups.values())


def _base_train_dataset(cfg: TrainConfig, dataset: dict) -> ArrayDataset:
    """The base corpus the members' ``rows`` index into: the from_dict that
    physionet_split/umc_split take from (UMC with its label swap)."""
    if cfg.dataset.startswith("PhysioNet"):
        return ArrayDataset.from_dict(dataset["train"], cfg.num_channels,
                                      spectrogram=cfg.spectrogram)
    if cfg.dataset.startswith("UMC"):
        ds = ArrayDataset.from_dict(dataset, cfg.num_channels, spectrogram=cfg.spectrogram)
        ds.label = swap_umc_labels(ds.label)
        return ds
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _check_provenance(base: ArrayDataset, cfgs, train_sets, member_rows) -> None:
    """A member's rows of the base must hold its split's labels and data:
    the step gathers both from the base."""
    for cfg, tr, rows in zip(cfgs, train_sets, member_rows):
        if not np.array_equal(base.label[rows], tr.label):
            raise AssertionError(f"base/split label mismatch for seed_data={cfg.seed_data}")
        li = np.arange(len(rows))[:: max(1, len(rows) // 8)][:8]
        if not np.array_equal(base.data[rows[li]], tr.data[li]):
            raise AssertionError(f"base/split data mismatch for seed_data={cfg.seed_data}")


def _member_engines(cfgs, train_sets) -> list:
    """One planning engine per member: its NumPy mirror stream advances as
    its standalone run's does."""
    shape = train_sets[0].data.shape
    engines = []
    for cfg in cfgs:
        cvd_map = load_cvd_map(cfg.cvd_map) if isinstance(cfg.cvd_map, str) else cfg.cvd_map
        engines.append(AugmentEngine(AugmentConfig(
            method=cfg.method, batch_size=cfg.batch_size, num_channels=shape[1],
            sig_len=shape[-1], sample_rate=cfg.sample_rate, cvd_map=cvd_map,
            spectrogram=cfg.spectrogram, spec_freq=shape[-2] if cfg.spectrogram else 0,
            model=cfg.model, num_classes=cfg.num_classes)))
    return engines


def gang_plan(arrays: list, batch: int) -> Optional[dict]:
    """One plan for a gang's S·B rows from the members' plan arrays (host):
    the batch-leading arrays concatenated, the row indices offset by s·B,
    a per-step scalar kept where the members agree and else spread to one
    value per row (λ, the gate, the sinusoid), the noise seeds kept one
    per member.  None where the members' plans cannot share one apply (a
    2-D frequency band that differs between members): they are then
    applied one by one."""
    out = {}
    for k in arrays[0]:
        vals = [a[k] for a in arrays]
        if k == "noise_seed":
            out[k] = np.asarray(vals, np.int64)
        elif k in _ROW_INDEX:
            out[k] = np.concatenate([np.asarray(v, np.int64) + s * batch
                                     for s, v in enumerate(vals)])
        elif k in SHARED_ARRAYS or np.ndim(vals[0]) == 0:
            if all(np.array_equal(vals[0], v) for v in vals[1:]):
                out[k] = vals[0]
            elif k in ("lam", "gate"):
                out[k] = np.repeat(np.asarray(vals, np.float32), batch)
            elif k == "sinusoid":
                out[k] = np.repeat(np.stack(vals)[:, None, :], batch, axis=0)
            else:
                return None
        else:
            out[k] = np.concatenate([np.asarray(v) for v in vals])
    return out


class _Generators(nn.Module):
    """Holds one member's generator (``train/steps.py::generators`` finds
    it), so that checkpoints and a graph's warm-up save and restore it."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.generator = generator


class _Stacked(nn.Module):
    """The gang's state as one module: each parameter and buffer of the
    template stacked on a leading member axis (``:`` for ``.`` in the
    names), and each member's generators."""

    def __init__(self, params: dict, buffers: dict, member_gens: list):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name.replace(".", ":"), nn.Parameter(t.detach().clone()))
        for name, t in buffers.items():
            self.register_buffer(name.replace(".", ":"), t.detach().clone())
        self.gens = nn.ModuleList(_Generators(g) for gens in member_gens for g in gens)
        self._names = (list(params), list(buffers))

    @property
    def params(self) -> dict:
        """The stacked parameters under the template's names."""
        return {n: getattr(self, n.replace(".", ":")) for n in self._names[0]}

    @property
    def buffers_(self) -> dict:
        """The stacked buffers under the template's names."""
        return {n: getattr(self, n.replace(".", ":")) for n in self._names[1]}


class MemberFedUpdate(ScalarFedUpdate):
    """:class:`ScalarFedUpdate` over a gang's stacked parameters, with each
    member's own step count: :meth:`member_scalars` gives the (S, 3)
    scalars of one gang step; :meth:`host_scalars` those of a step every
    member takes at one learning rate (the equal path, and the graph)."""

    def __init__(self, opt, members: int):
        self.ts = np.zeros(members, np.int64)
        super().__init__(opt)

    @property
    def t(self) -> int:
        return int(self.ts.max())

    @t.setter
    def t(self, value: int) -> None:
        self.ts[:] = value

    def host_scalars(self, lr: float, momentum: float) -> np.ndarray:
        n = len(self.ts)
        return self.member_scalars([lr] * n, [momentum] * n, [True] * n)

    def member_scalars(self, lrs, moms, active) -> np.ndarray:
        """(S, 3) float32 scalars; advances the active members' counts.  An
        idle member's row is inert (its update is put back anyway)."""
        rows = []
        beta2 = self.group["betas"][1] if self.adam else 0.0
        for s, (lr, mom, act) in enumerate(zip(lrs, moms, active)):
            if not act:
                rows.append((0.0, 0.0, 1.0))
            elif not self.adam:
                rows.append((mom, -lr, 0.0))
            else:
                self.ts[s] += 1
                t = float(self.ts[s])
                rows.append((1.0 - mom, -(lr / (1.0 - mom ** t)), (1.0 - beta2 ** t) ** 0.5))
        return np.asarray(rows, np.float32)


class GangStep:
    """A train step of S members over a corpus held on the device.

    :meth:`__call__` takes host arrays: ``idx`` (2, S, B), each member's
    split-local row indices (SELC's) and their base rows (the gather's),
    and each member's plan arrays or None; :meth:`run` is the step on
    device tensors, the body a CUDA graph captures (``MultiStep`` drives it
    as it drives ``TrainStep``).  Returns the members' (S,) losses and
    (S, B) predictions and targets."""

    def __init__(self, template: nn.Module, member_gens: list, opt_args: tuple, *,
                 train_data: torch.Tensor, train_labels: torch.Tensor,
                 soft_labels: torch.Tensor, num_classes: int, grad_clip: float,
                 selc_es: int, engine: Optional[AugmentEngine]):
        S = len(member_gens)
        params, buffers = stack_module_state([template] * S)
        self.template = template.to("meta")  # functional_call's module; holds nothing
        self.model = _Stacked(params, buffers, member_gens).to(train_data.device)
        self.member_gens = [list(g) for g in member_gens]
        self.template_gens = list(generators(template).values())
        self.opt, self.sched = make_optimizer(self.model, *opt_args)
        self.fed = MemberFedUpdate(self.opt, S)
        self.train_data, self.train_labels = train_data, train_labels
        self.soft_labels = soft_labels
        self.num_classes, self.grad_clip, self.selc_es = num_classes, grad_clip, selc_es
        self.engine = engine
        self.members = S
        self.dp = None  # MultiStep reads it: a gang runs on one device
        self.last_lr: Optional[float] = None
        self._draw_shapes: dict = {}

    # -- host → device ----------------------------------------------------
    def __call__(self, idx: np.ndarray, arrays: Optional[list], epoch: int,
                 latent_depth: Optional[int] = None, scalars: Optional[np.ndarray] = None,
                 drawing: Optional[list] = None) -> dict:
        dev = self.train_data.device
        idx_t = torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(dev)
        plan = None
        if arrays is not None:
            B = idx.shape[-1]
            joined = gang_plan(arrays, B)
            plan = ([self.device_plan(a, B, 1) for a in arrays] if joined is None
                    else self.device_plan(joined, B, len(arrays)))
        s = None if scalars is None else torch.from_numpy(scalars).to(dev)
        return self.run(idx_t, plan, epoch, latent_depth, s, drawing)

    def device_plan(self, arrays: dict, batch: int, members: int) -> dict:
        """Upload a plan; the noise seeds become the members' noise."""
        arrays = dict(arrays)
        seeds = arrays.pop("noise_seed", None)
        dev = self.train_data.device
        plan = AugmentEngine.device_arrays(arrays, dev)
        if seeds is not None:
            shape = (batch, *self.train_data.shape[1:])
            plan["noise"] = torch.cat([gaussian_noise_draw(int(sd), shape, dev)
                                       for sd in np.broadcast_to(seeds, (members,))])
        return plan

    # -- the step -----------------------------------------------------------
    def _apply(self, data, target, plan):
        if isinstance(plan, list):  # one apply per member (see gang_plan)
            B = data.shape[0] // len(plan)
            outs = [self.engine.apply(data[s * B:(s + 1) * B], target[s * B:(s + 1) * B], p)
                    for s, p in enumerate(plan)]
            return torch.cat([d for d, _ in outs]), torch.cat([t for _, t in outs])
        return self.engine.apply(data, target, plan)

    def draw_shapes(self, in_shape, depth, part, first_eval: bool) -> list:
        """(generator index, shape) of each host draw of one member's
        forward, in order: from a forward of the template on the meta
        device, once per geometry."""
        key = (tuple(in_shape), depth, part, first_eval)
        if key not in self._draw_shapes:
            shapes = []
            if self.template_gens:
                kw = {} if part is None else {"depth": depth, "part": part}
                with torch.no_grad(), record_draws() as log, \
                        batch_rows(in_shape[0], slice(0, in_shape[0]), replicated=True), \
                        (eval_mode(self.template) if first_eval else contextlib.nullcontext()):
                    self.template(torch.zeros(in_shape, device="meta"), **kw)
                ids = [id(g) for g in self.template_gens]
                shapes = [(ids.index(id(g)), shape) for g, shape in log]
            self._draw_shapes[key] = shapes
        return self._draw_shapes[key]

    def _forward(self, x, depth=None, part=None, first_eval=False, drawing=None):
        """The members' forward, vmapped over the stacked state: x (S, B, …)."""
        S, B = x.shape[:2]
        dev = x.device
        draws = [torch.stack([
            host_uniform(self.member_gens[s][gi], shape, dev)
            if drawing is None or drawing[s] else torch.zeros(shape, device=dev)
            for s in range(S)]) for gi, shape in self.draw_shapes(
                x.shape[1:], depth, part, first_eval)]
        kw = {} if part is None else {"depth": depth, "part": part}

        def member(p, b, xs, d):
            with feed_draws(d), batch_rows(B, slice(0, B), replicated=True):
                return functional_call(self.template, (p, b), (xs,), kw)

        with eval_mode(self.template) if first_eval else contextlib.nullcontext():
            return vmap(member, randomness="error")(self.model.params, self.model.buffers_,
                                                    x, draws)

    def _losses(self, out, target, local, epoch, momentum: float = 0.9):
        """Each member's SELC / soft-target CE (``train/losses.py``), (S,)."""
        logp = F.log_softmax(out.float(), dim=-1)
        if epoch <= self.selc_es:
            return -(logp * target.float()).sum(-1).mean(-1)
        S, N, K = self.soft_labels.shape
        B = out.shape[1]
        flat = (local + torch.arange(S, device=local.device)[:, None] * N).reshape(-1)
        table = self.soft_labels.view(S * N, K)
        pred = F.softmax(out.detach().float(), dim=-1).reshape(S * B, K)
        new_rows = momentum * table.index_select(0, flat) + (1.0 - momentum) * pred
        table.index_copy_(0, flat, new_rows)
        return -(logp * new_rows.view(S, B, K)).sum(-1).mean(-1)

    def gather(self, rows: torch.Tensor):
        """(data, one-hot target) of base rows ``rows`` (a device tensor)."""
        data = self.train_data.index_select(0, rows)
        target = F.one_hot(self.train_labels.index_select(0, rows),
                           self.num_classes).to(data.dtype)
        return data, target

    def run(self, idx: torch.Tensor, plan, epoch: int, latent_depth: Optional[int] = None,
            scalars: Optional[torch.Tensor] = None, drawing: Optional[list] = None) -> dict:
        """The step on device tensors: ``idx`` (2, S, B), the gang's plan
        (device arrays, or a list of the members'), and the members' (S, 3)
        optimizer scalars (None: this step's, from the schedule)."""
        data, target = self.gather(idx[1].reshape(-1))
        latent = plan is not None and latent_depth is not None
        if plan is not None and not latent:
            data, target = self._apply(data, target, plan)
        return self.train_on(data, target, idx[0], epoch, scalars, drawing,
                             latent_depth if latent else None, plan if latent else None)

    def train_on(self, data: torch.Tensor, target: torch.Tensor, local: torch.Tensor,
                 epoch: int, scalars: Optional[torch.Tensor] = None,
                 drawing: Optional[list] = None, latent_depth: Optional[int] = None,
                 latent_plan=None) -> dict:
        """Forward, loss, backward and update on the members' S·B rows
        ``data`` and their one-hot ``target``, whose SELC rows are ``local``
        (S, B); split at ``latent_depth`` with ``latent_plan``."""
        S, B = local.shape
        self.template.train()
        x = data.view(S, B, *data.shape[1:])
        if latent_plan is not None:
            manifold = self.engine.spec.manifold
            with torch.no_grad() if manifold else contextlib.nullcontext():
                h = self._forward(x, latent_depth, "first", manifold, drawing)
            h, target = self._apply(h.reshape(S * B, *h.shape[2:]), target, latent_plan)
            out = self._forward(h.view(S, B, *h.shape[1:]), latent_depth, "second",
                                drawing=drawing)
        else:
            out = self._forward(x, drawing=drawing)
        target = target.view(S, B, -1)
        losses = self._losses(out, target, local, epoch)
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        losses.sum().backward()
        for p in params:
            if p.grad is None:  # a manifold method's first part: zero, not none
                p.grad = torch.zeros_like(p)
        if self.grad_clip:
            nn.utils.clip_grad_value_(params, self.grad_clip)
        if scalars is None:
            self.last_lr, momentum = schedule_values(self.opt, self.sched)
            scalars = torch.from_numpy(self.fed.host_scalars(self.last_lr, momentum)).to(
                data.device)
        self.fed.apply(scalars)
        return {"loss": losses.detach(), "preds": out.detach().argmax(-1),
                "target": target.argmax(-1)}

    # -- the ragged path's masked no-op --------------------------------------
    @contextlib.contextmanager
    def masked(self, active: np.ndarray):
        """Within: a step whose update only the ``active`` members keep;
        every tensor of an idle member's state is put back as it was."""
        if active.all():
            yield
            return
        tensors = [*self.model.parameters(), *self.model.buffers(), self.soft_labels,
                   *(t for p in self.fed.params for t in self.opt.state[p].values()
                     if torch.is_tensor(t) and t.dim() and t.shape[0] == self.members)]
        saved = [t.detach().clone() for t in tensors]
        yield
        on = torch.from_numpy(active).to(self.train_data.device)
        with torch.no_grad():
            for t, old in zip(tensors, saved):
                t.copy_(torch.where(on.view(-1, *(1,) * (t.dim() - 1)), t, old))

    # -- the live model's passes -------------------------------------------
    def live_saliency(self, rows: torch.Tensor, end) -> torch.Tensor:
        """Each member's live saliency maps of its batch, (S·B, T): one
        vmapped gradient of the correct-class score sum with respect to the
        input, in eval mode (``saliency.py::training_saliency_raw``'s
        steps; no parameter gradient, no BatchNorm update), then the same
        smoothing and scaling.  ``rows`` (S, B) base rows, ``end`` (S·B,)."""
        S, B = rows.shape
        data, target = self.gather(rows.reshape(-1))
        target = hard_targets(target)
        params = {k: v.detach() for k, v in self.model.params.items()}

        def score(x, p, b, t):
            return (functional_call(self.template, (p, b), (x,)) * t).sum()

        with eval_mode(self.template):
            g = vmap(grad(score))(data.view(S, B, *data.shape[1:]), params,
                                  self.model.buffers_, target.view(S, B, -1))
        end = torch.as_tensor(np.asarray(end, np.int64), device=data.device)
        return smoothed_saliency(g.reshape(S * B, *g.shape[2:]), end, *TRAINING_KERNEL,
                                 post_zero_tail=False)

    def candidate_losses(self, cands: torch.Tensor, cand_t: torch.Tensor) -> torch.Tensor:
        """Each member's per-row CE of its candidate pool under eval mode,
        (S, N) from (S·N, …) rows and targets (``train/steps.py::
        candidate_losses`` under vmap)."""
        S = self.members
        return self.evaluate(cands.view(S, -1, *cands.shape[1:]),
                             cand_t.view(S, -1, cand_t.shape[-1]), shared=False)[1]

    # -- eval and the members' weights -------------------------------------
    @torch.no_grad()
    def evaluate(self, data: torch.Tensor, target: torch.Tensor, shared: bool):
        """Softmax probabilities and per-sample CE of every member: (S, n, C)
        and (S, n); ``data`` shared by the members, or (S, n, …)."""
        def member(p, b, x, t):
            out = functional_call(self.template, (p, b), (x,))
            return F.softmax(out, dim=1), -(F.log_softmax(out, dim=1) * t).sum(dim=1)

        dims = None if shared else 0
        with eval_mode(self.template):
            return vmap(member, in_dims=(0, 0, dims, dims))(
                self.model.params, self.model.buffers_, data, target)

    def member_state_dict(self, s: int) -> dict:
        """Member ``s``'s slice, as its own module's ``state_dict``."""
        state = {**self.model.params, **self.model.buffers_}
        return {k: v[s].detach().clone() for k, v in state.items()}


# --------------------------------------------------------------------------- #
# schedules, eval staging, checkpoints, plot epochs
# --------------------------------------------------------------------------- #


def schedule_table(cfg: TrainConfig, num_steps: int) -> list:
    """The (learning rate, momentum) of each of ``num_steps`` steps, as a
    run of that many steps reads them (``train/steps.py::schedule_values``
    on the optimizer and OneCycle of ``make_optimizer``)."""
    opt, sched = make_optimizer(nn.Linear(1, 1), cfg.op, cfg.lr_max, cfg.weight_decay,
                                num_steps, cfg.use_sched)
    return [schedule_values(opt, sched) for _ in range(num_steps)]


def _stage_eval_ragged(test_sets, cfg0: TrainConfig, device) -> tuple:
    """Every member's own eval batches, stacked per batch position: a
    member with fewer batches or rows there is padded with zero rows, which
    the host drops.  Returns (per-member host batches, [(data (S, n, …),
    one-hot targets (S, n, C))])."""
    batches = [list(eval_batches(te, cfg0.eval_batch_size)) for te in test_sets]
    eye = np.eye(cfg0.num_classes, dtype=np.float32)
    stacked = []
    for j in range(max(len(b) for b in batches)):
        here = [b[j] if j < len(b) else None for b in batches]
        n = max(len(h["label"]) for h in here if h is not None)
        row = next(h for h in here if h is not None)["data"].shape[1:]
        data = np.zeros((len(here), n, *row), np.float32)
        target = np.zeros((len(here), n, cfg0.num_classes), np.float32)
        for s, h in enumerate(here):
            if h is not None:
                data[s, :len(h["label"])] = h["data"]
                target[s, :len(h["label"])] = eye[h["label"]]
        stacked.append((torch.from_numpy(data).to(device), torch.from_numpy(target).to(device)))
    return batches, stacked


def _open_gang_ckpt(cfg0: TrainConfig, run_dirs) -> Optional[CheckpointManager]:
    """One checkpoint of the stacked state for the whole gang, keyed by the
    members' run dirs, so that the same configs resume it."""
    if not (cfg0.checkpoint_every and all(d is not None for d in run_dirs)):
        return None
    digest = hashlib.sha1("\n".join(run_dirs).encode()).hexdigest()[:16]
    return CheckpointManager(os.path.join(cfg0.experiments_root, ".gang_checkpoints", digest))


def _cleanup_gang_ckpt(ckpt: Optional[CheckpointManager]) -> None:
    """Drop the gang checkpoint once the members' run dirs hold the
    results: kept, it would make a later rerun of the grid (its run dirs
    deleted to retrain) resume past its end."""
    if ckpt is not None:
        ckpt.close()
        shutil.rmtree(ckpt.directory, ignore_errors=True)


def _emit_member_plot_epoch(perf, run_dir, epoch, steps, train_loss, train_acc, outs,
                            batches, class_majority, times, cfg, lr_list) -> None:
    """One member's plot-epoch record and plots, as ``train_model`` writes
    them (``pcgmix_tpu/train/gang.py:331-365``)."""
    perf.add("epochs", epoch)
    perf.add("steps", steps)
    perf.add("train_loss", train_loss)
    perf.add("train_accuracy", train_acc)
    add_eval(perf, outs, batches, class_majority)
    perf.add("times", float(np.sum(times)))
    if run_dir:
        utils.save_dict(perf.dict, os.path.join(run_dir, "performance.pkl"))
        if cfg.plot:
            _plot_epoch(cfg, perf, run_dir, lr_list, times)


# --------------------------------------------------------------------------- #
# sizing and advice
# --------------------------------------------------------------------------- #


def _sample_shape(cfg: TrainConfig, sample_shape: Optional[tuple]) -> tuple:
    """A member's input row: given, else (C, 2500) or a square spectrogram."""
    if sample_shape is not None:
        return tuple(sample_shape)
    return (1, 2500, 2500) if cfg.spectrogram else (cfg.num_channels, 2500)


def _model_for(cfg: TrainConfig, sample_shape: tuple) -> nn.Module:
    return build_model(cfg.model, cfg.num_classes, sample_shape[0], sample_shape[-1],
                       dataset=cfg.dataset,
                       freq=sample_shape[-2] if cfg.spectrogram else None,
                       conv_impl=cfg.conv_impl, compute_dtype=cfg.compute_dtype)


def variable_bytes(model: nn.Module) -> int:
    """Bytes of the parameters and BatchNorm running statistics: the JAX
    package's params plus batch_stats (flax keeps no batch counter)."""
    return (sum(p.numel() * p.element_size() for p in model.parameters())
            + sum(b.numel() * b.element_size() for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))))


def gang_state_bytes(cfg: TrainConfig, train_size: int,
                     sample_shape: Optional[tuple] = None) -> int:
    """A member's state: its variables times (1 + the optimizer's copies:
    Adam's two moments, SGD's momentum) plus its SELC table."""
    model = _model_for(cfg, _sample_shape(cfg, sample_shape))
    copies = 2 if cfg.op.lower() == "adam" else 1
    return variable_bytes(model) * (1 + copies) + train_size * cfg.num_classes * 4


def activation_bytes(model: nn.Module, input_shape: tuple) -> int:
    """Bytes that autograd saves in one train-mode forward of a batch of
    ``input_shape`` (the parameters aside), from a run on the meta device."""
    m = copy.deepcopy(model).to("meta").train()
    params = {id(p) for p in m.parameters()}
    saved: dict = {}

    def pack(t):
        if id(t) not in params:
            saved[id(t)] = t
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        m(torch.zeros(input_shape, device="meta"))
    return sum(t.numel() * t.element_size() for t in saved.values())


#: autograd's saved bytes → a member's share of a gang's peak memory, per
#: compute dtype (see :func:`estimate_gang_max_size`)
REUSE = {"float32": 1.5, "bfloat16": 1.6}


def estimate_gang_max_size(cfg: TrainConfig, train_size: int, corpus_bytes: int = 0,
                           hbm_bytes: Optional[int] = None, reuse: Optional[float] = None,
                           safety: float = 0.8, sample_shape: Optional[tuple] = None) -> int:
    """The largest gang the device holds (the JAX package's budget model):
    per member the state (:func:`gang_state_bytes`) and the activations
    (:func:`activation_bytes` times ``reuse``); once, the base corpus;
    ``S_max = (hbm × safety − corpus) // per_member``, at least 1.
    ``hbm_bytes`` defaults to the card's memory, 8 GiB on the CPU.

    ``reuse`` defaults to the dtype's :data:`REUSE`, 1.5 in float32 where
    the JAX package takes 0.25 for XLA's buffer reuse: on an NVIDIA H100
    (``chip_smoke.py`` phase 3g, batch 64) each member past the first added
    1.38× the bytes autograd saves to the gang's peak memory for ResNet9
    (2.10 GiB against 1.52 GiB) and 1.20× for Potes (the vmapped
    convolutions' transposes and workspaces); the costs every gang pays
    once (corpus, eval, workspaces: up to 3.4 GiB) fall within ``safety``.  In bf16 (``compute_dtype="bfloat16"``, phase
    3h) a ResNet9 member added 1.576× its saved bytes (1.74 GiB against
    1.10 GiB: the BatchNorm's float32 upcast is saved too), so bf16 takes
    1.6."""
    shape = _sample_shape(cfg, sample_shape)
    model = _model_for(cfg, shape)
    if reuse is None:
        reuse = REUSE[cfg.compute_dtype]
    per_member = (gang_state_bytes(cfg, train_size, shape)
                  + activation_bytes(model, (cfg.batch_size, *shape)) * reuse)
    if hbm_bytes is None:
        device = torch.device(cfg.device)
        if device.type == "cuda" and torch.cuda.is_available():
            hbm_bytes = torch.cuda.mem_get_info(device)[1]
        else:
            hbm_bytes = 8 * 1024**3
    budget = hbm_bytes * safety - corpus_bytes
    return max(1, int(budget // max(per_member, 1)))


def gang_profitable(cfg: TrainConfig, param_threshold: int = 1_000_000) -> bool:
    """The JAX package's advice, kept as its rule: a model under
    ``param_threshold`` parameters gains from a gang, a larger one does not.

    On an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 3g,
    PCGmix+, batch 64), aggregated member-steps/s against sequential runs:
    Potes (200k parameters, host-bound) 1.01–1.22× at S = 2, 1.30–1.47× at
    S = 4, 1.59–1.77× at S = 8; ResNet9 (2.3M, device-bound) 0.75–0.84× at
    S = 1 and 0.50–0.59× at S = 2–8, two fifths of the gang's device time in
    cuDNN's layout transposes around its grouped convolutions, and
    0.91–0.94× at S = 4 with ``conv_impl="matmul"``.  Advisory only: the
    runner gangs when asked and prints this."""
    shape = _sample_shape(cfg, None)
    return count_parameters(_model_for(cfg, shape)) < param_threshold


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #


def train_gang(cfgs: list, dataset: dict, *, n_devices: Optional[int] = None,
               progress: bool = False, saliency_model_providers: Optional[list] = None,
               latent_feature_fn=None) -> list:
    """Train the members ``cfgs`` together; returns one performance dict
    per member, of ``train_model``'s schema.  Members of unequal train
    sizes or test splits take the lockstep path (:func:`is_ragged`).

    The frozen-model hooks, as ``train_model`` takes them: for a
    ``(salopt…)`` method ``saliency_model_providers``, one provider per
    member, each closing over that member's own pretrained checkpoint
    (``saliency.make_pretrained_saliency_fn``); for a closest pairing
    ``latent_feature_fn``, the shared frozen embedder (by default the
    canonical ResCNN run of ``experiments_root``).

    ``n_devices`` > 1 splits the members over that many spawned ranks
    (NCCL on cards, gloo on the CPU), S/n whole members each, with their
    providers, which must pickle; ``TrainConfig.n_devices`` does not apply
    inside a gang."""
    if not cfgs:
        raise ValueError("empty gang")
    _validate_members(cfgs)
    cfg0 = cfgs[0]
    reason = gang_ineligible_reason(cfg0, model_hooks=True)
    if reason is not None:
        raise ValueError(f"config not gang-eligible ({reason}); use train_model")
    spec = parse_method(cfg0.method, spectrogram=cfg0.spectrogram)
    if spec.salopt is None:
        saliency_model_providers = None
    elif saliency_model_providers is None or len(saliency_model_providers) != len(cfgs):
        raise ValueError(
            "(salopt…) gang needs ONE saliency provider per member, each closing over "
            "that member's own pretrained checkpoint — pass saliency_model_providers "
            "(saliency.make_pretrained_saliency_fn per cfg; the runner's --gang wires "
            "this after training the dependency runs)")
    if spec.pairing not in LATENT_PAIRINGS:
        latent_feature_fn = None
    hooks = {"saliency_model_providers": saliency_model_providers,
             "latent_feature_fn": latent_feature_fn}
    device = resolve_device(cfg0.device)
    if n_devices is not None and n_devices > 1:
        if len(cfgs) % n_devices:
            raise ValueError(f"gang size {len(cfgs)} must divide evenly over "
                             f"{n_devices} devices")
        if device.type == "cuda" and n_devices > torch.cuda.device_count():
            raise ValueError(f"n_devices={n_devices} but {torch.cuda.device_count()} "
                             "CUDA devices")
        parts = spawn(_gang_rank, n_devices, "nccl" if device.type == "cuda" else "gloo",
                      (cfgs, dataset, progress, _picklable(hooks)), all_ranks=True)
        return [perf for part in parts for perf in part]
    return _train_gang(cfgs, dataset, progress, **hooks)


def _gang_rank(cfgs: list, dataset: dict, progress: bool, hooks: dict) -> list:
    """A spawned rank: its block of the members (and of their providers),
    trained as a gang."""
    per = len(cfgs) // dist.get_world_size()
    block = slice(dist.get_rank() * per, (dist.get_rank() + 1) * per)
    providers = hooks["saliency_model_providers"]
    return _train_gang(cfgs[block], dataset, progress,
                       saliency_model_providers=providers and providers[block],
                       latent_feature_fn=hooks["latent_feature_fn"])


def is_ragged(train_sets: list, test_sets: list) -> bool:
    """True where the members' train sizes or test splits differ: they then
    train in lockstep epochs with masked steps."""
    return (any(len(tr) != len(train_sets[0]) for tr in train_sets)
            or not _tests_equal(test_sets))


def _tests_equal(test_sets: list) -> bool:
    return all(np.array_equal(te.wav, test_sets[0].wav)
               and np.array_equal(te.label, test_sets[0].label) for te in test_sets[1:])


def _train_gang(cfgs: list, dataset: dict, progress: bool, saliency_model_providers=None,
                latent_feature_fn=None) -> list:
    cfg0, S = cfgs[0], len(cfgs)
    device = resolve_device(cfg0.device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    splits = [build_splits(cfg, dataset) for cfg in cfgs]
    train_sets, test_sets = [tr for tr, _ in splits], [te for _, te in splits]
    if any(tr.rows is None for tr in train_sets):
        raise ValueError("a train split lacks row provenance (rows=None)")
    tests_equal = _tests_equal(test_sets)
    ragged = is_ragged(train_sets, test_sets)
    bs, E = cfg0.batch_size, cfg0.num_epochs
    spe = [len(tr) // bs for tr in train_sets]
    if min(spe) == 0:
        raise ValueError("a member's train split is smaller than one batch")
    n_lock = max(spe)
    member_steps = [E * k for k in spe]

    engines = _member_engines(cfgs, train_sets)
    engine = engines[0]
    spec = engine.spec
    latent_mode = engine.enabled and spec.latent
    live_mode = engine.enabled and spec.base in LIVE_MODEL_BASES
    if live_mode and ragged:
        # a ragged member's '+p' gate follows its own step count, so one
        # live pass a step has no uniform gate; the runner falls back
        raise ValueError(
            "live-model methods (lc-nointrusion/saliency-cutmix) gang only with "
            "equal-size members; train these ragged points via train_model")
    base = _base_train_dataset(cfg0, dataset)
    member_rows = [np.asarray(tr.rows, np.int64) for tr in train_sets]
    _check_provenance(base, cfgs, train_sets, member_rows)
    put = _putter(cfg0.device_cache)

    C, T = base.data.shape[1], base.data.shape[-1]
    F_ = base.data.shape[-2] if cfg0.spectrogram else 0
    if engine.needs_latent_model and latent_feature_fn is None:
        # the canonical frozen embedder, as train_model resolves it
        from pcgmix_tpu_torch.latent import latent_space_for

        latent_feature_fn = latent_space_for(cfg0, T).generate

    def member_model(cfg):
        return build_model(cfg.model, cfg.num_classes, C, T, seed=cfg.seed,
                           dataset=cfg.dataset, freq=F_ or None, conv_impl=cfg.conv_impl,
                           compute_dtype=cfg.compute_dtype)

    template = seeded_init(member_model(cfg0), cfg0.seed_fix)
    # each member's generators as its own run seeds them
    member_gens = [list(generators(member_model(cfg)).values()) for cfg in cfgs]
    n_max = max(len(tr) for tr in train_sets)
    soft = torch.zeros((S, n_max, cfg0.num_classes), device=device)
    for s, tr in enumerate(train_sets):
        soft[s, :len(tr)] = init_selc_table(tr.label, cfg0.num_classes, device)
    step = GangStep(
        template, member_gens,
        (cfg0.op, cfg0.lr_max, cfg0.weight_decay, member_steps[0], cfg0.use_sched),
        train_data=put(base.data, device), train_labels=put(base.label, device),
        soft_labels=soft, num_classes=cfg0.num_classes, grad_clip=cfg0.grad_clip,
        selc_es=_selc_turnpoint(cfg0), engine=engine if engine.enabled else None)
    # each member's (lr, momentum) by its own step count
    tables = {n: schedule_table(cfg0, n) for n in set(member_steps)}
    if cfg0.steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be at least 1, got "
                         f"{cfg0.steps_per_dispatch}")
    # K gang steps per dispatch on the equal path, for the methods that
    # train_model chunks, but gaussiannoise, whose noise is drawn per member;
    # the model-in-the-loop methods plan from the batch (and the live
    # state) before each step: one step a dispatch (JAX scan_k = 1)
    multi = (MultiStep(step, cfg0.steps_per_dispatch)
             if (cfg0.steps_per_dispatch > 1 and not ragged and not latent_mode
                 and not engine.model_in_the_loop and spec.base != "gaussiannoise")
             else None)

    def member_hooks(s, batch):
        """Member ``s``'s frozen-model hooks on its batch, gathered from the
        base corpus at the first call (``train/loop.py::_plan_hooks``)."""
        cache = []

        def tensors():
            if not cache:
                rows = member_rows[s][np.asarray(batch["indices"])]
                cache.append(step.gather(torch.from_numpy(rows).to(device)))
            return cache[0]

        def saliency_fn(mix_model):
            with timed("saliency"):
                return np.asarray(saliency_model_providers[s](mix_model)(
                    *tensors(), np.asarray(batch["frames"])))

        def latent_fn():
            with timed("latent embedding"):
                return np.asarray(latent_feature_fn(tensors()[0]))

        return {"saliency_fn": saliency_fn if saliency_model_providers else None,
                "latent_fn": latent_fn if latent_feature_fn else None}

    run_dirs = [utils.check_folder(experiment_dir(cfg)) if cfg.save_artifacts else None
                for cfg in cfgs]
    perfs = [PerformanceTracker() for _ in cfgs]
    epoch_plot = set(np.linspace(1, E, 11).astype(int).tolist())
    msteps = [0] * S
    start_epoch = 1
    times: list = []
    lr_lists: list = [[] for _ in range(S)]
    ckpt = _open_gang_ckpt(cfg0, run_dirs)
    if ckpt is not None and ckpt.latest_step() is not None:
        state, lock_step = ckpt.restore(map_location="cpu")
        _load_gang_state(step, state)
        epochs_done = lock_step // n_lock  # saved at epoch ends
        start_epoch = epochs_done + 1
        msteps = [epochs_done * k for k in spe]
        saved = ckpt.restore_metrics(lock_step) or {}
        for perf, hist in zip(perfs, saved.get("perfs", [])):
            for k, v in hist.items():
                perf.dict[k] = list(v)
        times = list(saved.get("times", []))
        lr_lists = [list(x) for x in saved.get("lr_lists", lr_lists)]
        if _engine_rng_replayable(engine):
            for eng, tr, cfg, n in zip(engines, train_sets, cfgs, msteps):
                replay_plan_rng(eng, tr, cfg, n)
        if progress:
            print(f"gang resumed: epoch {start_epoch}, member steps {msteps}")

    eval_staged = None
    for epoch in range(start_epoch, E + 1):
        profiling = cfg0.profile_dir and epoch == min(2, E)
        if profiling:
            prof = _start_profile(device)
        t0 = time.time()
        outs, masks = [], []  # per dispatch: (loss (S,), preds/targets (S, B)); (S,) bool
        iters = [iter(EpochIterator(tr, bs, cfg.seed, msteps[s], cfg.loader_parity))
                 for s, (tr, cfg) in enumerate(zip(train_sets, cfgs))]
        last: list = [None] * S
        chunk: list = []

        def flush():
            o = multi.run(chunk, epoch)
            r = len(chunk)
            loss = o["loss"].view(r, S)
            preds, target = (o[k].view(r, S, -1) for k in ("preds", "target"))
            for j in range(r):
                outs.append((loss[j], preds[j], target[j]))
                masks.append(np.ones(S, bool))
            for lrs in lr_lists:
                lrs.extend(o["lr"])
            chunk.clear()

        for k in range(n_lock):
            active = np.array([k < n for n in spe])
            batches = []
            for s in range(S):
                if active[s]:
                    last[s] = next(iters[s])
                batches.append(last[s])
            idx = np.stack([np.stack([b["indices"], member_rows[s][b["indices"]]])
                            for s, b in enumerate(batches)], axis=1)
            if multi is not None:
                arrays = None
                if engine.enabled:
                    arrays = []
                    for eng, b, n in zip(engines, batches, msteps):
                        a, p = eng.plan_arrays_or_identity(n, b["frames"], b["label"], b["wav"])
                        arrays.append(eng.gated_arrays(a, p))
                    arrays = gang_plan(arrays, bs)
                    if arrays is None:
                        raise RuntimeError(f"step {msteps[0]}: the members' plans share "
                                           "no apply; run with steps_per_dispatch=1")
                chunk.append((idx, arrays or {}))
                msteps = [n + 1 for n in msteps]
                if len(chunk) == multi.k:
                    flush()
                continue
            lrm = [tables[member_steps[s]][msteps[s]] if active[s] else (0.0, 0.0)
                   for s in range(S)]
            scalars = step.fed.member_scalars([x for x, _ in lrm], [m for _, m in lrm], active)
            for s in range(S):
                if active[s]:
                    lr_lists[s].append(lrm[s][0])
            if live_mode:
                o = _live_gang_step(step, engines, batches, idx, msteps[0], epoch, scalars)
                outs.append((o["loss"], o["preds"], o["target"]))
                masks.append(active)
                msteps = [n + 1 for n in msteps]
                continue
            plans = [engines[s].plan(msteps[s], b["frames"], b["label"], b["wav"],
                                     **member_hooks(s, b))
                     if engine.enabled and active[s] else None
                     for s, b in enumerate(batches)]
            if not ragged:
                _check_uniform(plans, msteps[0])
            if latent_mode:
                # dispatch per draw (None: the '+p' gate left the batch
                # alone; d: the split depth), masked to that draw's members
                draw = [p.latent_depth if p is not None else None for p in plans]
                for d in dict.fromkeys(draw[s] for s in range(S) if active[s]):
                    mask = np.array([bool(active[s]) and draw[s] == d for s in range(S)])
                    donor = plans[int(np.argmax(mask))]
                    arrays = (None if d is None else
                              [(plans[s] if mask[s] else donor).arrays for s in range(S)])
                    with step.masked(mask):
                        o = step(idx, arrays, epoch, d, scalars, drawing=list(mask))
                    outs.append((o["loss"], o["preds"], o["target"]))
                    masks.append(mask)
            else:
                arrays = None
                if engine.enabled and (ragged or plans[0] is not None):
                    arrays = []
                    for s, (eng, b, p) in enumerate(zip(engines, batches, plans)):
                        if p is not None:
                            a = p.arrays
                        else:  # gated off, or idle: consumes no RNG (the hooks
                            # run once, where the identity plan is first built)
                            a = eng.identity_arrays(msteps[s], b["frames"], b["label"],
                                                    b["wav"], **member_hooks(s, b))
                        arrays.append(eng.gated_arrays(a, p) if ragged else a)
                with step.masked(active):
                    o = step(idx, arrays, epoch, None, scalars, drawing=list(active))
                outs.append((o["loss"], o["preds"], o["target"]))
                masks.append(active)
            msteps = [n + int(a) for n, a in zip(msteps, active)]
        if chunk:  # an epoch's partial chunk: single steps
            flush()

        if epoch in epoch_plot and outs:
            losses = torch.stack([o[0] for o in outs], 1).cpu().numpy()  # (S, dispatches)
            preds = torch.stack([o[1] for o in outs], 1).cpu().numpy()  # (S, d, B)
            targets = torch.stack([o[2] for o in outs], 1).cpu().numpy()
        times.append(time.time() - t0)
        if profiling:
            _stop_profile(prof, cfg0.profile_dir, epoch, None, device)
        if epoch in epoch_plot:
            mask = np.stack(masks, 1)  # (S, dispatches)
            if eval_staged is None:
                if tests_equal:
                    shared = stage_eval(test_sets[0], cfg0.eval_batch_size,
                                        cfg0.num_classes, device, put=put)
                    eval_staged = ([[b for _, _, b, _ in shared]] * S,
                                   [(d, t) for d, t, _, _ in shared])
                else:
                    eval_staged = _stage_eval_ragged(test_sets, cfg0, device)
            host, stacked = eval_staged
            ev = [step.evaluate(d, t, tests_equal) for d, t in stacked]
            for s, (perf, run_dir) in enumerate(zip(perfs, run_dirs)):
                m = mask[s]
                member_outs = [(p[s, :len(b["label"])].cpu().numpy(), l[s, :len(b["label"])])
                               for (p, l), b in zip(ev, host[s])]
                _emit_member_plot_epoch(
                    perf, run_dir, epoch, msteps[s], float(losses[s][m].mean()),
                    segment_accuracy(preds[s][m].reshape(-1), targets[s][m].reshape(-1)),
                    member_outs, host[s], spec.class_majority, times, cfgs[s], lr_lists[s])
            if progress:
                accs = [p.dict["test_accuracy"][-1] for p in perfs]
                print(f"epoch {epoch}: {'ragged ' if ragged else ''}gang of {S}, "
                      f"test_acc mean={np.mean(accs):.2f} min={min(accs):.2f} "
                      f"max={max(accs):.2f}", flush=True)
        if ckpt is not None and epoch % cfg0.checkpoint_every == 0:
            ckpt.save(epoch * n_lock, _gang_checkpoint(step),
                      metrics={"perfs": [p.dict for p in perfs], "times": times,
                               "lr_lists": lr_lists})

    for s, (cfg, perf) in enumerate(zip(cfgs, perfs)):
        if run_dirs[s]:
            module = member_model(cfg).to(device)
            module.load_state_dict(step.member_state_dict(s))
            torch.save(module.state_dict(), os.path.join(run_dirs[s], "model.pth"))
            utils.save_dict(perf.dict, os.path.join(run_dirs[s], "performance.pkl"))
        perf.dict["lr_per_step"] = list(lr_lists[s])
    _cleanup_gang_ckpt(ckpt)
    return [perf.dict for perf in perfs]


def _check_uniform(plans: list, n: int) -> None:
    """The members' plans of one equal-path step share the ``+p`` gate and
    the latent depth: both are seeded by the step alone."""
    if len({(p is None, getattr(p, "latent_depth", None)) for p in plans}) > 1:
        raise RuntimeError(f"step {n}: gang members disagree on the '+p' gate or the "
                           "latent depth")


def _live_gang_step(step: GangStep, engines: list, batches: list, idx: np.ndarray, n: int,
                    epoch: int, scalars: np.ndarray) -> dict:
    """One equal-path gang step of a live-model method (JAX
    ``_live_gang_step``): the live passes over the stacked state, each
    member's plan or picks from its own engine on the host, then the step.
    ``saliency-cutmix``'s saliency pass runs only where a plan asks for
    its bins; ``lc-nointrusion`` trains on the picked candidates of the
    scored pool, one K1 launch a step."""
    _, S, B = idx.shape
    device = step.train_data.device
    rows = torch.from_numpy(np.ascontiguousarray(idx[1])).to(device)
    spec = engines[0].spec
    hooks = [{} for _ in range(S)]
    if spec.base == "saliency-cutmix":
        frames = np.stack([np.asarray(b["frames"]) for b in batches])
        bins: list = []

        def bins_for(s):
            if not bins:
                with timed("saliency"):
                    sal = step.live_saliency(rows, frames[:, :, -1].reshape(-1))
                    sal = sal.cpu().numpy().reshape(S, B, -1)
                bins.extend(bin_training_saliency(sal[m], frames[m]) for m in range(S))
            return bins[s]

        hooks = [{"saliency_bins_fn": lambda s=s: bins_for(s)} for s in range(S)]
    plans = [eng.plan(n, b["frames"], b["label"], b["wav"], **kw)
             for eng, b, kw in zip(engines, batches, hooks)]
    _check_uniform(plans, n)
    if plans[0] is None:  # gated off: a plain step
        return step(idx, None, epoch, None, scalars)
    if spec.base == "saliency-cutmix":
        return step(idx, [p.arrays for p in plans], epoch, None, scalars)
    # lc-nointrusion: every member's pool in one apply (K1 on S·4B rows)
    pool = step.device_plan(gang_plan([p.arrays for p in plans], B), B, S)
    cands, cand_t = step.engine.apply(*step.gather(rows.reshape(-1)), pool)
    with timed("candidate forward"):
        losses = step.candidate_losses(cands, cand_t).cpu().numpy()
    picks, local = [], []
    with timed("lc_select"):
        for s, (eng, p, b) in enumerate(zip(engines, plans, batches)):
            sel = eng.lc_select(losses[s], p.aux["cand_labels"], p.aux["n_per_class"])
            picks.append(sel + s * losses.shape[1])
            local.append(np.asarray(b["indices"])[p.arrays["idx1"][sel]])
    picks = torch.from_numpy(np.concatenate(picks)).to(device)
    s_scalars = torch.from_numpy(scalars).to(device)
    return step.train_on(cands.index_select(0, picks), cand_t.index_select(0, picks),
                         torch.from_numpy(np.stack(local)).to(device), epoch, s_scalars)


def _gang_checkpoint(step: GangStep) -> dict:
    """What a gang checkpoint holds: the stacked state with the members'
    generators, the optimizer and schedule, the SELC tables, the members'
    step counts (the plan RNG is replayed instead)."""
    return {
        "model": step.model.state_dict(),
        "optimizer": step.opt.state_dict(),
        "scheduler": step.sched.state_dict() if step.sched is not None else None,
        "soft_labels": step.soft_labels,
        "ts": torch.from_numpy(step.fed.ts.copy()),
        "generators": {k: g.get_state() for k, g in generators(step.model).items()},
    }


def _load_gang_state(step: GangStep, state: dict) -> None:
    step.model.load_state_dict(state["model"])
    step.opt.load_state_dict(state["optimizer"])
    if step.sched is not None:
        step.sched.load_state_dict(state["scheduler"])
    step.soft_labels.copy_(state["soft_labels"])
    step.fed.ts[:] = state["ts"].numpy()
    for name, gen in generators(step.model).items():
        gen.set_state(state["generators"][name].cpu())

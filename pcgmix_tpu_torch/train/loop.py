"""The training loop (counterpart: ``pcgmix_tpu/train/loop.py``; reference
train_model.py:197-488).

Per batch, the host builds the augmentation plan (tiny, reference-exact
RNG) and one :class:`TrainStep` gathers the batch from the device-resident
corpus, mixes it through the CUDA kernels, and runs forward, loss and
update.  Metrics are recorded at the reference's 11 linspaced "plot epochs"
into the same performance-dict schema, pickled to ``performance.pkl`` in a
run directory with the reference naming contract; the final weights go to
``model.pth``.

Data parallelism (JAX ``TrainConfig.n_devices``, ``loop.py:262-287``): with
``n_devices > 1`` the loop spawns one worker per device, each a rank of a
process group (NCCL on ``cuda:r``, gloo on the CPU); called inside a process
group that is already initialized (the ``torchrun`` way) it trains on that
group.  Every rank plans the global batch and steps on its block of it, or
on all of it when it does not divide over the ranks (``train/steps.py``);
the numbers are the single-device run's.  Rank 0 writes the run
directory; the caller gets the performance dict.

Latent methods dispatch on the plan's ``latent_depth``: the JAX loop builds
one jitted step per depth (``loop.py:596-608``), the port's one step takes
the depth.

Model-in-the-loop methods (JAX ``loop.py:318-326``, ``:539-595``) get the
model through the plan's hooks, on the batch before its step: the
``(salopt…)`` methods a pretrained checkpoint's saliency maps
(``saliency_model_provider``, see :mod:`pcgmix_tpu_torch.saliency`),
``saliency-cutmix`` the live model's saliency bins, the
``(closestknn/closestbins…)`` pairings a frozen embedder's latents
(``latent_feature_fn``; by default the canonical ResCNN run of
``experiments_root``, :func:`pcgmix_tpu_torch.latent.latent_space_for`).
``lc-nointrusion`` scores its pool of 4B candidate joins with the live
model under eval mode and trains on the lowest-loss ones.  With
``latent_space`` and a ``latent_space_model`` the embeddings of each
augmented batch are dumped to ``latent_space/`` in the run directory.  The
host time of each of these phases adds to :mod:`pcgmix_tpu_torch.timing`.
Over data-parallel ranks (JAX ``loop.py:539-595``, ``:626``) each rank
computes its block of the batch's saliency maps, saliency bins,
embeddings or candidate losses and the ranks gather them, so every rank
builds the same plan from the same numbers (on a batch replicated over the
ranks rank 0's numbers are broadcast); ``lc-nointrusion``'s ranks each
build and score a block of the pool and train on their block of the
picked rows; the dumps hold the global batch's embeddings and rank 0
writes them.  Hooks reach spawned ranks pickled
(``make_pretrained_saliency_fn``'s provider and a ``LatentSpace`` pickle
as what rebuilds them).  The spectrogram datasets (``PhysioNet(spec128)``,
``UMC(spec128)``, ``UMC(spec64)``) train the 2-D ResNet9 on (N, 1, F, T)
mel spectrograms with the 2-D method ladder; the UMC datasets split by
patient folds (``data/umc.py``).

The runtime extras (JAX ``loop.py:76-110``): ``steps_per_dispatch`` K > 1
trains K steps per dispatch through ``train/steps.py::MultiStep`` (one
CUDA graph of K steps on a card), for the methods the JAX package runs in
its scan mode; ``checkpoint_every`` saves the whole state under
``<run dir>/checkpoints/`` and a rerun resumes from the latest, replaying
the plan RNG so that later plans are the uninterrupted run's;
``device_cache`` reuses an equal corpus's device tensors
(``data/device_cache.py``); ``track_variability`` writes
``variability.pkl``; ``profile_dir`` takes a ``torch.profiler`` trace of
epoch 2.

``compute_dtype="bfloat16"`` (JAX ``loop.py:79``, ``:242-249``) builds the
model with bf16 layers (``models/layers.py``); the JAX package's train and
eval models are the port's one model in its two modes.  Parameters, Adam's
moments, the BatchNorm buffers, the SELC table and the loss stay float32,
and the logits come out float32, so nothing past the model changes; a
latent method's latent is bf16, which the mix kernels take as it is.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.augment.engine import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import EpochIterator, eval_batches, physionet_split, umc_split
from pcgmix_tpu_torch.data.datasets import load_cvd_map
from pcgmix_tpu_torch.data.device_cache import device_tensor
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.models import SPECTROGRAM_DATASETS, build_model
from pcgmix_tpu_torch.models.layers import resolve_compute_dtype
from pcgmix_tpu_torch.parallel import DataParallel, spawn
from pcgmix_tpu_torch.train.checkpoint import CheckpointManager
from pcgmix_tpu_torch.train.convert import seeded_init
from pcgmix_tpu_torch.train.counters import VariabilityCounter
from pcgmix_tpu_torch.train.losses import init_selc_table
from pcgmix_tpu_torch.train.metrics import (
    PerformanceTracker,
    recording_level_eval,
    segment_accuracy,
)
from pcgmix_tpu_torch.saliency import training_saliency_bins
from pcgmix_tpu_torch.timing import timed
from pcgmix_tpu_torch.train.steps import (
    MultiStep,
    TrainStep,
    candidate_losses,
    eval_step,
    generators,
    make_optimizer,
)


@dataclasses.dataclass
class TrainConfig:
    """The reference args namespace as a typed config (main-path fields)."""

    dataset: str = "PhysioNet"
    model: str = "resnet9"
    method: str = "base"
    num_epochs: int = 50
    batch_size: int = 64
    n_fraction: float = 1.0
    op: str = "adam"
    use_sched: bool = True
    lr_max: float = 0.01
    train_balance: bool = True
    num_channels: int = 4
    grad_clip: float = 0.1
    seed_data: int = 1100001
    valid: bool = False
    seed: int = 1
    seed_fix: int = 4
    weight_decay: float = 1e-4
    sample_rate: int = 1000  # Hz; the respiratory sinusoid's time axis
    num_classes: int = 2
    experiments_root: str = "experiments"
    loader_parity: str = "torch"  # epoch-order parity mode
    save_artifacts: bool = True
    eval_batch_size: int = 1000
    true_seed: Optional[int] = None  # train-balance sampling seed override
                                     # (None: 18, or N from 'trueseed=N')
    cvd_map: Optional[object] = None  # dict wav→diagnosis, or a cvds_map.csv
                                      # path, for (sameCVD) pairing
    device: str = "cuda"  # "cpu" only when asked for; no silent fallback
    n_devices: Optional[int] = None  # data-parallel ranks; None = every
                                     # visible CUDA device (1 on the CPU);
                                     # the reference wraps every run in
                                     # nn.DataParallel, train_model.py:385
    latent_space: bool = False  # dump each augmented batch's embeddings
                                # under a latent_space_model
                                # (train_model.py:508-518)
    track_variability: bool = False  # the variability counter; its curves
                                     # go to variability.pkl at plot epochs
    checkpoint_every: int = 0  # epochs between full-state checkpoints
                               # (0 = final weights only, as the reference)
    profile_dir: Optional[str] = None  # a torch.profiler trace of epoch
                                       # min(2, num_epochs) into this dir
    steps_per_dispatch: int = 1  # >1: K steps per dispatch, one CUDA graph
                                 # on a card (device-resident methods only;
                                 # gated-off steps ride as identity plans)
    device_cache: bool = True  # reuse the device tensors of an equal corpus
                               # across train_model calls in one process
                               # (data/device_cache.py)
    conv_impl: str = "xla"  # "matmul": the ResNet9 and Potes presets' 1-D
                            # convolutions as shifted matmuls
    compute_dtype: str = "float32"  # "bfloat16": the layers of the families
                                    # that honor it compute in bf16 (params,
                                    # optimizer state, BatchNorm buffers and
                                    # loss stay float32); float32 is the
                                    # parity route

    def __post_init__(self):
        resolve_compute_dtype(self.compute_dtype)  # raises for another name

    @property
    def spectrogram(self) -> bool:
        return self.dataset in SPECTROGRAM_DATASETS


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    return device


def build_splits(cfg: TrainConfig, dataset: dict):
    """Train/test(/valid) splits (reference train_model.py:228-256): the
    PhysioNet pipeline, or for a UMC dataset its patient folds
    (``seed_data`` 1–10; ``seed`` 1–3 picks the inner validation fold)."""
    if cfg.dataset.startswith("UMC"):
        common = dict(num_channels=cfg.num_channels, seed_data=cfg.seed_data,
                      seed=cfg.seed, valid=cfg.valid, spectrogram=cfg.spectrogram)
        return (umc_split(dataset, "train", **common),
                umc_split(dataset, "valid" if cfg.valid else "test", **common))
    if cfg.dataset not in ("PhysioNet", "PhysioNet(spec128)"):
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    tbal_seed = cfg.true_seed
    if tbal_seed is None:
        m = re.search(r"trueseed=(\d+)", cfg.method)
        tbal_seed = int(m.group(1)) if m else 18
    common = dict(
        num_channels=cfg.num_channels, seed_data=cfg.seed_data, seed=cfg.seed,
        valid=cfg.valid, n_fraction=cfg.n_fraction,
        train_balance=cfg.train_balance, tbal_seed=tbal_seed,
        spectrogram=cfg.spectrogram,
    )
    train = physionet_split(dataset, "train", **common)
    test = physionet_split(dataset, "valid" if cfg.valid else "test", **common)
    return train, test


def _selc_turnpoint(cfg: TrainConfig) -> int:
    """SELC activates after 40% of epochs when 'SELC' is in the method."""
    if "SELC" in cfg.method:
        return int(cfg.num_epochs * 0.4)
    return cfg.num_epochs + 1


def _check_world(world: int) -> None:
    if world < 1:
        raise ValueError(f"n_devices must be at least 1, got {world}")


def run_world(cfg: TrainConfig) -> int:
    """The ranks a run of ``cfg`` takes: its process group's, else
    ``n_devices``, else every visible card (1 on the CPU)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if cfg.n_devices is not None:
        return cfg.n_devices
    return torch.cuda.device_count() if resolve_device(cfg.device).type == "cuda" else 1


def train_model(cfg: TrainConfig, dataset: dict, *, saliency_model_provider=None,
                latent_feature_fn=None, latent_space_model=None) -> dict:
    """Train one configuration end to end; returns the performance dict.

    ``saliency_model_provider(salopt_model)`` → ``fn(data, target_ohe,
    frames)`` → (B, T) saliency maps, for the (salopt…) methods (see
    :func:`pcgmix_tpu_torch.saliency.make_pretrained_saliency_fn`);
    ``latent_feature_fn(data)`` → (B, D) embeddings for the
    closestknn/closestbins pairings; ``latent_space_model`` (``.generate``)
    embeds the augmented batches that ``cfg.latent_space`` dumps.

    Inside an initialized process group every rank trains its share and
    returns the same dict; otherwise ``cfg.n_devices > 1`` spawns that many
    ranks and returns rank 0's dict."""
    device = resolve_device(cfg.device)
    hooks = dict(saliency_model_provider=saliency_model_provider,
                 latent_feature_fn=latent_feature_fn, latent_space_model=latent_space_model)
    if dist.is_available() and dist.is_initialized():
        dp = DataParallel.current()
        if cfg.n_devices is not None and cfg.n_devices != dp.world:
            raise ValueError(
                f"n_devices={cfg.n_devices} inside a process group of {dp.world}"
            )
        _check_world(dp.world)
        return _train(cfg, dataset, dp, **hooks)
    world = run_world(cfg)
    _check_world(world)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"n_devices={world} but {torch.cuda.device_count()} CUDA devices"
        )
    if world > 1:
        backend = "nccl" if device.type == "cuda" else "gloo"
        return spawn(_train_rank, world, backend, (cfg, dataset, _picklable(hooks)))
    return _train(cfg, dataset, None, **hooks)


def _picklable(hooks: dict) -> dict:
    """The hooks a spawned rank receives: each must pickle (a module-level
    function, ``make_pretrained_saliency_fn``'s provider, a ``LatentSpace``
    or its ``generate``)."""
    for name, hook in hooks.items():
        try:
            pickle.dumps(hook)
        except Exception as e:
            raise TypeError(
                f"{name} must pickle to reach the spawned ranks of n_devices > 1 ({e}); "
                "pass one that does, or call train_model inside an initialized process "
                "group (torchrun), where the hooks stay as they are") from e
    return hooks


def _train_rank(cfg: TrainConfig, dataset: dict, hooks: Optional[dict] = None) -> dict:
    """A spawned rank's entry point (see :func:`pcgmix_tpu_torch.parallel.spawn`)."""
    return _train(cfg, dataset, DataParallel.current(), **(hooks or {}))


def _ranks_share(dp: Optional[DataParallel], n: int):
    """(whether a batch of ``n`` rows is split over the ranks, the slice of
    it this process holds, ``share``): under data parallelism ``share(a)``
    turns the host array of the rows a rank holds into the global batch's
    on every rank, by gathering the ranks' blocks, or for a batch
    replicated over the ranks by broadcasting rank 0's."""
    if dp is None:
        return False, slice(None), lambda a: a
    if dp.divides(n):
        return True, dp.block(n), dp.gather_host
    return False, slice(None), dp.broadcast_host


def _plan_hooks(step: TrainStep, batch: dict, model, saliency_model_provider,
                latent_feature_fn, dp: Optional[DataParallel] = None) -> dict:
    """The plan's model hooks for one batch (JAX ``loop.py:539-566``), each
    on the device tensors of the rows this process holds, gathered at the
    first call; their per-row numbers are shared over the ranks."""
    _, sl, share = _ranks_share(dp, len(batch["indices"]))
    frames = np.asarray(batch["frames"])[sl]
    cache = []

    def tensors():
        if not cache:
            cache.append(step.batch(np.asarray(batch["indices"])[sl]))
        return cache[0]

    def saliency_fn(mix_model):
        _, data, target = tensors()
        with timed("saliency"):
            return share(np.asarray(saliency_model_provider(mix_model)(data, target, frames)))

    def saliency_bins_fn():
        _, data, target = tensors()
        with timed("saliency"):
            values, bin_frames = training_saliency_bins(model, data, target, frames)
            return share(values), share(bin_frames)

    def latent_fn():
        data = tensors()[1]
        with timed("latent embedding"):
            return share(np.asarray(latent_feature_fn(data)))

    return {"saliency_fn": saliency_fn if saliency_model_provider else None,
            "saliency_bins_fn": saliency_bins_fn,
            "latent_fn": latent_fn if latent_feature_fn else None}


def _lc_step(step: TrainStep, engine: AugmentEngine, plan, batch: dict, epoch: int) -> dict:
    """``lc-nointrusion`` (JAX ``loop.py:572-595``): the plan's 4B candidate
    joins (K1) scored by the live model under eval mode; a step on the
    lowest-loss ones, whose SELC rows are the batch's corpus rows mapped
    through ``idx1``.  On a batch split over data-parallel ranks each rank
    joins and scores its block of the pool (K3, zero base), the losses are
    gathered, every rank picks the same rows, and each trains on its block
    of them, joined again from the plan rows the pick names (K3)."""
    indices = np.asarray(batch["indices"])
    sharded, _, share = _ranks_share(step.dp, len(indices))
    idx = step.upload(indices)
    if sharded:
        cands, cand_t = step.mix_rows(idx, engine.device_arrays(plan.arrays, idx.device))
    else:
        _, data, target = step.batch(indices)
        cands, cand_t = engine.apply(data, target, plan.arrays)
    with timed("candidate forward"):
        losses = share(candidate_losses(step.model, cands, cand_t).cpu().numpy())
    with timed("lc_select"):
        sel = engine.lc_select(losses, plan.aux["cand_labels"], plan.aux["n_per_class"])
    rows = indices[plan.arrays["idx1"][sel]]
    if sharded:
        picked = {k: v[sel] if isinstance(v, np.ndarray) and v.ndim and
                  len(v) == len(losses) else v for k, v in plan.arrays.items()}
        data, target = step.mix_rows(idx, engine.device_arrays(picked, idx.device))
        return step.train_on(data, target, rows, epoch)
    sel = torch.from_numpy(sel).to(cands.device)
    return step.train_on(cands.index_select(0, sel), cand_t.index_select(0, sel), rows, epoch)


def _dump_latents(engine, step, plan, batch, step_count, latent_space_model,
                  results_dir) -> None:
    """The embeddings of the augmented batch, dumped per step (JAX
    ``loop.py:626-675``; train_model.py:508-518): the plan applied to the
    input, or the batch itself for a latent method or lc-nointrusion.  Over
    data-parallel ranks each rank embeds the rows it holds, and rank 0
    writes the global batch's (``results_dir`` None on the other ranks)."""
    from pcgmix_tpu_torch.latent import save_latent_space

    sharded, _, share = _ranks_share(step.dp, len(batch["indices"]))
    idx = step.upload(batch["indices"])
    augmented = plan is not None and plan.latent_depth is None and (
        engine.spec.base != "lc-nointrusion")
    arrays = engine.device_arrays(plan.arrays, idx.device) if augmented else None
    _, data, _ = step.inputs(idx, arrays, sharded)
    fts = share(np.asarray(latent_space_model.generate(data)))
    if results_dir is not None:
        save_latent_space({"fts": fts, "target": batch["label"]}, "train", step_count,
                          results_dir)


def _train(cfg: TrainConfig, dataset: dict, dp: Optional[DataParallel], *,
           saliency_model_provider=None, latent_feature_fn=None,
           latent_space_model=None) -> dict:
    device = resolve_device(cfg.device)
    if dp is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        # fp32 means fp32: cuDNN convolutions default to TF32 on Hopper
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    writes = cfg.save_artifacts and (dp is None or dp.rank == 0)
    run_dir = utils.check_folder(experiment_dir(cfg)) if writes else None

    train_ds, test_ds = build_splits(cfg, dataset)
    num_steps = cfg.num_epochs * (len(train_ds) // cfg.batch_size)
    if num_steps == 0:
        raise ValueError("train split smaller than one batch")
    C, T = train_ds.data.shape[1], train_ds.data.shape[-1]
    F = train_ds.data.shape[-2] if cfg.spectrogram else 0

    model = seeded_init(
        build_model(cfg.model, cfg.num_classes, C, T, seed=cfg.seed,
                    dataset=cfg.dataset, freq=F or None, conv_impl=cfg.conv_impl,
                    compute_dtype=cfg.compute_dtype),
        cfg.seed_fix
    )
    model.to(device)
    if dp is not None:
        dp.broadcast_module(model)
    opt, sched = make_optimizer(
        model, cfg.op, cfg.lr_max, cfg.weight_decay, num_steps, cfg.use_sched
    )
    cvd_map = cfg.cvd_map
    if isinstance(cvd_map, str):
        cvd_map = load_cvd_map(cvd_map)
    engine = AugmentEngine(AugmentConfig(
        method=cfg.method, batch_size=cfg.batch_size, num_channels=C, sig_len=T,
        sample_rate=cfg.sample_rate, cvd_map=cvd_map, spectrogram=cfg.spectrogram,
        spec_freq=F, model=cfg.model, num_classes=cfg.num_classes,
    ))
    if engine.needs_latent_model and latent_feature_fn is None:
        # the reference's canonical frozen embedder (latent_space.py:27-29);
        # raises, naming its model.pth, when that run has not been trained
        from pcgmix_tpu_torch.latent import latent_space_for

        latent_feature_fn = latent_space_for(cfg, T).generate
    if engine.needs_pretrained_saliency and saliency_model_provider is None:
        raise ValueError(
            f"method {cfg.method!r} needs a pretrained saliency model; pass "
            "saliency_model_provider (see pcgmix_tpu_torch.saliency)"
        )
    put = _putter(cfg.device_cache)
    step = TrainStep(
        model, opt, sched,
        train_data=put(train_ds.data, device),
        train_labels=put(train_ds.label, device),
        soft_labels=init_selc_table(train_ds.label, cfg.num_classes, device),
        num_classes=cfg.num_classes, grad_clip=cfg.grad_clip,
        selc_es=_selc_turnpoint(cfg), engine=engine, dp=dp,
    )
    eval_staged = stage_eval(test_ds, cfg.eval_batch_size, cfg.num_classes,
                             device, dp, put=put)
    variability = VariabilityCounter(len(train_ds)) if cfg.track_variability else None

    perf = PerformanceTracker()
    epoch_plot = set(np.linspace(1, cfg.num_epochs, 11).astype(int).tolist())
    step_count = 0
    start_epoch = 1
    times: list[float] = []
    lr_per_step: list[float] = []
    ckpt = None
    if cfg.checkpoint_every and cfg.save_artifacts:
        # every rank reads the checkpoints; rank 0 writes them
        ckpt = CheckpointManager(os.path.join(experiment_dir(cfg), "checkpoints"))
        if ckpt.latest_step() is not None:
            # on the CPU: load_state_dict moves each tensor where it belongs
            # (Adam keeps its step counts on the host)
            state, step_count = ckpt.restore(map_location="cpu")
            _load_state(step, state)
            start_epoch = step_count // (len(train_ds) // cfg.batch_size) + 1
            saved = ckpt.restore_metrics(step_count) or {}
            for k, v in saved.get("perf", {}).items():
                perf.dict[k] = list(v)
            times = list(saved.get("times", []))
            lr_per_step = list(saved.get("lr_per_step", []))
            if step_count and _engine_rng_replayable(engine):
                # the fresh engine's RNG mirrors to where the uninterrupted
                # run's are, so post-resume plans are that run's
                replay_plan_rng(engine, train_ds, cfg, step_count)
    multi = MultiStep(step, cfg.steps_per_dispatch) if _scan_mode(cfg, engine) else None

    for epoch in range(start_epoch, cfg.num_epochs + 1):
        profiling = cfg.profile_dir and epoch == min(2, cfg.num_epochs)
        if profiling:
            prof = _start_profile(device)
        t0 = time.time()
        losses, preds, targets = [], [], []
        chunk = []

        def flush():
            out = multi.run(chunk, epoch)
            losses.append(out["loss"])
            preds.append(out["preds"])
            targets.append(out["target"])
            lr_per_step.extend(out["lr"])
            chunk.clear()

        for batch in EpochIterator(
            train_ds, cfg.batch_size, cfg.seed, step_count, cfg.loader_parity
        ):
            plan = None
            if multi is not None:
                arrays = {}
                if engine.enabled:
                    arrays, plan = engine.plan_arrays_or_identity(
                        step_count, batch["frames"], batch["label"], batch["wav"])
                    arrays = engine.gated_arrays(arrays, plan)
                chunk.append((batch["indices"], arrays))
                if len(chunk) == multi.k:
                    flush()
            else:
                if engine.enabled:
                    hooks = (_plan_hooks(step, batch, model, saliency_model_provider,
                                         latent_feature_fn, dp)
                             if engine.model_in_the_loop else {})
                    plan = engine.plan(
                        step_count, batch["frames"], batch["label"], batch["wav"], **hooks
                    )
                lr_per_step.append(
                    float(sched.get_last_lr()[0]) if sched is not None else cfg.lr_max
                )
                if plan is not None and engine.spec.base == "lc-nointrusion":
                    out = _lc_step(step, engine, plan, batch, epoch)
                else:
                    out = step(batch["indices"], plan.arrays if plan else None, epoch,
                               plan.latent_depth if plan else None)
                if cfg.latent_space and latent_space_model is not None:
                    _dump_latents(engine, step, plan, batch, step_count, latent_space_model,
                                  (run_dir or cfg.experiments_root)
                                  if dp is None or dp.rank == 0 else None)
                losses.append(out["loss"].reshape(1))
                preds.append(out["preds"])
                targets.append(out["target"])
            if variability is not None:
                variability.add(batch["indices"], plan.mix_indices if plan else None,
                                plan.cut if plan else None, step_count)
            step_count += 1
            if step_count >= num_steps:
                break
        if chunk:  # an epoch's partial chunk: single steps
            flush()
        if epoch in epoch_plot and losses:
            # one device→host transfer per plot epoch; it also waits for the
            # epoch's queued work, so `times` stays exact at plot epochs
            losses_np = torch.cat(losses).cpu().numpy()
        times.append(time.time() - t0)
        if profiling:
            _stop_profile(prof, cfg.profile_dir, epoch, dp, device)
        if epoch in epoch_plot:
            perf.add("epochs", epoch)
            perf.add("steps", step_count)
            perf.add("train_loss", float(losses_np.mean()))
            perf.add("train_accuracy", segment_accuracy(
                torch.cat(preds).cpu().numpy(), torch.cat(targets).cpu().numpy()
            ))
            evaluate(model, eval_staged, perf, engine.spec.class_majority, dp)
            perf.add("times", float(np.sum(times)))
            if run_dir:
                utils.save_dict(perf.dict, os.path.join(run_dir, "performance.pkl"))
                if variability is not None and variability.steps:
                    utils.save_dict(variability.curves(),
                                    os.path.join(run_dir, "variability.pkl"))
        if ckpt is not None and run_dir and epoch % cfg.checkpoint_every == 0:
            ckpt.save(step_count, _checkpoint_state(step, step_count),
                      metrics={"perf": perf.dict, "times": times,
                               "lr_per_step": lr_per_step})
        if step_count >= num_steps:
            break

    if ckpt is not None:
        ckpt.close()
    if run_dir:
        torch.save(model.state_dict(), os.path.join(run_dir, "model.pth"))
    perf.dict["lr_per_step"] = lr_per_step
    return perf.dict


def _putter(cached: bool):
    """``put(array, device)``: through the device cache, or a plain upload."""
    if cached:
        return device_tensor
    return lambda a, device: torch.from_numpy(a).to(device)


def _scan_mode(cfg: TrainConfig, engine: AugmentEngine) -> bool:
    """K steps per dispatch for the methods the JAX package runs in its scan
    mode (``loop.py:332-338``, ``:372-379``): none that reads the batch on
    the host (the model-in-the-loop methods, the latent-space dumps), nor
    latentmixup or the manifold methods; those run one step per dispatch."""
    if cfg.steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be at least 1, got "
                         f"{cfg.steps_per_dispatch}")
    resident = not (cfg.latent_space or engine.model_in_the_loop)
    return (cfg.steps_per_dispatch > 1 and resident
            and (not engine.enabled
                 or (engine.spec.base != "latentmixup" and not engine.spec.manifold)))


def _checkpoint_state(step: TrainStep, step_count: int) -> dict:
    """What a checkpoint holds: everything a resumed run needs to continue
    as the uninterrupted one (the plan RNG is replayed instead)."""
    return {
        "model": step.model.state_dict(),
        "optimizer": step.opt.state_dict(),
        "scheduler": step.sched.state_dict() if step.sched is not None else None,
        "soft_labels": step.soft_labels,
        "step": step_count,
        "generators": {k: g.get_state() for k, g in generators(step.model).items()},
    }


def _load_state(step: TrainStep, state: dict) -> None:
    step.model.load_state_dict(state["model"])
    step.opt.load_state_dict(state["optimizer"])
    if step.sched is not None:
        step.sched.load_state_dict(state["scheduler"])
    step.soft_labels.copy_(state["soft_labels"])
    for name, gen in generators(step.model).items():
        gen.set_state(state["generators"][name].cpu())


def replay_plan_rng(engine: AugmentEngine, train_ds, cfg: TrainConfig,
                    num_past_steps: int) -> None:
    """Advance a fresh engine's RNG mirrors (its NumPy stream) to where an
    uninterrupted run's are after ``num_past_steps`` steps, by rebuilding
    those steps' plans on the host without training (JAX
    ``loop.py:786-813``).  Only for engines whose plans take no model
    (:func:`_engine_rng_replayable`)."""
    step = 0
    while step < num_past_steps:
        advanced = False
        for batch in EpochIterator(train_ds, cfg.batch_size, cfg.seed, step,
                                   cfg.loader_parity):
            engine.plan(step, batch["frames"], batch["label"], batch["wav"])
            step += 1
            advanced = True
            if step >= num_past_steps:
                break
        if not advanced:  # a split smaller than one batch: never loop forever
            break


def _engine_rng_replayable(engine: AugmentEngine) -> bool:
    """Plans that can be rebuilt without a model (see replay_plan_rng): a
    model-in-the-loop method's plans depend on past weights."""
    return engine.enabled and not engine.model_in_the_loop


def _start_profile(device: torch.device):
    """A started ``torch.profiler`` session: the CPU, and the card's kernels
    on a card (JAX ``loop.py:441-444``)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    prof = profile(activities=[ProfilerActivity.CPU, *cuda])
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, epoch: int, dp, device: torch.device) -> None:
    """Stop the epoch's trace once its work is done and write it as a
    Chrome trace into ``profile_dir`` (JAX ``loop.py:690-691``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    rank = f"_rank{dp.rank}" if dp is not None else ""
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_epoch{epoch}{rank}.json"))


def stage_eval(test_ds, batch_size: int, num_classes: int, device,
               dp: Optional[DataParallel] = None, put=None) -> list:
    """Eval batches on the device as (data, one-hot target, host batch,
    sharded).  Under data parallelism a batch that divides over the ranks
    is sharded (this rank's block); one that does not is replicated
    (JAX ``loop.py:709-723``).  ``put(array, device)`` uploads (by default
    a plain copy; ``train_model`` passes the device cache's)."""
    put = put or _putter(False)
    eye = np.eye(num_classes, dtype=np.float32)
    staged = []
    for b in eval_batches(test_ds, batch_size):
        n = len(b["label"])
        sharded = dp is not None and n % dp.world == 0
        sl = dp.block(n) if sharded else slice(None)
        staged.append((put(np.ascontiguousarray(b["data"][sl]), device),
                       put(eye[b["label"][sl]], device), b, sharded))
    return staged


def evaluate(model, staged, perf: PerformanceTracker, class_majority=False,
             dp: Optional[DataParallel] = None) -> None:
    """Recording-level test pass (reference train_model.py:591-670); sharded
    batches' probabilities and losses are gathered from the ranks."""
    outs = []
    for data, target, _, sharded in staged:
        p, l = eval_step(model, data, target)
        if sharded:
            p, l = dp.gather(p), dp.gather(l)
        outs.append((p.cpu().numpy(), l))
    add_eval(perf, outs, [b for _, _, b, _ in staged], class_majority)


def add_eval(perf: PerformanceTracker, outs: list, batches: list,
             class_majority=False) -> None:
    """Add the test loss and the recording-level metrics of eval batches
    ``batches`` (host dicts), given each batch's probabilities (host) and
    per-sample losses (a tensor, summed where it lies)."""
    loss_sum, n = 0.0, 0
    for _, l in outs:
        loss_sum += float(l.sum())
        n += len(l)
    labels = np.concatenate([b["label"] for b in batches])
    wavs = np.concatenate([b["wav"] for b in batches])
    perf.add("test_loss", loss_sum / max(n, 1))
    probs = np.concatenate([p for p, _ in outs])
    metrics = recording_level_eval(probs, labels, wavs, class_majority)
    for k, v in metrics.items():
        perf.add(k, v)

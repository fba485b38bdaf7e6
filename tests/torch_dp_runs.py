"""Shared pieces of the port's data-parallel tests: the entry points of
their spawned gloo ranks, the hooks both packages take, and the rank
blocks of a plan computed in one process.

This module imports neither JAX nor the JAX package: the spawned ranks
import it to find their entry points."""

import numpy as np
import torch
import torch.distributed as dist

from pcgmix_tpu_torch import latent
from pcgmix_tpu_torch.augment import AugmentEngine
from pcgmix_tpu_torch.parallel import DataParallel
from pcgmix_tpu_torch.train.steps import TrainStep


def run_all(calls: dict) -> dict:
    """A spawned rank's entry point: {key: (name of a function of this
    module, args)} → {key: its result}, called in order."""
    return {key: globals()[name](*args) for key, (name, args) in calls.items()}


def spawn_in_background(calls: dict):
    """Start :func:`run_all` of ``calls`` on two spawned gloo ranks while
    the caller goes on (its JAX references); ``result()`` waits for both
    ranks' results."""
    import threading

    from pcgmix_tpu_torch.parallel import spawn

    box = {}

    def target():
        try:
            box["out"] = spawn(run_all, 2, "gloo", (calls,), all_ranks=True)
        except BaseException as e:  # re-raised in the caller
            box["error"] = e

    thread = threading.Thread(target=target)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["out"]

    return result


def _np(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def amplitude_saliency(mix_model):
    """A saliency provider both packages take: a map of each row's absolute
    amplitudes over the channels, scaled to its maximum (the same float32
    values on either side, row by row)."""
    return _amplitude_map


def _amplitude_map(data, target_ohe, frames):
    x = np.abs(_np(data)).sum(axis=1)
    return x / x.max(axis=1, keepdims=True)


def window_means(data):
    """Latents both packages take: each channel's mean over four windows."""
    x = _np(data)
    return x.reshape(len(x), x.shape[1] * 4, -1).mean(axis=-1)


class WindowMeans:
    """A latent-space model for the dumps: :func:`window_means`."""

    @staticmethod
    def generate(data):
        return window_means(data)


def _recording():
    """Wrap the engine's plan and ``lc_select`` so each call's output is
    kept; returns (records, undo)."""
    records = {"plans": [], "picks": []}
    plan, select = AugmentEngine.plan, AugmentEngine.lc_select

    def recorded_plan(self, *args, **kw):
        p = plan(self, *args, **kw)
        if not kw.get("_force"):
            records["plans"].append(None if p is None else
                                    {k: np.array(v, copy=True) for k, v in p.arrays.items()})
        return p

    def recorded_select(losses, cand_labels, n_per_class):
        sel = select(losses, cand_labels, n_per_class)
        records["picks"].append(sel.copy())
        return sel

    AugmentEngine.plan = recorded_plan
    AugmentEngine.lc_select = staticmethod(recorded_select)

    def undo():
        AugmentEngine.plan, AugmentEngine.lc_select = plan, staticmethod(select)

    return records, undo


def train_runs(dataset, runs, potes_head_dropout=None, narrow_2d=None):
    """``train_model`` on ``dataset`` for each (key, TrainConfig fields,
    hooks) of ``runs``:
    inside a process group (a spawned rank) this rank's share, outside it
    the single-device run.  Returns {key: {"perf", "plans", "picks",
    "dumps"}} with each step's plan arrays, ``lc_select`` picks and the
    number of latent-space dumps this process wrote, beside "rank".
    ``potes_head_dropout`` overrides Potes' head dropout; ``narrow_2d``
    (filters, numpy variables of the JAX package's 2-D ResNet9) trains that
    ResNet9-2D from those variables."""
    from pcgmix_tpu_torch.models import potes
    from pcgmix_tpu_torch.train import TrainConfig, loop, train_model

    saved = (potes.HEAD_DROPOUT, loop.build_model, loop.seeded_init, latent.save_latent_space)
    dumps = []
    latent.save_latent_space = lambda *a, **kw: dumps.append(1) or saved[3](*a, **kw)
    if potes_head_dropout is not None:
        potes.HEAD_DROPOUT = potes_head_dropout
    if narrow_2d is not None:
        from pcgmix_tpu_torch.models import ResNet9_2D
        from pcgmix_tpu_torch.train.convert import jax_resnet9_2d_to_torch

        filters, variables = narrow_2d
        loop.build_model = lambda name, num_classes, C, T, **kw: ResNet9_2D(
            num_classes, filters, kw["freq"], T)

        def carried(model, seed):
            model.load_state_dict(jax_resnet9_2d_to_torch(variables["params"],
                                                          variables["batch_stats"]))
            return model

        loop.seeded_init = carried
    out = {"rank": dist.get_rank() if dist.is_initialized() else None}
    try:
        for key, cfg, hooks in runs:
            records, undo = _recording()
            dumps.clear()
            try:
                perf = train_model(TrainConfig(**cfg), dataset, **hooks)
            finally:
                undo()
            out[key] = {"perf": perf, **records, "dumps": len(dumps)}
    finally:
        (potes.HEAD_DROPOUT, loop.build_model, loop.seeded_init,
         latent.save_latent_space) = saved
    return out


def gather_grad_case(dp=None):
    """The autograd gather on a seeded (8, 3, 5) batch: each rank takes the
    global batch from its block through ``gather_grad``, and its loss reads
    its own rows and partner rows of any rank (``mix``), weighted per rank.
    Returns this rank's block's gradient; without ``dp``, the gradient of
    the ranks' summed losses over the whole batch (the concatenated
    batch's), for ``world`` ranks."""
    world = 2 if dp is None else dp.world
    rng = np.random.default_rng(11)
    x = rng.normal(size=(8, 3, 5)).astype(np.float32)
    mix = rng.permutation(8)
    w = rng.normal(size=(world, 8 // world, 3, 5)).astype(np.float32)
    v = rng.normal(size=(world, 8 // world, 3, 5)).astype(np.float32)

    def loss(rank, own, whole):
        sl = DataParallel(rank, world).block(8)
        partner = whole.index_select(0, torch.from_numpy(mix[sl]))
        return ((torch.from_numpy(w[rank]) * partner * own).sum()
                + (torch.from_numpy(v[rank]) * own.square()).sum())

    if dp is None:
        whole = torch.from_numpy(x).requires_grad_(True)
        sum(loss(r, whole[DataParallel(r, world).block(8)], whole)
            for r in range(world)).backward()
        return whole.grad.numpy()
    own = torch.from_numpy(x[dp.block(8)]).requires_grad_(True)
    loss(dp.rank, own, dp.gather_grad(own)).backward()
    return own.grad.numpy()


def latent_step_grads(dp=None, method="latentmixup", depth=2, B=8, T=256):
    """One latent step of ``method`` (its plan forced at ``depth``) on
    resnet9-5k, its gradients averaged over the ranks as the update takes
    them: {parameter name: gradient}."""
    from pcgmix_tpu_torch.augment import AugmentConfig
    from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.train.convert import seeded_init
    from pcgmix_tpu_torch.train.losses import init_selc_table
    from pcgmix_tpu_torch.train.steps import make_optimizer

    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=2, segments_per_wav=2,
                                  sig_len=T, seed=6)
    train = physionet_split(ds, "train", train_balance=False)
    model = seeded_init(build_model("resnet9-5k", 2, 4, T, seed=3), 4)
    opt, sched = make_optimizer(model, "adam", 0.0, 0.0, 10, False)
    engine = AugmentEngine(AugmentConfig(method, B, 4, T, model="resnet9-5k"))
    step = TrainStep(model, opt, sched, torch.from_numpy(train.data),
                     torch.from_numpy(train.label), init_selc_table(train.label, 2),
                     num_classes=2, grad_clip=0.0, selc_es=99, engine=engine, dp=dp)
    idx = np.arange(B) % len(train)
    plan = engine.plan(1, train.frames[idx], train.label[idx], _force=True)
    step(idx, plan.arrays, epoch=1, latent_depth=depth)
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def rank_cases():
    """The spawned ranks' cases of the gather tests."""
    dp = DataParallel.current()
    return {"gather": gather_grad_case(dp),
            "latentmixup": latent_step_grads(dp),
            "manifold-cutmix": latent_step_grads(dp, "manifold-cutmix", depth=1)}


def rank_steps(engine, corpus, labels, idx, arrays, world=2):
    """Each of ``world`` ranks' (data, target) of a plan's rows, from the
    train step's data-parallel route (``TrainStep.mix_rows``) on a rank of
    ``world`` simulated in this process: none of it takes a collective."""
    out = []
    for rank in range(world):
        step = TrainStep(None, None, None, torch.as_tensor(corpus), torch.as_tensor(labels),
                         None, num_classes=2, grad_clip=0.0, selc_es=0, engine=engine,
                         dp=DataParallel(rank, world))
        t = step.upload(idx)
        plan = engine.device_arrays(arrays, t.device)
        out.append(step.mix_rows(t, plan))
    return out


def assert_ranks_equal_whole(engine, corpus, labels, idx, arrays, world=2):
    """The ranks' blocks (:func:`rank_steps`) of a plan's rows, in rank
    order, equal the whole batch's apply, bit for bit, targets included."""
    data = torch.as_tensor(corpus)[torch.as_tensor(np.asarray(idx))]
    target = torch.eye(2)[torch.as_tensor(np.asarray(labels)[np.asarray(idx)])]
    whole, whole_t = engine.apply(data, target, arrays)
    blocks = rank_steps(engine, corpus, labels, idx, arrays, world)
    assert torch.equal(torch.cat([d for d, _ in blocks]), whole)
    assert torch.equal(torch.cat([t for _, t in blocks]), whole_t)


def rank_latents(engine, latent_whole, target_whole, arrays, world=2):
    """Each rank's mix of its block of a latent (the split step's route,
    ``TrainStep._mix_block``), its partner rows read from the whole latent
    (what the ranks' gather gives)."""
    out = []
    n = len(latent_whole)
    for rank in range(world):
        dp = DataParallel(rank, world)
        step = TrainStep(None, None, None, latent_whole, torch.zeros(n, dtype=torch.int64),
                         None, num_classes=2, grad_clip=0.0, selc_es=0, engine=engine, dp=dp)
        block = step._block_plan(engine.device_arrays(arrays, latent_whole.device), n,
                                 latent_whole)
        sl = dp.block(n)

        def fetch(pos):
            pos = pos.long()
            return latent_whole.index_select(0, pos), target_whole.index_select(0, pos)

        own = latent_whole[sl], target_whole[sl]
        out.append(step._mix_block(fetch, lambda: own, block))
    return out


def grid_over_ranks(base, dataset, methods):
    """``run_grid`` inside the group (every rank runs it, as under
    torchrun): the configs it trained and their performance dicts."""
    from pcgmix_tpu_torch import utils
    from pcgmix_tpu_torch.exp.dirs import experiment_dir
    from pcgmix_tpu_torch.exp.runner import run_grid

    executed = run_grid(base, dataset, methods, [1.0], [1], seed_datas=[1100001],
                        robust=False, progress=False)
    perfs = []
    for cfg in executed:
        path = experiment_dir(cfg) + "/performance.pkl"
        perfs.append(utils.load_dict(path) if dist.get_rank() == 0 else None)
    return {"executed": executed, "perfs": perfs}

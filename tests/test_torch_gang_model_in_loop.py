"""The model-in-the-loop methods in a gang (``pcgmix_tpu_torch/train/gang.py``)
on the CPU: the frozen-model hooks (``(salopt…)`` with one provider per
member, the closest pairings with the shared embedder) plan bit-equal to,
and train within 1e-6 of, the members' standalone ``train_model`` runs with
the same hooks, on the equal path and on a ragged UMC gang; the live-model
mode (``lc-nointrusion``, ``saliency-cutmix``) on ``Potes(noDropout)``
tracks the JAX package's ``train_gang`` at the transplant bar (step 0
within 1e-5, steps 0–6 within 1e-3 relative) with the same picks, bins and
plans; the vmapped saliency and candidate losses equal each member's own
within 1e-6; the protocol errors; two gloo ranks equal one process."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from pcgmix_tpu import saliency as jsaliency
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import gang as jgang
from pcgmix_tpu_torch.augment import AugmentEngine
from pcgmix_tpu_torch.data import synthetic_physionet_dict, synthetic_umc_dict
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.saliency import training_saliency_raw
from pcgmix_tpu_torch.train import TrainConfig, gang, train_model
from pcgmix_tpu_torch.train.convert import seeded_init
from pcgmix_tpu_torch.train.steps import candidate_losses, generators
from tests import torch_dp_runs

T = 512
# two seed_datas whose n_fraction=0.5 splits hold 15 rows each: one batch
# of 8 an epoch, so that every step is a plot epoch
SEED_DATAS = (1100001, 1100003)
HOOKS = {
    "(saloptenv)durratiomixup": "salopt",
    "(saloptsum-2)durmixmagwarp(0.2,4)": "salopt",
    "(closestknn=8)durmixmagwarp(0.2,4)": "closest",
    "(closestbins=4)durratiomixup": "closest",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=6,
                                    segments_per_wav=2, sig_len=T, seed=1)


def _members(**kw):
    common = dict(model="resnet9-5k", num_epochs=4, batch_size=8, n_fraction=0.5,
                  save_artifacts=False, device="cpu")
    common.update(kw)
    return [TrainConfig(**common, seed_data=sd, seed=i + 1)
            for i, sd in enumerate(SEED_DATAS)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def _hooks(method, n):
    """(train_gang's hooks for ``n`` members, train_model's for one)."""
    kind = HOOKS[method]
    if kind == "salopt":
        provider = torch_dp_runs.amplitude_saliency
        return {"saliency_model_providers": [provider] * n}, {
            "saliency_model_provider": provider}
    fn = torch_dp_runs.window_means
    return {"latent_feature_fn": fn}, {"latent_feature_fn": fn}


class _Plans:
    """Every plan an engine builds (forced identity templates aside), by
    engine: a gang's members each have their own."""

    def __init__(self, monkeypatch):
        self.by_engine: dict = {}
        plan = AugmentEngine.plan

        def recording(engine, step, *a, **k):
            p = plan(engine, step, *a, **k)
            if not k.get("_force"):
                self.by_engine.setdefault(id(engine), []).append((step, p))
            return p

        monkeypatch.setattr(AugmentEngine, "plan", recording)

    def take(self) -> list:
        out = list(self.by_engine.values())
        self.by_engine.clear()
        return out


def _assert_same_plans(a, b):
    assert [s for s, _ in a] == [s for s, _ in b]
    for (_, p), (_, q) in zip(a, b):
        assert (p is None) == (q is None)
        if p is not None:
            assert sorted(p.arrays) == sorted(q.arrays)
            for k in p.arrays:
                np.testing.assert_array_equal(p.arrays[k], q.arrays[k], err_msg=k)


def _assert_members_equal_their_runs(cfgs, data, got, plans, ganged, one):
    """Frozen members within 1e-6 of their own runs, plans bit-equal."""
    for s, (g, cfg) in enumerate(zip(got, cfgs)):
        ref = train_model(cfg, data, **one)
        (alone,) = plans.take()
        assert g["steps"] == ref["steps"]
        assert _rel(g["train_loss"], ref["train_loss"]).max() < 1e-6
        assert _rel(g["test_loss"], ref["test_loss"]).max() < 1e-6
        assert any(p is not None for _, p in alone)
        _assert_same_plans(ganged[s], alone)


# --------------------------------------------------------------------------- #
# the frozen-model hooks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", list(HOOKS))
def test_hook_members_equal_their_train_model_runs(method, ds, monkeypatch):
    plans = _Plans(monkeypatch)
    cfgs = _members(method=method, lr_max=0.0)
    hooks, one = _hooks(method, len(cfgs))
    got = gang.train_gang(cfgs, ds, **hooks)
    ganged = plans.take()
    assert len(ganged) == len(cfgs)
    _assert_members_equal_their_runs(cfgs, ds, got, plans, ganged, one)


@pytest.fixture(scope="module")
def umc():
    """Folds 1 and 5 train on 14 rows (one batch of 8 an epoch), fold 2 on
    16 (two), each testing on its own held-out patients (as
    tests/test_torch_gang_ragged.py builds them)."""
    from pcgmix_tpu_torch.data import umc as umc_mod

    ds = synthetic_umc_dict(segments_per_patient=1, sig_len=T, seed=6)
    held = {p for f in (1, 2, 5) for p in umc_mod.HELDOUT_GROUPS[f - 1]}
    ds["excluded"] = np.array([int(p in held) for p in ds["id"]], np.int64)
    return ds


@pytest.mark.parametrize("method", ["(saloptenv)durratiomixup",
                                    "(closestbins=4)durratiomixup"])
def test_ragged_umc_hook_gang_equals_the_folds_runs(method, umc, monkeypatch):
    """The lockstep path: each active member's hook on its own batch; an
    idle member plans nothing."""
    plans = _Plans(monkeypatch)
    cfgs = [TrainConfig(dataset="UMC", model="resnet9-5k", method=method, op="SGD",
                        num_epochs=3, batch_size=8, lr_max=0.0, save_artifacts=False,
                        seed_data=f, device="cpu") for f in (1, 2, 5)]
    hooks, one = _hooks(method, len(cfgs))
    got = gang.train_gang(cfgs, umc, **hooks)
    ganged = plans.take()
    assert [len(p) for p in ganged] == [3, 6, 3]
    _assert_members_equal_their_runs(cfgs, umc, got, plans, ganged, one)


# --------------------------------------------------------------------------- #
# the live-model mode against the JAX package's train_gang
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def potes_no_dropout():
    """Potes(noDropout) in both packages with the head's Dropout(0.5) off
    too, the JAX loop's torch-seeded init the port's seeded init (as
    tests/test_torch_model_in_loop.py runs it)."""
    import flax.linen as fnn

    from pcgmix_tpu.train import convert as jconvert
    from pcgmix_tpu_torch.models import potes

    class _NoDropout:
        def __init__(self, rate, deterministic=None, **kw):
            pass

        def __call__(self, x, *args, **kw):
            return x

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    mp.setattr(potes, "HEAD_DROPOUT", 0.0)
    mp.setattr(jconvert, "torch_seeded_init", lambda model, C, T_, k, seed: (
        jconvert.torch_potes_to_flax(seeded_init(build_model(model, k, C, T_),
                                                 seed).state_dict())))
    yield
    mp.undo()


def _live_records(mp, engine_cls, bin_module):
    """Record ``lc_select``'s picks, the plans and the saliency bins."""
    rec = {"picks": [], "plans": [], "bins": []}
    select, plan, binning = engine_cls.lc_select, engine_cls.plan, bin_module.bin_training_saliency

    def picks(*args):  # the port's is a staticmethod, the JAX engine's a method
        sel = select(*args)
        rec["picks"].append(np.asarray(sel).copy())
        return sel

    def plans(engine, *a, **k):
        p = plan(engine, *a, **k)
        rec["plans"].append(None if p is None else
                            {k_: np.array(v, copy=True) for k_, v in p.arrays.items()})
        return p

    def bins(sal, frames):
        out = binning(sal, frames)
        rec["bins"].append(out)
        return out

    static = isinstance(inspect.getattr_static(engine_cls, "lc_select"), staticmethod)
    mp.setattr(engine_cls, "lc_select", staticmethod(picks) if static else picks)
    mp.setattr(engine_cls, "plan", plans)
    mp.setattr(bin_module, "bin_training_saliency", bins)
    return rec


def _live_cfgs(cls, method, **kw):
    return [cls(model="Potes(noDropout)", method=method, num_epochs=7, batch_size=8,
                n_fraction=0.5, save_artifacts=False, seed_data=sd, seed=i + 1, **kw)
            for i, sd in enumerate(SEED_DATAS)]


@pytest.fixture(scope="module")
def jax_live(ds, potes_no_dropout):
    """One jitted JAX gang a live method, with its picks, plans and bins."""
    out = {}
    for method in ("lc-nointrusion", "saliency-cutmix"):
        mp = pytest.MonkeyPatch()
        rec = _live_records(mp, JEngine, jsaliency)
        try:
            perfs = jgang.train_gang(_live_cfgs(JTrainConfig, method, sig_len=T,
                                                torch_init=True, loader_parity="torch"), ds)
        finally:
            mp.undo()
        out[method] = perfs, rec
    return out


@pytest.mark.parametrize("method", ["lc-nointrusion", "saliency-cutmix"])
def test_live_gang_tracks_the_jax_gang(method, jax_live, ds, potes_no_dropout, monkeypatch):
    ref, jrec = jax_live[method]
    rec = _live_records(monkeypatch, AugmentEngine, gang)
    got = gang.train_gang(_live_cfgs(TrainConfig, method, device="cpu"), ds)
    for g, r in zip(got, ref):
        assert g["steps"] == r["steps"] == list(range(1, 8))
        assert abs(g["train_loss"][0] - r["train_loss"][0]) < 1e-5
        assert _rel(g["train_loss"], r["train_loss"]).max() < 1e-3
    assert len(rec["plans"]) == len(jrec["plans"]) == 14
    for p, q in zip(rec["plans"], jrec["plans"]):
        assert sorted(p) == sorted(q)
        for k in p:
            np.testing.assert_array_equal(p[k], np.asarray(q[k]), err_msg=k)
    if method == "lc-nointrusion":
        assert len(rec["picks"]) == len(jrec["picks"]) == 14
        for a, b in zip(rec["picks"], jrec["picks"]):
            np.testing.assert_array_equal(a, b)
    else:
        assert len(rec["bins"]) == len(jrec["bins"]) == 14
        for (v, f), (jv, jf) in zip(rec["bins"], jrec["bins"]):
            np.testing.assert_array_equal(f, jf)
            np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# the vmapped passes
# --------------------------------------------------------------------------- #


def _two_member_step(model, data, labels):
    """A GangStep whose two members hold different weights and BatchNorm
    statistics, and each member's own module."""
    C = data.shape[1]
    template = seeded_init(build_model(model, 2, C, T), 4)
    other = seeded_init(build_model(model, 2, C, T), 9)
    with torch.no_grad():  # BatchNorm statistics away from their init
        other.train()(torch.from_numpy(data[:8]) * 3.0)
    gens = [list(generators(build_model(model, 2, C, T, seed=s + 1)).values())
            for s in range(2)]
    step = gang.GangStep(template, gens, ("adam", 0.01, 1e-4, 10, True),
                         train_data=torch.from_numpy(data),
                         train_labels=torch.from_numpy(labels),
                         soft_labels=torch.zeros(2, len(labels), 2), num_classes=2,
                         grad_clip=0.1, selc_es=99, engine=None)
    sd = other.state_dict()
    with torch.no_grad():
        for k, v in {**step.model.params, **step.model.buffers_}.items():
            v[1] = sd[k]
    members = []
    for s in range(2):
        m = build_model(model, 2, C, T)
        m.load_state_dict(step.member_state_dict(s))
        members.append(m)
    return step, members


@pytest.mark.parametrize("model", ["resnet9-5k", "Potes(noDropout)"])
def test_vmapped_saliency_equals_each_members_own(model, ds):
    from pcgmix_tpu_torch.data import physionet_split

    split = physionet_split(ds, "train", train_balance=False)
    step, members = _two_member_step(model, split.data, split.label)
    rng = np.random.default_rng(5)
    rows = rng.choice(len(split), (2, 8), replace=False)
    end = split.frames[rows.reshape(-1), -1]
    got = step.live_saliency(torch.from_numpy(rows), end).numpy().reshape(2, 8, T)
    for s, m in enumerate(members):
        data = torch.from_numpy(split.data[rows[s]])
        target = torch.eye(2)[split.label[rows[s]]]
        ref = training_saliency_raw(m, data, target, end.reshape(2, 8)[s]).numpy()
        np.testing.assert_allclose(got[s], ref, rtol=0, atol=1e-6)
    assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize("model", ["resnet9-5k", "Potes(noDropout)"])
def test_vmapped_candidate_losses_equal_each_members_own(model, ds):
    from pcgmix_tpu_torch.data import physionet_split

    split = physionet_split(ds, "train", train_balance=False)
    step, members = _two_member_step(model, split.data, split.label)
    rng = np.random.default_rng(6)
    cands = torch.from_numpy(rng.standard_normal((2 * 32, 4, T)).astype(np.float32))
    cand_t = torch.eye(2)[torch.from_numpy(rng.integers(0, 2, 2 * 32))]
    got = step.candidate_losses(cands, cand_t).numpy()
    assert got.shape == (2, 32)
    for s, m in enumerate(members):
        ref = candidate_losses(m, cands[s * 32:(s + 1) * 32], cand_t[s * 32:(s + 1) * 32])
        np.testing.assert_allclose(got[s], ref.numpy(), rtol=1e-6, atol=1e-6)
    # eval mode: no BatchNorm buffer moved
    before = {k: v.clone() for k, v in step.model.buffers_.items()}
    step.candidate_losses(cands, cand_t)
    assert all(torch.equal(before[k], v) for k, v in step.model.buffers_.items())


# --------------------------------------------------------------------------- #
# protocol errors
# --------------------------------------------------------------------------- #


def test_protocol_errors(ds):
    ragged = [dataclasses.replace(c, seed_data=sd) for c, sd in
              zip(_members(method="lc-nointrusion"), (1100001, 1100002))]
    with pytest.raises(ValueError, match="equal-size members"):
        gang.train_gang(ragged, ds)
    cfgs = _members(method="(saloptenv)durratiomixup")
    with pytest.raises(ValueError, match="ONE saliency provider per member"):
        gang.train_gang(cfgs, ds)
    with pytest.raises(ValueError, match="ONE saliency provider per member"):
        gang.train_gang(cfgs, ds, saliency_model_providers=[torch_dp_runs.amplitude_saliency])
    with pytest.raises(TypeError, match="must pickle"):  # before any rank is spawned
        gang.train_gang(cfgs, ds, n_devices=2,
                        saliency_model_providers=[lambda m: None, lambda m: None])
    # the JAX package refuses the same configs
    jcfgs = [JTrainConfig(model="resnet9-5k", method="(saloptenv)durratiomixup", num_epochs=4,
                          batch_size=8, n_fraction=0.5, save_artifacts=False, sig_len=T,
                          seed_data=sd) for sd in SEED_DATAS]
    with pytest.raises(ValueError, match="ONE saliency provider per member"):
        jgang.train_gang(jcfgs, ds)


# --------------------------------------------------------------------------- #
# two gloo ranks
# --------------------------------------------------------------------------- #


def test_two_gloo_ranks_equal_one_process(ds):
    """n_devices=2: each rank trains one member (and its provider) with no
    collectives; a hook method and a live method in one spawn."""
    runs = [("(saloptenv)durratiomixup",
             [dataclasses.asdict(c) for c in _members(method="(saloptenv)durratiomixup",
                                                      num_epochs=3, lr_max=0.0)],
             {"saliency_model_providers": [torch_dp_runs.amplitude_saliency] * 2}),
            ("lc-nointrusion",
             [dataclasses.asdict(c) for c in _members(method="lc-nointrusion", num_epochs=3,
                                                      lr_max=0.0)], {})]
    ranks = torch_dp_runs.spawn_in_background({"gangs": ("gang_runs", (ds, runs))})
    one = {key: gang.train_gang([TrainConfig(**c) for c in cfgs], ds, **hooks)
           for key, cfgs, hooks in runs}
    for r, out in enumerate(ranks()):
        for key, _, _ in runs:
            (got,) = out["gangs"][key]
            ref = one[key][r]
            assert got["steps"] == ref["steps"]
            assert _rel(got["train_loss"], ref["train_loss"]).max() < 1e-6
            assert got["test_wav_preds"] == ref["test_wav_preds"]

"""The ragged gang path (``pcgmix_tpu_torch/train/gang.py``) on the CPU:
UMC's per-member folds with SGD against the JAX package's ``train_gang``,
members of unequal train sizes against their own ``train_model`` runs,
the masked no-op that leaves an idle member's every bit alone, and the
forced-ragged path equal to the equal one."""

import dataclasses

import numpy as np
import pytest
import torch

from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import gang as jgang
from pcgmix_tpu_torch.data import synthetic_physionet_dict, synthetic_umc_dict
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train import gang

T = 512


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def umc():
    """Two rows a patient; the exclusion flags keep the held-out groups of
    folds 1, 2 and 5 alone, so that folds 1 and 5 train on 14 rows (one
    batch of 8 an epoch) and fold 2 on 16 (two), each testing on its own
    held-out patients."""
    from pcgmix_tpu_torch.data import umc as umc_mod

    ds = synthetic_umc_dict(segments_per_patient=1, sig_len=T, seed=6)
    held = {p for f in FOLDS for p in umc_mod.HELDOUT_GROUPS[f - 1]}
    ds["excluded"] = np.array([int(p in held) for p in ds["id"]], np.int64)
    return ds


@pytest.fixture(scope="module")
def physionet():
    """seed_data 1100001 keeps 15 train rows (one batch of 8 an epoch),
    1100002 16 (two): the first member idles every other lockstep step."""
    return synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=6,
                                    segments_per_wav=2, sig_len=T, seed=1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


FOLDS = (1, 2, 5)
UMC_COMMON = dict(dataset="UMC", model="resnet9-5k", method="durratiomixup", op="SGD",
                  num_epochs=4, batch_size=8, save_artifacts=False)


@pytest.fixture(scope="module")
def jax_umc(umc):
    """One jitted ragged JAX gang: three UMC folds of unequal train sizes
    and their own held-out patient groups."""
    cfgs = [JTrainConfig(**UMC_COMMON, seed_data=f, sig_len=T, torch_init=True,
                         loader_parity="torch") for f in FOLDS]
    return jgang.train_gang(cfgs, umc)


def test_umc_folds_with_sgd_track_the_jax_gang(jax_umc, umc):
    cfgs = [TrainConfig(**UMC_COMMON, seed_data=f, device="cpu") for f in FOLDS]
    got = gang.train_gang(cfgs, umc)
    for g, r, cfg in zip(got, jax_umc, cfgs):
        assert g["steps"] == r["steps"]
        assert abs(g["train_loss"][0] - r["train_loss"][0]) < 1e-5
        assert _rel(g["train_loss"], r["train_loss"]).max() < 1e-3
        assert g["lr_per_step"] == pytest.approx(r["lr_per_step"], rel=1e-5)  # float32 there
        # each member evaluated on its own held-out patients
        assert g["test_wav_preds"] == train_model(cfg, umc)["test_wav_preds"]


@pytest.mark.parametrize("method,lr", [("durmixmagwarp(0.2,4)+0.5", 0.01),
                                       ("latentmixup", 0.0), ("latentmixup", 0.01)])
def test_unequal_members_track_their_train_model_runs(method, lr, physionet):
    """Lockstep epochs of two steps; the 15-row member runs one and idles
    (draws nothing, its state put back); latentmixup dispatches once per
    distinct depth draw, masked to that draw's members."""
    cfgs = [TrainConfig(model="resnet9-5k", method=method, num_epochs=5, batch_size=8,
                        n_fraction=0.5, seed_data=sd, lr_max=lr, save_artifacts=False,
                        device="cpu") for sd in (1100001, 1100002)]
    for got, cfg in zip(gang.train_gang(cfgs, physionet), cfgs):
        ref = train_model(cfg, physionet)
        assert got["steps"] == ref["steps"]
        assert got["lr_per_step"] == ref["lr_per_step"]
        bar = 1e-6 if lr == 0.0 else 1e-3
        assert _rel(got["train_loss"], ref["train_loss"]).max() < bar
        assert abs(got["train_loss"][0] - ref["train_loss"][0]) < 1e-5


def _state(step, s):
    """Every tensor of member s's state, and its generators' states."""
    tensors = {k: v[s].clone() for k, v in step.model.state_dict().items()}
    for i, p in enumerate(step.fed.params):
        for k, v in step.opt.state[p].items():
            if torch.is_tensor(v) and v.dim():
                tensors[f"opt{i}.{k}"] = v[s].clone()
    tensors["soft"] = step.soft_labels[s].clone()
    gens = [g.get_state() for g in step.member_gens[s]]
    return tensors, gens, int(step.fed.ts[s])


@pytest.mark.parametrize("method,selc", [("durmixmagwarp(0.2,4)", False),
                                         ("durratiomixup-SELC", True)])
def test_masked_no_op_leaves_an_idle_member_bit_equal(method, selc, physionet, monkeypatch):
    """An idle member's parameters, Adam moments and step count, BatchNorm
    buffers and counters, SELC rows and dropout generator stay bit-equal
    over its masked steps, while the active member trains."""
    seen = []
    masked = gang.GangStep.masked

    def watching(self, active):
        before = [_state(self, s) for s in range(self.members)]
        with masked(self, active):
            yield
        for s in np.flatnonzero(~active):
            after = _state(self, s)
            t0, g0, n0 = before[s]
            t1, g1, n1 = after
            assert n0 == n1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
            for k in t0:
                assert torch.equal(t0[k], t1[k]), k
            seen.append(s)
        first = next(n for n, _ in self.model.named_parameters())
        for s in np.flatnonzero(active):  # an active member moved
            assert not torch.equal(before[s][0][first], self.model.state_dict()[first][s])

    monkeypatch.setattr(gang.GangStep, "masked", __import__("contextlib").contextmanager(
        watching))
    cfgs = [TrainConfig(model="Potes" if not selc else "resnet9-5k", method=method,
                        num_epochs=5 if selc else 2, batch_size=8, n_fraction=0.5,
                        seed_data=sd, save_artifacts=False, device="cpu")
            for sd in (1100001, 1100002)]
    gang.train_gang(cfgs, physionet)
    assert seen and set(seen) == {0}


def test_forced_ragged_equals_the_equal_path(physionet, monkeypatch):
    cfgs = [TrainConfig(model="Potes", method="durmixmagwarp(0.2,4)+0.5", num_epochs=3,
                        batch_size=8, n_fraction=0.5, seed_data=sd, seed=i + 1,
                        save_artifacts=False, device="cpu")
            for i, sd in enumerate((1100001, 1100003))]
    equal = gang.train_gang(cfgs, physionet)
    monkeypatch.setattr(gang, "is_ragged", lambda train_sets, test_sets: True)
    forced = gang.train_gang(cfgs, physionet)
    for a, b in zip(equal, forced):
        for k in ("train_loss", "test_loss", "lr_per_step", "test_wav_preds", "steps"):
            assert a[k] == b[k], k


def test_ragged_eval_stages_each_members_own_batches(umc):
    cfgs = [TrainConfig(**UMC_COMMON, seed_data=f, device="cpu", eval_batch_size=3)
            for f in FOLDS]
    tests = [gang.build_splits(c, umc)[1] for c in cfgs]
    host, stacked = gang._stage_eval_ragged(tests, cfgs[0], torch.device("cpu"))
    for te, batches in zip(tests, host):
        assert sum(len(b["label"]) for b in batches) == len(te)
    for s, te in enumerate(tests):
        rows = np.concatenate([d[s, :len(b["label"])].numpy()
                               for (d, _), b in zip(stacked, host[s])])
        np.testing.assert_array_equal(rows, te.data)
    assert len(stacked) == max(len(b) for b in host)


def test_jax_gangs_these_ragged_members_too(umc):
    """The ragged path is the JAX package's for these members: its
    eligibility and member validation agree."""
    cfgs = [TrainConfig(**UMC_COMMON, seed_data=f) for f in FOLDS]
    assert gang.gang_ineligible_reason(cfgs[0]) is None
    assert jgang.gang_ineligible_reason(JTrainConfig(**UMC_COMMON)) is None
    gang._validate_members(cfgs)
    with pytest.raises(ValueError, match="differ only in"):
        gang._validate_members([cfgs[0], dataclasses.replace(cfgs[1], op="adam")])

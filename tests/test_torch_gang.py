"""Gang training in the port (``pcgmix_tpu_torch/train/gang.py``) on the
CPU: each member against its own ``train_model`` run (plans bit-equal,
frozen weights within 1e-6, loss traces at the transplant bar), the JAX
package's ``train_gang`` on equal PCGmix+ and latentmixup members, the
graph route's chunks, resume, ranks, eligibility and grouping (the JAX
package's for every method of the DSL, with and without the model
hooks), sizing, and ``conv_impl="matmul"``.  The model-in-the-loop
methods' gangs: tests/test_torch_gang_model_in_loop.py."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from pcgmix_tpu.models import build_model as jbuild_model
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import gang as jgang
from pcgmix_tpu_torch.augment.engine import AugmentEngine
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.models.layers import MatmulConv1d
from pcgmix_tpu_torch.ops import mix_kernels
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train import gang
from pcgmix_tpu_torch.train.convert import jax_gang_to_torch, jax_to_torch, seeded_init

T = 512
# two seed_datas whose n_fraction=0.5 splits hold 15 rows each: one batch
# of 8 an epoch, so that every step is a plot epoch
SEED_DATAS = (1100001, 1100003)


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
    common = dict(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=7,
                  batch_size=8, n_fraction=0.5, save_artifacts=False, device="cpu")
    common.update(kw)
    return [TrainConfig(**common, seed_data=sd, seed=i + 1)
            for i, sd in enumerate(SEED_DATAS)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def _assert_transplant_bar(got, ref):
    """Step 0 within 1e-5, steps 0–6 within 1e-3 relative."""
    assert got["steps"] == ref["steps"] == list(range(1, 8))
    lt, lr = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lr[0]) < 1e-5, (lt, lr)
    assert _rel(lt, lr).max() < 1e-3, (lt, lr)


@pytest.mark.parametrize("model,method", [
    ("resnet9-5k", "base"),
    ("resnet9-5k", "durratiomixup"),
    ("resnet9-5k", "durratiomixup+0.5"),
    ("Potes", "durmixmagwarp(0.2,4)"),
    ("resnet9-5k", "cutmix"),
    ("Potes", "cutmix"),
])
def test_members_track_their_train_model_runs(model, method, ds):
    """At lr 0.01 with Adam a run can be chaotic: resnet9-5k with
    ``durmixmagwarp(0.2,4)+0.5`` on this data leaves its own
    ``train_model`` run by 5e-3 relative at step 6 when only its
    convolutions' rounding changes (``conv_impl="matmul"``), and the gang
    by the same; its gang is held with frozen weights below."""
    cfgs = _members(model=model, method=method)
    for got, cfg in zip(gang.train_gang(cfgs, ds), cfgs):
        ref = train_model(cfg, ds)
        _assert_transplant_bar(got, ref)
        assert got["lr_per_step"] == ref["lr_per_step"]
        assert sorted(got) == sorted(ref)


@pytest.mark.parametrize("model,method", [("resnet9-5k", "durmixmagwarp(0.2,4)+0.5"),
                                          ("Potes", "durratiomixup"),
                                          ("resnet9-5k", "latentmixup"),
                                          ("resnet9-5k", "manifold-cutmix")])
def test_frozen_members_equal_their_train_model_runs(model, method, ds):
    """lr_max=0: the same batches, plans, dropout masks and BatchNorm
    statistics; only the grouped convolutions' rounding differs."""
    cfgs = _members(model=model, method=method, lr_max=0.0)
    for got, cfg in zip(gang.train_gang(cfgs, ds), cfgs):
        ref = train_model(cfg, ds)
        assert _rel(got["train_loss"], ref["train_loss"]).max() < 1e-6
        assert _rel(got["test_loss"], ref["test_loss"]).max() < 1e-6


def test_plans_equal_the_standalone_runs(ds, monkeypatch):
    """Every member's plan is its standalone run's, bit for bit."""
    log: dict = {}
    plan = AugmentEngine.plan

    def recording(self, step, *a, **k):
        p = plan(self, step, *a, **k)
        if not k.get("_force"):
            log.setdefault(id(self), []).append((step, p))
        return p

    monkeypatch.setattr(AugmentEngine, "plan", recording)
    cfgs = _members(method="durmixmagwarp(0.2,4)+0.5", num_epochs=4)
    gang.train_gang(cfgs, ds)
    ganged = list(log.values())
    for s, cfg in enumerate(cfgs):
        log.clear()
        train_model(cfg, ds)
        (alone,) = log.values()
        assert [st for st, _ in ganged[s]] == [st for st, _ in alone]
        assert any(p is None for _, p in alone) and any(p is not None for _, p in alone)
        for (_, a), (_, b) in zip(ganged[s], alone):
            assert (a is None) == (b is None)
            if a is not None:
                assert sorted(a.arrays) == sorted(b.arrays)
                for k in a.arrays:
                    np.testing.assert_array_equal(a.arrays[k], b.arrays[k])


def test_gang_plan_offsets_rows_and_spreads_scalars():
    a = {"mix": np.array([1, 0]), "lam": np.float32(0.3), "len": np.ones((2, 3), np.int32),
         "sinusoid": np.zeros(4, np.float32)}
    b = {"mix": np.array([0, 1]), "lam": np.float32(0.3), "len": np.ones((2, 3), np.int32),
         "sinusoid": np.ones(4, np.float32)}
    joined = gang.gang_plan([a, b], 2)
    np.testing.assert_array_equal(joined["mix"], [1, 0, 2, 3])
    assert joined["lam"] == np.float32(0.3) and joined["len"].shape == (4, 3)
    assert joined["sinusoid"].shape == (4, 1, 4)
    np.testing.assert_array_equal(joined["sinusoid"][2:, 0], np.ones((2, 4)))
    spread = gang.gang_plan([a, {**b, "lam": np.float32(0.5)}], 2)
    np.testing.assert_array_equal(spread["lam"], np.float32([0.3, 0.3, 0.5, 0.5]))
    assert gang.gang_plan([{"fbb": np.array([1, 2])}, {"fbb": np.array([0, 2])}], 2) is None


def test_one_apply_per_gang_step(ds, monkeypatch):
    """K1/K2 run once on the S·B rows of a gang step, not once a member."""
    calls = []
    fused = mix_kernels.pcgmix_plus_fused_plain

    def counting(data, *a):
        calls.append(data.shape[0])
        return fused(data, *a)

    monkeypatch.setattr(mix_kernels, "pcgmix_plus_fused_plain", counting)
    gang.train_gang(_members(num_epochs=3), ds)
    assert calls == [16, 16, 16]


# --------------------------------------------------------------------------- #
# against the JAX package's train_gang
# --------------------------------------------------------------------------- #


def _jax_gang(ds, method):
    """One jitted JAX gang of the two members; returns its perf dicts and
    its stacked final variables (numpy)."""
    import jax

    common = dict(model="resnet9-5k", method=method, num_epochs=7, batch_size=8,
                  n_fraction=0.5, save_artifacts=False, sig_len=T, torch_init=True,
                  loader_parity="torch")
    cfgs = [JTrainConfig(**common, seed_data=sd, seed=i + 1)
            for i, sd in enumerate(SEED_DATAS)]
    captured = {}
    finalize = jgang._finalize_members

    def capture(cfgs_, perfs, run_dirs, state, lr_lists):
        captured["params"] = jax.device_get(state.params)
        captured["batch_stats"] = jax.device_get(state.batch_stats)
        return finalize(cfgs_, perfs, run_dirs, state, lr_lists)

    jgang._finalize_members = capture
    try:
        perfs = jgang.train_gang(cfgs, ds)
    finally:
        jgang._finalize_members = finalize
    return perfs, captured


@pytest.fixture(scope="module")
def jax_pcgmix_plus(ds):
    return _jax_gang(ds, "durmixmagwarp(0.2,4)")


@pytest.fixture(scope="module")
def jax_latentmixup(ds):
    return _jax_gang(ds, "latentmixup")


def test_equal_pcgmix_plus_tracks_the_jax_gang(jax_pcgmix_plus, ds, tmp_path):
    ref, state = jax_pcgmix_plus
    cfgs = _members(save_artifacts=True, plot=False, experiments_root=str(tmp_path))
    got = gang.train_gang(cfgs, ds)
    for g, r in zip(got, ref):
        _assert_transplant_bar(g, r)
        assert g["test_wav_preds"] == r["test_wav_preds"]
    # the JAX gang's stacked final state, per member, in the port's model:
    # its eval is the JAX package's last plot epoch's
    from pcgmix_tpu_torch.train.loop import build_splits, evaluate, stage_eval
    from pcgmix_tpu_torch.train.metrics import PerformanceTracker

    members = jax_gang_to_torch("resnet9-5k", state["params"], state["batch_stats"])
    for sd, cfg, r in zip(members, cfgs, ref):
        saved = torch.load(f"{experiment_dir(cfg)}/model.pth", weights_only=True)
        assert sorted(sd) == sorted(saved)
        model = build_model("resnet9-5k", 2, 4, T)
        model.load_state_dict(sd)
        perf = PerformanceTracker()
        evaluate(model, stage_eval(build_splits(cfg, ds)[1], 1000, 2, "cpu"), perf)
        assert perf.dict["test_wav_preds"][-1] == r["test_wav_preds"][-1]
        assert abs(perf.dict["test_loss"][-1] - r["test_loss"][-1]) < 1e-5


def test_latentmixup_tracks_the_jax_gang(jax_latentmixup, ds):
    ref, _ = jax_latentmixup
    for g, r in zip(gang.train_gang(_members(method="latentmixup"), ds), ref):
        _assert_transplant_bar(g, r)


# --------------------------------------------------------------------------- #
# the graph route's chunks, resume, ranks
# --------------------------------------------------------------------------- #


def _same(a, b):
    return all(x["train_loss"] == y["train_loss"] and x["test_loss"] == y["test_loss"]
               and x["lr_per_step"] == y["lr_per_step"] for x, y in zip(a, b))


@pytest.mark.parametrize("model,method", [("Potes", "durmixmagwarp(0.2,4)+0.5"),
                                          ("resnet9-5k", "durratiomixup")])
def test_steps_per_dispatch_4_equals_1(model, method):
    """Chunks of 4 gang steps (on the CPU the plain version: 4 eager
    steps from the chunk's staged buffers) equal one step per dispatch,
    bit for bit: Potes' dropout from the staged draws, gated steps as
    identity plans with the gate off."""
    ds = synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=6,
                                  segments_per_wav=4, sig_len=T, seed=1)
    one = _members(model=model, method=method, num_epochs=3)
    four = [dataclasses.replace(c, steps_per_dispatch=4) for c in one]
    assert _same(gang.train_gang(one, ds), gang.train_gang(four, ds))


def test_resume_equals_the_uninterrupted_gang(ds, tmp_path, monkeypatch):
    cfgs = _members(model="Potes", num_epochs=4, save_artifacts=True, plot=False,
                    experiments_root=str(tmp_path), checkpoint_every=1)
    full = gang.train_gang(cfgs, ds)
    emit = gang._emit_member_plot_epoch
    seen = []

    def crash(perf, run_dir, epoch, *a):
        emit(perf, run_dir, epoch, *a)
        seen.append(epoch)
        if seen.count(3) == len(cfgs):
            raise KeyboardInterrupt

    monkeypatch.setattr(gang, "_emit_member_plot_epoch", crash)
    monkeypatch.setattr(gang, "_cleanup_gang_ckpt", lambda ckpt: None)
    for cfg in cfgs:
        shutil.rmtree(experiment_dir(cfg))
    with pytest.raises(KeyboardInterrupt):
        gang.train_gang(cfgs, ds)
    monkeypatch.undo()
    resumed = gang.train_gang(cfgs, ds)
    assert _same(full, resumed)
    assert not (tmp_path / ".gang_checkpoints").exists() or not any(
        (tmp_path / ".gang_checkpoints").iterdir())


def test_two_gloo_ranks_equal_one_process(ds):
    """n_devices=2: each rank trains one member, with no collectives."""
    cfgs = _members(num_epochs=3, lr_max=0.0)
    one = gang.train_gang(cfgs, ds)
    two = gang.train_gang(cfgs, ds, n_devices=2)
    for a, b in zip(one, two):
        assert _rel(b["train_loss"], a["train_loss"]).max() < 1e-6
        assert a["test_wav_preds"] == b["test_wav_preds"]
    with pytest.raises(ValueError, match="divide evenly"):
        gang.train_gang(cfgs + cfgs[:1], ds, n_devices=2)


# --------------------------------------------------------------------------- #
# eligibility, grouping, sizing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", ["base", "durratiomixup", "durmixmagwarp(0.2,4)+0.5",
                                    "latentmixup", "manifold-cutmix", "cutmix",
                                    "gaussiannoise(10,30)", "durratiomixup-SELC"])
def test_eligible_where_the_jax_package_is(method):
    assert gang.gang_ineligible_reason(TrainConfig(method=method)) is None
    assert jgang.gang_ineligible_reason(JTrainConfig(method=method)) is None


@pytest.mark.parametrize("fields", [dict(latent_space=True), dict(track_variability=True)])
def test_host_side_reasons_equal_the_jax_package(fields):
    assert (gang.gang_ineligible_reason(TrainConfig(**fields))
            == jgang.gang_ineligible_reason(JTrainConfig(**fields)))


@pytest.mark.parametrize("method", ["(saloptenv)durratiomixup",
                                    "(closestknn=8)durmixmagwarp(0.2,4)",
                                    "lc-nointrusion", "saliency-cutmix"])
def test_model_hook_and_live_methods_name_item_12(method):
    """The frozen-model hook and live-model methods, once refused by the
    port's gangs, take the JAX package's reasons: the hooks need
    ``model_hooks``, the live methods are eligible either way."""
    for hooks in (False, True):
        got = gang.gang_ineligible_reason(TrainConfig(method=method), model_hooks=hooks)
        assert got == jgang.gang_ineligible_reason(JTrainConfig(method=method),
                                                   model_hooks=hooks)
    assert gang.gang_ineligible_reason(TrainConfig(method=method), model_hooks=True) is None


# one method of each base and pairing of the DSL, the salopt variants, the
# gated, SELC, '(rand)' and '(smooth)' forms, and the 2-D ladder's masks
DSL_METHODS = (
    "base", "durratiomixup", "durmixmagwarp(0.2,4)", "durmixrespscale(12,20)",
    "durratiocutmix", "(UMC-subset)durratiocutmix", "wav-durratiocutmix", "cutmix",
    "cutmix(ch)", "labelcutmix", "lengthcutmix", "datasetcutmix", "wavcutmix", "swapsysdia",
    "cont-cutmix", "(smooth)labelcutmix", "lc-nointrusion", "(rand)lc-nointrusion",
    "lc-nointrusion+cutout+1.0", "lc-nointrusion+0.5", "saliency-cutmix",
    "saliency-cutmix+0.6", "mixup(same)", "mixup(mix)", "latentmixup", "manifold-cutout",
    "manifold-cutmix", "timemask(0.2)", "respiratoryscale(12,20)", "magnitudewarp(0.2,4)",
    "timewarp(0.05,4)", "gaussiannoise(25,40)", "cutout(0.25,0.25)", "s1s2mask",
    "(sameCVD)durratiomixup", "(samePCG)durmixmagwarp(0.2,4)",
    "(sameDataset)durmixmagwarp(0.2,4)", "(mixAll)durmixmagwarp(0.2,4)",
    "(sameLength)durratiomixup", "(rand)durratiomixup", "durratiomixup-SELC",
    "durmixmagwarp(0.2,4)+0.5", "(saloptenv)durratiomixup", "(saloptsum)durratiomixup",
    "(saloptenv-1)durratiomixup", "(saloptsum-2)durmixmagwarp(0.2,4)",
    "(saloptenv)durmixmagwarp(0.2,4)+0.5", "(closestknn=8)durmixmagwarp(0.2,4)",
    "(closestbins=4)durratiomixup", "(closestknn=2)durratiocutmix",
    "(UMC-subset)durratiomixup", "trueseed=7durratiomixup",
    ("PhysioNet(spec128)", "freqmask(0.1)"), ("PhysioNet(spec128)", "durmixtimemask(0.1)"),
)


@pytest.mark.parametrize("hooks", [False, True])
def test_reasons_equal_the_jax_package_for_every_method(hooks):
    for entry in DSL_METHODS:
        dataset, method = entry if isinstance(entry, tuple) else ("PhysioNet", entry)
        got = gang.gang_ineligible_reason(TrainConfig(method=method, dataset=dataset), hooks)
        ref = jgang.gang_ineligible_reason(JTrainConfig(method=method, dataset=dataset),
                                           model_hooks=hooks)
        assert got == ref, method


def test_recurrent_models_train_sequentially():
    for name in gang.RECURRENT_MODELS:
        assert name in gang.gang_ineligible_reason(TrainConfig(model=name))
    with pytest.raises(ValueError, match="not gang-eligible"):
        gang.train_gang([TrainConfig(model="LSTM", device="cpu")], {})


def test_group_gangable_buckets_as_the_jax_package():
    grid = [dict(method=m, seed_data=sd, n_fraction=nf)
            for m in ("base", "lc-nointrusion", "durratiomixup", "(saloptenv)durratiomixup",
                      "(closestknn=8)durmixmagwarp(0.2,4)", "saliency-cutmix")
            for nf in (0.5, 1.0) for sd in (1, 2)]
    grid.append(dict(method="base", seed_data=3, n_fraction=0.5, seed=2))
    grid.append(dict(method="base", seed_data=4, latent_space=True))
    for hooks in (False, True):
        got = gang.group_gangable([TrainConfig(**g) for g in grid], model_hooks=hooks)
        ref = jgang.group_gangable([JTrainConfig(**g) for g in grid], model_hooks=hooks)
        key = [[(c.method, c.n_fraction, c.seed_data, c.seed) for c in b] for b in got]
        assert key == [[(c.method, c.n_fraction, c.seed_data, c.seed) for c in b]
                       for b in ref]
        # the hook methods gang only with the hooks; the live methods always
        sizes = {b[0][0]: len(b) for b in key}
        assert sizes["(saloptenv)durratiomixup"] == (2 if hooks else 1)
        assert sizes["lc-nointrusion"] == sizes["saliency-cutmix"] == 2
    with pytest.raises(ValueError, match="differ only in"):
        gang._validate_members([TrainConfig(), TrainConfig(lr_max=0.5)])


@pytest.mark.parametrize("model,dataset,shape,op", [
    ("resnet9", "PhysioNet", (4, 2500), "adam"), ("Potes", "PhysioNet", (4, 2500), "adam"),
    ("resnet9", "PhysioNet(spec128)", (1, 128, 128), "SGD"),
])
def test_state_term_equals_the_jax_package(model, dataset, shape, op):
    """Variables × (1 + optimizer copies) + the SELC table, byte for byte."""
    cfg = TrainConfig(model=model, dataset=dataset, op=op, batch_size=64)
    jcfg = JTrainConfig(model=model, dataset=dataset, op=op, batch_size=64,
                        sig_len=shape[-1])
    _, _, variables = jgang._abstract_variables(jcfg, 64, shape if len(shape) == 3 else None)
    copies = 2 if op == "adam" else 1
    ref = jgang._tree_bytes(variables) * (1 + copies) + 3000 * 2 * 4
    assert gang.gang_state_bytes(cfg, 3000, shape) == ref
    small = gang.estimate_gang_max_size(cfg, 3000, sample_shape=shape)
    assert 1 <= small <= gang.estimate_gang_max_size(dataclasses.replace(cfg, batch_size=8),
                                                     3000, sample_shape=shape)
    assert gang.estimate_gang_max_size(cfg, 3000, hbm_bytes=1, sample_shape=shape) == 1


def test_profitability_rule():
    assert gang.gang_profitable(TrainConfig(model="Potes"))
    assert not gang.gang_profitable(TrainConfig(model="resnet9"))


def test_launch_rows_chunk_at_the_grid_limit():
    n = mix_kernels.MAX_LAUNCH_ROWS
    assert mix_kernels._chunks(70_000) == [(0, n), (n, 70_000)]
    assert mix_kernels._chunks(64) == [(0, 64)]


# --------------------------------------------------------------------------- #
# conv_impl="matmul"
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("model", ["resnet9-5k", "Potes"])
def test_matmul_conv_equals_the_conv_and_the_jax_package(model):
    import jax

    x = np.random.default_rng(0).standard_normal((4, 4, T)).astype(np.float32)
    conv = seeded_init(build_model(model, 2, 4, T), 4).eval()
    mm = build_model(model, 2, 4, T, conv_impl="matmul").eval()
    assert any(isinstance(m, MatmulConv1d) for m in mm.modules())
    mm.load_state_dict(conv.state_dict())
    with torch.no_grad():
        a, b = conv(torch.from_numpy(x)), mm(torch.from_numpy(x))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
    jm = jbuild_model(model, num_classes=2, train=False, conv_impl="matmul")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), x)
    sd = jax_to_torch(model, jax.device_get(variables["params"]),
                      jax.device_get(variables.get("batch_stats", {})))
    mm.load_state_dict(sd)
    with torch.no_grad():
        got = mm(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_matmul_conv_trains_as_the_conv(ds):
    cfgs = _members(num_epochs=3)
    got = gang.train_gang([dataclasses.replace(c, conv_impl="matmul") for c in cfgs], ds)
    for g, cfg in zip(got, cfgs):
        ref = train_model(cfg, ds)
        assert abs(g["train_loss"][0] - ref["train_loss"][0]) < 1e-5
        assert _rel(g["train_loss"], ref["train_loss"]).max() < 1e-3

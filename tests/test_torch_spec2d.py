"""The spectrogram path of the PyTorch port against pcgmix_tpu: the 2-D
ResNet9 carries the JAX model's weights and gives its logits and latents
within 1e-5 at every depth (first ∘ second is the full forward);
``synthetic_spectrogram_dict`` and the spectrogram splits are bit-equal;
every 2-D plan is bit-equal to the JAX engine's over 8 steps and its
apply within 1e-6 (the keep-duration blends through K1's plain version on
the (B, F, T) view, and through K3's on a rank's block); ``train_model``
with PCGmix on ``PhysioNet(spec128)`` tracks ``pcgmix_tpu.train_model``
from the same flax init at the bar of tests/test_transplant_dynamics.py,
and the full-width model with frozen weights gives its losses for a mask
method, mixup and latentmixup within 1e-4 relative; a 2-D run dir the port's runner writes reads back through
``pcgmix_tpu.exp.results``; and what waits for later slices raises,
naming its ROADMAP item (2-D cutmix and durratiocutmix: tests/test_torch_concat.py;
the UMC datasets: tests/test_torch_umc.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.data import physionet_split as jphysionet_split
from pcgmix_tpu.data import synthetic_spectrogram_dict as jsynthetic_spectrogram_dict
from pcgmix_tpu.exp import results as jresults
from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import loop as jloop
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.augment.engine import SHARED_ARRAYS
from pcgmix_tpu_torch.data import EpochIterator, physionet_split, synthetic_spectrogram_dict
from pcgmix_tpu_torch.exp import runner
from pcgmix_tpu_torch.exp.robust import SEED_DATA_GRIDS
from pcgmix_tpu_torch.models import ResNet9_2D, build_model
from pcgmix_tpu_torch.parallel import DataParallel
from pcgmix_tpu_torch.train import TrainConfig, loop, train_model
from pcgmix_tpu_torch.train.convert import jax_resnet9_2d_to_torch

S, B = 32, 8  # spectrogram side, batch
SPEC = "PhysioNet(spec128)"
STEPS = 8
METHODS_2D = [
    "durratiomixup", "durratiomixup(rand)+0.6", "(mixAll)durratiomixup",
    "durmixfreqmask(0.1)", "durmixtimemask(0.1)", "durmixcutout(0.25,0.25)+0.5",
    "cutout(0.25,0.25)", "cutout", "timemask(0.1)", "timemask(0.1)+0.6",
    "freqmask(0.1)", "freqmask(0.3)", "mixup(same)", "mixup(mix)", "latentmixup",
    "latentmixup+0.5",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spec_dict():
    return synthetic_spectrogram_dict(num_wavs_train=24, num_wavs_test=4,
                                      segments_per_wav=2, size=S, seed=5)


@pytest.fixture(scope="module")
def split(spec_dict):
    return physionet_split(spec_dict, "train", train_balance=False, spectrogram=True)


def _flax_init(seed=4, model=None):
    """A JAX 2-D ResNet9 (eval; the registry's unless ``model``) and its
    flax init from PRNGKey(seed), as the JAX loop initializes it."""
    jmodel = model or jbuild("resnet9", SPEC, train=False)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 1, S, S), jnp.float32))
    return jmodel, variables


@pytest.fixture(scope="module")
def full_width():
    """The registry's (full-width) JAX 2-D ResNet9 and its flax init."""
    return _flax_init()


@pytest.fixture(scope="module")
def full_width_run(full_width):
    """One jitted eval-mode run of the full-width JAX 2-D ResNet9 on the
    split tests' input (the ``rng`` fixture's first draw): the activation
    at every depth and the logits."""
    jmodel, variables = full_width
    x = np.random.default_rng(1234).normal(size=(2, 1, S, S)).astype(np.float32)
    run = jax.jit(lambda v, x: ([jmodel.apply(v, x, depth=d, part="first") for d in range(4)],
                                jmodel.apply(v, x)))
    firsts, logits = jax.tree_util.tree_map(np.asarray, run(variables, x))
    return x, firsts, logits


def _jax_loop_starts_from(monkeypatch, variables):
    """The JAX loop's ``init_state`` from ``variables``, its flax init at
    PRNGKey(seed_fix) taken jitted once here (``_flax_init``) instead of op
    by op in each loop call; the port's loop carries the same variables."""
    init_state = jloop.init_state

    class Initialized:
        @staticmethod
        def init(key, sample):  # a copy: the JAX step donates its state
            return jax.tree_util.tree_map(jnp.copy, variables)

    monkeypatch.setattr(jloop, "init_state",
                        lambda cfg, model, train_ds, tx: init_state(cfg, Initialized, train_ds,
                                                                    tx))


def _carried(variables, model=None):
    """The port's 2-D ResNet9 (the registry's unless ``model``) holding the
    JAX variables."""
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    model = model or build_model("resnet9", 2, 1, S, dataset=SPEC)
    model.load_state_dict(jax_resnet9_2d_to_torch(np_vars["params"],
                                                  np_vars["batch_stats"]))
    return model


def test_synthetic_spectrogram_dict_and_splits_equal_reference():
    got = synthetic_spectrogram_dict(num_wavs_train=14, num_wavs_test=4,
                                     segments_per_wav=3, size=S, seed=9)
    exp = jsynthetic_spectrogram_dict(num_wavs_train=14, num_wavs_test=4,
                                      segments_per_wav=3, size=S, seed=9)
    for part in ("train", "test"):
        assert sorted(got[part]) == sorted(exp[part])
        for k, v in exp[part].items():
            assert got[part][k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    for mode, kw in (("train", {}), ("test", {}), ("train", dict(n_fraction=0.5)),
                     ("valid", dict(valid=True, seed=2))):
        a = physionet_split(got, mode, spectrogram=True, **kw)
        b = jphysionet_split(exp, mode, spectrogram=True, **kw)
        assert a.data.shape == b.data.shape and a.data.shape[1:] == (1, S, S)
        for k in ("data", "label", "frames", "wav", "sig_qual"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def test_resnet9_2d_width_and_classifier_size():
    assert build_model("resnet9", dataset=SPEC, sig_len=128).linear.in_features == 8192
    assert build_model("resnet9", dataset="UMC(spec64)", sig_len=64).linear.in_features == 2048
    model = build_model("resnet9", 2, 1, 128, dataset=SPEC)
    assert isinstance(model, ResNet9_2D)
    assert [model.conv1[0].out_channels, model.conv2[0].out_channels,
            model.conv3[0].out_channels, model.conv4[0].out_channels] == [64, 128, 256, 512]
    with pytest.raises(ValueError, match="resnet9"):
        build_model("Potes", dataset=SPEC)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_split_forward_matches_reference(depth, full_width, full_width_run):
    _, variables = full_width
    x, jfirsts, jlogits = full_width_run
    model = _carried(variables).eval()
    with torch.no_grad():
        latent = model(torch.from_numpy(x), depth=depth, part="first")
        full = model(torch.from_numpy(x))
        again = model(latent, depth=depth, part="second")
    jlatent = jfirsts[depth]
    assert latent.shape == jlatent.shape
    np.testing.assert_allclose(latent.numpy(), jlatent, rtol=0, atol=1e-5)
    np.testing.assert_allclose(full.numpy(), jlogits, rtol=0, atol=1e-5)
    assert torch.equal(again, full)


def test_train_mode_logits_and_batchnorm_updates_match_reference(rng, full_width):
    """Train-mode BatchNorm2d: the batch's biased statistics, the running
    buffers folded as flax folds them."""
    _, variables = full_width
    model = _carried(variables).train()
    x = rng.normal(size=(4, 1, S, S)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jtrain_model = jbuild("resnet9", SPEC, train=True)
    ref, mut = jax.jit(lambda v, x: jtrain_model.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    for tname, fname in (("conv1", "conv1"), ("res2.1", "res2b")):
        bn = dict(model.named_modules())[f"{tname}.1"]
        want = stats[fname]["BatchNorm_0"]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"], atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), want["var"], atol=1e-6)


def _batches(split, n_steps):
    step = 0
    while True:
        for b in EpochIterator(split, B, 1, step, "torch"):
            yield step, b
            step += 1
            if step >= n_steps:
                return


def _engines(method):
    kw = dict(spectrogram=True, spec_freq=S)
    return (AugmentEngine(AugmentConfig(method, B, 1, S, **kw)),
            JEngine(JConfig(method, B, 1, S, **kw)))


@pytest.mark.parametrize("method", METHODS_2D)
def test_2d_plans_and_applies_equal_reference(method, split):
    eng, ref = _engines(method)
    japply = jax.jit(ref.apply)  # one compile for the method's shapes
    assert vars(eng.spec) == vars(ref.spec)
    eye = np.eye(2, dtype=np.float32)
    n_plans = 0
    for step, b in _batches(split, STEPS):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args), ref.plan(*args)
        assert (got is None) == (exp is None), step
        if got is None:
            continue
        n_plans += 1
        assert got.latent_depth == exp.latent_depth, step
        assert sorted(got.arrays) == sorted(exp.arrays)
        for k, v in exp.arrays.items():
            g, r = np.asarray(got.arrays[k]), np.asarray(v)
            assert g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=f"{method} step {step} {k}")
        data, target = split.data[b["indices"]], eye[b["label"]]
        out, tgt = eng.apply(torch.from_numpy(data), torch.from_numpy(target), got.arrays)
        jout, jtgt = japply(jnp.asarray(data), jnp.asarray(target), exp.arrays)
        assert out.shape == data.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0, atol=1e-6)
    assert n_plans >= 3
    # identity templates (gated-off steps) equal too
    idn = eng.identity_arrays(0, b["frames"], b["label"])
    jidn = ref.identity_arrays(0, b["frames"], b["label"])
    assert sorted(idn) == sorted(jidn)
    for k in jidn:
        np.testing.assert_array_equal(np.asarray(idn[k]), np.asarray(jidn[k]), err_msg=k)


@pytest.mark.parametrize("method", ["durratiomixup", "durmixcutout(0.25,0.25)",
                                    "durmixfreqmask(0.3)"])
def test_2d_rank_blocks_equal_the_whole_batch(method, split):
    """The data-parallel route's apply (K3's plain version here) on each
    rank's block, with the partners gathered beforehand, the time windows
    of the block and the frequency band shared, equals the whole batch's."""
    eng, _ = _engines(method)
    idx = np.arange(B)
    plan = eng.plan(3, split.frames[idx], split.label[idx], _force=True)
    data = torch.from_numpy(split.data[idx])
    target = torch.eye(2)[torch.from_numpy(split.label[idx])]
    whole, whole_t = eng.apply(data, target, plan.arrays)
    eng.check_prepaired()
    for rank in range(2):
        dp = DataParallel(rank=rank, world=2)
        sl = dp.block(B)
        block = dp.shard_arrays(plan.arrays, B, SHARED_ARRAYS)
        if "fbb" in plan.arrays:
            assert np.array_equal(block["fbb"], plan.arrays["fbb"])
        mix = torch.from_numpy(np.asarray(block["mix"]))
        out, out_t = eng.apply_prepaired(data[sl], data[mix], target[sl], target[mix], block)
        assert torch.equal(out, whole[sl]) and torch.equal(out_t, whole_t[sl])


@pytest.mark.parametrize("method", ["cutout(0.25,0.25)", "timemask(0.1)", "freqmask(0.1)",
                                    "mixup(same)", "latentmixup"])
def test_2d_row_global_bases_refuse_a_split_batch(method):
    eng, _ = _engines(method)
    with pytest.raises(NotImplementedError, match="data-parallel"):
        eng.check_prepaired()


@pytest.mark.parametrize("method,spectrogram", [
    pytest.param("lc-nointrusion", False, id="lc-nointrusion-False-10"),
    pytest.param("saliency-cutmix", False, id="saliency-cutmix-False-10"),
    pytest.param("(closestknn=8)durratiomixup", True, id="(closestknn=8)durratiomixup-True-10"),
    pytest.param("(saloptenv)durratiomixup", False, id="(saloptenv)durratiomixup-False-10"),
])
def test_unported_bases_name_their_queue_item(method, spectrogram):
    """The model-in-the-loop methods build, and refuse a batch split over
    data-parallel ranks, naming ROADMAP queue 1 item 9."""
    eng = AugmentEngine(AugmentConfig(method, B, 1, S, spectrogram=spectrogram, spec_freq=S))
    with pytest.raises(NotImplementedError, match="item 9"):
        eng.check_prepaired()


def test_runner_takes_the_spectrogram_seed_grids(monkeypatch, spec_dict):
    seen = []
    monkeypatch.setattr(runner, "train_model",
                        lambda cfg, ds: seen.append(cfg.seed_data) or {"steps": [1]})
    for dataset, grid in ((SPEC, 1), ("PhysioNet", 0)):
        seen.clear()
        runner.run_grid(TrainConfig(dataset=dataset, device="cpu", experiments_root="absent"),
                        spec_dict, ["base"], [0.6], [1], robust=False, progress=False)
        assert seen == list(SEED_DATA_GRIDS[0.6][grid])


NARROW = (4, 8, 16, 32)


def test_train_model_pcgmix_tracks_reference(monkeypatch):
    """Both loops train a 2-D ResNet9 of widths 4/8/16/32: the registry's
    is full width, whose fp32 convolutions the two packages sum in other
    orders, so that at lr 0.01 even ``base`` drifts apart chaotically
    within three steps, as full-width 1-D training does.  The port starts
    from the JAX loop's flax init, carried over."""
    from pcgmix_tpu.models.resnet9_2d import ResNet9_2D as JResNet9_2D

    _, variables = _flax_init(model=JResNet9_2D(filters=NARROW, train=False))
    _jax_loop_starts_from(monkeypatch, variables)
    monkeypatch.setattr(jloop, "build_model", lambda name, dataset, num_classes, train,
                        **kw: JResNet9_2D(num_classes, NARROW, train=train))
    monkeypatch.setattr(loop, "build_model",
                        lambda name, num_classes, C, T, **kw: ResNet9_2D(num_classes, NARROW,
                                                                          kw["freq"], T))
    monkeypatch.setattr(loop, "seeded_init",
                        lambda model, seed: _carried(variables, model))
    # 8 recordings × 1 cycle: one batch of 8 per epoch, so each plot
    # epoch's train_loss is one step's loss
    ds = synthetic_spectrogram_dict(num_wavs_train=8, num_wavs_test=4,
                                    segments_per_wav=1, size=S, seed=3)
    common = dict(dataset=SPEC, model="resnet9", method="durratiomixup", num_epochs=7,
                  batch_size=B, save_artifacts=False)
    ref = jtrain(JTrainConfig(**common, loader_parity="torch", n_devices=1), ds)
    got = train_model(TrainConfig(**common, device="cpu"), ds)
    assert got["steps"] == ref["steps"] == list(range(1, 8))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj))[:7].max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


@pytest.mark.parametrize("method", ["cutout(0.25,0.25)", "mixup(same)", "latentmixup"])
def test_train_model_full_width_frozen_tracks_reference(method, monkeypatch, full_width):
    """The registry's full-width 2-D ResNet9 through both loops with its
    weights frozen (lr 0), from the JAX loop's flax init carried over: the
    same batches, plans, 2-D masks, blends and split forwards give steps
    0 and 1 the JAX package's loss within 1e-4 relative, and BatchNorm's
    running statistics the same test predictions.  At this width the two
    packages' fp32 convolutions sum in other orders, and their train-mode
    logits differ by some 1e-5 on equal inputs, which is why the bar is
    not the narrow trace's 1e-5."""
    _, variables = full_width
    _jax_loop_starts_from(monkeypatch, variables)
    monkeypatch.setattr(loop, "seeded_init", lambda model, seed: _carried(variables, model))
    ds = synthetic_spectrogram_dict(num_wavs_train=8, num_wavs_test=4,
                                    segments_per_wav=1, size=S, seed=3)
    common = dict(dataset=SPEC, model="resnet9", method=method, num_epochs=2,
                  batch_size=B, lr_max=0.0, save_artifacts=False)
    ref = jtrain(JTrainConfig(**common, loader_parity="torch", n_devices=1), ds)
    got = train_model(TrainConfig(**common, device="cpu"), ds)
    assert got["steps"] == ref["steps"] == [1, 2]
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-4, atol=0)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def test_data_parallel_group_route_equals_single_device(tmp_path, monkeypatch):
    """Inside a (1-rank gloo) process group the 2-D step splits its batch:
    K3's route with the rank's time windows and the shared band, and
    global BatchNorm2d statistics; it gives the single-device numbers."""
    import torch.distributed as dist

    from pcgmix_tpu_torch.parallel import init_group

    monkeypatch.setattr(loop, "build_model",
                        lambda name, num_classes, C, T, **kw: ResNet9_2D(num_classes, NARROW,
                                                                          kw["freq"], T))
    ds = synthetic_spectrogram_dict(num_wavs_train=8, num_wavs_test=4,
                                    segments_per_wav=1, size=S, seed=3)
    kw = dict(dataset=SPEC, method="durmixcutout(0.25,0.25)", num_epochs=3, batch_size=B,
              save_artifacts=False, device="cpu")
    ref = train_model(TrainConfig(**kw), ds)
    init_group("gloo", 0, 1, str(tmp_path / "store"))
    try:
        got = train_model(TrainConfig(**kw), ds)
    finally:
        dist.destroy_process_group()
    assert abs(got["train_loss"][0] - ref["train_loss"][0]) < 1e-5
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-3)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def test_runner_run_dir_reads_back_through_the_jax_package(tmp_path, capsys):
    ds = synthetic_spectrogram_dict(num_wavs_train=8, num_wavs_test=4,
                                    segments_per_wav=2, size=S, seed=6)
    dat = tmp_path / "spec.dat"
    utils.dict2file(ds, str(dat))
    root = str(tmp_path / "exp")
    args = ["--dataset-file", str(dat), "--dataset", SPEC, "--device", "cpu",
            "--methods", "durratiomixup", "--num-epochs", "1", "--batch-size", "8",
            "--seed-datas", "1100001", "--no-robust", "--experiments-root", root]
    runner.main(args)
    cfg = JTrainConfig(dataset=SPEC, method="durratiomixup", num_epochs=1, batch_size=8,
                       experiments_root=root)
    perf = jresults.read_performance(cfg)
    assert perf["epochs"] == [1] and perf["steps"] == [2]
    assert np.isfinite(perf["train_loss"]).all() and perf["test_wav_preds"]
    capsys.readouterr()
    runner.main(args)
    assert capsys.readouterr().out.startswith("skip (done): ")

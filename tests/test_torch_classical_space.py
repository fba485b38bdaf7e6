"""``TrainConfig.classical_space`` in the port against ``pcgmix_tpu``:
the wide 25-400 band rides as a 5th channel of the train split, the
augmentation mixes all five, the model sees four, and each step's
augmented wide band goes through the classical features into
``classical_space/train_{step}.csv``.

At resnet9-5k, sig_len 512, batch 8 (one step an epoch), torch init and
the torch epoch order on both sides.  Bars:
- the channel stacking and the splits equal;
- ``base``: every CSV equal to the JAX loop's, value for value;
- ``durmixmagwarp(0.2,4)``: the plans bit-equal and the 5-channel
  augmented rows within 1e-6 of the JAX engine's; the CSVs' header and
  meta columns equal to the JAX loop's, and each value equal to the port's
  ``feature_vector_seg`` of its own augmented rows (rounded ratios,
  zero-crossing counts and sample entropy are not continuous, so rows 1e-6
  apart need not give equal features); the loss trace at the transplant
  bar (step 0 within 1e-5, steps 0-6 within 1e-3 relative).  The JAX
  loop's features cost 0.1 s a row (a pandas Series filled key by key), so
  that run computes them for its first two steps, the ones compared, and
  only the meta columns after.
The data-parallel case (rank 0's CSVs against the single-device run's)
rides in ``tests/test_torch_dp_methods.py``'s spawn."""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import pcgmix_tpu.classical as jclassical
from pcgmix_tpu.augment.engine import AugmentConfig as JAugConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.data.datasets import bands_to_channels as jbands_to_channels
from pcgmix_tpu.data.physionet import physionet_split as jphysionet_split
from pcgmix_tpu.data.umc import umc_split as jumc_split
from pcgmix_tpu.train import TrainConfig as JConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu.train.gang import gang_ineligible_reason as jgang_reason
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.classical import feature_vector_seg
from pcgmix_tpu_torch.data import (
    EpochIterator,
    bands_to_channels,
    physionet_split,
    synthetic_physionet_dict,
    synthetic_umc_dict,
    umc_split,
)
from pcgmix_tpu_torch.exp import runner
from pcgmix_tpu_torch.latent import latent_pretrain_config
from pcgmix_tpu_torch.train import TrainConfig, loop, train_model
from pcgmix_tpu_torch.train.gang import gang_ineligible_reason, train_gang

T, BATCH, EPOCHS = 512, 8, 7
PLUS = "durmixmagwarp(0.2,4)"
META = ["class", "wav", "segment", "sig_qual", "split"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset():
    # 8 recordings × 2 segments: one batch of 8 per epoch
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                    sig_len=T, seed=3)


def _common(method, epochs, root):
    return dict(model="resnet9-5k", method=method, num_epochs=epochs, batch_size=BATCH,
                save_artifacts=False, classical_space=True, experiments_root=str(root))


def _csvs(root, n):
    return [os.path.join(root, "classical_space", f"train_{i}.csv") for i in range(n)]


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """The JAX loop's ``base`` (2 steps) and PCGmix+ (7 steps; features for
    the first two) runs and the port's, each into its own experiments root."""
    real = jclassical.feature_vector_seg
    calls = []

    def first_two_steps(data, label, frames, wav, sig_qual, segment, split):
        calls.append(1)
        if len(calls) <= 2 * BATCH:
            return real(data, label, frames, wav, sig_qual, segment, split)
        return pd.Series(dict(zip(META, (label, wav, segment, sig_qual, split))),
                         dtype=object)

    out = {}
    for method, epochs in (("base", 2), (PLUS, EPOCHS)):
        roots = {k: tmp_path_factory.mktemp(k) for k in ("jax", "port")}
        mp = pytest.MonkeyPatch()
        if method == PLUS:
            mp.setattr(jclassical, "feature_vector_seg", first_two_steps)
        try:
            ref = jtrain(JConfig(**_common(method, epochs, roots["jax"]), sig_len=T,
                                 torch_init=True, loader_parity="torch", n_devices=1),
                         dataset)
        finally:
            mp.undo()
        got = train_model(TrainConfig(**_common(method, epochs, roots["port"]), device="cpu"),
                          dataset)
        out[method] = {"ref": ref, "got": got, "roots": roots}
    return out


@pytest.mark.parametrize("num_channels,classical", [(4, False), (4, True), (1, False)])
def test_bands_to_channels_matches_reference(num_channels, classical, dataset):
    got = bands_to_channels(dataset["train"]["data"], num_channels, classical)
    exp = jbands_to_channels(dataset["train"]["data"], num_channels, classical)
    assert got.shape == (16, 5 if classical else num_channels, T)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("num_channels", [1, 2])
def test_classical_space_takes_the_four_band_layout_only(num_channels, dataset):
    for fn in (bands_to_channels, jbands_to_channels):
        with pytest.raises(ValueError, match="num_channels must be 1"):
            fn(dataset["train"]["data"], num_channels, True)


@pytest.mark.parametrize("mode,kw", [("train", {}), ("test", {}),
                                     ("valid", dict(valid=True, seed=2)),
                                     ("train", dict(n_fraction=0.5))])
def test_physionet_split_matches_reference(mode, kw, dataset):
    got = physionet_split(dataset, mode, classical_space=True, **kw)
    exp = jphysionet_split(dataset, mode, classical_space=True, **kw)
    assert got.data.shape[1] == (4 if mode == "test" else 5)
    np.testing.assert_array_equal(got.data, exp.data)
    np.testing.assert_array_equal(got.label, exp.label)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_umc_split_matches_reference(mode):
    d = synthetic_umc_dict(segments_per_patient=2, sig_len=256, seed=4)
    got = umc_split(d, mode, classical_space=True, seed_data=3)
    exp = jumc_split(d, mode, classical_space=True, seed_data=3)
    assert got.data.shape[1] == 5
    np.testing.assert_array_equal(got.data, exp.data)
    np.testing.assert_array_equal(got.ids, exp.ids)


@pytest.mark.parametrize("dataset_name", ["PhysioNet", "UMC"])
def test_eval_split_never_carries_the_wide_band(dataset_name, dataset):
    d = dataset if dataset_name == "PhysioNet" else synthetic_umc_dict(2, 256, seed=4)
    cfg = TrainConfig(dataset=dataset_name, classical_space=True, seed_data=1100001
                      if dataset_name == "PhysioNet" else 3, device="cpu")
    train, test = loop.build_splits(cfg, d)
    assert (train.data.shape[1], test.data.shape[1]) == (5, 4)


def test_base_csvs_equal_the_reference(runs):
    r = runs["base"]
    for ours, theirs in zip(_csvs(r["roots"]["port"], 2), _csvs(r["roots"]["jax"], 2)):
        a, b = pd.read_csv(ours), pd.read_csv(theirs)
        assert a.shape == (BATCH, 5 + 255)
        pd.testing.assert_frame_equal(a, b)
        with open(ours) as f, open(theirs) as g:
            assert f.read() == g.read()
    assert not os.path.exists(_csvs(r["roots"]["port"], 3)[-1])


def _port_batches(dataset, n_steps):
    """(step, batch, 5-channel batch tensor) of the port loop's first steps."""
    split = physionet_split(dataset, "train", classical_space=True)
    step = 0
    while step < n_steps:
        for b in EpochIterator(split, BATCH, 1, step, "torch"):
            yield step, b, torch.from_numpy(split.data[b["indices"]])
            step += 1
            if step >= n_steps:
                return


def test_plans_and_five_channel_rows_match_reference(dataset):
    eng = AugmentEngine(AugmentConfig(PLUS, BATCH, 5, T))
    ref = JEngine(JAugConfig(PLUS, BATCH, 5, T))
    apply = jax.jit(ref.apply)
    for step, b, x in _port_batches(dataset, EPOCHS):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args), ref.plan(*args)
        assert sorted(got.arrays) == sorted(exp.arrays)
        for k, v in exp.arrays.items():
            assert np.asarray(got.arrays[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got.arrays[k], v, err_msg=k)
        target = np.eye(2, dtype=np.float32)[b["label"]]
        rows, _ = eng.apply(x, torch.from_numpy(target),
                            AugmentEngine.device_arrays(got.arrays, "cpu"))
        exp_rows, _ = apply(x.numpy(), target, exp.arrays)
        assert rows.shape == (BATCH, 5, T)
        np.testing.assert_allclose(rows.numpy(), np.asarray(exp_rows), rtol=0, atol=1e-6)


def test_pcgmix_plus_csvs(runs, dataset):
    r = runs[PLUS]
    ours, theirs = _csvs(r["roots"]["port"], EPOCHS), _csvs(r["roots"]["jax"], EPOCHS)
    for i in range(2):  # the JAX run's features: its first two steps
        a, b = pd.read_csv(ours[i]), pd.read_csv(theirs[i])
        assert list(a.columns) == list(b.columns) and len(a.columns) == 5 + 255
        pd.testing.assert_frame_equal(a[META], b[META])
    for i in range(2, EPOCHS):
        pd.testing.assert_frame_equal(pd.read_csv(ours[i])[META], pd.read_csv(theirs[i]))
    # each value: the port's features of the port's own augmented wide band
    eng = AugmentEngine(AugmentConfig(PLUS, BATCH, 5, T))
    for step, b, x in _port_batches(dataset, 3):
        plan = eng.plan(step, b["frames"], b["label"], b["wav"])
        target = torch.eye(2)[torch.from_numpy(b["label"])]
        rows, _ = eng.apply(x, target, AugmentEngine.device_arrays(plan.arrays, "cpu"))
        exp = pd.DataFrame([feature_vector_seg(rows[i, 4].numpy(), int(b["label"][i]),
                                               b["frames"][i], b["wav"][i],
                                               int(b["sig_qual"][i]), i, "train")
                            for i in range(BATCH)])
        got = pd.read_csv(ours[step], float_precision="round_trip")
        np.testing.assert_array_equal(got.select_dtypes("number").to_numpy(float),
                                      exp.select_dtypes("number").to_numpy(float))
        assert (got["wav"] == exp["wav"]).all()


def test_pcgmix_plus_loss_trace_tracks_reference(runs):
    got, ref = runs[PLUS]["got"], runs[PLUS]["ref"]
    assert got["steps"] == ref["steps"] == list(range(1, EPOCHS + 1))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj))[:7].max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def test_model_is_built_for_four_channels(dataset, monkeypatch, tmp_path):
    """The engine takes five channels, the model four; with a run dir the
    CSVs go into it."""
    from pcgmix_tpu_torch.exp.dirs import experiment_dir

    built, planned = [], []
    build, init = loop.build_model, AugmentEngine.__init__
    monkeypatch.setattr(loop, "build_model", lambda name, k, C, n, **kw:
                        built.append(C) or build(name, k, C, n, **kw))
    monkeypatch.setattr(AugmentEngine, "__init__", lambda self, cfg:
                        planned.append(cfg.num_channels) or init(self, cfg))
    cfg = TrainConfig(**{**_common("durratiomixup", 1, tmp_path), "save_artifacts": True},
                      device="cpu")
    train_model(cfg, dataset)
    assert built == [4] and planned == [5]
    assert os.path.exists(os.path.join(experiment_dir(cfg), "classical_space", "train_0.csv"))


def test_latent_method_dumps_the_raw_batch(dataset, tmp_path):
    train_model(TrainConfig(**_common("latentmixup", 2, tmp_path), device="cpu"), dataset)
    for step, b, x in _port_batches(dataset, 2):
        got = pd.read_csv(_csvs(tmp_path, 2)[step], float_precision="round_trip")
        exp = pd.DataFrame([feature_vector_seg(x[i, 4].numpy(), int(b["label"][i]),
                                               b["frames"][i], b["wav"][i],
                                               int(b["sig_qual"][i]), i, "train")
                            for i in range(BATCH)])
        np.testing.assert_array_equal(got.select_dtypes("number").to_numpy(float),
                                      exp.select_dtypes("number").to_numpy(float))


def test_gang_refuses_with_the_reference_reason(dataset):
    cfg = TrainConfig(model="resnet9-5k", classical_space=True, device="cpu")
    reason = gang_ineligible_reason(cfg)
    assert reason == jgang_reason(JConfig(classical_space=True))
    assert reason == "classical_space dumps need host-side batch tensors"
    with pytest.raises(ValueError, match="classical_space dumps need host-side"):
        train_gang([cfg, TrainConfig(model="resnet9-5k", classical_space=True, seed=2,
                                     device="cpu")], dataset)


def test_steps_per_dispatch_runs_one_step_per_dispatch(runs, dataset, tmp_path, monkeypatch):
    def no_chunks(*a, **kw):
        raise AssertionError("classical_space must not take the K-step route")

    monkeypatch.setattr(loop, "MultiStep", no_chunks)
    got = train_model(TrainConfig(**_common("base", 2, tmp_path), device="cpu",
                                  steps_per_dispatch=4), dataset)
    assert got["train_loss"] == runs["base"]["got"]["train_loss"]
    for ours, one in zip(_csvs(tmp_path, 2), _csvs(runs["base"]["roots"]["port"], 2)):
        with open(ours) as f, open(one) as g:
            assert f.read() == g.read()


def test_dependency_runs_drop_classical_space(tmp_path):
    cfg = TrainConfig(model="resnet9-5k", method="(saloptenv)durratiomixup",
                      classical_space=True, experiments_root=str(tmp_path), device="cpu")
    assert not latent_pretrain_config(cfg).classical_space
    dep = runner._salopt_dependency(cfg, robust=False)
    assert dep.method == "base" and not dep.classical_space


def test_runner_trains_classical_space_and_skips_the_rerun(dataset, tmp_path, capsys):
    dat = str(tmp_path / "p.dat")
    utils.dict2file(dataset, dat)
    args = ["--dataset-file", dat, "--methods", PLUS, "--seed-datas", "1100001",
            "--model", "resnet9-5k", "--num-epochs", "1", "--batch-size", "8", "--no-robust",
            "--experiments-root", str(tmp_path / "exp"), "--device", "cpu",
            "--classical-space"]
    assert runner.main(args) == 0
    out = capsys.readouterr().out
    run_dir = next(line.split(": ", 1)[1] for line in out.splitlines()
                   if line.startswith("run: "))
    assert '"classical features"' in out
    assert os.path.exists(os.path.join(run_dir, "classical_space", "train_0.csv"))
    assert runner.main(args) == 0
    assert "skip (done)" in capsys.readouterr().out

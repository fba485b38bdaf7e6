"""The slice end to end: the port's train_model against
pcgmix_tpu.train_model(torch_init=True, loader_parity='torch') on the same
synthetic data, plus the loss, optimizer and metric pieces it is built of.

Bar (the one tests/test_transplant_dynamics.py sets): step-0 loss within
1e-5 absolute, steps 0-6 within 1e-3 relative; the recording-level
predictions identical at every plot epoch."""

import numpy as np
import pytest
import torch
from sklearn.metrics import f1_score, precision_score, recall_score, roc_auc_score

from pcgmix_tpu.train import TrainConfig as JConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu.train.metrics import recording_level_eval as jeval
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.exp.dirs import experiment_already_done, experiment_dir
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train.losses import init_selc_table, selc_update, soft_target_ce
from pcgmix_tpu_torch.train.metrics import recording_level_eval, roc_auc

T, BATCH, EPOCHS = 512, 8, 7


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
    # 8 recordings × 2 segments: one batch of 8 per epoch, so each plot
    # epoch's train_loss is one step's loss
    return synthetic_physionet_dict(
        num_wavs_train=8, num_wavs_test=6, segments_per_wav=2, sig_len=T, seed=3
    )


def _common(method):
    return dict(model="resnet9-5k", method=method, num_epochs=EPOCHS,
                batch_size=BATCH, save_artifacts=False)


@pytest.mark.parametrize("method", ["base", "durratiomixup", "durmixmagwarp(0.2,4)"])
def test_train_model_tracks_reference(method, dataset):
    ref = jtrain(JConfig(**_common(method), sig_len=T, torch_init=True,
                         loader_parity="torch", n_devices=1), dataset)
    got = train_model(TrainConfig(**_common(method), device="cpu"), dataset)
    assert got["steps"] == ref["steps"] == list(range(1, EPOCHS + 1))
    assert sorted(got) == sorted(ref)
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    rel = np.abs(lt - lj) / np.abs(lj)
    assert rel[:7].max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]
    np.testing.assert_allclose(got["lr_per_step"], ref["lr_per_step"], rtol=1e-5)
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=1e-3)


def test_train_model_writes_run_dir(dataset, tmp_path):
    cfg = TrainConfig(**{**_common("durratiomixup"), "num_epochs": 2,
                         "save_artifacts": True},
                      experiments_root=str(tmp_path), device="cpu")
    perf = train_model(cfg, dataset)
    run = experiment_dir(cfg)
    saved = utils.load_dict(f"{run}/performance.pkl")
    assert saved["test_accuracy"] == perf["test_accuracy"]
    assert experiment_already_done(cfg)
    sd = torch.load(f"{run}/model.pth")
    assert "conv1.0.weight" in sd and "linear.weight" in sd


def test_selc_matches_reference_and_updates_table_in_place(rng):
    from pcgmix_tpu.train.losses import selc_update as jselc

    import jax.numpy as jnp

    n, k = 12, 2
    labels = rng.integers(0, k, n)
    logits = rng.normal(size=(5, k)).astype(np.float32)
    target = np.eye(k, dtype=np.float32)[rng.integers(0, k, 5)]
    idx = np.array([3, 0, 7, 11, 5])
    for epoch in (1, 3):
        table = init_selc_table(labels, k)
        loss = selc_update(table, torch.from_numpy(logits), torch.from_numpy(target),
                           torch.from_numpy(idx), epoch, es=2)
        jloss, jtable = jselc(jnp.eye(k)[labels], jnp.asarray(logits),
                              jnp.asarray(target), jnp.asarray(idx), epoch, 2)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(table.numpy(), np.asarray(jtable), atol=1e-7)
    ce = soft_target_ce(torch.from_numpy(logits), torch.from_numpy(target))
    assert torch.isclose(ce, selc_update(init_selc_table(labels, k),
                                         torch.from_numpy(logits),
                                         torch.from_numpy(target),
                                         torch.from_numpy(idx), 1, es=2))


@pytest.mark.parametrize("class_majority", [False, True])
def test_recording_level_eval_matches_sklearn_reference(rng, class_majority):
    n = 60
    wavs = np.array([f"w{i % 13}" for i in range(n)], object)
    labels = np.array([int(w[1:]) % 2 for w in wavs])
    p1 = rng.uniform(size=n)
    probs = np.stack([1 - p1, p1], 1).astype(np.float32)
    got = recording_level_eval(probs, labels, wavs, class_majority)
    ref = jeval(probs, labels, wavs, class_majority)
    assert sorted(got) == sorted(ref)
    assert got["test_wav_preds"] == ref["test_wav_preds"]
    for k in ref:
        if k != "test_wav_preds":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)


def test_metric_primitives_match_sklearn(rng):
    for _ in range(20):
        t = rng.integers(0, 2, 15)
        p = rng.integers(0, 2, 15)
        s = np.round(rng.uniform(size=15), 1)  # ties
        if 0 < t.sum() < len(t):
            assert np.isclose(roc_auc(t, s), roc_auc_score(t, s))
        probs = np.stack([1 - (p + 0.1) / 1.2, (p + 0.1) / 1.2], 1)
        got = recording_level_eval(probs, t, np.arange(15).astype(str))
        assert np.isclose(got["test_f1"], f1_score(t, p, zero_division=0))
        assert np.isclose(got["test_precision"], precision_score(t, p, zero_division=0))
        assert np.isclose(got["test_recall"], recall_score(t, p, zero_division=0))
    assert np.isnan(roc_auc(np.zeros(4, int), np.arange(4.0)))


def test_multiclass_metrics_match_sklearn_reference(rng):
    n = 40
    wavs = np.arange(n).astype(str)
    labels = rng.integers(0, 3, n)
    probs = rng.dirichlet(np.ones(3), n).astype(np.float32)
    got = recording_level_eval(probs, labels, wavs)
    ref = jeval(probs, labels, wavs)
    for k in ("test_accuracy", "test_f1", "test_precision", "test_recall",
              "test_rocauc"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)

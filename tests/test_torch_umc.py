"""UMC and the multi-cycle variant in the PyTorch port against pcgmix_tpu:
``umc_split`` gives the JAX package's rows and arrays for every mode, the
ten train folds and the three inner folds, in 1-D and on a UMC-shaped
spectrogram dict (exclusions and signal quality drawn so both filters
bite); ``same_umc_subset`` and the label swap are bit-equal;
``synthetic_physionet_full_dict`` and ``synthetic_umc_dict`` give the JAX
package's arrays from the same seed; ``train_model`` on the three UMC
datasets trains, and the runner's UMC grid skips finished runs; and the
loss traces of ``(UMC-subset)durratiocutmix`` on UMC and of PCGmix on the
multi-cycle variant track ``pcgmix_tpu.train_model(torch_init=True,
loader_parity="torch")`` at the bar of tests/test_transplant_dynamics.py
(step 0 within 1e-5, steps 0-6 within 1e-3 relative)."""

import numpy as np
import pytest
import torch

from pcgmix_tpu.augment import pairing as jpairing
from pcgmix_tpu.data import synthetic as jsynthetic
from pcgmix_tpu.data import umc as jumc
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch.augment import pairing
from pcgmix_tpu_torch.data import (
    synthetic_physionet_full_dict,
    synthetic_spectrogram_dict,
    synthetic_umc_dict,
    umc,
    umc_split,
)
from pcgmix_tpu_torch.exp import runner
from pcgmix_tpu_torch.train import TrainConfig, train_model

T = 512
FIELDS = ("data", "label", "frames", "wav", "sig_qual", "ids")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _with_filters(d, seed):
    """A UMC dict whose exclusion flags and signal quality vary by row."""
    rng = np.random.default_rng(seed)
    n = len(d["label"])
    return {**d, "excluded": (rng.random(n) < 0.85).astype(np.int64),
            "sig_qual": (rng.random(n) < 0.9).astype(np.int64)}


@pytest.fixture(scope="module")
def umc_1d():
    return _with_filters(synthetic_umc_dict(segments_per_patient=2, sig_len=128, seed=2), 3)


@pytest.fixture(scope="module")
def umc_2d():
    """A UMC-shaped spectrogram dict: the spectrogram rows of 74 recordings
    on the UMC patient ids, two recordings a patient."""
    d = synthetic_spectrogram_dict(num_wavs_train=74, num_wavs_test=0, segments_per_wav=2,
                                   size=32, seed=4)["train"]
    n = len(d["label"])
    d["id"] = np.array([umc.ALL_PATIENTS[(i // 4) % len(umc.ALL_PATIENTS)]
                        for i in range(n)], object)
    return _with_filters(d, 5)


@pytest.mark.parametrize("spectrogram", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("seed_data", list(range(1, 11)))
def test_umc_split_equals_reference(seed_data, spectrogram, umc_1d, umc_2d):
    d = umc_2d if spectrogram else umc_1d
    cases = [("train", False, 1), ("test", False, 1)]
    cases += [(mode, True, seed) for mode in ("train", "valid", "test") for seed in (1, 2, 3)]
    sizes = set()
    for mode, valid, seed in cases:
        kw = dict(num_channels=4, seed_data=seed_data, seed=seed, valid=valid,
                  spectrogram=spectrogram)
        got, ref = umc_split(d, mode, **kw), jumc.umc_split(d, mode, **kw)
        for field in FIELDS:
            g, r = getattr(got, field), getattr(ref, field)
            assert g.dtype == r.dtype, (mode, field)
            np.testing.assert_array_equal(g, r, err_msg=f"{mode} {valid} {seed} {field}")
        sizes.add(len(got))
    assert len(sizes) > 2 and 0 not in sizes


def test_umc_split_refuses_what_the_reference_refuses(umc_1d):
    for kw, match in ((dict(seed_data=11), "1..10"), (dict(valid=True, seed=4), "1..3"),
                      (dict(), "valid=True")):
        mode = "valid" if match == "valid=True" else "train"
        with pytest.raises(ValueError, match=match):
            umc_split(umc_1d, mode, **kw)
        with pytest.raises(ValueError, match=match):
            jumc.umc_split(umc_1d, mode, **kw)


def test_umc_tables_and_label_swap_equal_reference():
    assert umc.HELDOUT_GROUPS == jumc.HELDOUT_GROUPS
    assert umc.ALL_PATIENTS == jumc.ALL_PATIENTS
    labels = np.array([0, 1, 2, 1, 0, 3])
    got = umc.swap_umc_labels(labels)
    np.testing.assert_array_equal(got, jumc.swap_umc_labels(labels))
    np.testing.assert_array_equal(got, [1, 0, 2, 0, 1, 3])


def test_same_umc_subset_equals_reference():
    rng = np.random.default_rng(7)
    for step in range(12):
        n = int(rng.integers(4, 70))
        labels = rng.integers(0, 2, n)
        wavs = [f"{rng.integers(1, 1000):0{rng.integers(2, 4)}d}_{i}" for i in range(n)]
        got = pairing.same_umc_subset(labels, wavs, step)
        ref = jpairing.same_umc_subset(labels, wavs, step)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        assert all(labels[got] == labels)


def _assert_tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_synthetic_dicts_equal_reference():
    kw = dict(num_wavs_train=6, num_wavs_test=3, windows_per_wav=2, sig_len=700, seed=9)
    _assert_tree_equal(synthetic_physionet_full_dict(**kw),
                       jsynthetic.synthetic_physionet_full_dict(**kw))
    kw = dict(segments_per_patient=3, sig_len=300, seed=8)
    _assert_tree_equal(synthetic_umc_dict(**kw), jsynthetic.synthetic_umc_dict(**kw))


@pytest.mark.parametrize("dataset", ["UMC", "UMC(spec128)", "UMC(spec64)"])
def test_train_model_takes_the_umc_datasets(dataset, umc_1d, umc_2d):
    """The three UMC datasets through ``train_model`` (the spectrogram ones
    on the 2-D ResNet9), a method that mixes within the UMC subsets."""
    spec = dataset != "UMC"
    perf = train_model(TrainConfig(
        dataset=dataset, model="resnet9" if spec else "resnet9-5k", batch_size=16,
        num_epochs=1, seed_data=3, method="(UMC-subset)durratiocutmix",
        save_artifacts=False, device="cpu"), umc_2d if spec else umc_1d)
    assert perf["steps"][-1] >= 2
    assert np.isfinite(perf["train_loss"]).all() and np.isfinite(perf["test_loss"]).all()


def test_runner_runs_a_umc_grid_and_skips_it_again(umc_1d, tmp_path, capsys):
    cfg = TrainConfig(dataset="UMC", model="resnet9-5k", batch_size=16, num_epochs=1,
                      experiments_root=str(tmp_path), device="cpu")
    args = (umc_1d, ["base", "(UMC-subset)durratiocutmix"], [1.0], [1])
    with pytest.raises(ValueError, match="--seed-datas"):
        runner.run_grid(cfg, *args, robust=False)
    assert not any(tmp_path.iterdir())  # refused before any run
    first = runner.run_grid(cfg, *args, seed_datas=[1, 10], robust=False)
    assert [(c.method, c.seed_data) for c in first] == [
        ("base", 1), ("base", 10), ("(UMC-subset)durratiocutmix", 1),
        ("(UMC-subset)durratiocutmix", 10)]
    capsys.readouterr()
    assert runner.run_grid(cfg, *args, seed_datas=[1, 10], robust=False) == []
    assert capsys.readouterr().out.count("skip (done): ") == 4


def _tracks_reference(dataset_name, method, dataset):
    """``train_model`` against ``pcgmix_tpu.train_model`` over 7 steps (one
    a plot epoch) at the transplant bar."""
    common = dict(dataset=dataset_name, model="resnet9-5k", method=method, num_epochs=7,
                  batch_size=8, seed_data=1 if dataset_name == "UMC" else 1100001,
                  save_artifacts=False)
    ref = jtrain(JTrainConfig(**common, sig_len=T, torch_init=True, loader_parity="torch",
                              n_devices=1), dataset)
    got = train_model(TrainConfig(**common, device="cpu"), dataset)
    assert got["steps"] == ref["steps"] == list(range(1, 8))
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    assert abs(lt[0] - lj[0]) < 1e-5, (lt, lj)
    assert (np.abs(lt - lj) / np.abs(lj)).max() < 1e-3, (lt, lj)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def test_train_model_umc_subset_durratiocutmix_tracks_reference():
    """Two rows a patient; the exclusion flags keep six patients of train
    fold 1 (12 rows: one batch of 8 an epoch, as in the other loss-trace
    tests) and the fold's four held-out patients."""
    ds = synthetic_umc_dict(segments_per_patient=1, sig_len=T, seed=6)
    held = jumc.HELDOUT_GROUPS[0]
    keep = set(held) | set([p for p in umc.ALL_PATIENTS if p not in held][:6])
    ds["excluded"] = np.array([int(p in keep) for p in ds["id"]], np.int64)
    _tracks_reference("UMC", "(UMC-subset)durratiocutmix", ds)


def test_train_model_multicycle_pcgmix_tracks_reference():
    """PCGmix on −1-padded multi-cycle frames: up to 27 pieces a row, the
    padding slots sanitised to empty pieces."""
    ds = synthetic_physionet_full_dict(num_wavs_train=6, num_wavs_test=6, windows_per_wav=2,
                                       sig_len=T, seed=3)
    assert (ds["train"]["frames"] == -1).any()
    _tracks_reference("PhysioNet", "durratiomixup", ds)

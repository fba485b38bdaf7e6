"""Data contract of the PyTorch port against pcgmix_tpu.data: synthetic
datasets, splits, epoch orders, eval batches and .dat files are equal."""

import numpy as np
import pytest

from pcgmix_tpu import utils as jutils
from pcgmix_tpu.data import EpochIterator as JEpochIterator
from pcgmix_tpu.data import eval_batches as jeval_batches
from pcgmix_tpu.data import physionet_split as jsplit
from pcgmix_tpu.data import synthetic_physionet_dict as jsynthetic
from pcgmix_tpu.data.loader import epoch_permutation as jperm
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.data import (
    EpochIterator,
    epoch_permutation,
    eval_batches,
    physionet_split,
    synthetic_physionet_dict,
)


@pytest.fixture(scope="module")
def dataset():
    return synthetic_physionet_dict(
        num_wavs_train=30, num_wavs_test=8, segments_per_wav=3, sig_len=256, seed=5
    )


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_synthetic_dataset_equals_reference(dataset):
    ref = jsynthetic(
        num_wavs_train=30, num_wavs_test=8, segments_per_wav=3, sig_len=256, seed=5
    )
    _assert_tree_equal(dataset, ref)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(train_balance=False),
    dict(n_fraction=0.5, seed_data=1010001),
    dict(valid=True, seed=3),
    dict(tbal_seed=7, n_fraction=0.3),
])
@pytest.mark.parametrize("mode", ["train", "test", "valid"])
def test_splits_equal_reference(dataset, kw, mode):
    if mode == "valid" and not kw.get("valid"):
        with pytest.raises(ValueError):
            physionet_split(dataset, mode, **kw)
        return
    got = physionet_split(dataset, mode, **kw)
    ref = jsplit(dataset, mode, **kw)
    for field in ("data", "label", "frames", "wav", "sig_qual"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    assert got.data.dtype == ref.data.dtype == np.float32


@pytest.mark.parametrize("parity", ["torch", "numpy"])
def test_epoch_orders_equal_reference(parity):
    for n, seed, step in [(37, 1, 0), (100, 3, 77), (8, 2, 5)]:
        np.testing.assert_array_equal(
            epoch_permutation(n, seed, step, parity), jperm(n, seed, step, parity)
        )


def test_epoch_iterator_and_eval_batches_equal_reference(dataset):
    train = physionet_split(dataset, "train")
    jtrain = jsplit(dataset, "train")
    got = list(EpochIterator(train, 8, 1, 13, "torch"))
    ref = list(JEpochIterator(jtrain, 8, 1, 13, "torch"))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for k in ("label", "frames", "wav", "sig_qual", "indices"):
            np.testing.assert_array_equal(g[k], r[k])
    test = physionet_split(dataset, "test")
    got = list(eval_batches(test, 7))
    ref = list(jeval_batches(jsplit(dataset, "test"), 7, pad_to_batch=False))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for k in ("data", "label", "frames", "wav"):
            np.testing.assert_array_equal(g[k], r[k])


def test_dat_files_cross_load(dataset, tmp_path):
    mine, theirs = tmp_path / "port.dat", tmp_path / "jax.dat"
    utils.dict2file(dataset, str(mine))
    jutils.dict2file(dataset, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    _assert_tree_equal(jutils.file2dict(str(mine)), dataset)
    _assert_tree_equal(utils.file2dict(str(theirs)), dataset)


def test_save_load_dict_roundtrip(tmp_path):
    d = {"a": [1, 2], "b": {"c": 0.5}}
    p = str(tmp_path / "x.pkl")
    utils.save_dict(d, p)
    assert jutils.load_dict(p) == d == utils.load_dict(p)
    assert utils.check_folder(str(tmp_path / "x" / "y")).endswith("y")

"""The device cache (``data/device_cache.py``, counterpart of the JAX
package's): content-addressed hits, distinct content and devices kept
apart, the LRU bound, and ``train_model`` bit-identical with and without
it, the second of two calls served from it."""

import numpy as np
import pytest
import torch

from pcgmix_tpu_torch.data import device_cache, synthetic_physionet_dict
from pcgmix_tpu_torch.train import TrainConfig, train_model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_cache():
    device_cache.clear()
    yield
    device_cache.clear()


def test_equal_content_hits_and_aliases_nothing():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = device_cache.device_tensor(a, "cpu")
    assert torch.equal(t, torch.from_numpy(a))
    a[0, 0] = 99.0  # the entry does not alias the caller's array
    assert t[0, 0] == 0.0
    u = device_cache.device_tensor(np.arange(12, dtype=np.float32).reshape(3, 4), "cpu")
    assert u is t
    assert device_cache.stats() == {"hits": 1, "misses": 1, "entries": 1}


def test_distinct_content_shape_dtype_and_device_miss():
    a = np.zeros((2, 3), np.float32)
    keys = [a, np.zeros((3, 2), np.float32), np.zeros((2, 3), np.float64),
            np.ones((2, 3), np.float32), a[:, :2]]
    tensors = [device_cache.device_tensor(k, "cpu") for k in keys]
    assert len({id(t) for t in tensors}) == len(keys)
    assert tensors[4].shape == (2, 2)  # a non-contiguous view, hashed by content
    assert device_cache._key(a, torch.device("cpu")) != device_cache._key(
        a, torch.device("cuda", 0))
    assert device_cache.stats()["misses"] == len(keys)


def test_lru_bound():
    arrays = [np.full(4, i, np.int64) for i in range(device_cache.MAX_ENTRIES + 3)]
    for a in arrays:
        device_cache.device_tensor(a, "cpu")
    assert device_cache.stats()["entries"] == device_cache.MAX_ENTRIES
    device_cache.device_tensor(arrays[-1], "cpu")  # the newest is kept
    device_cache.device_tensor(arrays[0], "cpu")  # the oldest was dropped
    assert device_cache.stats()["hits"] == 1


def test_train_model_identical_with_and_without_the_cache():
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4, segments_per_wav=2,
                                  sig_len=512, seed=3)
    cfg = dict(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=2,
               batch_size=8, save_artifacts=False, device="cpu")
    first = train_model(TrainConfig(**cfg), ds)
    hits = device_cache.stats()["hits"]
    second = train_model(TrainConfig(**cfg), ds)
    assert device_cache.stats()["hits"] > hits  # the corpus and eval batches
    plain = train_model(TrainConfig(**cfg, device_cache=False), ds)
    for key in first:
        if key != "times":
            assert first[key] == second[key] == plain[key], key

"""A process-level, content-addressed cache of device tensors (counterpart:
``pcgmix_tpu/data/device_cache.py``).

A grid calls ``train_model`` once per member, and each call stages the
same corpus on the device (the training array and the eval batches) even
when members differ only in ``seed``.  The cache hands back the tensor
already on the device for an array of equal content.  Keys hash the
content (blake2b over the bytes, with shape, dtype and device), not object
identities: the split pipeline rebuilds fresh NumPy arrays of equal values
for every member, and an id can be reused after garbage collection.  An
LRU bound caps the device memory held by grid points gone by.

A cached tensor is shared by every caller that asks for equal content, so
it must never be written in place: the train step gathers batches from it
(``index_select`` copies) and the SELC table, which the step updates, is
per run and never cached.
"""

from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np
import torch

MAX_ENTRIES = 16

_lock = threading.Lock()
_cache: collections.OrderedDict = collections.OrderedDict()
_stats = {"hits": 0, "misses": 0}


def _key(a: np.ndarray, device: torch.device) -> tuple:
    h = hashlib.blake2b(digest_size=16)
    h.update(a.data if a.flags["C_CONTIGUOUS"] else a.tobytes())
    return h.digest(), a.shape, str(a.dtype), str(device)


def device_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """``torch.from_numpy(arr).to(device)``, reusing the tensor of an earlier
    call with equal content on the same device.  The result is read-only
    by contract (see the module's docstring)."""
    device = torch.device(device)
    key = _key(arr, device)
    with _lock:
        if key in _cache:
            _cache.move_to_end(key)
            _stats["hits"] += 1
            return _cache[key]
    # a copy on the CPU too: the entry must not alias the caller's array
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)
    with _lock:
        _cache[key] = t
        _stats["misses"] += 1
        while len(_cache) > MAX_ENTRIES:
            _cache.popitem(last=False)  # dropping the reference frees the memory
    return t


def stats() -> dict:
    with _lock:
        return dict(_stats, entries=len(_cache))


def clear() -> None:
    """Drop every cached tensor and reset the counts."""
    with _lock:
        _cache.clear()
        _stats["hits"] = _stats["misses"] = 0

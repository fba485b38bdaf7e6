"""Shared fixtures of the benchmark's tests: the ``cuda`` marker, one torch
thread, and tiny cells that run the harness on the CPU."""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _layers(cin: int, size: int, dims: int, f):
    s0 = size
    s1, s2, s3 = s0 // 2, s0 // 4, s0 // 8
    out = []

    def conv(name, ci, co, s, pool, grad=True):
        out.append({"conv": name + ".0", "bn": name + ".1", "in": ci, "out": co,
                    "kernel": [3] * dims, "padding": 1, "size": [s] * dims, "pool": pool,
                    "input_grad": grad})

    conv("conv1", cin, f[0], s0, 1, False)
    conv("conv2", f[0], f[1], s0, 2)
    conv("res1.0", f[1], f[1], s1, 1)
    conv("res1.1", f[1], f[1], s1, 1)
    conv("conv3", f[1], f[2], s1, 2)
    conv("conv4", f[2], f[3], s2, 2)
    conv("res2.0", f[3], f[3], s3, 1)
    conv("res2.1", f[3], f[3], s3, 1)
    return out, {"name": "linear", "in": f[3] * (s3 // 4) ** dims, "out": 2, "pool": [4] * dims}


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json cut to a CPU test's size: 48 rows,
    batch 8 (96 rows where the check takes 6 steps or more, so that an epoch
    holds them and a shorter chunk follows); the 1-D model at the
    ``resnet9-5k`` widths on 256 steps, the 2-D one (which has only the full
    widths) on 32 × 32 maps."""
    from benchmark import harness

    cell = copy.deepcopy(harness.load_cell(name))
    c, t = cell.config, cell.traffic
    if len(c["input"]) == 2:
        c.update(model="resnet9-5k", filters=[2, 4, 8, 16], input=[4, 256], sample_rate=100)
        c["layers"], c["linear"] = _layers(4, 256, 1, c["filters"])
    else:
        c.update(input=[1, 32, 32], column_ms=50.0)
        c["layers"], c["linear"] = _layers(1, 32, 2, c["filters"])
    t.update(train_wavs=12, segments_per_wav=4 if t["check_steps"] < 6 else 8,
             test_wavs=12, test_segments_per_wav=1,
             batch_size=8, warmup_steps=1, trace_steps=2)
    return cell


CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]

"""Reading a profiled slice: busy intervals, idle gaps by host span, the
per-operation sums; and a CPU profile of a slice with the benchmark's
spans."""

import pytest
import torch

from benchmark import trace


def test_busy_and_gaps():
    tr = trace.Trace(0.0, 100.0, trace._merge([(10, 20), (15, 30), (50, 60)]),
                     {"k": [0.0, 2]}, {}, {},
                     [("plan", 0.0, 12.0), ("step", 25.0, 48.0), ("epoch boundary", 61.0, 99.0)])
    assert tr.busy == [(10, 30), (50, 60)]
    assert tr.busy_s == pytest.approx(30e-6)
    assert tr.wall_s == pytest.approx(100e-6)
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["epoch boundary", "step", "plan"]
    assert [g[1] for g in gaps] == pytest.approx([40e-6, 20e-6, 10e-6])


def test_op_and_kernel_sums():
    tr = trace.Trace(0.0, 1.0, [], {"mix_warp_kernel<float>": [3e-6, 2], "gemm": [5e-6, 4]},
                     {"aten::cudnn_convolution": 4e-3, "aten::convolution_backward": 6e-3,
                      "aten::cudnn_batch_norm": 1e-3, "aten::max_pool2d_with_indices": 2e-3},
                     {"gemm": "aten::cudnn_convolution"}, [])
    assert tr.kernel_events("mix_warp_kernel") == (3e-6, 2)
    assert tr.op_seconds("convolution") == pytest.approx(10e-3)
    assert tr.op_seconds("batch_norm", "max_pool") == pytest.approx(3e-3)
    assert tr.device_ops(1) == [("aten::cudnn_convolution: gemm", 5e-6)]


def test_read_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.slice"):
            with record_function("bench.plan"):
                torch.randn(64).sum()
            with record_function("bench.step"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    tr = trace.read(prof)
    assert tr.busy == [] and tr.wall_s > 0
    assert {s[0] for s in tr.spans} == {"plan", "step"}
    assert tr.idle_gaps()[0][1] == pytest.approx(tr.wall_s)


def test_idle_share_is_the_windows():
    import types

    from benchmark import harness

    # 10 steps of 2 ms busy in a 25-ms slice; the window ran 100 steps in 0.25 s
    tr = trace.Trace(0.0, 25e3, [(0.0, 20e3)], {}, {}, {}, [])
    run = types.SimpleNamespace(trace=tr, trace_steps=10, steps=100, window_s=0.25)
    assert harness.metric_reader("device_idle_share").read(run) == pytest.approx(20.0)
    assert harness.metric_reader("device_idle_share").read(
        types.SimpleNamespace(trace=None, trace_steps=0, steps=100, window_s=0.25)) is None

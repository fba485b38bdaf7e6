"""K5 of the PyTorch port (``ops/conv_bn.py``) against the Pallas kernel it
replaces, ``scripts/bench_conv_bn_fused.py::make_arms``, run in interpret
mode on the CPU; the CPU wrapper takes the plain version.

Bars (measured at B=4, T=96, Cin=Cout=128 between the two: y differs in 5
of 49,152 elements by one bf16 ulp, the statistics by 2.2e-7 relative):
y within one bf16 ulp elementwise and at most 0.1 % of its elements
differing; s2 within rtol 1e-5; s1, which can cancel, within
1e-5·Σ|acc| per column (the bar ``chip_smoke.py`` holds the card to).
The wrapper's refusals and the harness's bounds are held here too."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu_torch.bench import conv_bn_fused as harness
from pcgmix_tpu_torch.ops import conv3_bn_stats, launch_counts, reset_launch_counts
from pcgmix_tpu_torch.ops.conv_bn import (
    conv3_acc_plain,
    conv3_bn_stats_plain,
    conv3_partial_rows,
    pad_channels,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "bench_conv_bn_fused", ROOT / "scripts" / "bench_conv_bn_fused.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(B, T, Cin, Cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Cin)).astype(np.float32)
    w = (rng.standard_normal((3, Cin, Cout)) * 0.05).astype(np.float32)
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_matches(got, ref, x, w):
    y, s1, s2 = got
    y_ref, s1_ref, s2_ref = (_f32(r) for r in ref)
    y = y.float().numpy()
    d = np.abs(y - y_ref)
    ulp = np.maximum(np.abs(y), np.abs(y_ref)) * 2.0 ** -7
    assert (d <= ulp).all(), d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).sum()
    abs_sum = conv3_acc_plain(x, w).abs().sum(dim=(0, 1)).numpy()
    assert (np.abs(s1.numpy() - s1_ref.reshape(-1)) <= 1e-5 * abs_sum).all()
    np.testing.assert_allclose(s2.numpy(), s2_ref.reshape(-1), rtol=1e-5, atol=0)


@pytest.mark.parametrize("arm", ["pallas_fused", "pallas_fused_flat2"])
def test_plain_matches_the_pallas_kernel(script, arm):
    x, w, jx, jw = _inputs(4, 96, 128, 128)
    ref = script.make_arms(4, 96, 128, 128, interpret=True)[arm](jx, jw)
    _assert_matches(conv3_bn_stats(x, w), ref, x, w)


@pytest.mark.parametrize("T", [1, 2])
def test_short_samples_zero_both_boundary_rows(script, T):
    x, w, jx, jw = _inputs(3, T, 8, 16, seed=T)
    ref = script.make_arms(3, T, 8, 16, interpret=True)["pallas_fused"](jx, jw)
    got = conv3_bn_stats(x, w)
    _assert_matches(got, ref, x, w)
    # per sample: only the centre tap sees data when T = 1
    if T == 1:
        centre = (x.float() @ w.float()[1]).bfloat16()
        assert torch.equal(got[0], centre)


def test_without_stats_equals_the_pallas_conv(script):
    x, w, jx, jw = _inputs(2, 24, 16, 24, seed=3)
    y, s1, s2 = conv3_bn_stats(x, w, with_stats=False)
    assert s1 is None and s2 is None
    assert torch.equal(y, conv3_bn_stats(x, w)[0])
    ref = script.make_arms(2, 24, 16, 24, interpret=True)["pallas_conv"](jx, jw)
    d = np.abs(y.float().numpy() - _f32(ref))
    assert (d <= np.abs(_f32(ref)) * 2.0 ** -7 + 1e-30).all()


def test_cpu_wrapper_takes_the_plain_version_and_launches_nothing():
    x, w, _, _ = _inputs(2, 9, 8, 8, seed=4)
    reset_launch_counts()
    got = conv3_bn_stats(x, w)
    ref = conv3_bn_stats_plain(x, w)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert launch_counts()["conv3_bn_stats"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w, _, _ = _inputs(2, 9, 8, 6, seed=5)
    with pytest.raises(TypeError, match="bfloat16"):
        conv3_bn_stats(x.float(), w)
    with pytest.raises(ValueError, match="w must be"):
        conv3_bn_stats(x, w[:2].contiguous())
    with pytest.raises(ValueError, match="w must be"):
        conv3_bn_stats(x, torch.zeros(3, 7, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        conv3_bn_stats(x.transpose(0, 1), w)
    with pytest.raises(ValueError, match="x must be"):
        conv3_bn_stats(x[0], w)
    meta = torch.zeros(2, 9, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3_bn_stats(meta, w.to("meta"))


def test_harness_bounds_and_cpu_check():
    # bounds on an H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s
    assert harness.work(*harness.SHAPES["res2a"]) == (31_406_948_352, 42_471_424)
    assert harness.work(*harness.SHAPES["conv3"]) == (15_728_640_000, 61_638_656)
    ms, by = harness.bound(*harness.SHAPES["res2a"])
    assert by == "operations" and abs(ms - 0.03176) < 1e-5
    ms, by = harness.bound(*harness.SHAPES["conv3"])
    assert by == "bytes" and abs(ms - 0.01840) < 1e-5
    assert harness.main(["--check"]) == 0


def _events(*rows):
    """Stand-ins of torch.profiler's ``key_averages()``: (key, self device
    µs in all, count)."""
    from types import SimpleNamespace

    return [SimpleNamespace(key=k, self_device_time_total=us, count=n) for k, us, n in rows]


K1_NAME = "void (anonymous namespace)::mix_warp_kernel<float, 4, false, false>(...)"


@pytest.mark.parametrize("rows,expected", [
    # a whole trace: the kernel under test alone is summed, not the
    # closure's other kernels, nor the runtime's host-side entries
    ([(K1_NAME, 120.0, 60), ("vectorized_elementwise_kernel<FillFunctor>", 90.0, 60),
      ("cudaLaunchKernel", 0.0, 60)], (2.0, 60)),
    # a short trace (events lost) and a long one are not read
    ([(K1_NAME, 38.0, 15)], (None, 15)),
    ([(K1_NAME, 250.0, 120)], (None, 120)),
    # no kernel event, or events without device time (a 0.000 µs reading)
    ([("cudaLaunchKernel", 0.0, 60)], (None, 0)),
    ([(K1_NAME, 0.0, 60)], (None, 60)),
])
def test_profiler_reading_counts_the_kernels_events(rows, expected):
    times = harness.event_times(_events(*rows), 60)
    us, events = harness.kernel_reading(times, "mix_warp_kernel", 60)
    assert events == expected[1]
    assert us == pytest.approx(expected[0]) if expected[0] is not None else us is None
    text = harness.reading_text(us, events, 60)
    assert text == ("not measured (%d of 60 events)" % events if us is None
                    else "%.3f us" % us)


def test_profiler_reading_sums_every_launch_of_the_kernel():
    """K5 with statistics: two kernels a call, each read on its own."""
    times = harness.event_times(_events(("conv3_kernel<256, true>", 640.0, 10),
                                        ("stats_reduce_kernel", 30.0, 10)), 10)
    assert harness.kernel_reading(times, "conv3_kernel", 10) == (pytest.approx(64.0), 10)
    assert harness.kernel_reading(times, "stats_reduce_kernel", 10) == (pytest.approx(3.0),
                                                                        10)
    assert harness.kernel_reading(times, "mix_warp_kernel", 10) == (None, 0)


@pytest.mark.parametrize("shape", [harness.SMALL_ODD, (3, 1, 44, 70)])
def test_zero_padded_channels_change_nothing(shape):
    # the card's wrapper launches on these copies where TMA cannot describe
    # the tensors (Cin or Cout not a multiple of 8) and slices back
    x, w = harness.inputs(*shape, "cpu")
    xp, wp = pad_channels(x, w)
    assert xp.shape[2] % 8 == 0 and wp.shape[1:] == (xp.shape[2], 72)
    y, s1, s2 = conv3_bn_stats_plain(xp, wp)
    Cout = shape[3]
    ref = conv3_bn_stats_plain(x, w)
    assert torch.equal(y[..., :Cout], ref[0])
    assert torch.equal(s1[:Cout], ref[1]) and torch.equal(s2[:Cout], ref[2])
    assert not y[..., Cout:].any() and not s2[Cout:].any()


@pytest.mark.parametrize("B, T, rows", [
    (64, 312, 160),   # res2a: 5 chunks a sample
    (64, 1250, 640),  # conv3: 20 chunks a sample
    (3, 63, 2),       # 3 chunks: the last block's second chunk is empty
    (5, 312, 13),     # 25 chunks
    (2, 1, 1),        # T < 64: one chunk a sample
    (1, 64, 1),
    (1, 65, 1),
    (3, 65, 3),
])
def test_partial_rows_count_blocks_of_two_chunks(B, T, rows):
    assert conv3_partial_rows(B, T) == rows

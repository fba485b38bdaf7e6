"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (sm_90a) and nvcc; where CUDA is absent they
skip.  They import neither JAX nor tests/conftest.py, so on a machine
without JAX run them as

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import (
    physionet_split,
    synthetic_physionet_dict,
    synthetic_spectrogram_dict,
)
from pcgmix_tpu_torch.models.registry import COMPUTE_DTYPE_FAMILIES
from pcgmix_tpu_torch.ops import mix_kernels
from pcgmix_tpu_torch.ops.mix_kernels import (
    launch_counts,
    pcgmix_plus_fused,
    pcgmix_plus_fused_plain,
    pcgmix_plus_fused_prepaired,
    pcgmix_plus_fused_prepaired_plain,
    piecewise_mix_batch,
    piecewise_mix_batch_plain,
    piecewise_mix_pairs,
    piecewise_mix_pairs_plain,
    piecewise_mix_prepaired,
    piecewise_mix_prepaired_plain,
    reset_launch_counts,
    warm_up_counts,
)

pytestmark = pytest.mark.cuda

B, C, T = 16, 4, 2500


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mix_kernels.build_library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def batch():
    ds = synthetic_physionet_dict(num_wavs_train=12, num_wavs_test=0,
                                  segments_per_wav=2, sig_len=T, seed=2)
    split = physionet_split(ds, "train", train_balance=False)
    assert len(split) >= B
    return split.data[:B], split.frames[:B], split.label[:B]


def _plan(batch, method, dev):
    data, frames, labels = batch
    arrays = AugmentEngine(AugmentConfig(method, B, C, T)).plan(3, frames, labels).arrays
    return torch.from_numpy(data).to(dev), AugmentEngine.device_arrays(arrays, dev)


def _args(a):
    return a["dst"], a["src"], a["len"], a["sel"], a["alpha"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(batch, dev, dtype):
    x, a = _plan(batch, "durratiomixup(rand)", dev)
    x = x.to(dtype)
    idn = torch.arange(B, dtype=torch.int32, device=dev)
    reset_launch_counts()
    got = piecewise_mix_pairs(x, idn, a["mix"], *_args(a))
    torch.cuda.synchronize()
    assert launch_counts()["piecewise_mix_pairs"] == 1
    ref = piecewise_mix_pairs_plain(x, idn, a["mix"], *_args(a))
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= 1e-6


def test_k2_matches_plain(batch, dev):
    x, a = _plan(batch, "durmixmagwarp(0.2,4)", dev)
    got = pcgmix_plus_fused(x, a["mix"], *_args(a), a["knots"])
    ref = pcgmix_plus_fused_plain(x, a["mix"], *_args(a), a["knots"])
    assert (got - ref).abs().max().item() <= 1e-5


def test_k1_concat_pairs_and_many_pieces(dev):
    rng = np.random.default_rng(0)
    N, K = 2 * B, 27
    x = torch.randn(B, C, T, device=dev)
    dst = np.sort(rng.integers(0, T, (N, K)), axis=1)
    ln = np.diff(np.concatenate([dst, np.full((N, 1), T)], 1), axis=1)
    ln[:, ::4] = 0
    src = np.clip(dst + rng.integers(-50, 50, (N, K)), -3, T + 3)
    i32 = lambda v: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
    args = (i32(rng.integers(0, B, N)), i32(rng.integers(0, B, N)), i32(dst),
            i32(src), i32(ln), i32(rng.integers(0, 2, (N, K))),
            torch.from_numpy(rng.uniform(0, 1, (N, K)).astype(np.float32)).to(dev))
    got = piecewise_mix_pairs(x, *args, base_is_d1=False)
    ref = piecewise_mix_pairs_plain(x, *args, base_is_d1=False)
    assert (got - ref).abs().max().item() <= 1e-6


def test_training_on_the_card_launches_the_kernels(dev):
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4,
                                  segments_per_wav=2, sig_len=512, seed=3)
    for method, kernel in (("durratiomixup", "piecewise_mix_pairs"),
                           ("durmixmagwarp(0.2,4)", "pcgmix_plus_fused")):
        reset_launch_counts()
        perf = train_model(TrainConfig(model="resnet9-5k", method=method,
                                       num_epochs=2, batch_size=8,
                                       save_artifacts=False), ds)
        assert launch_counts()[kernel] == perf["steps"][-1]
        assert np.isfinite(perf["train_loss"]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_and_k1(batch, dev, dtype):
    x, a = _plan(batch, "durratiomixup(rand)", dev)
    x = x.to(dtype)
    d2 = x.index_select(0, a["mix"].long())
    reset_launch_counts()
    got = piecewise_mix_prepaired(x, d2, *_args(a))
    torch.cuda.synchronize()
    assert launch_counts()["piecewise_mix_prepaired"] == 1
    ref = piecewise_mix_prepaired_plain(x, d2, *_args(a))
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= 1e-6
    idn = torch.arange(B, dtype=torch.int32, device=dev)
    assert torch.equal(got, piecewise_mix_pairs(x, idn, a["mix"], *_args(a)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain_and_k2(batch, dev, dtype):
    x, a = _plan(batch, "durmixmagwarp(0.2,4)", dev)
    x = x.to(dtype)
    d2 = x.index_select(0, a["mix"].long())
    got = pcgmix_plus_fused_prepaired(x, d2, *_args(a), a["knots"])
    ref = pcgmix_plus_fused_prepaired_plain(x, d2, *_args(a), a["knots"])
    # fp32: 1e-5 (the envelope summed in another order); bf16: one ulp
    tol = 1e-5 if dtype == torch.float32 else torch.maximum(
        got.float().abs(), ref.float().abs()) * 2.0 ** -7
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    assert torch.equal(got, pcgmix_plus_fused(x, a["mix"], *_args(a), a["knots"]))


# K2/K4 at lengths that reach every edge of their tiling: tiles of
# WARP_THREADS·V steps, V = 16 bytes of the dtype where T is a multiple of V
# and the rows are 16-byte aligned, else V = 1 (the scalar edge path)
WARP_LENGTHS = [1, 3, 4, 5, "tile-1", "tile", "tile+1", "tile+V", 2500, 2509]


def _warp_edge_inputs(n, C, T, K2, dtype, tile, dev, k=5):
    """Rows, partners, a plan and knots.  Pieces are disjoint and cover the
    row, one slot is empty; sources run past both ends (clamped): row 0's
    first window starts at −3, row 1's last runs 5 steps past T, and row 2
    is one piece shifted by half a tile plus one, so its window crosses a
    tile boundary."""
    rng = np.random.default_rng(T * 100 + C * 10 + K2)
    dst = np.sort(rng.integers(0, T, (n, k)), axis=1)
    dst[:, 0] = 0
    ln = np.diff(np.concatenate([dst, np.full((n, 1), T)], 1), axis=1)
    ln[:, 2] = 0
    src = dst + rng.integers(-(T // 3) - 6, T // 3 + 7, (n, k))
    src[0, 0] = -3
    src[1, -1] = dst[1, -1] + 5
    dst[2], ln[2], src[2] = 0, 0, 0
    ln[2, 0], src[2, 0] = T, tile // 2 + 1
    i32 = lambda v: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
    f32 = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    x = f32(rng.normal(size=(n, C, T))).to(dtype)
    mix = i32(rng.permutation(n))
    pieces = (i32(dst), i32(src), i32(ln), i32(rng.integers(0, 2, (n, k))),
              f32(rng.uniform(0, 1, (n, k))))
    return x, mix, pieces, f32(rng.normal(1.0, 0.2, (n, K2, C)))


def _within_k2_bar(got, ref):
    """fp32: 1e-5 (the envelope summed in another order); bf16: one ulp."""
    if got.dtype == torch.float32:
        return bool(((got - ref).abs() <= 1e-5).all())
    ulp = torch.maximum(got.float().abs(), ref.float().abs()) * 2.0 ** -7
    return bool(((got.float() - ref.float()).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K2", [3, 6])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("length", WARP_LENGTHS)
def test_k2_k4_match_plain_at_the_tiling_edges(dev, monkeypatch, length, C, K2, dtype):
    vec = 16 // (torch.finfo(dtype).bits // 8)
    tile = mix_kernels.WARP_THREADS * vec
    T = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "tile+V": tile + vec}.get(length, length)
    if T == 1:  # scipy has no spline through knots at one point: a seeded basis
        basis = np.random.default_rng(K2).normal(size=(1, K2))
        monkeypatch.setattr(mix_kernels, "cubic_spline_basis", lambda t, knot: basis)
        monkeypatch.setattr(mix_kernels, "_basis_cache", {})
    n = 5
    x, mix, pieces, knots = _warp_edge_inputs(n, C, T, K2, dtype, tile, dev)
    d2 = x.index_select(0, mix.long())
    reset_launch_counts()
    k2 = pcgmix_plus_fused(x, mix, *pieces, knots)
    k4 = pcgmix_plus_fused_prepaired(x, d2, *pieces, knots)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["pcgmix_plus_fused"] == counts["pcgmix_plus_fused_prepaired"] == 1
    assert k2.dtype == k4.dtype == dtype and k2.shape == (n, C, T)
    assert _within_k2_bar(k2, pcgmix_plus_fused_plain(x, mix, *pieces, knots))
    assert _within_k2_bar(k4, pcgmix_plus_fused_prepaired_plain(x, d2, *pieces, knots))
    assert torch.equal(k4, k2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,K2", [(5, 9), (9, 17)])
def test_k2_k4_match_plain_beyond_one_channel_group_and_basis_chunk(dev, C, K2, dtype):
    """A thread holds 4 channels and 8 basis columns at once: more of either
    take further passes."""
    T = 2 * mix_kernels.WARP_THREADS * 16 // (torch.finfo(dtype).bits // 8)
    x, mix, pieces, knots = _warp_edge_inputs(5, C, T, K2, dtype, T, dev)
    d2 = x.index_select(0, mix.long())
    k2 = pcgmix_plus_fused(x, mix, *pieces, knots)
    assert _within_k2_bar(k2, pcgmix_plus_fused_plain(x, mix, *pieces, knots))
    assert torch.equal(pcgmix_plus_fused_prepaired(x, d2, *pieces, knots), k2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k4_scalar_edge_path_equals_the_vector_path(dev, dtype):
    """An offset view misaligns every row, so the wrapper takes V = 1: the
    same arithmetic per element as the vector path, bit for bit."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    n, C, T = 5, 4, 2 * mix_kernels.WARP_THREADS * vec + 4 * vec
    x, mix, pieces, knots = _warp_edge_inputs(n, C, T, 6, dtype, T, dev)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    buf[1:] = x.flatten()
    shifted = buf[1:].view(n, C, T)
    assert mix_kernels._warp_vector_width(T, dtype, x) == vec
    assert mix_kernels._warp_vector_width(T, dtype, shifted) == 1
    for fn, partner in ((pcgmix_plus_fused, lambda r: mix),
                        (pcgmix_plus_fused_prepaired,
                         lambda r: r.index_select(0, mix.long()).contiguous())):
        assert torch.equal(fn(shifted, partner(shifted), *pieces, knots),
                           fn(x, partner(x), *pieces, knots))


def _warp_length(length, dtype):
    """(T, V, tile) for one of WARP_LENGTHS in ``dtype``."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    tile = mix_kernels.WARP_THREADS * vec
    T = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "tile+V": tile + vec}.get(length, length)
    return T, vec, tile


def _concat_pairs(n, C, T, dtype, tile, dev):
    """Explicit (idx1, idx2) pairs over a batch of n rows with repeated rows
    and twice as many output rows as inputs, and a plan for them."""
    _, _, pieces, _ = _warp_edge_inputs(2 * n, C, T, 2, dtype, tile, dev)
    rng = np.random.default_rng(T + C)
    idx1 = rng.integers(0, n, 2 * n)
    idx1[:2] = 1  # a row used twice as the base
    i32 = lambda v: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
    return i32(idx1), i32(rng.integers(0, n, 2 * n)), pieces


# K1/K3 run on K2/K4's kernel body without the envelope: the same tiling
# edges, with base d1 (keep-duration) and base 0 (the concat family)
@pytest.mark.parametrize("base_is_d1", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 4, 5])
@pytest.mark.parametrize("length", WARP_LENGTHS)
def test_k1_k3_match_plain_at_the_tiling_edges(dev, length, C, dtype, base_is_d1):
    T, _, tile = _warp_length(length, dtype)
    n = 5
    x, mix, pieces, _ = _warp_edge_inputs(n, C, T, 1, dtype, tile, dev)
    d2 = x.index_select(0, mix.long())
    idx1, idx2, pair_pieces = _concat_pairs(n, C, T, dtype, tile, dev)
    kw = {"base_is_d1": base_is_d1}
    reset_launch_counts()
    k1 = piecewise_mix_batch(x, mix, *pieces, **kw)
    k1_pairs = piecewise_mix_pairs(x, idx1, idx2, *pair_pieces, **kw)
    k3 = piecewise_mix_prepaired(x, d2, *pieces, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["piecewise_mix_pairs"] == 2 and counts["piecewise_mix_prepaired"] == 1
    assert k1.dtype == k3.dtype == k1_pairs.dtype == dtype
    assert k1.shape == (n, C, T) and k1_pairs.shape == (2 * n, C, T)
    assert torch.equal(k1, piecewise_mix_batch_plain(x, mix, *pieces, **kw))
    assert torch.equal(k1_pairs,
                       piecewise_mix_pairs_plain(x, idx1, idx2, *pair_pieces, **kw))
    assert torch.equal(k3, piecewise_mix_prepaired_plain(x, d2, *pieces, **kw))
    assert torch.equal(k3, k1)


@pytest.mark.parametrize("base_is_d1", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k3_scalar_edge_path_equals_the_vector_path(dev, dtype, base_is_d1):
    """An offset view misaligns every row, so the wrappers take V = 1: the
    same arithmetic per element as the vector path, bit for bit."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    n, C, T = 5, 4, 2 * mix_kernels.WARP_THREADS * vec + 4 * vec
    x, mix, pieces, _ = _warp_edge_inputs(n, C, T, 1, dtype, T, dev)
    idx1, idx2, pair_pieces = _concat_pairs(n, C, T, dtype, T, dev)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    buf[1:] = x.flatten()
    shifted = buf[1:].view(n, C, T)
    assert mix_kernels._warp_vector_width(T, dtype, x) == vec
    assert mix_kernels._warp_vector_width(T, dtype, shifted) == 1
    kw = {"base_is_d1": base_is_d1}

    def k1_k1_pairs_k3(rows):
        return (piecewise_mix_batch(rows, mix, *pieces, **kw),
                piecewise_mix_pairs(rows, idx1, idx2, *pair_pieces, **kw),
                piecewise_mix_prepaired(rows, rows.index_select(0, mix.long()),
                                        *pieces, **kw))

    assert all(torch.equal(s, v) for s, v in zip(k1_k1_pairs_k3(shifted),
                                                   k1_k1_pairs_k3(x)))


def test_data_parallel_route_launches_k3_and_k4(dev, tmp_path):
    import torch.distributed as dist

    from pcgmix_tpu_torch.parallel import init_group
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4,
                                  segments_per_wav=2, sig_len=512, seed=3)
    init_group("nccl", 0, 1, str(tmp_path / "store"))
    try:
        for method, kernel in (("durratiomixup", "piecewise_mix_prepaired"),
                               ("durmixmagwarp(0.2,4)", "pcgmix_plus_fused_prepaired")):
            reset_launch_counts()
            perf = train_model(TrainConfig(model="resnet9-5k", method=method,
                                           num_epochs=2, batch_size=8,
                                           save_artifacts=False), ds)
            counts = launch_counts()
            assert counts[kernel] == perf["steps"][-1]
            assert counts["piecewise_mix_pairs"] == counts["pcgmix_plus_fused"] == 0
            assert np.isfinite(perf["train_loss"]).all()
    finally:
        dist.destroy_process_group()


def test_k5_matches_plain_at_a_small_odd_shape(dev):
    from pcgmix_tpu_torch.bench.conv_bn_fused import SMALL_ODD, check_against_plain, inputs

    reset_launch_counts()
    errs = check_against_plain(*inputs(*SMALL_ODD, dev))  # raises on a miss
    torch.cuda.synchronize()
    assert launch_counts()["conv3_bn_stats"] == 2  # with and without stats
    assert errs["y_ok"] and errs["stats_ok"] and errs["no_stats_bit_equal"]


# K5 at shapes that reach every edge of its tiling: chunks of 64 rows that
# never cross a sample, two chunks per block, 64 channels per K step, and
# 128 columns per block where Cout ≤ 128, else 256
K5_EDGES = [
    (1, 64, 64, 64),     # one chunk, one channel block per tap
    (2, 1, 64, 64),      # T = 1: only the centre tap sees data
    (3, 63, 64, 128),    # T = 63, 3 chunks: the last block's second chunk is empty
    (2, 64, 128, 64),    # T = 64: a chunk ends where the sample does
    (3, 65, 64, 72),     # T = 65: a chunk of one row; Cout = 72, inside one N tile
    (5, 312, 128, 256),  # res2a's T, 25 chunks (odd); 256 columns per block
    (2, 40, 72, 136),    # Cin = 72: a part-filled channel block; Cout = 136
    (2, 65, 64, 384),    # a second column block of 256, half filled
]


@pytest.mark.parametrize("shape", K5_EDGES + ["small_odd"])
def test_k5_matches_plain_at_the_tiling_edges(dev, shape):
    from pcgmix_tpu_torch.bench.conv_bn_fused import SMALL_ODD, check_against_plain, inputs

    shape = SMALL_ODD if shape == "small_odd" else shape  # padded to 48 → 72 channels
    reset_launch_counts()
    errs = check_against_plain(*inputs(*shape, dev, seed=sum(shape)))
    torch.cuda.synchronize()
    assert launch_counts()["conv3_bn_stats"] == 2  # with and without stats
    assert errs["y_ok"] and errs["stats_ok"] and errs["no_stats_bit_equal"]


# the 1-D baseline bases (plain tensor code) and the pairings on K1: the
# card's apply equals the CPU's
NEW_BASES = [
    "mixup(same)", "mixup(mix)", "timemask(0.2)", "respiratoryscale(12,20)",
    "durmixrespscale(12,20)", "magnitudewarp(0.2,4)", "timewarp(0.05,4)",
    "cutout", "cutout(ch)", "s1s2mask", "(sameCVD)durratiomixup",
    "(samePCG)durratiomixup", "(sameDataset)durratiomixup", "(mixAll)durratiomixup",
]


def _engine_and_plan(batch, method):
    data, frames, labels = batch
    wavs = [f"{'abc'[i % 3]}w{i // 2}" for i in range(B)]
    cvd = {w: "NS"[i % 2] for i, w in enumerate(wavs)}
    eng = AugmentEngine(AugmentConfig(method, B, C, T, cvd_map=cvd))
    return eng, eng.plan(3, frames, labels, wavs).arrays


@pytest.mark.parametrize("method", NEW_BASES)
def test_new_bases_on_the_card_equal_the_cpu(batch, dev, method):
    data, _, labels = batch
    eng, arrays = _engine_and_plan(batch, method)
    x, t = torch.from_numpy(data), torch.from_numpy(np.eye(2, dtype=np.float32)[labels])
    cpu, t_cpu = eng.apply(x, t, arrays)
    card, t_card = eng.apply(x.to(dev), t.to(dev), arrays)
    assert card.device.type == "cuda"
    assert (card.cpu() - cpu).abs().max().item() <= 1e-6
    assert (t_card.cpu() - t_cpu).abs().max().item() <= 1e-6


def test_gaussian_noise_on_the_card(batch, dev):
    data, _, labels = batch
    eng, arrays = _engine_and_plan(batch, "gaussiannoise(25,40)")
    x = torch.from_numpy(data).to(dev)
    t = torch.zeros(B, 2, device=dev)
    out = eng.apply(x, t, arrays)[0]
    assert torch.equal(out, eng.apply(x, t, arrays)[0])  # one seed, one draw
    out, x = out.cpu().numpy(), data
    for i, end in enumerate(arrays["end"]):
        assert not out[i, :, end:].any()
        rms = np.sqrt(np.mean(np.square(x[i], dtype=np.float64)))
        want = rms / 10 ** (arrays["snr"][i] / 20)
        assert abs((out[i, :, :end] - x[i, :, :end]).std() / want - 1) < 0.05


# the spectrogram path: K1/K3 on the (B, F, T) view of (B, 1, F, T) mel
# spectrograms, the frequency rows as channels
SPEC_GEOMETRIES = [(C2, T2) for C2 in (1, 64, 128) for T2 in (64, 128, 127)]


def _spec_batch(n, F, T, method, dev, step=5):
    """A spectrogram batch (n, 1, F, T) on the card and a spectrogram
    engine's plan for it; the frames end within the row (at most 50
    columns), so the pieces cover it only in part."""
    ds = synthetic_spectrogram_dict(num_wavs_train=8, num_wavs_test=0,
                                    segments_per_wav=n // 8, size=T, seed=F + T)
    split = physionet_split(ds, "train", train_balance=False, spectrogram=True)
    eng = AugmentEngine(AugmentConfig(method, n, 1, T, spectrogram=True, spec_freq=F))
    plan = eng.plan(step, split.frames[:n], split.label[:n], _force=True)
    x = np.random.default_rng(F * T).normal(size=(n, 1, F, T)).astype(np.float32)
    return eng, plan, torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T", SPEC_GEOMETRIES)
def test_k1_k3_match_plain_at_spectrogram_geometries(dev, C, T, dtype):
    n = 16
    _, plan, x = _spec_batch(n, C, T, "durratiomixup", dev)
    a = AugmentEngine.device_arrays(plan.arrays, dev)
    assert a["dst"].shape[1] == 4 and (a["dst"] + a["len"]).max().item() < T
    rows = x.reshape(n, C, T).to(dtype)
    d2 = rows.index_select(0, a["mix"].long())
    reset_launch_counts()
    k1 = piecewise_mix_batch(rows, a["mix"], *_args(a))
    k3 = piecewise_mix_prepaired(rows, d2, *_args(a))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["piecewise_mix_pairs"] == counts["piecewise_mix_prepaired"] == 1
    assert torch.equal(k1, piecewise_mix_batch_plain(rows, a["mix"], *_args(a)))
    assert torch.equal(k3, piecewise_mix_prepaired_plain(rows, d2, *_args(a)))
    assert torch.equal(k3, k1)


@pytest.mark.parametrize("method", ["durratiomixup", "durmixcutout(0.25,0.25)",
                                    "durmixfreqmask(0.1)", "cutout(0.25,0.25)",
                                    "latentmixup"])
def test_spectrogram_applies_on_the_card_equal_the_cpu(dev, method):
    """The engine's spectrogram apply at the 2-D table's geometry: K1 and
    the masks on the card equal the plain versions on the CPU, bit for bit."""
    eng, plan, x = _spec_batch(16, 128, 128, method, dev)
    t = torch.eye(2, device=dev)[torch.arange(16, device=dev) % 2]
    reset_launch_counts()
    out, tgt = eng.apply(x, t, plan.arrays)
    torch.cuda.synchronize()
    ref, ref_t = eng.apply(x.cpu(), t.cpu(), plan.arrays)
    assert launch_counts()["piecewise_mix_pairs"] == int(method.startswith("dur"))
    assert torch.equal(out.cpu(), ref) and torch.equal(tgt.cpu(), ref_t)


# the keep-duration cut and the concat family: K1 (base d1 without a row
# index; base 0 with idx1 and idx2), K3 on a rank's block; the (smooth)
# crossfade and the +cutout window in tensor code
CONCAT_METHODS = [
    "durratiocutmix", "(rand)wav-durratiocutmix", "cutmix", "cutmix(ch)", "labelcutmix",
    "(smooth)labelcutmix", "labelcutmix+cutout+1.0", "lengthcutmix(5bins)",
    "datasetcutmix", "wavcutmix", "swapsysdia", "cont-cutmix",
]


@pytest.mark.parametrize("method", CONCAT_METHODS)
def test_cuts_and_concat_joins_on_the_card_equal_the_cpu(batch, dev, method):
    data, _, labels = batch
    eng, arrays = _engine_and_plan(batch, method)
    x, t = torch.from_numpy(data), torch.from_numpy(np.eye(2, dtype=np.float32)[labels])
    cpu, t_cpu = eng.apply(x, t, arrays)
    reset_launch_counts()
    card, t_card = eng.apply(x.to(dev), t.to(dev), arrays)
    torch.cuda.synchronize()
    kernel = "piecewise_mix_prepaired" if "(ch)" in method else "piecewise_mix_pairs"
    assert {k: v for k, v in launch_counts().items() if v} == {kernel: 1}
    assert (card.cpu() - cpu).abs().max().item() <= 1e-6
    assert (t_card.cpu() - t_cpu).abs().max().item() <= 1e-6
    # a rank's block: base rows by idx1 (or its own), partners by idx2 or mix
    sl = slice(B // 2, B)
    block = {k: v[sl] if isinstance(v, np.ndarray) and v.ndim and len(v) == B else v
             for k, v in arrays.items()}
    base = block.get("idx1", np.arange(B)[sl])
    partner = block["idx2" if "idx2" in block else "mix"]
    xd, td = x.to(dev), t.to(dev)
    reset_launch_counts()
    out, out_t = eng.apply_prepaired(xd[base], xd[partner], td[base], td[partner], block)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {"piecewise_mix_prepaired": 1}
    assert (out.cpu() - cpu[sl]).abs().max().item() <= 1e-6
    assert (out_t.cpu() - t_cpu[sl]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_manifold_cutmix_on_a_latent_on_the_card(batch, dev, depth):
    """K1 with a zero base on a ResNet9 latent whose length is under the
    plan's T, bit-equal to the plain version: at depth 2 (T / 8 steps)
    pieces run past its end and clamp their source."""
    data, frames, labels = batch
    eng = AugmentEngine(AugmentConfig("manifold-cutmix", B, C, T))
    arrays = eng.plan(3, frames, labels).arrays
    from pcgmix_tpu_torch.models import build_model

    model = build_model("resnet9-5k", 2, C, T).to(dev).eval()
    with torch.no_grad():
        latent = model(torch.from_numpy(data).to(dev), depth=depth, part="first")
    past = (arrays["dst"] + arrays["len"] > latent.shape[-1]) & (arrays["len"] > 0)
    assert past.any() or depth != 2
    t = torch.eye(2, device=dev)[torch.from_numpy(labels).to(dev)]
    reset_launch_counts()
    out, tgt = eng.apply(latent, t, arrays)
    torch.cuda.synchronize()
    assert launch_counts()["piecewise_mix_pairs"] == 1
    ref, ref_t = eng.apply(latent.cpu(), t.cpu(), arrays)
    assert torch.equal(out.cpu(), ref) and torch.equal(tgt.cpu(), ref_t)


@pytest.mark.parametrize("method", ["cutmix", "(smooth)cutmix", "durratiocutmix"])
def test_spectrogram_cuts_on_the_card_equal_the_cpu(dev, method):
    """2-D cutmix (K1, base 0) and durratiocutmix (K1, base d1) on the
    (B, F, T) view at the 2-D table's geometry, against the CPU."""
    eng, plan, x = _spec_batch(16, 128, 128, method, dev)
    t = torch.eye(2, device=dev)[torch.arange(16, device=dev) % 2]
    reset_launch_counts()
    out, tgt = eng.apply(x, t, plan.arrays)
    torch.cuda.synchronize()
    ref, ref_t = eng.apply(x.cpu(), t.cpu(), plan.arrays)
    assert launch_counts()["piecewise_mix_pairs"] == 1
    assert (out.cpu() - ref).abs().max().item() <= 1e-6
    assert torch.equal(tgt.cpu(), ref_t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["FCN", "ResCNN", "Singstad_d10"])
def test_manifold_cutmix_on_a_zoo_latent_on_the_card(batch, dev, model, dtype):
    """K1 with a zero base on the zoo's full-length latents (FCN at depth 2:
    256 channels × 2500 steps), bit-equal to the plain version."""
    data, frames, labels = batch
    eng = AugmentEngine(AugmentConfig("manifold-cutmix", B, C, T, model=model))
    arrays = eng.plan(3, frames, labels).arrays
    from pcgmix_tpu_torch.models import build_model

    net = build_model(model, 2, C, T).to(dev).eval()
    with torch.no_grad():
        latent = net(torch.from_numpy(data).to(dev), depth=2, part="first").to(dtype)
    assert latent.shape[-1] == T
    t = torch.eye(2, device=dev)[torch.from_numpy(labels).to(dev)]
    reset_launch_counts()
    out, _ = eng.apply(latent, t, arrays)
    torch.cuda.synchronize()
    assert launch_counts()["piecewise_mix_pairs"] == 1
    ref, _ = eng.apply(latent.cpu(), t.cpu(), arrays)
    assert torch.equal(out.cpu(), ref)


ZOO = ["FCN", "FCN(custom)", "ResCNN", "ResNet", "Singstad_d3", "Singstad_d6",
       "Singstad_d10", "InceptionTime", "XceptionTime", "XResNet1d18", "gMLP", "XCM",
       "RNN", "LSTM", "GRU", "mWDN", "OmniScaleCNN"]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_forward_on_the_card_equals_the_cpu(dev, name):
    """A train-mode forward and backward of each zoo architecture on the
    card (cuDNN, TF32 off) against the same on the CPU: logits and the last
    weight's gradient within 1e-4, running statistics within 1e-5."""
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.train.convert import seeded_init

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = 512
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(8, C, t)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 2)).astype(np.float32))
    outs = []
    for device in ("cpu", dev):
        model = seeded_init(build_model(name, 2, C, t), 4).to(device).train()
        logits = model(x.to(device))
        (logits * w.to(device)).sum().backward()
        grad = [p for k, p in model.named_parameters() if k.endswith("weight")][-1].grad
        stats = [b.detach().cpu() for k, b in model.named_buffers() if "running" in k]
        outs.append((logits.detach().cpu(), grad.cpu(), stats))
    (l0, g0, s0), (l1, g1, s1) = outs
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-4)
    for a, b in zip(s1, s0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _live_plan(batch, method):
    """A model-in-the-loop plan on the host, its hooks given: a random
    saliency map's bins, random latents, a random pretrained map."""
    data, frames, labels = batch
    sal = np.random.default_rng(5).random((B, T)).astype(np.float32)
    from pcgmix_tpu_torch.saliency import bin_training_saliency

    eng = AugmentEngine(AugmentConfig(method, B, C, T))
    plan = eng.plan(3, frames, labels, saliency_fn=lambda mix_model: sal,
                    saliency_bins_fn=lambda: bin_training_saliency(sal, frames),
                    latent_fn=lambda: sal[:, ::100])
    return eng, plan.arrays


LIVE_METHODS = ["lc-nointrusion", "lc-nointrusion+cutout+1.0", "saliency-cutmix",
                "(saloptenv)durratiomixup", "(saloptsum-2)durmixmagwarp(0.2,4)",
                "(closestknn=3)durmixmagwarp(0.2,4)", "(closestbins=4)durratiomixup"]


@pytest.mark.parametrize("method", LIVE_METHODS)
def test_model_in_the_loop_applies_on_the_card_equal_the_cpu(batch, dev, method):
    """K1 (lc-nointrusion: 4B output rows; saliency-cutmix: 14 pieces; the
    salopt and closest blends) or K2, once, within 1e-6 of the CPU."""
    data, _, labels = batch
    eng, arrays = _live_plan(batch, method)
    x, t = torch.from_numpy(data), torch.from_numpy(np.eye(2, dtype=np.float32)[labels])
    cpu, t_cpu = eng.apply(x, t, arrays)
    reset_launch_counts()
    card, t_card = eng.apply(x.to(dev), t.to(dev), arrays)
    torch.cuda.synchronize()
    kernel = "pcgmix_plus_fused" if "magwarp" in method else "piecewise_mix_pairs"
    assert {k: v for k, v in launch_counts().items() if v} == {kernel: 1}
    assert card.shape == cpu.shape == ((4 * B, C, T) if "lc-" in method else (B, C, T))
    tol = 1e-5 if "magwarp" in method else 1e-6
    assert (card.cpu() - cpu).abs().max().item() <= tol
    assert (t_card.cpu() - t_cpu).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["lc-nointrusion", "saliency-cutmix"])
def test_k1_live_geometries_match_plain(batch, dev, method, dtype):
    """K1 on lc-nointrusion's 4B candidate rows and saliency-cutmix's 14
    pieces, bit-equal to its plain version."""
    data, _, _ = batch
    _, arrays = _live_plan(batch, method)
    a = AugmentEngine.device_arrays(arrays, dev)
    x = torch.from_numpy(data).to(dev, dtype)
    args = (x, a["idx1"], a["idx2"], *_args(a))
    got = piecewise_mix_pairs(*args, base_is_d1=False)
    ref = piecewise_mix_pairs_plain(*args, base_is_d1=False)
    assert got.shape[0] == len(arrays["idx1"])
    assert torch.equal(got, ref)


def test_saliency_on_the_card_equals_the_cpu(batch, dev):
    """Maps of one set of weights (pretrained n = 101 and live n = 57) with
    float64 gradients, as chip_smoke.py phase 3e holds them (in float32 the
    input gradient is conditioned at a few 1e-4 of the map), and the model
    left as it was: no buffer or flag changed."""
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.saliency import saliency_maps, training_saliency_raw
    from pcgmix_tpu_torch.train.convert import seeded_init

    data, frames, labels = batch
    cpu_model = seeded_init(build_model("resnet9-15k", 2, C, T), 4).double().train()
    card_model = build_model("resnet9-15k", 2, C, T).to(dev, torch.float64).train()
    card_model.load_state_dict(cpu_model.state_dict())
    before = {k: v.clone() for k, v in card_model.state_dict().items()}
    x = torch.from_numpy(data).double()
    t = torch.from_numpy(np.eye(2)[labels])
    for fn in (lambda m, x, t: saliency_maps(m, x, t, frames),
               lambda m, x, t: training_saliency_raw(m, x, t, frames[:, -1]).cpu().numpy()):
        assert np.abs(fn(card_model, x.to(dev), t.to(dev)) - fn(cpu_model, x, t)).max() <= 1e-6
    assert all(m.training for m in card_model.modules())
    for k, v in card_model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("method", ["lc-nointrusion", "saliency-cutmix"])
def test_live_model_training_on_the_card_launches_k1(dev, method):
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4, segments_per_wav=2,
                                  sig_len=512, seed=3)
    reset_launch_counts()
    perf = train_model(TrainConfig(model="resnet9-5k", method=method, num_epochs=3,
                                   batch_size=8, save_artifacts=False), ds)
    assert {k: v for k, v in launch_counts().items() if v} == {"piecewise_mix_pairs": 3}
    assert np.isfinite(perf["train_loss"]).all()


# ---- the runtime extras on the card: CUDA graphs of K steps, serving -----------

GRAPH_METHODS = ["durmixmagwarp(0.2,4)", "durratiomixup", "durmixmagwarp(0.2,4)+0.5",
                 "gaussiannoise", "magnitudewarp(0.2,4)", "timewarp(0.05,4)", "mixup(same)",
                 "cutmix", "SELC-durratiomixup"]


@pytest.mark.parametrize("model", ["resnet9-5k", "Potes"])
@pytest.mark.parametrize("method", GRAPH_METHODS)
def test_graph_chunks_equal_eager_steps_with_frozen_weights(dev, model, method):
    """steps_per_dispatch=4 (a CUDA graph of 4 steps) against one step per
    dispatch with the weights frozen: the same losses within 1e-5 and K1/K2
    once per step, replays counted (identity plans included)."""
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    ds = synthetic_physionet_dict(num_wavs_train=22, num_wavs_test=6, segments_per_wav=4,
                                  sig_len=512, seed=3)
    runs = {}
    for k in (1, 4):
        reset_launch_counts()
        runs[k] = (train_model(TrainConfig(model=model, method=method, num_epochs=4,
                                           batch_size=8, lr_max=0.0, save_artifacts=False,
                                           steps_per_dispatch=k), ds), launch_counts())
    (one, n1), (four, n4) = runs[1], runs[4]
    np.testing.assert_allclose(four["train_loss"], one["train_loss"], rtol=0, atol=1e-5)
    assert four["lr_per_step"] == one["lr_per_step"]
    kernel = {"durmixmagwarp": "pcgmix_plus_fused", "durratiomixup": "piecewise_mix_pairs",
              "cutmix": "piecewise_mix_pairs"}.get(method.split("(")[0].split("-")[-1])
    if kernel:
        assert n4[kernel] == four["steps"][-1] and n4[kernel] >= n1[kernel]


def test_graph_capture_refuses_a_host_draw_without_its_buffer(dev):
    from pcgmix_tpu_torch.models.layers import host_uniform

    graph, gen = torch.cuda.CUDAGraph(), torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="drawn ahead"):
        with torch.cuda.graph(graph):
            host_uniform(gen, (4,), dev)


def _graph_corpus():
    # 10 steps an epoch at batch 8: two chunks of 4 and a partial one of 2
    return synthetic_physionet_dict(num_wavs_train=22, num_wavs_test=6, segments_per_wav=4,
                                    sig_len=512, seed=3)


@pytest.mark.parametrize("model,op", [("resnet9-5k", "adam"), ("Potes", "adam"),
                                      ("resnet9-5k", "SGD")])
def test_graph_chunks_follow_eager_steps_while_training(dev, monkeypatch, model, op):
    """At lr 0.01 under cuDNN's deterministic algorithms, a CUDA graph of 4
    steps trains as one step per dispatch: each replay reads its steps' lr
    and momentum from the staged buffer, and each epoch ends in a partial
    chunk; every epoch's loss within 1e-6 relative, lr_per_step equal."""
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = _graph_corpus()
    one, four = (train_model(TrainConfig(model=model, op=op, method="durmixmagwarp(0.2,4)",
                                         num_epochs=4, batch_size=8, save_artifacts=False,
                                         steps_per_dispatch=k), ds) for k in (1, 4))
    np.testing.assert_allclose(four["train_loss"], one["train_loss"], rtol=1e-6, atol=0)
    assert four["lr_per_step"] == one["lr_per_step"]


def test_resume_under_the_graph_equals_the_uninterrupted_run(dev, monkeypatch, tmp_path):
    """steps_per_dispatch=4 with checkpoint_every=1, crashed after its first
    checkpoint and rerun: the uninterrupted run's losses, a new warm-up and
    capture, and K2 once per resumed step."""
    from pcgmix_tpu_torch.train import TrainConfig, train_model
    from pcgmix_tpu_torch.train.checkpoint import CheckpointManager

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = _graph_corpus()

    def cfg(root):
        return TrainConfig(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=3,
                           batch_size=8, checkpoint_every=1, steps_per_dispatch=4,
                           experiments_root=str(tmp_path / root))

    ref = train_model(cfg("ref"), ds)
    orig = CheckpointManager.save

    def crashing_save(self, *a, **k):
        orig(self, *a, **k)
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(CheckpointManager, "save", crashing_save)
    with pytest.raises(RuntimeError, match="simulated crash"):
        train_model(cfg("run"), ds)
    monkeypatch.setattr(CheckpointManager, "save", orig)
    reset_launch_counts()
    resumed = train_model(cfg("run"), ds)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(resumed[key], ref[key], rtol=0, atol=1e-6)
    assert resumed["lr_per_step"] == ref["lr_per_step"]
    assert launch_counts()["pcgmix_plus_fused"] == 20  # epochs 2 and 3
    assert warm_up_counts()["pcgmix_plus_fused"] == 4


SERVED = ["resnet9", "Potes", *ZOO, "resnet9-2d"]


@pytest.mark.parametrize("name", SERVED)
def test_serving_artifact_on_the_card(dev, tmp_path, name):
    """Every distinct registry architecture (the ResNet9 presets' network,
    Potes, the zoo's 17 and the 2-D ResNet9) exports its batched softmax
    forward on the card, and the artifact's probabilities equal the live
    model's within 1e-5."""
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.serve import Classifier, ExportedClassifier

    if name == "resnet9-2d":
        shape = (1, 128, 128)
        model = build_model("resnet9", 2, 1, 128, dataset="PhysioNet(spec128)", freq=128)
    else:
        shape = (C, T)
        model = build_model(name, 2, C, T)
    x = np.random.default_rng(0).normal(size=(21, *shape)).astype(np.float32)
    live = Classifier(model, batch_size=16)
    live.export_artifact(str(tmp_path / "m.pcgt"), shape, model_name=name)
    exported = ExportedClassifier(str(tmp_path / "m.pcgt"))
    assert exported.header["platforms"] == ["cuda"]
    np.testing.assert_allclose(exported.predict_proba(x), live.predict_proba(x),
                               rtol=0, atol=1e-5)


# ---- gang training on the card: one vmapped program over S members ---------


def _gang(method, model="resnet9-5k", n=3, **kw):
    from pcgmix_tpu_torch.train import TrainConfig

    kw = {"n_fraction": 0.5, **kw}
    return [TrainConfig(model=model, method=method, num_epochs=3, batch_size=8,
                        save_artifacts=False, seed_data=1100001 + s, seed=s + 1, **kw)
            for s in range(n)]


def _gang_corpus():
    return synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=6, segments_per_wav=4,
                                    sig_len=512, seed=1)


@pytest.mark.parametrize("model,method,kernel", [
    (model, method, kernel) for model in ("resnet9-5k", "Potes")
    for method, kernel in (("durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
                           ("durratiomixup", "piecewise_mix_pairs"),
                           ("durmixmagwarp(0.2,4)+0.5", "pcgmix_plus_fused"),
                           ("latentmixup", None))
] + [("resnet9-5k", "manifold-cutmix", "piecewise_mix_pairs")])
def test_gang_members_equal_their_runs_on_the_card(dev, model, method, kernel):
    """Frozen weights: each member within 1e-6 relative of its own
    train_model run on the card; K1/K2 once a gang step (the S·B rows in
    one launch), unequal members (the ragged path) included."""
    from pcgmix_tpu_torch.train import train_model
    from pcgmix_tpu_torch.train.gang import train_gang

    ds = _gang_corpus()
    cfgs = _gang(method, model, lr_max=0.0)
    reset_launch_counts()
    perfs = train_gang(cfgs, ds)
    counts = {k: v for k, v in launch_counts().items() if v}
    for perf, cfg in zip(perfs, cfgs):
        ref = train_model(cfg, ds)
        np.testing.assert_allclose(perf["train_loss"], ref["train_loss"], rtol=1e-6)
        np.testing.assert_allclose(perf["test_loss"], ref["test_loss"], rtol=1e-6)
    if kernel and "+0.5" not in method:
        assert set(counts) == {kernel}
        assert counts[kernel] >= max(p["steps"][-1] for p in perfs)
    elif kernel is None:
        assert counts == {}


def test_gang_graph_equals_the_eager_gang_on_the_card(dev, monkeypatch):
    from pcgmix_tpu_torch.train.gang import train_gang

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = _graph_corpus()
    cfgs = _gang("durmixmagwarp(0.2,4)", "Potes", n=2, n_fraction=1.0)
    runs = {}
    for k in (1, 4):
        reset_launch_counts()
        runs[k] = (train_gang([dataclasses.replace(c, steps_per_dispatch=k) for c in cfgs],
                              ds), launch_counts())
    (one, n1), (four, n4) = runs[1], runs[4]
    for a, b in zip(one, four):
        np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=1e-6, atol=0)
        assert a["lr_per_step"] == b["lr_per_step"]
    assert n1["pcgmix_plus_fused"] == n4["pcgmix_plus_fused"] == one[0]["steps"][-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_over_the_row_limit_match_plain(dev, dtype):
    """70,000 output rows: K1 (without and with a row index), K3 and K4
    launch once per chunk of at most 65,535 rows and equal their plain
    versions; K2, whose partners address the whole batch, raises naming
    the limit."""
    n, c, t, k = 70_000, 1, 64, 3
    g = torch.Generator().manual_seed(5)
    x = torch.randn(n, c, t, generator=g).to(dev, dtype)
    mix = torch.randint(0, n, (n,), generator=g, dtype=torch.int32).to(dev)
    dst = torch.randint(0, t, (n, k), generator=g, dtype=torch.int32)
    length = torch.minimum(torch.randint(0, t, (n, k), generator=g, dtype=torch.int32),
                           t - dst)
    src = torch.randint(0, t, (n, k), generator=g, dtype=torch.int32)
    sel = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int32)
    alpha = torch.rand(n, k, generator=g)
    pieces = [a.to(dev) for a in (dst, src, length, sel, alpha)]
    knots = (1 + 0.1 * torch.randn(n, 6, c, generator=g)).to(dev)
    d2 = x.index_select(0, mix.long()).contiguous()
    idx1 = torch.arange(n, dtype=torch.int32, device=dev).flip(0).contiguous()
    cases = [
        (lambda: piecewise_mix_batch(x, mix, *pieces),
         lambda: piecewise_mix_batch_plain(x, mix, *pieces), "piecewise_mix_pairs"),
        (lambda: piecewise_mix_pairs(x, idx1, mix, *pieces, base_is_d1=False),
         lambda: piecewise_mix_pairs_plain(x, idx1, mix, *pieces, base_is_d1=False),
         "piecewise_mix_pairs"),
        (lambda: piecewise_mix_prepaired(x, d2, *pieces),
         lambda: piecewise_mix_prepaired_plain(x, d2, *pieces), "piecewise_mix_prepaired"),
        (lambda: pcgmix_plus_fused_prepaired(x, d2, *pieces, knots),
         lambda: pcgmix_plus_fused_prepaired_plain(x, d2, *pieces, knots),
         "pcgmix_plus_fused_prepaired"),
    ]
    for kernel, plain, name in cases:
        reset_launch_counts()
        got = kernel()
        assert launch_counts()[name] == 2
        ref = plain()
        tol = 1e-5 if "plus" in name else 1e-6
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=0, atol=tol)
        else:
            torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7, atol=1e-2)
    with pytest.raises(ValueError, match="65535"):
        pcgmix_plus_fused(x, mix, *pieces, knots)


# ---- the bf16 compute mode on the card (TrainConfig.compute_dtype) ------------

BF16 = dict(compute_dtype="bfloat16")
BF16_SERVED = ["resnet9", "Potes", *COMPUTE_DTYPE_FAMILIES, "resnet9-2d"]
# the bars of the CPU tests (tests/test_torch_bf16*.py): the port's bf16
# logits against the JAX package's, relative to their largest magnitude
BF16_LOGIT_BAR = 3e-2
# a bf16 gang member against its own run, frozen weights, at resnet9-5k's and
# Potes' widths (measured 1.7e-7 on an NVIDIA H100 80GB HBM3; chip_smoke.py
# phase 3h holds the full-width gang at 2e-3, where the vmapped convolutions
# round their bf16 outputs in other places: 5.3e-4)
BF16_GANG_BAR = 1e-6


@pytest.mark.parametrize("model,method,kernel", [
    ("resnet9-5k", "durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
    ("resnet9-5k", "durratiomixup", "piecewise_mix_pairs"),
    ("resnet9-5k", "manifold-cutmix", "piecewise_mix_pairs"),
    ("Potes", "durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
    ("Potes", "durratiomixup", "piecewise_mix_pairs"),
])
def test_bf16_training_on_the_card_launches_the_kernels(dev, model, method, kernel):
    """bf16 training on the card: K1/K2 once a step (manifold-cutmix's K1
    on the bf16 latent), finite losses, float32 parameters."""
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4, segments_per_wav=2,
                                  sig_len=512, seed=3)
    reset_launch_counts()
    perf = train_model(TrainConfig(model=model, method=method, num_epochs=3, batch_size=8,
                                   save_artifacts=False, **BF16), ds)
    assert {k: v for k, v in launch_counts().items() if v} == {kernel: 3}
    assert np.isfinite(perf["train_loss"]).all()


@pytest.mark.parametrize("model", ["resnet9-5k", "Potes"])
@pytest.mark.parametrize("method", ["durmixmagwarp(0.2,4)", "durratiomixup"])
def test_bf16_graph_chunks_equal_eager_steps_with_frozen_weights(dev, model, method):
    """steps_per_dispatch=8 (a CUDA graph of 8 steps, the JAX package's
    production config) against one step per dispatch in bf16, weights
    frozen: the same losses within 1e-5, K1/K2 once per step."""
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    ds = _graph_corpus()
    runs = {}
    for k in (1, 8):
        reset_launch_counts()
        runs[k] = (train_model(TrainConfig(model=model, method=method, num_epochs=3,
                                           batch_size=8, lr_max=0.0, save_artifacts=False,
                                           steps_per_dispatch=k, **BF16), ds),
                   launch_counts())
    (one, n1), (eight, n8) = runs[1], runs[8]
    print(f"bf16 graph {model} {method}: max |diff| "
          f"{np.max(np.abs(np.subtract(eight['train_loss'], one['train_loss']))):.3e}")
    np.testing.assert_allclose(eight["train_loss"], one["train_loss"], rtol=0, atol=1e-5)
    kernel = "pcgmix_plus_fused" if "magwarp" in method else "piecewise_mix_pairs"
    assert n8[kernel] == n1[kernel] == one["steps"][-1]


def test_bf16_latent_k1_k3_equal_plain_on_the_card(batch, dev):
    """K1 with a zero base on a full-width ResNet9's bf16 latent at depth 2
    (16 × 512 × 312) under a manifold-cutmix plan, bit-equal to its plain
    version; K3 on the rows idx1 and idx2 name, bit-equal to K1."""
    from pcgmix_tpu_torch.models import build_model

    data, frames, labels = batch
    arrays = AugmentEngine(AugmentConfig("manifold-cutmix", B, C, T)).plan(
        3, frames, labels).arrays
    a = AugmentEngine.device_arrays(arrays, dev)
    net = build_model("resnet9", 2, C, T, **BF16).to(dev).eval()
    with torch.no_grad():
        latent = net(torch.from_numpy(data).to(dev), depth=2, part="first")
    assert latent.dtype == torch.bfloat16 and latent.shape == (B, 512, 312)
    reset_launch_counts()
    k1 = piecewise_mix_pairs(latent, a["idx1"], a["idx2"], *_args(a), base_is_d1=False)
    d1, d2 = (latent.index_select(0, a[k].long()).contiguous() for k in ("idx1", "idx2"))
    k3 = piecewise_mix_prepaired(d1, d2, *_args(a), base_is_d1=False)
    torch.cuda.synchronize()
    assert launch_counts()["piecewise_mix_pairs"] == launch_counts()[
        "piecewise_mix_prepaired"] == 1
    plain = piecewise_mix_pairs_plain(latent, a["idx1"], a["idx2"], *_args(a),
                                      base_is_d1=False)
    assert torch.equal(k1, plain) and torch.equal(k3, k1)


@pytest.mark.parametrize("name", ["resnet9-5k", "resnet9", "Potes", "InceptionTime", "gMLP"])
def test_bf16_forward_on_the_card_equals_the_cpu(dev, name):
    """A bf16 train-mode forward of one set of weights on the card and on
    the CPU: logits float32 on both, within the CPU tests' bar of their
    largest magnitude."""
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.train.convert import seeded_init

    cpu = seeded_init(build_model(name, 2, C, T, **BF16), 4)
    card = build_model(name, 2, C, T, **BF16)
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, C, T)).astype(np.float32))
    with torch.no_grad():
        ref = cpu.train()(x)
        got = card.train()(x.to(dev)).cpu()
    assert got.dtype == ref.dtype == torch.float32
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"bf16 {name} card against CPU: {rel:.3e} of max |logit|")
    assert rel < BF16_LOGIT_BAR


@pytest.mark.parametrize("model,method", [("resnet9-5k", "durmixmagwarp(0.2,4)"),
                                          ("Potes", "durratiomixup"),
                                          ("resnet9-5k", "manifold-cutmix")])
def test_bf16_gang_members_equal_their_runs_on_the_card(dev, model, method):
    from pcgmix_tpu_torch.train import train_model
    from pcgmix_tpu_torch.train.gang import train_gang

    ds = _gang_corpus()
    cfgs = _gang(method, model, lr_max=0.0, **BF16)
    perfs = train_gang(cfgs, ds)
    worst = 0.0
    for perf, cfg in zip(perfs, cfgs):
        ref = train_model(cfg, ds)
        for key in ("train_loss", "test_loss"):
            a, b = np.asarray(perf[key], np.float64), np.asarray(ref[key], np.float64)
            worst = max(worst, float((np.abs(a - b) / np.abs(b)).max()))
    print(f"bf16 gang {model} {method}: {worst:.3e} relative to the members' runs")
    assert worst < BF16_GANG_BAR


@pytest.mark.parametrize("name", BF16_SERVED)
def test_bf16_serving_artifact_on_the_card(dev, tmp_path, name):
    """Every architecture that honors the bf16 compute dtype exports its
    bf16 forward on the card, and the artifact answers as the live model."""
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.serve import Classifier, ExportedClassifier

    if name == "resnet9-2d":
        shape = (1, 128, 128)
        model = build_model("resnet9", 2, 1, 128, dataset="PhysioNet(spec128)", freq=128,
                            **BF16)
    else:
        shape = (C, T)
        model = build_model(name, 2, C, T, **BF16)
    x = np.random.default_rng(0).normal(size=(21, *shape)).astype(np.float32)
    live = Classifier(model, batch_size=16)
    live.export_artifact(str(tmp_path / "m.pcgt"), shape, model_name=name)
    exported = ExportedClassifier(str(tmp_path / "m.pcgt"))
    d = float(np.abs(exported.predict_proba(x) - live.predict_proba(x)).max())
    print(f"bf16 artifact {name}: {d:.3e} from the live model")
    assert d <= 1e-5

"""Plain versions of the port's mix kernels K1 (piecewise_mix_pairs), K2
(pcgmix_plus_fused), K3 (piecewise_mix_prepaired) and K4
(pcgmix_plus_fused_prepaired) against the JAX package: the Pallas kernels
in interpret mode and the XLA piecewise_mix_batch / magnitude_warp.

Tolerances: 1e-6 absolute for the blend (same fp32 arithmetic, rounding
order may differ by one ulp), 1e-5 absolute once the spline warp is applied
(a 6-term fp32 contraction summed in another order)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.ops import magnitude_warp as jwarp
from pcgmix_tpu.ops import piecewise_mix_batch, piecewise_mix_pairs as jpairs
from pcgmix_tpu.ops.pallas_mix import (
    pcgmix_plus_fused_pallas,
    pcgmix_plus_fused_prepaired_pallas,
    piecewise_mix_batch_pallas,
    piecewise_mix_prepaired_pallas,
)
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.ops import build, magnitude_warp, mix_kernels
from pcgmix_tpu_torch.ops.mix_kernels import (
    launch_counts,
    pcgmix_plus_fused,
    pcgmix_plus_fused_prepaired,
    piecewise_mix_pairs,
    piecewise_mix_prepaired,
)

from .conftest import make_frames

B, C, T = 8, 4, 512
MIX_ATOL = 1e-6
WARP_ATOL = 1e-5


def _engine_plan(rng, method, step=5):
    data = rng.normal(size=(B, C, T)).astype(np.float32)
    frames = make_frames(rng, B, T, min_seg=10, max_seg=60)
    labels = rng.integers(0, 2, B)
    plan = AugmentEngine(AugmentConfig(method, B, C, T)).plan(step, frames, labels)
    return data, plan.arrays


def _k27_engine_plan(rng, method, step=5):
    """An engine plan over 28-entry frames: the multi-cycle variant's 27
    segments (disjoint, in-range pieces, as the Pallas body needs)."""
    data = rng.normal(size=(B, C, T)).astype(np.float32)
    frames = np.zeros((B, 28), np.int64)
    frames[:, 1:] = np.cumsum(rng.integers(4, 18, size=(B, 27)), axis=1)
    labels = rng.integers(0, 2, B)
    plan = AugmentEngine(AugmentConfig(method, B, C, T)).plan(step, frames, labels)
    assert plan.arrays["dst"].shape == (B, 27)
    return data, plan.arrays


def _zero_length_plan(rng, K=7):
    """Disjoint pieces with empty slots, pieces at both ends of the row, and
    source windows that run past T (clamped), mixed selectors and alphas."""
    data = rng.normal(size=(B, C, T)).astype(np.float32)
    dst = np.zeros((B, K), np.int64)
    ln = np.zeros((B, K), np.int64)
    for i in range(B):
        cuts = np.sort(rng.choice(np.arange(1, T), K - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [T]])
        dst[i] = bounds[:-1]
        ln[i] = bounds[1:] - bounds[:-1]
    ln[:, 1::3] = 0
    src = np.clip(dst + rng.integers(-40, 40, (B, K)), -5, T + 5)
    sel = rng.integers(0, 2, (B, K))
    alpha = rng.uniform(0, 1, (B, K)).astype(np.float32)
    mix = rng.permutation(B)
    return data, {"mix": mix, "dst": dst, "src": src, "len": ln, "sel": sel,
                  "alpha": alpha}


def _t(arrays):
    return AugmentEngine.device_arrays({**arrays, "lam": 1.0}, "cpu")


def _pieces(a):
    return a["dst"], a["src"], a["len"], a["sel"], a["alpha"]


def _jargs(data, a):
    return (jnp.asarray(data), jnp.asarray(a["mix"], jnp.int32),
            *(jnp.asarray(a[k], jnp.int32) for k in ("dst", "src", "len", "sel")),
            jnp.asarray(a["alpha"], jnp.float32))


def _k1(data, a, base_is_d1=True):
    t = _t(a)
    idn = torch.arange(data.shape[0], dtype=torch.int32)
    return piecewise_mix_pairs(torch.from_numpy(data), idn, t["mix"], *_pieces(t),
                               base_is_d1=base_is_d1).numpy()


@pytest.mark.parametrize("method", ["durratiomixup", "durratiomixup(rand)"])
def test_k1_plain_matches_pallas_and_xla_on_engine_plans(rng, method):
    data, a = _engine_plan(rng, method)
    got = _k1(data, a)
    pallas = np.asarray(piecewise_mix_batch_pallas(*_jargs(data, a), interpret=True))
    xla = np.asarray(piecewise_mix_batch(*_jargs(data, a)))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=MIX_ATOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=MIX_ATOL)


@pytest.mark.parametrize("base_is_d1", [True, False])
def test_k1_batch_plain_matches_pallas_and_xla(rng, base_is_d1):
    """piecewise_mix_batch, K1 without a row index (the main path's PCGmix),
    against piecewise_mix_batch_pallas and XLA's piecewise_mix_batch."""
    data, a = _engine_plan(rng, "durratiomixup(rand)")
    t = _t(a)
    got = mix_kernels.piecewise_mix_batch(torch.from_numpy(data), t["mix"], *_pieces(t),
                                          base_is_d1=base_is_d1).numpy()
    pallas = np.asarray(piecewise_mix_batch_pallas(*_jargs(data, a), base_is_d1=base_is_d1,
                                                   interpret=True))
    xla = np.asarray(piecewise_mix_batch(*_jargs(data, a), base_is_d1=base_is_d1))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=MIX_ATOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=MIX_ATOL)
    assert np.array_equal(got, _k1(data, a, base_is_d1))


def test_k1_batch_takes_one_partner_per_row(rng):
    data, a = _engine_plan(rng, "durratiomixup")
    t = _t(a)
    with pytest.raises(ValueError, match="one entry per row"):
        mix_kernels.piecewise_mix_batch(torch.from_numpy(data), t["mix"][:-1].contiguous(),
                                        *(p[:-1].contiguous() for p in _pieces(t)))
    with pytest.raises(ValueError, match="int32"):
        mix_kernels.piecewise_mix_batch(torch.from_numpy(data), t["mix"][:-1].contiguous(),
                                        *_pieces(t))


@pytest.mark.parametrize("base_is_d1", [True, False])
def test_k1_plain_matches_xla_on_zero_length_and_boundary_pieces(rng, base_is_d1):
    data, a = _zero_length_plan(rng)
    got = _k1(data, a, base_is_d1)
    xla = np.asarray(piecewise_mix_batch(*_jargs(data, a), base_is_d1=base_is_d1))
    np.testing.assert_allclose(got, xla, rtol=0, atol=MIX_ATOL)


def test_k1_plain_concat_pairs_match_pallas(rng):
    """base_is_d1=False over explicit (idx1, idx2) pairs, the concat family's
    call shape, including an output batch larger than the input."""
    data = rng.normal(size=(B, C, T)).astype(np.float32)
    N = 2 * B
    idx1, idx2 = rng.integers(0, B, N), rng.integers(0, B, N)
    c1 = rng.integers(50, 300, N)
    c2 = rng.integers(50, 300, N)
    dst = np.stack([np.zeros(N, np.int64), c1], 1)
    src = np.stack([np.zeros(N, np.int64), c2], 1)
    ln = np.stack([c1, np.minimum(c1 + 150, T) - c1], 1)
    sel = np.stack([np.zeros(N, np.int64), np.ones(N, np.int64)], 1)
    alpha = np.zeros((N, 2), np.float32)
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32))
    got = piecewise_mix_pairs(
        torch.from_numpy(data), i32(idx1), i32(idx2), i32(dst), i32(src), i32(ln),
        i32(sel), torch.from_numpy(alpha), base_is_d1=False,
    ).numpy()
    ref = np.asarray(jpairs(
        jnp.asarray(data), *(jnp.asarray(x, jnp.int32) for x in (idx1, idx2, dst, src, ln, sel)),
        jnp.asarray(alpha), base_is_d1=False,
    ))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MIX_ATOL)


@pytest.mark.parametrize("method", ["durmixmagwarp(0.2,4)", "(rand)durmixmagwarp(0.3,2)"])
def test_k2_plain_matches_pallas_and_two_stage_xla(rng, method):
    data, a = _engine_plan(rng, method)
    t = _t(a)
    got = pcgmix_plus_fused(torch.from_numpy(data), t["mix"], *_pieces(t),
                            t["knots"]).numpy()
    jargs = _jargs(data, a)
    knots = jnp.asarray(a["knots"])
    pallas = np.asarray(pcgmix_plus_fused_pallas(*jargs, knots, interpret=True))
    xla = np.asarray(jwarp(piecewise_mix_batch(*jargs), knots))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=WARP_ATOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=WARP_ATOL)


def test_k2_plain_zero_length_pieces_match_xla(rng):
    data, a = _zero_length_plan(rng)
    knots = rng.normal(1.0, 0.2, (B, 6, C)).astype(np.float32)
    t = _t({**a, "knots": knots})
    got = pcgmix_plus_fused(torch.from_numpy(data), t["mix"], *_pieces(t),
                            t["knots"]).numpy()
    xla = np.asarray(jwarp(piecewise_mix_batch(*_jargs(data, a)), jnp.asarray(knots)))
    np.testing.assert_allclose(got, xla, rtol=0, atol=WARP_ATOL)


def test_magnitude_warp_matches_reference(rng):
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    knots = rng.normal(1.0, 0.2, (B, 6, C)).astype(np.float32)
    got = magnitude_warp(torch.from_numpy(x), torch.from_numpy(knots)).numpy()
    ref = np.asarray(jwarp(jnp.asarray(x), jnp.asarray(knots)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=WARP_ATOL)


def test_bf16_plain_blends_in_fp32_and_casts_once(rng):
    data, a = _engine_plan(rng, "durmixmagwarp(0.2,4)")
    t = _t(a)
    x16 = torch.from_numpy(data).bfloat16()
    idn = torch.arange(B, dtype=torch.int32)
    k1 = piecewise_mix_pairs(x16, idn, t["mix"], *_pieces(t))
    k2 = pcgmix_plus_fused(x16, t["mix"], *_pieces(t), t["knots"])
    assert k1.dtype == k2.dtype == torch.bfloat16
    x32 = x16.float()
    ref1 = piecewise_mix_pairs(x32, idn, t["mix"], *_pieces(t)).bfloat16()
    ref2 = pcgmix_plus_fused(x32, t["mix"], *_pieces(t), t["knots"]).bfloat16()
    assert torch.equal(k1, ref1) and torch.equal(k2, ref2)


def test_cpu_tensors_take_the_plain_path_without_launching(rng):
    data, a = _engine_plan(rng, "durmixmagwarp(0.2,4)")
    before = launch_counts()
    t = _t(a)
    pcgmix_plus_fused(torch.from_numpy(data), t["mix"], *_pieces(t), t["knots"])
    _k1(data, a)
    assert launch_counts() == before


def test_wrappers_validate_arguments(rng):
    data, a = _engine_plan(rng, "durmixmagwarp(0.2,4)")
    t = _t(a)
    x = torch.from_numpy(data)
    idn = torch.arange(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        piecewise_mix_pairs(x, idn.long(), t["mix"], *_pieces(t))
    with pytest.raises(ValueError, match="contiguous"):
        piecewise_mix_pairs(x.transpose(1, 2).contiguous().transpose(1, 2), idn,
                            t["mix"], *_pieces(t))
    with pytest.raises(TypeError):
        piecewise_mix_pairs(x.double(), idn, t["mix"], *_pieces(t))
    with pytest.raises(ValueError, match="knots"):
        pcgmix_plus_fused(x, t["mix"], *_pieces(t), t["knots"][:, :, :2].contiguous())
    wide = {k: v.repeat(1, 9) if v.dim() == 2 else v for k, v in t.items()
            if k in ("dst", "src", "len", "sel", "alpha")}
    with pytest.raises(ValueError, match="pieces"):
        piecewise_mix_pairs(x, idn, t["mix"], *_pieces({**t, **wide}))


def test_engine_apply_matches_reference_engine(rng):
    """AugmentEngine.apply (port, CPU → plain kernels) against the JAX
    engine's apply on the same plan, batch and targets."""
    for method in ("durratiomixup", "durmixmagwarp(0.2,4)"):
        data = rng.normal(size=(B, C, T)).astype(np.float32)
        frames = make_frames(rng, B, T, min_seg=10, max_seg=60)
        labels = rng.integers(0, 2, B)
        target = np.eye(2, dtype=np.float32)[labels]
        eng = AugmentEngine(AugmentConfig(method, B, C, T))
        ref = JEngine(JConfig(method, B, C, T))
        plan = eng.plan(9, frames, labels)
        out, tgt = eng.apply(torch.from_numpy(data), torch.from_numpy(target),
                             plan.arrays)
        jout, jtgt = ref.apply(jnp.asarray(data), jnp.asarray(target),
                               ref.plan(9, frames, labels).arrays)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=WARP_ATOL)
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))


def test_blend_targets_matches_reference(rng):
    from pcgmix_tpu.augment.engine import _blend_targets as jblend
    from pcgmix_tpu_torch.augment.engine import _blend_targets

    target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    mix = rng.permutation(B)
    for lam in (np.float32(0.3), rng.uniform(size=B).astype(np.float32)):
        got = _blend_targets(torch.from_numpy(target),
                             torch.from_numpy(mix.astype(np.int32)), lam)
        ref = jblend(jnp.asarray(target), mix, lam)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-7)


def test_build_dir_is_ignored_by_git():
    import pathlib

    root = pathlib.Path(mix_kernels.__file__).resolve().parents[2]
    assert mix_kernels.BUILD_DIR.relative_to(root).parts[0] == "build"
    assert "build/" in (root / ".gitignore").read_text().splitlines()


# --------------------------------------------------------------------------- #
# K3 / K4: partner rows gathered beforehand (the data-parallel path)
# --------------------------------------------------------------------------- #


def _jpieces(a):
    return (*(jnp.asarray(a[k], jnp.int32) for k in ("dst", "src", "len", "sel")),
            jnp.asarray(a["alpha"], jnp.float32))


@pytest.mark.parametrize("base_is_d1", [True, False])
@pytest.mark.parametrize("geometry", ["engine", "k27"])
def test_k3_plain_matches_prepaired_pallas(rng, geometry, base_is_d1):
    method = "durratiomixup(rand)"
    data, a = (_engine_plan(rng, method) if geometry == "engine"
               else _k27_engine_plan(rng, method))
    d2 = np.ascontiguousarray(data[a["mix"]])
    t = _t(a)
    got = piecewise_mix_prepaired(torch.from_numpy(data), torch.from_numpy(d2),
                                  *_pieces(t), base_is_d1=base_is_d1).numpy()
    ref = np.asarray(piecewise_mix_prepaired_pallas(
        jnp.asarray(data), jnp.asarray(d2), *_jpieces(a), base_is_d1=base_is_d1,
        interpret=True,
    ))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MIX_ATOL)


@pytest.mark.parametrize("geometry", ["engine", "k27"])
def test_k4_plain_matches_prepaired_pallas(rng, geometry):
    method = "(rand)durmixmagwarp(0.2,4)"
    data, a = (_engine_plan(rng, method) if geometry == "engine"
               else _k27_engine_plan(rng, method))
    d2 = np.ascontiguousarray(data[a["mix"]])
    t = _t(a)
    got = pcgmix_plus_fused_prepaired(torch.from_numpy(data), torch.from_numpy(d2),
                                      *_pieces(t), t["knots"]).numpy()
    ref = np.asarray(pcgmix_plus_fused_prepaired_pallas(
        jnp.asarray(data), jnp.asarray(d2), *_jpieces(a), jnp.asarray(a["knots"]),
        interpret=True,
    ))
    np.testing.assert_allclose(got, ref, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("base_is_d1", [True, False])
def test_k3_on_gathered_partners_equals_k1_bit_for_bit(rng, base_is_d1):
    data, a = _zero_length_plan(rng)
    t = _t(a)
    x = torch.from_numpy(data)
    k3 = piecewise_mix_prepaired(x, x.index_select(0, t["mix"].long()), *_pieces(t),
                                 base_is_d1=base_is_d1)
    assert torch.equal(k3, torch.from_numpy(_k1(data, a, base_is_d1)))


def test_k4_on_gathered_partners_equals_k2_bit_for_bit(rng):
    data, a = _engine_plan(rng, "durmixmagwarp(0.2,4)")
    t = _t(a)
    x = torch.from_numpy(data)
    k4 = pcgmix_plus_fused_prepaired(x, x.index_select(0, t["mix"].long()),
                                     *_pieces(t), t["knots"])
    assert torch.equal(k4, pcgmix_plus_fused(x, t["mix"], *_pieces(t), t["knots"]))


@pytest.mark.parametrize("kernel", ["k2", "k4"])
def test_k2_k4_plain_match_pallas_and_xla_at_an_unaligned_length(rng, kernel):
    """T = 509 is not a multiple of 4: the length at which the card takes
    K2/K4's scalar edge path, held there against these plain versions."""
    T509 = 509
    data = rng.normal(size=(B, C, T509)).astype(np.float32)
    frames = make_frames(rng, B, T509, min_seg=10, max_seg=60)
    labels = rng.integers(0, 2, B)
    a = AugmentEngine(AugmentConfig("durmixmagwarp(0.2,4)", B, C, T509)).plan(
        5, frames, labels).arrays
    t = _t(a)
    x = torch.from_numpy(data)
    knots = jnp.asarray(a["knots"])
    xla = np.asarray(jwarp(piecewise_mix_batch(*_jargs(data, a)), knots))
    if kernel == "k2":
        got = pcgmix_plus_fused(x, t["mix"], *_pieces(t), t["knots"]).numpy()
        pallas = pcgmix_plus_fused_pallas(*_jargs(data, a), knots, interpret=True)
    else:
        d2 = np.ascontiguousarray(data[a["mix"]])
        got = pcgmix_plus_fused_prepaired(x, torch.from_numpy(d2), *_pieces(t),
                                          t["knots"]).numpy()
        pallas = pcgmix_plus_fused_prepaired_pallas(
            jnp.asarray(data), jnp.asarray(d2), *_jpieces(a), knots, interpret=True)
    assert got.shape == (B, C, T509)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=WARP_ATOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("dtype,T,offset,want", [
    (torch.float32, 2500, 0, 4),   # the main path: 16-byte vectors
    (torch.float32, 509, 0, 1),    # T not a multiple of 4
    (torch.float32, 2500, 1, 1),   # an offset view: rows off the 16-byte grid
    (torch.float32, 2500, 4, 4),   # offset by 16 bytes: aligned again
    (torch.bfloat16, 1024, 0, 8),
    (torch.bfloat16, 2500, 0, 1),  # 2500 bf16 steps: rows 8 bytes off the grid
    (torch.bfloat16, 509, 0, 1),   # a bf16 row of odd length
])
def test_warp_vector_width_takes_16_bytes_only_where_rows_are_aligned(
        dtype, T, offset, want):
    buf = torch.zeros(2 * C * T + 8, dtype=dtype)
    rows = buf[offset:offset + 2 * C * T].view(2, C, T)
    out = torch.empty_like(rows)
    assert mix_kernels._warp_vector_width(T, dtype, out, rows) == want


@pytest.mark.parametrize("dtype,T,want", [
    (torch.bfloat16, 312, 1),   # ResNet9's depth-2 latent: a 1024-step tile
    (torch.float32, 312, 1),    # a 512-step tile on 312 steps
    (torch.float32, 128, 1),    # the 2-D path's 128-step rows
    (torch.float32, 512, 4),    # one full tile
    (torch.bfloat16, 1016, 1),  # a multiple of 8, short of one tile
    (torch.bfloat16, 2048, 8),
])
def test_warp_vector_width_takes_16_bytes_only_where_a_row_fills_a_block(dtype, T, want):
    """A block takes one tile of WARP_THREADS·V steps of a row: rows
    shorter than that take V = 1 and more, fuller blocks."""
    rows = torch.zeros(2, C, T, dtype=dtype)
    assert mix_kernels._warp_vector_width(T, dtype, rows) == want


@pytest.mark.parametrize("dtype,T,offset,want", [
    (torch.float32, 2500, 0, 4),   # the main path
    (torch.float32, 2500, 1, 1),   # an offset view
    (torch.bfloat16, 1024, 0, 8),
    (torch.bfloat16, 2500, 0, 1),  # bf16 rows 8 bytes off the grid
])
@pytest.mark.parametrize("wrapper", ["pairs", "batch", "prepaired"])
def test_k1_k3_wrappers_hand_their_entry_points_the_vector_width(
        monkeypatch, wrapper, dtype, T, offset, want):
    """K1/K3 take K2/K4's vector-width rule; the main path's K1
    (piecewise_mix_batch) passes no row index and counts as K1.  The
    launch is intercepted, so this runs without the card."""
    calls = []
    monkeypatch.setattr(mix_kernels, "is_plain", lambda t: False)
    monkeypatch.setattr(mix_kernels, "launch",
                        lambda name, device, *args: calls.append((name, args)))
    n = 2
    buf = torch.zeros(n * C * T + 8, dtype=dtype)
    rows = buf[offset:offset + n * C * T].view(n, C, T)
    idx = torch.zeros(n, dtype=torch.int32)
    pieces = [torch.zeros((n, 1), dtype=torch.int32) for _ in range(4)]
    alpha = torch.zeros((n, 1))
    if wrapper == "pairs":
        mix_kernels.piecewise_mix_pairs(rows, idx, idx, *pieces, alpha)
    elif wrapper == "batch":
        mix_kernels.piecewise_mix_batch(rows, idx, *pieces, alpha)
    else:
        mix_kernels.piecewise_mix_prepaired(rows, rows.clone(), *pieces, alpha)
    (name, args), = calls
    _, n_ptr, n_int = build._ENTRIES[name]
    assert name == ("piecewise_mix_prepaired" if wrapper == "prepaired"
                    else "piecewise_mix_pairs")
    assert len(args) == n_ptr + n_int
    assert args[-2] == want  # vector_width, then the dtype code
    if wrapper != "prepaired":
        assert (args[2] is None) == (wrapper == "batch")  # idx1


def test_mix_kernels_cu_holds_one_kernel_body():
    """K1–K4 are instantiations of one __global__ body."""
    text = (build._CSRC / "mix_kernels.cu").read_text()
    assert text.count("__global__") == 1
    assert re.search(r"__global__ void __launch_bounds__\(kWarpThreads\) mix_warp_kernel\(",
                     text)


@pytest.mark.parametrize("knot", [1, 4, 6, 7])
def test_kernel_basis_is_the_spline_basis_padded_with_zero_columns(knot):
    basis = mix_kernels.warp_basis(T, knot, "cpu")
    padded = mix_kernels.warp_basis(T, knot, "cpu", columns=mix_kernels.WARP_BASIS_CHUNK)
    assert padded.shape == (T, -(-(knot + 2) // 8) * 8)
    assert torch.equal(padded[:, :knot + 2], basis)
    assert not padded[:, knot + 2:].any()


def test_warp_ablations_edit_the_kernel_source_and_need_the_card():
    from pcgmix_tpu_torch.bench import mix_warp_ablation

    src = mix_warp_ablation.sources()  # raises where an edit went stale
    assert set(src) == set(mix_warp_ablation.ABLATIONS)
    kernel = src.pop("kernel")
    assert all(text != kernel for text in src.values())
    assert mix_warp_ablation.main([]) == 2  # no CUDA here: refused, no result


def test_mix_kernel_times_needs_the_card(capsys):
    from pcgmix_tpu_torch.bench import mix_kernel_times

    assert mix_kernel_times.main([]) == 2  # no CUDA here: refused, no result
    assert capsys.readouterr().out == ""


def test_prepaired_wrappers_validate_and_take_the_plain_path(rng):
    data, a = _engine_plan(rng, "durmixmagwarp(0.2,4)")
    t = _t(a)
    x = torch.from_numpy(data)
    before = launch_counts()
    out = piecewise_mix_prepaired(x.bfloat16(), x.bfloat16(), *_pieces(t))
    assert out.dtype == torch.bfloat16 and launch_counts() == before
    with pytest.raises(ValueError, match="share dtype, shape"):
        piecewise_mix_prepaired(x, x[:-1].contiguous(), *_pieces(t))
    with pytest.raises(ValueError, match="share dtype, shape"):
        pcgmix_plus_fused_prepaired(x, x.bfloat16(), *_pieces(t), t["knots"])
    with pytest.raises(ValueError, match="knots"):
        pcgmix_plus_fused_prepaired(x, x, *_pieces(t), t["knots"][:-1].contiguous())
    with pytest.raises(ValueError, match="piece arrays"):
        piecewise_mix_prepaired(x[:-1].contiguous(), x[:-1].contiguous(), *_pieces(t))
    half = {k: t[k][: B // 2].contiguous() for k in ("dst", "src", "len", "sel", "alpha")}
    with pytest.raises(ValueError):
        piecewise_mix_prepaired(x, x, *_pieces(half))


def test_apply_prepaired_equals_apply_on_the_whole_batch(rng):
    """The engine's data-parallel apply on two blocks of a batch, with the
    partners gathered beforehand, equals its single-device apply."""
    for method in ("durratiomixup", "durmixmagwarp(0.2,4)"):
        data = rng.normal(size=(B, C, T)).astype(np.float32)
        frames = make_frames(rng, B, T, min_seg=10, max_seg=60)
        labels = rng.integers(0, 2, B)
        target = torch.from_numpy(np.eye(2, dtype=np.float32)[labels])
        eng = AugmentEngine(AugmentConfig(method, B, C, T))
        arrays = eng.plan(4, frames, labels).arrays
        x = torch.from_numpy(data)
        whole, tgt = eng.apply(x, target, arrays)
        mix = torch.from_numpy(arrays["mix"])
        parts = []
        for sl in (slice(0, B // 2), slice(B // 2, B)):
            block = {k: v[sl] if isinstance(v, np.ndarray) else v
                     for k, v in arrays.items()}
            parts.append(eng.apply_prepaired(
                x[sl], x.index_select(0, mix[sl]), target[sl],
                target.index_select(0, mix[sl]), block,
            ))
        assert torch.equal(torch.cat([p[0] for p in parts]), whole)
        assert torch.equal(torch.cat([p[1] for p in parts]), tgt)

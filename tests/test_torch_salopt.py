"""The (salopt…) displacement search and the latent-distance pairings of the
PyTorch port against pcgmix_tpu: displacements bit-equal to
``pcgmix_tpu.augment.salopt`` on seeded random maps; the port's native
max-envelope scan (g++, built under build/native) equal to its NumPy plain
version; the TSP solvers, ``closest_knn`` and ``closest_bins`` bit-equal,
their total distances within 1e-6; and the engine's plans for every salopt
variant (env/sum × saliency models 0/1/2) and the closestknn/closestbins
pairings bit-equal to the JAX engine's, given the same injected saliency
maps or latents, with their applies within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment import pairing as jpairing
from pcgmix_tpu.augment import salopt as jsalopt
from pcgmix_tpu.augment import tsp as jtsp
from pcgmix_tpu.augment.engine import AugmentConfig as JConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu_torch import native
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine, pairing, salopt, tsp
from pcgmix_tpu_torch.data import EpochIterator, physionet_split, synthetic_physionet_dict

B, C, T = 8, 4, 512
STEPS = 8
EYE = np.eye(2, dtype=np.float32)
SALOPT_METHODS = [
    "(saloptenv)durratiomixup", "(saloptenv-1)durratiomixup",
    "(saloptenv-2)durmixmagwarp(0.2,4)", "(saloptsum)durmixmagwarp(0.2,4)",
    "(saloptsum-1)durratiomixup+0.5", "(saloptsum-2)durratiomixup",
]
CLOSEST_METHODS = [
    "(closestknn=3)durratiomixup", "(closestknn=8)durmixmagwarp(0.2,4)",
    "(closestknn=2)durratiomixup+0.6", "(closestbins=4)durratiomixup",
    "(closestbins=1)durmixmagwarp(0.2,4)", "(closestbins=3)durmixmagwarp(0.2,4)",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def split():
    ds = synthetic_physionet_dict(num_wavs_train=24, num_wavs_test=2,
                                  segments_per_wav=2, sig_len=T, seed=4)
    return physionet_split(ds, "train", train_balance=False)


def _batches(split, n_steps):
    step = 0
    while True:
        for b in EpochIterator(split, B, 1, step, "torch"):
            yield step, b
            step += 1
            if step >= n_steps:
                return


def _assert_arrays_equal(got, ref, where):
    assert sorted(got) == sorted(ref), where
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype, f"{where} {k}: {g.dtype} vs {r.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=f"{where} {k}")


def _map(seed, n=B, t=T):
    """A seeded (n, t) map in [0, 1], as the saliency maps are."""
    x = np.random.default_rng(seed).random((n, t))
    return (x / x.max(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("mode", ["env", "sum"])
@pytest.mark.parametrize("lam", [0.2, 0.75])
def test_displacements_equal_reference(mode, lam, split):
    for step, b in _batches(split, 6):
        frames = b["frames"]
        mix = np.random.default_rng(step).permutation(B)
        sal = _map(100 + step)
        got = salopt.salopt_displacements(sal, frames, mix, lam, mode)
        exp = jsalopt.salopt_displacements(sal, frames, mix, lam, mode)
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
        assert got.any()  # the partners' segments differ in length


@pytest.mark.parametrize("n1,n2", [(120, 40), (40, 120), (75, 74), (10, 60), (33, 33)])
def test_single_searches_equal_reference(n1, n2, rng):
    for _ in range(5):
        s1, s2 = rng.random(n1), rng.random(n2)
        for lam in (0.3, 0.9):
            assert (salopt.optimal_displacement_max_envelope(s1, s2, lam)
                    == jsalopt.optimal_displacement_max_envelope(s1, s2, lam))
            assert (salopt.optimal_displacement_max_sum(s1, s2, lam)
                    == jsalopt.optimal_displacement_max_sum(s1, s2, lam))
    flat = np.full(n1 + 7, 0.5)  # every window ties: the first maximum wins
    assert salopt.optimal_displacement_max_envelope(flat, np.full(7, 0.25), 0.5) == 0


def test_native_scan_equals_its_plain_version(rng):
    lib = native.build_library()
    assert native.BUILD_DIR.name == "native" and native.BUILD_DIR.parent.name == "build"
    assert str(native.BUILD_DIR) in lib._name
    for _ in range(40):
        n1 = int(rng.integers(20, 400))
        n2 = int(rng.integers(1, n1))
        s1, s2 = rng.random(n1), rng.random(n2)
        assert native.opt_disp_env(s1, s2) == native.opt_disp_env_plain(s1, s2)
    # near ties: values on a coarse grid make many windows' totals equal
    for _ in range(20):
        s1 = rng.integers(0, 3, 90) / 2.0
        s2 = rng.integers(0, 3, 30) / 2.0
        assert native.opt_disp_env(s1, s2) == native.opt_disp_env_plain(s1, s2)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17])
def test_tsp_solvers_equal_reference(n, rng):
    pts = rng.random((n, 3))
    dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    path = tsp.solve_tsp_greedy(dist)
    assert path == jtsp.solve_tsp_greedy(dist)
    assert tsp.solve_tsp_local_search(dist, path[:-1]) == jtsp.solve_tsp_local_search(
        dist, path[:-1])


@pytest.mark.parametrize("labels", [
    [0, 1] * 8, [0] * 5 + [1] * 11, [1] + [0] * 15, [0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1],
])
def test_closest_pairings_equal_reference(labels, rng):
    labels = np.array(labels)
    n = len(labels)
    for trial in range(3):
        latent = rng.normal(size=(n, 6)).astype(np.float32)
        for k in (1, 3, 5, n):
            got = pairing.closest_knn(labels, latent, k, trial, n)
            exp = jpairing.closest_knn(labels, latent, k, trial, n)
            np.testing.assert_array_equal(got[0], exp[0])
            assert got[0].dtype == exp[0].dtype
            assert abs(got[1] - exp[1]) <= 1e-6
            assert (labels[got[0]] == labels).all()
        for bins in (1, 2, 4, 7):
            got = pairing.closest_bins(labels, latent, bins, trial)
            exp = jpairing.closest_bins(labels, latent, bins, trial)
            np.testing.assert_array_equal(got[0], exp[0])
            assert abs(got[1] - exp[1]) <= 1e-6


def _check_plans_and_applies(method, split, hooks_for):
    """Plans (and identity plans) over STEPS steps with the same injected
    hooks on both engines, and the applies; returns the steps planned."""
    eng = AugmentEngine(AugmentConfig(method, B, C, T))
    ref = JEngine(JConfig(method, B, C, T))
    japply = jax.jit(ref.apply)
    n_plans = 0
    for step, b in _batches(split, STEPS):
        args = (step, b["frames"], b["label"], b["wav"])
        got, exp = eng.plan(*args, **hooks_for(step)), ref.plan(*args, **hooks_for(step))
        assert (got is None) == (exp is None), step
        got_a, _ = eng.plan_arrays_or_identity(*args, **hooks_for(step))
        exp_a, _ = ref.plan_arrays_or_identity(*args, **hooks_for(step))
        _assert_arrays_equal(got_a, exp_a, f"{method} step {step} (or identity)")
        data = split.data[b["indices"]]
        out, tgt = eng.apply(torch.from_numpy(data), torch.from_numpy(EYE[b["label"]]), got_a)
        jout, jtgt = japply(jnp.asarray(data), jnp.asarray(EYE[b["label"]]), exp_a)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6,
                                   err_msg=f"{method} step {step}")
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0, atol=1e-6)
        if exp is not None:
            n_plans += 1
            _assert_arrays_equal(got.arrays, exp.arrays, f"{method} step {step}")
    for g, r in zip(eng.np_stream.get_state(), ref.np_stream.get_state()):
        np.testing.assert_array_equal(g, r)
    return n_plans


@pytest.mark.parametrize("method", SALOPT_METHODS)
def test_salopt_plans_and_applies_equal_reference(method, split):
    """Both engines search displacements in the same maps; the saliency
    model asked for is the method's (0 for the bare tag, 1 for '-1', 2
    for '-2')."""
    want = 2 if "-2)" in method else 1 if "-1)" in method else 0
    asked = []

    def hooks_for(step):
        def saliency_fn(mix_model):
            asked.append(mix_model)
            return _map(1000 + step)
        return {"saliency_fn": saliency_fn}

    n_plans = _check_plans_and_applies(method, split, hooks_for)
    assert n_plans >= (3 if "+" in method else STEPS)
    assert set(asked) == {want}


@pytest.mark.parametrize("method", CLOSEST_METHODS)
def test_closest_plans_and_applies_equal_reference(method, split):
    def hooks_for(step):
        latent = np.random.default_rng(2000 + step).normal(size=(B, 16)).astype(np.float32)
        return {"latent_fn": lambda: latent}

    n_plans = _check_plans_and_applies(method, split, hooks_for)
    assert n_plans >= (3 if "+" in method else STEPS)


def test_latent_pairing_needs_latents(split):
    eng = AugmentEngine(AugmentConfig("(closestknn=3)durratiomixup", B, C, T))
    _, b = next(_batches(split, 1))
    with pytest.raises(ValueError, match="latent_fn"):
        eng.plan(0, b["frames"], b["label"], b["wav"])


def test_salopt_refuses_multicycle_frames():
    frames = np.full((B, 28), -1, np.int64)
    frames[:, :9] = np.cumsum(np.r_[0, [30, 50, 20, 90] * 2])
    labels = np.array([0, 1] * (B // 2))
    for eng in (AugmentEngine(AugmentConfig("(saloptenv)durratiomixup", B, C, T)),
                JEngine(JConfig("(saloptenv)durratiomixup", B, C, T))):
        with pytest.raises(NotImplementedError, match="single-cycle"):
            eng.plan(3, frames, labels, saliency_fn=lambda mix_model: _map(1))

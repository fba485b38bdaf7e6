"""Input-gradient saliency of the PyTorch port against pcgmix_tpu.saliency:
with the JAX model's weights carried over (``jax_to_torch``), the 1-D maps
of ResNet9 (n = 101, σ = 12), the 2-D maps of a narrow 2-D ResNet9 (n = 11,
σ = 1, frequency rows summed with the channels) and the live training map
(n = 57, σ = 7.54) within 1e-5; the per-segment bins and bin frames
bit-equal given the same map; a saliency pass leaves the model's
parameters, BatchNorm buffers, gradients, training flags and the next
training step unchanged; and the pretrained provider loads ``model.pth``
once and refuses a run dir without one, naming the path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu import saliency as jsaliency
from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.models.resnet9_2d import ResNet9_2D as JResNet9_2D
from pcgmix_tpu_torch import saliency
from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.models import ResNet9_2D, build_model
from pcgmix_tpu_torch.train import TrainConfig
from pcgmix_tpu_torch.train.convert import jax_resnet9_2d_to_torch, jax_to_torch
from pcgmix_tpu_torch.train.steps import make_optimizer

B, C, T = 8, 4, 512
S = 32  # spectrogram side
NARROW = (4, 8, 16, 32)  # the 2-D ResNet9's widths, cut
EYE = np.eye(2, dtype=np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(variables, seed):
    """numpy variables with BatchNorm running statistics moved off their
    init (mean N(0, 0.1), var U(0.5, 1.5)), so eval mode reads them."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def move(path, a):
        name = path[-1].key
        if name == "mean":
            return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return {"params": v["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(move, v["batch_stats"])}


@pytest.fixture(scope="module")
def batch():
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=2, segments_per_wav=2,
                                  sig_len=T, seed=6)
    split = physionet_split(ds, "train", train_balance=False)
    return split.data[:B], EYE[split.label[:B]], split.frames[:B]


@pytest.fixture(scope="module")
def resnet9():
    """JAX resnet9-5k (eval), perturbed variables, and the port's carrier."""
    jmodel = jbuild("resnet9-5k", "PhysioNet", 2, train=False)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(4), jnp.zeros((1, C, T), jnp.float32))
    v = _perturbed(v, 1)
    model = build_model("resnet9-5k", 2, C, T)
    model.load_state_dict(jax_to_torch("resnet9-5k", v["params"], v["batch_stats"]))
    return jmodel, v, model.train()


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_kernels_and_downsampling_equal_reference(rng):
    for n, sigma in ((101, 12.0), (11, 1.0), (57, 7.54)):
        got, exp = saliency.gaussian_kernel(n, sigma), jsaliency.gaussian_kernel(n, sigma)
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    for L in (0, 1, 3, 7, 50, 333):
        x = rng.random(L).astype(np.float32)
        for bins in (1, 4, 8):
            np.testing.assert_array_equal(saliency._interp_downsample(x, bins),
                                          jsaliency._interp_downsample(x, bins))
    assert saliency.SEGMENT_BINS == jsaliency.SEGMENT_BINS
    assert saliency.SALOPT_PRETRAIN_METHODS == jsaliency.SALOPT_PRETRAIN_METHODS


def test_1d_maps_equal_reference(resnet9, batch):
    jmodel, v, model = resnet9
    data, target, frames = batch
    got = saliency.saliency_maps(model, *_torch(data, target), frames)
    exp = jsaliency.saliency_maps(jmodel, v["params"], v["batch_stats"], data, target, frames)
    assert got.shape == (B, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    assert (got[np.arange(T)[None, :] >= frames[:, -1:]] == 0).all()  # tail re-zeroed
    assert np.allclose(got.max(axis=1), 1.0) and got.min() == 0.0


def test_training_map_and_bins_equal_reference(resnet9, batch):
    jmodel, v, model = resnet9
    data, target, frames = batch
    got = saliency.training_saliency_raw(model, *_torch(data, target), frames[:, -1]).numpy()
    exp = np.asarray(jsaliency.training_saliency_raw(
        jmodel, v["params"], v["batch_stats"], data, target, frames[:, -1]))
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    # the bins of one map: bit-equal
    gv, gf = saliency.bin_training_saliency(exp, frames)
    ev, ef = jsaliency.bin_training_saliency(exp, frames)
    assert (gv.dtype, gf.dtype) == (ev.dtype, ef.dtype)
    np.testing.assert_array_equal(gv, ev)
    np.testing.assert_array_equal(gf, ef)
    gv, gf = saliency.training_saliency_bins(model, *_torch(data, target), frames)
    assert gv.shape == (B, 14) and gf.shape == (B, 15)


def test_bins_of_short_segments_equal_reference(rng):
    """Segments shorter than their bin count: ceil(L/bins) overshoots, and
    the bin starts run past the segment's end (raw lengths go negative)."""
    frames = np.array([[0, 3, 10, 11, 19], [0, 40, 41, 80, 83], [0, 1, 2, 3, 4],
                       [0, 20, 90, 100, 300]], np.int64)
    sal = rng.random((4, 320)).astype(np.float32)
    got, exp = saliency.bin_training_saliency(sal, frames), jsaliency.bin_training_saliency(
        sal, frames)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
    assert (np.diff(got[1], axis=1) < 0).any()


def test_2d_maps_equal_reference(rng):
    jmodel = JResNet9_2D(filters=NARROW, train=False)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(4), jnp.zeros((1, 1, S, S), jnp.float32))
    v = _perturbed(v, 2)
    model = ResNet9_2D(2, NARROW, S, S)
    model.load_state_dict(jax_resnet9_2d_to_torch(v["params"], v["batch_stats"]))
    data = rng.normal(size=(B, 1, S, S)).astype(np.float32)
    target = EYE[rng.integers(0, 2, B)]
    frames = np.sort(rng.integers(1, S, (B, 5)), axis=1)
    frames[:, 0] = 0
    got = saliency.saliency_maps(model, *_torch(data, target), frames, dim=2)
    exp = jsaliency.saliency_maps(jmodel, v["params"], v["batch_stats"], data, target,
                                  frames, dim=2)
    assert got.shape == (B, S)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)


def _train_step(model, opt, data, target):
    loss = -(torch.log_softmax(model(data), dim=1) * target).sum(dim=1).mean()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def test_saliency_pass_leaves_the_model_alone(resnet9, batch):
    """Eval mode without side effects: parameters, BatchNorm buffers and
    gradients untouched, every module back in train mode, and the next
    training step the same as without the pass."""
    _, _, carrier = resnet9
    data, target = _torch(*batch[:2])
    frames = batch[2]
    runs = []
    for with_saliency in (False, True):
        model = build_model("resnet9-5k", 2, C, T)
        model.load_state_dict(carrier.state_dict())
        model.train()
        opt, _ = make_optimizer(model, "adam", 0.01, 1e-4, 4, False)
        _train_step(model, opt, data, target)  # Adam state and .grad exist
        before = {k: t.clone() for k, t in model.state_dict().items()}
        grads = [p.grad.clone() for p in model.parameters()]
        if with_saliency:
            saliency.training_saliency_bins(model, data, target, frames)
            saliency.saliency_maps(model, data, target, frames)
            assert all(m.training for m in model.modules())
            for k, t in model.state_dict().items():
                assert torch.equal(t, before[k]), k
            for p, g in zip(model.parameters(), grads):
                assert torch.equal(p.grad, g)
        loss = _train_step(model, opt, data, target)
        runs.append((loss, model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][k]), k


def test_pretrained_provider_loads_model_pth_once(resnet9, batch, tmp_path, monkeypatch):
    _, _, carrier = resnet9
    run_dir = tmp_path / "base_run"
    run_dir.mkdir()
    torch.save(carrier.state_dict(), run_dir / "model.pth")
    loads = []
    load = saliency.load_weights
    monkeypatch.setattr(saliency, "load_weights", lambda p: loads.append(p) or load(p))
    cfg = TrainConfig(model="resnet9-5k", device="cpu")
    asked = []
    provider = saliency.make_pretrained_saliency_fn(
        cfg, lambda method: asked.append(method) or str(run_dir))
    data, target = _torch(*batch[:2])
    want = saliency.saliency_maps(carrier, data, target, batch[2])
    for _ in range(3):
        np.testing.assert_array_equal(provider(0)(data, target, batch[2]), want)
    assert loads == [os.path.join(str(run_dir), "model.pth")] and asked == ["base"]
    provider(2)
    assert asked == ["base", "durmixmagwarp(0.2,4)"]


def test_pretrained_provider_needs_model_pth(tmp_path):
    """A run dir with the JAX package's model.msgpack only counts as done,
    but this package loads model.pth: the provider raises, naming it."""
    (tmp_path / "model.msgpack").write_bytes(b"")
    provider = saliency.make_pretrained_saliency_fn(TrainConfig(device="cpu"),
                                                    lambda method: str(tmp_path))
    with pytest.raises(FileNotFoundError, match="model.pth") as err:
        provider(0)
    assert str(tmp_path / "model.pth") in str(err.value) and "msgpack" in str(err.value)

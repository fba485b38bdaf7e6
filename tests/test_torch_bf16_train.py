"""The bf16 compute mode through training, the mix kernels' bf16-latent
path, gangs, serving and the runner, on the CPU (``TrainConfig.
compute_dtype="bfloat16"``), against pcgmix_tpu where it has a
counterpart.

Bars, each with the value measured when it was set:

- ``train_model`` with PCGmix+ (resnet9-5k, 8 × 4 × 512, one step an
  epoch, lr 0.01) against the JAX package's in bf16 (``torch_init``, the
  torch loader order): step 0's loss within 1e-2 absolute (measured
  3.7e-3), steps 0–2 within 5e-2 relative (measured 2.45e-2).  The
  float32 route's bars are 1e-5 and 1e-3 (tests/test_torch_train.py).
  The eval model (bf16, float32 logits): test losses within 2e-2
  relative (measured 5.2e-3), the recording-level predictions equal.
  The gap is XLA's excess precision on the CPU, not the port: XLA keeps
  each conv's bias add (and the last residual add before the head) in
  float32 where the program rounds it to bf16 (tests/test_torch_bf16.py
  pins it on one block).  Adding the biases unrounded in the port takes
  step 0's logits from 1.7e-2 to 2.2e-3 of their largest magnitude, and
  the last residual to 1.7e-3; two channels at the first block and the
  batch statistics of eight rows amplify every rounding.  These bars hold
  the mode's training loop, not its dtype: the port run in float32
  against the same JAX bf16 run is within them too (measured 4.5e-3,
  3.8e-2, test losses 1.5e-2).  tests/test_torch_bf16_exact.py tells the
  two apart, with XLA's excess precision off (step 0: 1.2e-7 in bf16,
  7.9e-4 in float32).
- the mix kernels on a bf16 latent (K1's plain version here): bit-equal to
  the JAX package's Pallas kernel in interpret mode, on a bf16 ResNet9
  latent with ``manifold-cutmix`` and with PCGmix's blends (both blend in
  float32 with a float32 α and round once).  The JAX XLA route casts the
  piece membership and α to the rows' dtype first
  (``pcgmix_tpu/ops/piecewise.py:74-86``): on the blends it lies within 1
  bf16 ulp of both (measured 1.0); on manifold-cutmix's joins (α = 0) it
  is bit-equal, its clamp where a piece runs past the latent's end
  included.
- a gang of two in bf16 with frozen weights (lr_max=0) against its
  members' own runs: train and test losses within 1e-6 relative, the
  float32 route's bar (measured 0).
- ``Classifier.from_checkpoint(compute_dtype="bfloat16")`` on a float32
  checkpoint: probabilities within 2e-3 of the float32 classifier's
  (measured 1.7e-4), its ``torch.export`` artifact bit-equal to it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.augment.engine import AugmentConfig as JAugmentConfig
from pcgmix_tpu.augment.engine import AugmentEngine as JEngine
from pcgmix_tpu.train import TrainConfig as JConfig
from pcgmix_tpu.train import train_model as jtrain
from pcgmix_tpu_torch import serve, utils
from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.exp.runner import main as runner_main
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.models.layers import BatchNorm1d
from pcgmix_tpu_torch.parallel import init_group
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train import gang
from pcgmix_tpu_torch.train import steps as steps_mod
from pcgmix_tpu_torch.train.convert import seeded_init
from tests.test_torch_bf16 import bf16_ulps
from tests.test_torch_zoo_ref import one_torch_thread  # noqa: F401 (autouse)

T, BATCH = 512, 8
EYE = np.eye(2, dtype=np.float32)


@pytest.fixture(scope="module")
def dataset():
    # 8 recordings × 2 segments: one batch of 8 an epoch, so each plot
    # epoch's train_loss is one step's loss
    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6,
                                    segments_per_wav=2, sig_len=T, seed=3)


@pytest.fixture(scope="module")
def ds16():
    return synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=6,
                                    segments_per_wav=2, sig_len=T, seed=1)


def _cfg(**kw):
    common = dict(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=3,
                  batch_size=BATCH, save_artifacts=False, device="cpu",
                  compute_dtype="bfloat16")
    return TrainConfig(**{**common, **kw})


def test_compute_dtype_names():
    assert TrainConfig().compute_dtype == "float32"
    TrainConfig(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainConfig(compute_dtype="float16")


def test_train_model_tracks_jax_in_bf16(dataset):
    common = dict(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=3,
                  batch_size=BATCH, save_artifacts=False, compute_dtype="bfloat16")
    ref = jtrain(JConfig(**common, sig_len=T, torch_init=True, loader_parity="torch",
                         n_devices=1), dataset)
    got = train_model(TrainConfig(**common, device="cpu"), dataset)
    assert got["steps"] == ref["steps"] == [1, 2, 3]
    lt, lj = np.asarray(got["train_loss"]), np.asarray(ref["train_loss"])
    d0, rel = abs(lt[0] - lj[0]), np.abs(lt - lj) / np.abs(lj)
    print(f"bf16 PCGmix+ losses: port {lt}, JAX {lj}; step 0 |diff| {d0:.3e}, "
          f"steps 0-2 relative {rel.max():.3e}")
    assert d0 < 1e-2
    assert rel.max() < 5e-2
    # the eval model: bf16 with float32 logits, the recording-level metrics
    tt, tj = np.asarray(got["test_loss"]), np.asarray(ref["test_loss"])
    print(f"bf16 test losses: port {tt}, JAX {tj}; relative "
          f"{(np.abs(tt - tj) / np.abs(tj)).max():.3e}; wav preds equal "
          f"{got['test_wav_preds'] == ref['test_wav_preds']}")
    assert (np.abs(tt - tj) / np.abs(tj)).max() < 2e-2
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def test_bf16_state_stays_float32(dataset, monkeypatch):
    """Parameters, Adam's moments, the BatchNorm buffers and the SELC
    table are float32 after bf16 steps, and the logits the loss takes are
    float32."""
    seen = {}
    selc = steps_mod.selc_update

    def spy(soft_labels, logits, *a, **k):
        seen.setdefault("logits", logits.dtype)
        return selc(soft_labels, logits, *a, **k)

    monkeypatch.setattr(steps_mod, "selc_update", spy)
    kept = {}
    make = steps_mod.TrainStep.__init__

    def keep(self, *a, **k):
        make(self, *a, **k)
        kept["step"] = self

    monkeypatch.setattr(steps_mod.TrainStep, "__init__", keep)
    for model in ("resnet9-5k", "Potes"):
        train_model(_cfg(model=model, num_epochs=2), dataset)
        st = kept["step"]
        assert seen.pop("logits") == torch.float32
        assert all(t.dtype == torch.float32 for t in st.model.state_dict().values()
                   if t.is_floating_point())
        for state in st.opt.state.values():
            assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32
        assert st.soft_labels.dtype == torch.float32


# --------------------------------------------------------------------------- #
# the mix kernels on bf16 latents
# --------------------------------------------------------------------------- #


def _latent_and_plans(method, latent_len):
    """A bf16 resnet9-5k latent at depth 2 (16 × ``latent_len``, from an
    input 8 × as long) and the port's and the JAX package's engines'
    plan for it, reckoned for ``latent_len`` from a real batch's frames."""
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=2, segments_per_wav=2,
                                  sig_len=latent_len, seed=5)
    split = physionet_split(ds, "train")
    frames, labels = split.frames[:BATCH], split.label[:BATCH]
    x = np.random.default_rng(5).normal(size=(BATCH, 4, 8 * latent_len)).astype(np.float32)
    model = seeded_init(build_model("resnet9-5k", 2, 4, 8 * latent_len,
                                    compute_dtype="bfloat16"), 4)
    with torch.no_grad():
        latent = model.eval()(torch.from_numpy(x), depth=2, part="first")
    assert latent.dtype == torch.bfloat16 and latent.shape == (BATCH, 16, latent_len)
    eng = AugmentEngine(AugmentConfig(method, BATCH, 16, latent_len))
    plan = eng.plan(7, frames, labels)
    return latent, eng, plan.arrays, labels


def _jax_apply(method, latent_len, latent, arrays, labels, pallas):
    jeng = JEngine(JAugmentConfig(method, BATCH, 16, latent_len, use_pallas=pallas,
                                  pallas_interpret=pallas))
    x = jnp.asarray(latent.float().numpy()).astype(jnp.bfloat16)
    out, _ = jax.jit(jeng.apply)(x, jnp.asarray(EYE[labels]), arrays)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("method", ["manifold-cutmix", "durratiomixup"])
def test_bf16_latent_mix_equals_the_pallas_route(method):
    """K1 on a bf16 latent (``piecewise_mix_pairs`` with a zero base for
    the joins, ``piecewise_mix_batch`` for the blends), against the Pallas
    kernel in interpret mode: bit-equal; the XLA route within 1 bf16 ulp."""
    latent, eng, arrays, labels = _latent_and_plans(method, 512)
    out, _ = eng.apply(latent, torch.from_numpy(EYE[labels]), arrays)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    pallas = _jax_apply(method, 512, latent, arrays, labels, pallas=True)
    np.testing.assert_array_equal(got, pallas)
    xla = _jax_apply(method, 512, latent, arrays, labels, pallas=False)
    ulps = bf16_ulps(got, xla, floor=1e-30)
    print(f"{method} on a bf16 latent: XLA route {ulps.max()} bf16 ulps from the port, "
          f"{int((got != xla).sum())} of {got.size} elements differ")
    assert ulps.max() <= 1.0
    if method == "manifold-cutmix":  # α = 0: the joins copy rows exactly
        np.testing.assert_array_equal(got, xla)


def test_manifold_cutmix_on_the_train_path_equals_the_xla_route(dataset):
    """The train path's plan is reckoned for the input's length, so on a
    latent its pieces run past the end: the port clamps the source index
    as the XLA route does (the Pallas kernel wraps it), bit-equal in bf16."""
    split = physionet_split(dataset, "train")
    frames, labels = split.frames[:BATCH], split.label[:BATCH]
    model = seeded_init(build_model("resnet9-5k", 2, 4, T, compute_dtype="bfloat16"), 4)
    with torch.no_grad():
        latent = model.eval()(torch.from_numpy(split.data[:BATCH]), depth=2, part="first")
    eng = AugmentEngine(AugmentConfig("manifold-cutmix", BATCH, 4, T))
    arrays = eng.plan(7, frames, labels).arrays
    past = int(((arrays["dst"] + arrays["len"] > latent.shape[-1]) & (arrays["len"] > 0)).sum())
    assert past > 0
    out, _ = eng.apply(latent, torch.from_numpy(EYE[labels]), arrays)
    jeng = JEngine(JAugmentConfig("manifold-cutmix", BATCH, 4, T))
    x = jnp.asarray(latent.float().numpy()).astype(jnp.bfloat16)
    ref, _ = jax.jit(jeng.apply)(x, jnp.asarray(EYE[labels]), arrays)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_manifold_cutmix_trains_on_the_bf16_latent(dataset, monkeypatch):
    """The split step in bf16: K1 gets the bf16 latent, the first part runs
    under no_grad and its parameters get float32 zero gradients (Adam moves
    them by weight decay and momentum, as optax does), the rest float32
    gradients."""
    from pcgmix_tpu_torch.augment import engine as engine_mod

    rows, grads = [], []
    pairs = engine_mod.piecewise_mix_pairs

    def spy_pairs(data, *a, **k):
        rows.append((data.dtype, tuple(data.shape)))
        return pairs(data, *a, **k)

    clip = torch.nn.utils.clip_grad_value_

    def spy_clip(params, value):
        params = list(params)
        grads.append([(p.grad is None, None if p.grad is None else p.grad.dtype,
                       None if p.grad is None else bool((p.grad == 0).all()))
                      for p in params])
        return clip(params, value)

    monkeypatch.setattr(engine_mod, "piecewise_mix_pairs", spy_pairs)
    monkeypatch.setattr(steps_mod.nn.utils, "clip_grad_value_", spy_clip)
    perf = train_model(_cfg(method="manifold-cutmix", num_epochs=8), dataset)
    assert np.isfinite(perf["train_loss"]).all()
    # the latents at depths 1–3: (8, 4, 256), (8, 16, 64), and the flattened
    # (8, 256) as (8, 1, 256) rows
    latents = {shape for dtype, shape in rows if dtype == torch.bfloat16}
    assert latents and latents <= {(8, 4, 256), (8, 16, 64), (8, 1, 256)}
    assert all(not none and dtype == torch.float32 for g in grads for none, dtype, _ in g)
    # a step at depth ≥ 1: conv1's parameters (the first two) are zeros
    assert any(g[0][2] and g[1][2] for g in grads)


@pytest.mark.parametrize("model,method", [("resnet9-5k", "latentmixup"),
                                          ("resnet9-5k", "manifold-cutout"),
                                          ("Potes", "manifold-cutmix"),
                                          ("resnet9-5k", "lc-nointrusion"),
                                          ("resnet9-5k", "saliency-cutmix")])
def test_split_and_live_model_methods_train_in_bf16(dataset, model, method):
    """The split step (latentmixup's differentiable first part, the
    manifold methods' masks and joins on bf16 latents), ``lc-nointrusion``'s
    candidate losses and ``TrainStep.train_on``, and the live saliency of
    ``saliency-cutmix``, through a bf16 model: finite train and test
    losses."""
    perf = train_model(_cfg(model=model, method=method, num_epochs=4), dataset)
    assert np.isfinite(perf["train_loss"]).all() and np.isfinite(perf["test_loss"]).all()


def test_global_batch_norm_reduces_float32_sums(tmp_path, monkeypatch):
    """Under data parallelism (a 1-rank gloo group here) a bf16 BatchNorm
    all-reduces Σx and Σx² taken on the float32 upcast, and gives the local
    statistics' output within 1 bf16 ulp at max(|y|, 1)."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_fn

    reduced = []
    all_reduce = dist_fn.all_reduce

    def spy(t, *a, **k):
        reduced.append(t.dtype)
        return all_reduce(t, *a, **k)

    monkeypatch.setattr(dist_fn, "all_reduce", spy)
    x = torch.from_numpy(np.random.default_rng(2).normal(1.0, 2.0, (8, 6, 40))
                         .astype(np.float32)).bfloat16()
    local = BatchNorm1d(6, compute_dtype=torch.bfloat16).train()
    glob = BatchNorm1d(6, compute_dtype=torch.bfloat16).train()
    y_local = local(x)
    init_group("gloo", 0, 1, str(tmp_path / "store"))
    try:
        y_global = glob(x)
    finally:
        dist.destroy_process_group()
    assert reduced == [torch.float32]
    assert y_local.dtype == y_global.dtype == torch.bfloat16
    assert bf16_ulps(y_global.float().detach().numpy(),
                     y_local.float().detach().numpy()).max() <= 1.0
    for a, b in ((glob.running_mean, local.running_mean), (glob.running_var, local.running_var)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# gangs, the chunked route, serving, the runner
# --------------------------------------------------------------------------- #


def test_gang_of_two_in_bf16_equals_its_members(ds16):
    cfgs = [_cfg(method="durratiomixup", num_epochs=3, n_fraction=0.5, lr_max=0.0,
                 seed_data=sd, seed=i + 1) for i, sd in enumerate((1100001, 1100003))]
    worst = 0.0
    for got, cfg in zip(gang.train_gang(cfgs, ds16), cfgs):
        ref = train_model(cfg, ds16)
        for key in ("train_loss", "test_loss"):
            a, b = np.asarray(got[key], np.float64), np.asarray(ref[key], np.float64)
            worst = max(worst, float((np.abs(a - b) / np.abs(b)).max()))
    print(f"bf16 gang of 2, frozen: {worst:.3e} relative to the members' own runs")
    assert worst < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gang_size_estimate_takes_the_dtype_reuse(dtype):
    """A member's activations count autograd's saved bytes times the
    dtype's ``REUSE``: 1.5 in float32, 1.6 in bf16, where a bf16 ResNet9
    member added 1.576× its saved bytes on the card."""
    cfg = TrainConfig(model="resnet9", batch_size=64, compute_dtype=dtype)
    shape, rows, hbm = (4, 2500), 3000, 80 * 2**30
    saved = gang.activation_bytes(build_model("resnet9", 2, 4, 2500, compute_dtype=dtype),
                                  (64, *shape))
    per_member = gang.gang_state_bytes(cfg, rows, shape) + saved * gang.REUSE[dtype]
    assert gang.estimate_gang_max_size(cfg, rows, hbm_bytes=hbm, sample_shape=shape) == \
        int(hbm * 0.8 // per_member)
    assert gang.REUSE[dtype] == {"float32": 1.5, "bfloat16": 1.6}[dtype]


def test_steps_per_dispatch_in_bf16_equals_one_step(dataset):
    """On the CPU a chunk runs as plain steps: bit-equal to one step per
    dispatch (the card's CUDA graph is held in tests/test_torch_cuda.py)."""
    one = train_model(_cfg(num_epochs=4), dataset)
    two = train_model(_cfg(num_epochs=4, steps_per_dispatch=2), dataset)
    assert one["train_loss"] == two["train_loss"]
    assert one["test_loss"] == two["test_loss"]


def test_classifier_from_checkpoint_in_bf16(dataset, tmp_path):
    """A float32 ``model.pth`` serves in bf16: the same weights in the bf16
    model, probabilities near the float32 classifier's, and its
    ``torch.export`` artifact answers as the live one."""
    model = seeded_init(build_model("resnet9-5k", 2, 4, T), 4)
    path = str(tmp_path / "model.pth")
    torch.save(model.state_dict(), path)
    split = physionet_split(dataset, "test")
    kw = dict(model_name="resnet9-5k", sig_len=T, device="cpu", batch_size=16)
    live = serve.Classifier.from_checkpoint(path, compute_dtype="bfloat16", **kw)
    fp32 = serve.Classifier.from_checkpoint(path, **kw)
    assert {m.compute_dtype for m in live.net.modules()
            if getattr(m, "compute_dtype", None)} == {torch.bfloat16}
    p16, p32 = live.predict_proba(split.data), fp32.predict_proba(split.data)
    assert p16.dtype == np.float32 and p16.shape == (len(split.data), 2)
    gap = float(np.abs(p16 - p32).max())
    print(f"bf16 classifier: {gap:.3e} from the float32 one")
    assert gap < 2e-3
    art = str(tmp_path / "bf16.pcgt")
    header = live.export_artifact(art, (4, T), model_name="resnet9-5k")
    assert header["dtype"] == "float32"  # the input's; the program computes in bf16
    np.testing.assert_array_equal(serve.ExportedClassifier(art).predict_proba(split.data),
                                  p16)


def test_runner_trains_in_bf16(dataset, tmp_path, monkeypatch):
    from pcgmix_tpu_torch.train import loop

    path = str(tmp_path / "p.dat")
    utils.dict2file(dataset, path)
    seen = []
    train = loop._train
    monkeypatch.setattr(loop, "_train", lambda cfg, *a, **k: seen.append(cfg) or train(
        cfg, *a, **k))
    root = str(tmp_path / "exp")
    runner_main(["--dataset-file", path, "--device", "cpu", "--model", "resnet9-5k",
                 "--methods", "durmixmagwarp(0.2,4)", "--num-epochs", "2", "--batch-size",
                 "8", "--seed-datas", "1100001", "--no-robust", "--experiments-root", root,
                 "--compute-dtype", "bfloat16"])
    (cfg,) = seen
    assert cfg.compute_dtype == "bfloat16"
    run_dir = experiment_dir(cfg)
    perf = utils.load_dict(os.path.join(run_dir, "performance.pkl"))
    assert np.isfinite(perf["train_loss"]).all()
    sd = torch.load(os.path.join(run_dir, "model.pth"), weights_only=True)
    assert all(t.dtype == torch.float32 for t in sd.values() if t.is_floating_point())
    assert dataclasses.replace(cfg, compute_dtype="float32") != cfg

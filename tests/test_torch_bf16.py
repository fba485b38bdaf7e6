"""The bf16 compute mode of the port's models against pcgmix_tpu's
(``compute_dtype="bfloat16"``), on the CPU.

Same inputs and float32 weights (drawn with numpy) on both sides; the JAX
models built with ``compute_dtype=jnp.bfloat16`` and jitted once each.

Bars, each with the value measured when it was set:

- one conv → BatchNorm → ReLU block of ResNet9, 1-D (8 × 4 × 64 → 16
  channels) and 2-D (8 × 4 × 16 × 16 → 16): the output within 2 bf16 ulps
  at max(|y|, 1) (measured 1.0 in both), the running statistics within
  2e-4 (measured 7.3e-5 and 4.7e-5).  XLA keeps the conv's bias add in
  float32 up to the BatchNorm (it drops the add's bf16 rounding, its
  "excess precision"); the port rounds it, as the program says.  That is
  the whole difference: the port's conv output with the bias added in
  float32 reproduces the JAX block bit for bit.
- the logits of one set of weights, 8 × 4 × 512, train mode (batch
  statistics) and eval mode (running statistics): resnet9-5k within 3e-2
  of the logits' largest magnitude (measured 1.67e-2 train, 3.8e-3 eval:
  the block's ulp compounds over nine blocks two channels wide, and the
  batch statistics of eight rows amplify it); the full-width 2-D ResNet9
  on 8 × 1 × 32 × 32 within 3e-2 (measured 2.23e-2 train, 2.10e-2 eval);
  Potes(noDropout), eval mode, within 1e-5 (measured 7.8e-7: no
  BatchNorm, and a rounding XLA drops before a ReLU and a max-pool is
  taken at the next convolution's input, where both round).  Float32
  logits on both sides.
- the registry contract, all 39 names at 2 × 4 × 64: for each layer kind
  (convolution, dense, BatchNorm, LayerNorm) the port's model gives as
  many bf16 and as many float32 outputs as the JAX model's layers of that
  kind (``capture_intermediates`` under ``jax.eval_shape``), so a head
  built with a dtype, or a convolution or BatchNorm built without one,
  fails; Potes' shared branch runs once over B·C rows in the port and
  once per band in JAX, so its convolutions count C times.  Parameters
  and running statistics are float32 after ``seeded_init`` and after
  loading the JAX variables through ``jax_to_torch``, the logits are
  float32, and at float32 every layer's output is float32.

The logits of each family that honors the dtype, and step 0's loss, are
held much tighter with XLA's excess precision off in
tests/test_torch_bf16_exact.py, where the port run in float32 fails the
bars.  Here, with it on, the port in float32 is about as close to the
JAX package's bf16 logits as the port in bf16 (the families that honor
the dtype at 2 × 4 × 64: 5.5e-4 to 4.6e-2 of the logits' largest
magnitude in float32, 9.8e-5 to 9.2e-2 in bf16).
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.models.resnet9 import _ConvBlock
from pcgmix_tpu.models.resnet9_2d import _ConvBlock2d
from pcgmix_tpu_torch.models import MODEL_NAMES, build_model
from pcgmix_tpu_torch.models.potes import POTES_PRESETS
from pcgmix_tpu_torch.models.resnet9 import conv_block
from pcgmix_tpu_torch.models.resnet9_2d import conv_block_2d
from pcgmix_tpu_torch.train.convert import (
    jax_resnet9_2d_to_torch,
    jax_to_torch,
    seeded_init,
)
from tests.test_torch_zoo_ref import numpy_variables
from tests.test_torch_zoo_ref import one_torch_thread  # noqa: F401 (autouse)

B, C, T = 8, 4, 512
S = 32  # the 2-D ResNet9's smallest side (its pools)
SPEC = "PhysioNet(spec128)"
BF16 = jnp.bfloat16


def bf16_ulps(got, ref, floor=1.0):
    """|got − ref| in bf16 ulps at max(|got|, |ref|, ``floor``): 2^(e − 7)
    for a magnitude in [2^e, 2^(e+1))."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    m = np.maximum(np.maximum(np.abs(got), np.abs(ref)), floor)
    return np.abs(got - ref) / 2.0 ** (np.floor(np.log2(m)) - 7)


def rel_to_max(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


# --------------------------------------------------------------------------- #
# one conv → BatchNorm → ReLU block
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dim", [1, 2])
def test_conv_bn_relu_block_tracks_jax(dim):
    rng = np.random.default_rng(dim)
    ci, co = 4, 16
    shape = (8, 64, ci) if dim == 1 else (8, 16, 16, ci)
    x = rng.normal(size=shape).astype(np.float32)
    kshape = (3, ci, co) if dim == 1 else (3, 3, ci, co)
    bound = 1.0 / np.sqrt(np.prod(kshape[:-1]))
    kernel = rng.uniform(-bound, bound, kshape).astype(np.float32)
    bias, bn_bias = (rng.uniform(-0.1, 0.1, co).astype(np.float32) for _ in range(2))
    scale = rng.uniform(0.8, 1.2, co).astype(np.float32)
    conv = "Conv1d_0" if dim == 1 else "Conv2d_0"
    params = {conv: {"Conv_0": {"kernel": kernel, "bias": bias}},
              "BatchNorm_0": {"BatchNorm_0": {"scale": scale, "bias": bn_bias}}}
    stats = {"BatchNorm_0": {"BatchNorm_0": {"mean": np.zeros(co, np.float32),
                                             "var": np.ones(co, np.float32)}}}
    block = (_ConvBlock if dim == 1 else _ConvBlock2d)(co, train=True, dtype=BF16)
    y, mut = jax.jit(lambda p, s, x: block.apply({"params": p, "batch_stats": s}, x,
                                                 mutable=["batch_stats"]))(params, stats, x)
    assert y.dtype == BF16
    y = np.asarray(y.astype(jnp.float32))
    jstats = mut["batch_stats"]["BatchNorm_0"]["BatchNorm_0"]

    net = (conv_block if dim == 1 else conv_block_2d)(ci, co, compute_dtype=torch.bfloat16)
    to_torch = (2, 1, 0) if dim == 1 else (3, 2, 0, 1)
    with torch.no_grad():
        net[0].weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(to_torch))))
        net[0].bias.copy_(torch.from_numpy(bias))
        net[1].weight.copy_(torch.from_numpy(scale))
        net[1].bias.copy_(torch.from_numpy(bn_bias))
    to_nchw = (0, 2, 1) if dim == 1 else (0, 3, 1, 2)
    to_nhwc = (0, 2, 1) if dim == 1 else (0, 2, 3, 1)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(to_nchw)))
    with torch.no_grad():
        out = net.train()(xt)
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert net[1].running_mean.dtype == net[1].running_var.dtype == torch.float32
    got = out.float().numpy().transpose(to_nhwc)
    ulps = bf16_ulps(got, y)
    d_mean = np.abs(net[1].running_mean.numpy() - np.asarray(jstats["mean"])).max()
    d_var = np.abs(net[1].running_var.numpy() - np.asarray(jstats["var"])).max()
    print(f"block {dim}-D: {ulps.max()} bf16 ulps at max(|y|, 1); running mean "
          f"{d_mean:.3e}, var {d_var:.3e}")
    assert ulps.max() <= 2.0
    assert max(d_mean, d_var) < 2e-4

    # the difference is XLA's dropped rounding: the port's conv product
    # (rounded to bf16, as both round it), the bias added in float32
    with torch.no_grad():
        w, b = net[0].weight.bfloat16(), net[0].bias.bfloat16().float()
        xb = xt.bfloat16()
        prod = (F.conv1d(xb, w, padding=1) if dim == 1 else F.conv2d(xb, w, padding=1))
        h = prod.float() + b.view(-1, *(1,) * (dim))
        dims = (0, *range(2, h.dim()))
        mu = h.mean(dims, keepdim=True)
        var = torch.clamp((h * h).mean(dims, keepdim=True) - mu * mu, min=0.0)
        shp = (1, -1) + (1,) * dim
        norm = (h - mu) * (torch.rsqrt(var + 1e-5) * net[1].weight.view(shp))
        emulated = torch.relu((norm + net[1].bias.view(shp)).bfloat16())
    np.testing.assert_array_equal(emulated.float().numpy().transpose(to_nhwc), y)


@pytest.mark.parametrize("dim,kernel", [(1, 64), (2, (1, 40)), (1, 3)])
def test_bf16_conv_on_the_cpu_accumulates_in_float32(dim, kernel):
    """A bf16 convolution on a CPU tensor is the float32 product of the bf16
    operands rounded once, then the bias added in bf16: oneDNN's own bf16
    convolution is wrong for 4 channels under a 40- or 64-step kernel
    (XCM's; 100 % off with torch 2.13)."""
    from pcgmix_tpu_torch.models.layers import Conv1d, Conv2d

    torch.manual_seed(dim)
    conv = (Conv1d(4, 32, kernel, padding=0, compute_dtype=torch.bfloat16) if dim == 1
            else Conv2d(4, 32, kernel, compute_dtype=torch.bfloat16))
    x = torch.randn((2, 4, 127) if dim == 1 else (2, 4, 8, 79))
    with torch.no_grad():
        got = conv(x)
        xb, wb, bb = x.bfloat16(), conv.weight.bfloat16(), conv.bias.bfloat16()
        op = F.conv1d if dim == 1 else F.conv2d
        want = op(xb.float(), wb.float()).bfloat16() + bb.view(-1, *(1,) * dim)
        onednn = op(xb, wb).float() + bb.float().view(-1, *(1,) * dim)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    print(f"{dim}-D bf16 conv, kernel {kernel}: torch's own bf16 convolution "
          f"{rel_to_max(onednn.numpy(), want.float().numpy()):.3e} of max |y| away")


# --------------------------------------------------------------------------- #
# the logits of one set of weights
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,bar", [("resnet9-5k", 3e-2), ("Potes(noDropout)", 1e-5),
                                      ("resnet9-2d", 3e-2)])
def test_model_logits_track_jax(name, bar):
    """Train mode for ResNet9 (its BatchNorm's batch statistics); Potes has
    no BatchNorm and keeps its head's dropout in every preset, so it is
    held in eval mode only.  The 2-D ResNet9 runs at its full width on
    8 × 1 × 32 × 32."""
    rng = np.random.default_rng(3)
    two_d = name == "resnet9-2d"
    shape = (B, 1, S, S) if two_d else (B, C, T)
    x = rng.normal(size=shape).astype(np.float32)
    jtrain, jeval = (jbuild("resnet9", SPEC, train=t, compute_dtype=BF16) if two_d
                     else jbuild(name, train=t, compute_dtype=BF16) for t in (True, False))
    v = numpy_variables(jtrain, shape, 3)
    modes = ("train", "eval") if name.startswith("resnet9") else ("eval",)

    @jax.jit
    def run(v, x):
        out = {"eval": jeval.apply(v, x)}
        if "train" in modes:
            out["train"], _ = jtrain.apply(v, x, mutable=["batch_stats"])
        return out

    ref = run(v, x)
    if two_d:
        model = build_model("resnet9", 2, 1, S, dataset=SPEC, compute_dtype="bfloat16")
        state = jax_resnet9_2d_to_torch(v["params"], v["batch_stats"])
    else:
        model = build_model(name, 2, C, T, compute_dtype="bfloat16")
        state = jax_to_torch(name, v["params"], v.get("batch_stats", {}))
    xt = torch.from_numpy(x)
    for mode in modes:
        model.load_state_dict(state)
        assert all(t.dtype == torch.float32 for t in model.state_dict().values()
                   if t.is_floating_point())
        with torch.no_grad():
            got = model.train(mode == "train")(xt)
        assert got.dtype == torch.float32 and ref[mode].dtype == jnp.float32
        r = rel_to_max(got.numpy(), ref[mode])
        print(f"{name} bf16 logits, {mode} mode: {r:.3e} of max |logit|")
        assert r < bar


# --------------------------------------------------------------------------- #
# the registry contract: which names compute in bf16, fp32 state and logits
# --------------------------------------------------------------------------- #


#: the layer kinds whose output dtype is counted: flax's class, the port's
KINDS = {"conv": (fnn.Conv, torch.nn.modules.conv._ConvNd),
         "dense": (fnn.Dense, torch.nn.Linear),
         "batchnorm": (fnn.BatchNorm, torch.nn.modules.batchnorm._BatchNorm),
         "layernorm": (fnn.LayerNorm, torch.nn.LayerNorm)}


def _jax_dtypes_by_kind(name, shape):
    """(kind, output dtype) → how many layer calls of the JAX model at
    ``compute_dtype=bf16`` give it (``capture_intermediates`` under
    ``jax.eval_shape``: traced, not compiled); its logits' dtype; its
    variables' shapes."""
    model = jbuild(name, train=True, compute_dtype=BF16)
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    assert all(a.dtype == jnp.float32 for a in jax.tree_util.tree_leaves(v))
    counts = Counter()
    for kind, (cls, _) in KINDS.items():
        out, state = jax.eval_shape(
            lambda v, x: model.apply(
                v, x, mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda m, method: isinstance(m, cls) and method == "__call__",
                rngs={"dropout": jax.random.PRNGKey(0)}), v, x)
        for a in jax.tree_util.tree_leaves(state.get("intermediates", {})):
            counts[kind, jnp.dtype(a.dtype).name] += 1
    return counts, out.dtype


def _port_dtypes_by_kind(model, x):
    """(kind, output dtype) → how many layer calls of the port's ``model``
    give it on ``x``, and the logits."""
    counts = Counter()

    def count(kind):
        return lambda _m, _i, out: counts.update([(kind, str(out.dtype)[len("torch."):])])

    hooks = [m.register_forward_hook(count(kind)) for m in model.modules()
             for kind, (_, cls) in KINDS.items() if isinstance(m, cls)]
    with torch.no_grad():
        out = model.train()(x)
    for h in hooks:
        h.remove()
    return counts, out


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_registry_honors_compute_dtype_as_jax(name):
    shape = (2, 4, 64)
    jax_kinds, jax_logits = _jax_dtypes_by_kind(name, shape)
    assert jax_logits == jnp.float32
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    model = seeded_init(build_model(name, 2, 4, 64, compute_dtype="bfloat16"), 4)
    states = [model.state_dict()]
    filled = numpy_variables(jbuild(name, train=True, compute_dtype=BF16), shape, 0)
    twin = build_model(name, 2, 4, 64, compute_dtype="bfloat16")
    twin.load_state_dict(jax_to_torch(name, filled["params"], filled.get("batch_stats", {})))
    states.append(twin.state_dict())
    for sd in states:
        assert all(t.dtype == torch.float32 for t in sd.values() if t.is_floating_point())
    port_kinds, out = _port_dtypes_by_kind(model, x)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    if name in POTES_PRESETS:  # one branch call over B·C rows, where JAX calls it per band
        port_kinds = Counter({k: n * shape[1] if k[0] == "conv" else n
                              for k, n in port_kinds.items()})
    assert port_kinds == jax_kinds, (name, port_kinds, jax_kinds)
    fp32_kinds, _ = _port_dtypes_by_kind(build_model(name, 2, 4, 64), x)
    assert all(dtype == "float32" for _, dtype in fp32_kinds)

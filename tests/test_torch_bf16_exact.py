"""The port's bf16 compute mode against pcgmix_tpu with XLA's excess
precision off, on the CPU.

On the CPU XLA keeps some bf16 values in float32 where the program rounds
them (its "excess precision": a conv's bias add, an elementwise chain), so
in the suite's own processes the JAX package's bf16 models lie about
halfway between a bf16 program and a float32 one, and the port run in
float32 is about as close to them as the port in bf16 (the bars of
tests/test_torch_bf16*.py, each with that control).  With
``--xla_allow_excess_precision=false`` XLA rounds where the program does,
as the port does, and the bars below tell bf16 from float32.  XLA_FLAGS is
read once per process, so the measurements run in a subprocess of their
own (``python -m tests.test_torch_bf16_exact``, which prints them as one
JSON line); the tests read that line.

Bars, each with the value measured when it was set and, in brackets, the
port run in float32 on the same weights and inputs (the control):

- ``train_model`` with PCGmix+ (resnet9-5k, 8 × 4 × 512, as in
  tests/test_torch_bf16_train.py): step 0's loss within 1e-6 absolute
  (measured 1.2e-7 [7.9e-4]).
- the logits of each family that honors the dtype, 2 × 4 × 64, eval and
  train mode, relative to their largest magnitude: within 1e-6 where
  both packages round alike (measured at most 3.5e-7: XceptionTime, XCM
  and OmniScaleCNN in both modes, InceptionTime and mWDN in eval mode,
  XResNet1d18 in train mode [1.1e-3 to 8.6e-2]); within 1e-2 for
  InceptionTime and mWDN in train mode and XResNet1d18 in eval mode
  (measured 3.9e-3, 3.6e-3, 4.0e-3 [2.3e-3, 6.3e-3, 2.4e-3]: a few
  elements a bf16 ulp apart, not traced to one op; one ulp of a logit is
  3.9e-3 of it) and for gMLP (measured 5.8e-3 [4.7e-3]: XLA rounds each
  op of the tanh GELU to bf16, torch computes it in float32 and rounds
  once, and 1636 of 4096 GELU outputs differ by an ulp).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

FAMILIES = ("InceptionTime", "XceptionTime", "XResNet1d18", "gMLP", "XCM", "mWDN",
            "OmniScaleCNN")
SHAPE = (2, 4, 64)
T, BATCH = 512, 8
EXACT = 1e-6
#: (family, mode) → bar where the packages round apart (see above)
ULP_BARS = {("InceptionTime", "train"): 1e-2, ("mWDN", "train"): 1e-2,
            ("XResNet1d18", "eval"): 1e-2, ("gMLP", "eval"): 1e-2, ("gMLP", "train"): 1e-2}


def measure() -> dict:
    """Step 0's loss and the families' logits, the port in bf16 and in
    float32 against the JAX package in bf16 (run with excess precision
    off)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from pcgmix_tpu.models import build_model as jbuild
    from pcgmix_tpu.train import TrainConfig as JConfig
    from pcgmix_tpu.train import train_model as jtrain
    from pcgmix_tpu_torch.data import synthetic_physionet_dict
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.train import TrainConfig, train_model
    from pcgmix_tpu_torch.train.convert import jax_to_torch
    from tests.test_torch_zoo_ref import numpy_variables

    torch.set_num_threads(1)
    out = {"loss": {}, "logits": {}}
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                  sig_len=T, seed=3)
    common = dict(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=1,
                  batch_size=BATCH, save_artifacts=False)
    ref = jtrain(JConfig(**common, compute_dtype="bfloat16", sig_len=T, torch_init=True,
                         loader_parity="torch", n_devices=1), ds)["train_loss"][0]
    for dt in ("bfloat16", "float32"):
        got = train_model(TrainConfig(**common, compute_dtype=dt, device="cpu"), ds)
        out["loss"][dt] = abs(float(got["train_loss"][0]) - float(ref))

    x = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    for name in FAMILIES:
        jt, je = (jbuild(name, train=t, compute_dtype=jnp.bfloat16) for t in (True, False))
        v = numpy_variables(jt, SHAPE, 3)
        run = jax.jit(lambda v, x: {
            "eval": je.apply(v, x),
            "train": jt.apply(v, x, mutable=["batch_stats"])[0]})
        jref = {k: np.asarray(a) for k, a in run(v, x).items()}
        for dt in ("bfloat16", "float32"):
            model = build_model(name, 2, SHAPE[1], SHAPE[2], compute_dtype=dt)
            model.load_state_dict(jax_to_torch(name, v["params"], v.get("batch_stats", {})))
            for mode, r in jref.items():
                with torch.no_grad():
                    got = model.train(mode == "train")(torch.from_numpy(x)).numpy()
                out["logits"][f"{name} {mode} {dt}"] = float(
                    np.abs(got - r).max() / np.abs(r).max())
    return out


@pytest.fixture(scope="module")
def exact():
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "tests.test_torch_bf16_exact"], cwd=root,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_step0_loss_equals_jax_without_excess_precision(exact):
    got = exact["loss"]
    print(f"step 0 loss against JAX bf16: port bf16 {got['bfloat16']:.3e}, "
          f"port float32 {got['float32']:.3e}")
    assert got["bfloat16"] < EXACT
    assert got["float32"] > EXACT  # the control: the bar tells bf16 from float32


@pytest.mark.parametrize("name", FAMILIES)
def test_family_logits_track_jax_without_excess_precision(exact, name):
    for mode in ("eval", "train"):
        got = exact["logits"][f"{name} {mode} bfloat16"]
        control = exact["logits"][f"{name} {mode} float32"]
        bar = ULP_BARS.get((name, mode), EXACT)
        print(f"{name} {mode}: port bf16 {got:.3e} (bar {bar:g}), port float32 {control:.3e}")
        assert got < bar
        if bar == EXACT:
            assert control > EXACT  # the control


if __name__ == "__main__":
    print(json.dumps(measure()))

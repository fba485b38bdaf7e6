"""The yardstick's counts against hand counts."""

import json
import os

import pytest

from benchmark import counts, inputs
from conftest import ROOT


def config(name):
    return json.load(open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")))


@pytest.mark.parametrize("name, macs", [("resnet9_1d", 1.0456e9), ("resnet9_2d", 6.049e9)])
def test_forward_macs(name, macs):
    assert counts.forward_macs(config(name)) == pytest.approx(macs, rel=1e-4)


def test_resnet9_1d_hand_count():
    # conv1 … res2 at T = 2500, 1250, 625, 312, and the 39,936 → 2 head
    hand = (64 * 4 * 3 * 2500 + 128 * 64 * 3 * 2500 + 2 * 128 * 128 * 3 * 1250
            + 256 * 128 * 3 * 1250 + 512 * 256 * 3 * 625 + 2 * 512 * 512 * 3 * 312
            + 39936 * 2)
    assert counts.forward_macs(config("resnet9_1d")) == hand


def test_conv_flops_skip_the_first_input_gradient():
    c = config("resnet9_1d")
    fwd = sum(counts.conv_macs(l) for l in c["layers"]) * 2 * 64
    first = counts.conv_macs(c["layers"][0]) * 2 * 64
    assert counts.conv_flops(c, 64) == 3 * fwd - first


@pytest.mark.parametrize("kernel, extra", [("piecewise_mix_pairs", 0),
                                           ("pcgmix_plus_fused", 64 * 6 * 4 * 4 + 2500 * 6 * 4)])
def test_mix_bytes_at_the_main_geometry(kernel, extra):
    rows, c, t, k = 64, 4, 2500, 4
    formula = 2 * rows * c * t * 4 + 4 * rows + rows * k * 5 * 4 + extra
    nbytes, _ = counts.mix_counts(kernel, rows, c, t, k, covered=rows * 1000,
                                  knots=6 if extra else 0)
    assert nbytes == formula
    bound_ms = 1e3 * counts.mix_bound_s((nbytes, 0), 67e12, 3.35e12)
    assert bound_ms == pytest.approx(0.001550 if extra else 0.001530, abs=1e-6)


@pytest.mark.parametrize("name", ["resnet9_1d", "resnet9_2d"])
def test_parameters_match_the_port(name):
    from pcgmix_tpu_torch.models import build_model

    c = config(name)
    spec = {n: tuple(s) for n, s, _ in inputs.param_specs(c)}
    freq = c["input"][1] if len(c["input"]) == 3 else None
    model = build_model(c["model"], c["num_classes"], c["input"][0], c["input"][-1],
                        dataset=c["dataset"], freq=freq)
    assert spec == {n: tuple(p.shape) for n, p in model.named_parameters()}

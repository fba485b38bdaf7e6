"""A configuration's model family gives its first weights and its
operation count: the ResNet9 family's weights are the ones the layer table
always gave, bit for bit, and a family of another shape needs nothing but
its own module."""

import hashlib
import json
import math
import os
import types

import pytest
import torch

from benchmark import counts, inputs
from benchmark.reference import load
from conftest import ROOT

CPU = torch.device("cpu")

# sha256 of make_weights (each name, shape and float32 bytes, in the model's
# order) before the families gave the specs, when the layer table did
DIGESTS = {
    ("resnet9_1d", 7): "af0aec59bd2cadb694fe29687b30c8e2f8cf92e616f33ad90b7c5a30d6e78cb6",
    ("resnet9_1d", 2**31 + 5): "6f93a78ec21af7d96296ba1078657aa29458b4eccbf23389f092f8094f9421c5",
    ("resnet9_2d", 7): "cba94ece2d73595ef585d4e49fa961ee406479e80c9bb83a5975b0b3d0a960a8",
    ("resnet9_2d", 2**31 + 5): "d9e9fbdb2cf879b2fef5ba7fccdc4b1f4b5e6dec7873bbee158a11d30b6291e7",
}


def config(name):
    return json.load(open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")))


def digest(weights: dict) -> str:
    h = hashlib.sha256()
    for k, v in weights.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, seed", sorted(DIGESTS))
def test_resnet9_weights_are_bit_equal_to_the_layer_tables(name, seed):
    assert digest(inputs.make_weights(config(name), seed, CPU)) == DIGESTS[(name, seed)]


@pytest.mark.parametrize("name, macs, flops", [("resnet9_1d", 1045693440, 6274160640),
                                               ("resnet9_2d", 6049251328, 36295507968)])
def test_resnet9_counts_are_the_layer_tables(name, macs, flops):
    c = config(name)
    assert counts.forward_macs(c) == macs
    assert counts.model_flops_per_sample(c) == flops


def toy_family(normals: bool):
    """A family whose parameters are no layer table's: a projection with a
    bias of ones and near-zero normal weights, a norm, a head."""
    specs = [("proj_in.weight", (32, 16), ("uniform", 16)),
             ("proj_in.bias", (32,), ("uniform", 16))]
    if normals:
        specs += [("gate.weight", (50, 50), ("normal", 0.5))]
    specs += [("gate.bias", (50,), ("fill", 1.0)),
              ("norm.weight", (32,), ("fill", 1.0)),
              ("head.weight", (2, 32), ("uniform", 32))]
    if normals:
        specs += [("head.scale", (400,), ("normal", 2.0))]
    return types.SimpleNamespace(param_specs=lambda config: list(specs),
                                 forward_macs=lambda config: 12345)


@pytest.fixture
def toy(monkeypatch):
    """Config ``{"family": "toy"}`` (``"toy-uniform"``: without the normal
    parameters), its module found as a family file would be."""
    families = {"toy": toy_family(True), "toy-uniform": toy_family(False)}

    def find(kind, name):
        return families[name] if kind == "models" and name in families else load(kind, name)

    monkeypatch.setattr(inputs, "load", find)
    monkeypatch.setattr(counts, "load", find)
    return {"family": "toy"}


def test_a_family_gets_the_parameters_it_declares(toy):
    w = inputs.make_weights(toy, 11, CPU)
    assert [(n, tuple(t.shape)) for n, t in w.items()] == [
        (n, s) for n, s, _ in toy_family(True).param_specs(toy)]
    assert all(t.dtype == torch.float32 for t in w.values())
    for name, fan_in in (("proj_in.weight", 16), ("proj_in.bias", 16), ("head.weight", 32)):
        bound = 1 / math.sqrt(fan_in)
        assert w[name].abs().max() <= bound and w[name].abs().max() > 0.8 * bound
    assert (w["gate.bias"] == 1).all() and (w["norm.weight"] == 1).all()
    assert w["gate.weight"].mean().abs() < 0.05
    assert w["gate.weight"].std().item() == pytest.approx(0.5, rel=0.05)
    assert w["head.scale"].std().item() == pytest.approx(2.0, rel=0.15)
    assert counts.forward_macs(toy) == 12345
    assert counts.model_flops_per_sample(toy) == 6 * 12345


def test_a_family_draws_reproducibly_by_seed(toy):
    a, b, c = (inputs.make_weights(toy, s, CPU) for s in (2**31 + 3, 2**31 + 3, 2**31 + 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gate.weight"], c["gate.weight"])
    assert not torch.equal(a["proj_in.weight"], c["proj_in.weight"])


def test_normal_parameters_leave_the_uniform_draws_alone(toy):
    with_normals = inputs.make_weights(toy, 5, CPU)
    uniform_only = inputs.make_weights({"family": "toy-uniform"}, 5, CPU)
    assert set(uniform_only) < set(with_normals)
    assert all(torch.equal(uniform_only[k], with_normals[k]) for k in uniform_only)
    # the normal parameters: one draw, in the specs' order, from a stream of their own
    gen = torch.Generator().manual_seed(inputs.stream_seed(5, inputs.STREAMS["weights"], 1))
    z = torch.randn(50 * 50 + 400, generator=gen)
    assert torch.equal(with_normals["gate.weight"], (z[:2500] * 0.5).view(50, 50))
    assert torch.equal(with_normals["head.scale"], z[2500:] * 2.0)


def test_an_unknown_init_is_refused(toy, monkeypatch):
    bad = types.SimpleNamespace(param_specs=lambda c: [("w", (2,), ("xavier", 2))])
    monkeypatch.setattr(inputs, "load", lambda kind, name: bad)
    with pytest.raises(ValueError, match="no init 'xavier'"):
        inputs.make_weights(toy, 1, CPU)

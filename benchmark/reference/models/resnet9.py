"""ResNet9 (myrtle-style), 1-D or 2-D, from a parameter dict (reference
models.py:468-473 and :520-589, models2d.py:13-87).

conv1 → conv2 (pool 2) → res1 (two blocks) + skip → conv3 (pool 2) →
conv4 (pool 2) → res2 (two blocks) + skip → max-pool 4 → flatten → linear.
A block is a 3-wide convolution with padding 1 and a bias, BatchNorm and
ReLU, then its pool.  The parameter names and the layer sizes are the
configuration's layer table (``layers``, ``linear``), which also gives the
family's first weights (:func:`param_specs`) and its operations
(:func:`forward_macs`).
"""

from __future__ import annotations

import math

import torch

from benchmark import counts
from benchmark.reference.common import batch_norm, max_pool


def param_specs(config: dict) -> list:
    """(name, shape, init) of every parameter in the model's order:
    convolution and linear weights and biases U(±1/√fan_in) (PyTorch's
    default), BatchNorm scale 1 and shift 0."""
    specs = []
    for l in config["layers"]:
        k = list(l["kernel"])
        u = ("uniform", l["in"] * math.prod(k))
        specs += [(f"{l['conv']}.weight", (l["out"], l["in"], *k), u),
                  (f"{l['conv']}.bias", (l["out"],), u),
                  (f"{l['bn']}.weight", (l["out"],), ("fill", 1.0)),
                  (f"{l['bn']}.bias", (l["out"],), ("fill", 0.0))]
    lin = config["linear"]
    u = ("uniform", lin["in"])
    return specs + [(f"{lin['name']}.weight", (lin["out"], lin["in"]), u),
                    (f"{lin['name']}.bias", (lin["out"],), u)]


def forward_macs(config: dict) -> int:
    """Multiply-adds of the forward for one sample: every convolution and
    the linear head."""
    lin = config["linear"]
    return sum(counts.conv_macs(l) for l in config["layers"]) + lin["in"] * lin["out"]


def forward(params: dict, x: torch.Tensor, ops, config: dict) -> torch.Tensor:
    eps = config["recipe"]["bn_eps"]
    layers = {l["conv"].rsplit(".", 1)[0]: l for l in config["layers"]}

    def block(h, name):
        l = layers[name]
        h = ops.conv(h, params[f"{l['conv']}.weight"], params[f"{l['conv']}.bias"],
                     l["padding"])
        h = torch.relu(batch_norm(h, params[f"{l['bn']}.weight"], params[f"{l['bn']}.bias"],
                                  eps))
        return max_pool(h, l["pool"]) if l["pool"] > 1 else h

    h = block(block(x, "conv1"), "conv2")
    h = block(block(h, "res1.0"), "res1.1") + h
    h = block(block(h, "conv3"), "conv4")
    h = block(block(h, "res2.0"), "res2.1") + h
    lin = config["linear"]
    h = torch.flatten(max_pool(h, lin["pool"][0]), 1)
    return ops.linear(h, params[f"{lin['name']}.weight"], params[f"{lin['name']}.bias"])

"""Weight carry-over between the two packages (inverses of
``pcgmix_tpu/train/convert.py::torch_resnet9_to_flax`` and
``torch_potes_to_flax``, and every other registry model's flax trees to
torch: :func:`jax_to_torch`) and the reference's seeded initialization.

Layouts: flax Conv kernel (k, Ci, Co) ↔ torch Conv1d weight (Co, Ci, k)
(a depthwise kernel (k, 1, C) ↔ (C, 1, k)), (kh, kw, Ci, Co) ↔ Conv2d
weight (Co, Ci, kh, kw); flax Dense kernel (Ci, Co) ↔ torch Linear weight
(Co, Ci); flax BatchNorm and LayerNorm scale/bias and batch_stats mean/var
↔ weight/bias and running_mean/running_var; PReLU's alpha ↔ its weight.
The 2-D ResNet9's classifier needs no reordering: the JAX model flattens
its (B, H, W, C) features in torch's C, H, W order
(``pcgmix_tpu/models/layers.py::flatten_torch_2d``); no other model
flattens.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from pcgmix_tpu_torch.models import POTES_PRESETS, RESNET9_PRESETS

# torch module path → flax block name (reference ResNet9_myrtle)
RESNET9_BLOCKS = {
    "conv1": "conv1",
    "conv2": "conv2",
    "res1.0": "res1a",
    "res1.1": "res1b",
    "conv3": "conv3",
    "conv4": "conv4",
    "res2.0": "res2a",
    "res2.1": "res2b",
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def jax_resnet9_to_torch(params: Mapping, batch_stats: Mapping) -> dict:
    """ResNet9 flax trees (numpy leaves) → a ``ResNet9_1D`` state_dict."""
    return _resnet9_to_torch(params, batch_stats, "Conv1d_0", (2, 1, 0))


def jax_resnet9_2d_to_torch(params: Mapping, batch_stats: Mapping) -> dict:
    """2-D ResNet9 flax trees (numpy leaves) → a ``ResNet9_2D`` state_dict."""
    return _resnet9_to_torch(params, batch_stats, "Conv2d_0", (3, 2, 0, 1))


def _resnet9_to_torch(params, batch_stats, conv_name: str, perm) -> dict:
    sd = {}
    for tname, fname in RESNET9_BLOCKS.items():
        conv = params[fname][conv_name]["Conv_0"]
        bn = params[fname]["BatchNorm_0"]["BatchNorm_0"]
        stats = batch_stats[fname]["BatchNorm_0"]["BatchNorm_0"]
        sd[f"{tname}.0.weight"] = _t(np.transpose(conv["kernel"], perm))
        sd[f"{tname}.0.bias"] = _t(conv["bias"])
        sd[f"{tname}.1.weight"] = _t(bn["scale"])
        sd[f"{tname}.1.bias"] = _t(bn["bias"])
        sd[f"{tname}.1.running_mean"] = _t(stats["mean"])
        sd[f"{tname}.1.running_var"] = _t(stats["var"])
        sd[f"{tname}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    dense = params["linear"]["Dense_0"]
    sd["linear.weight"] = _t(np.asarray(dense["kernel"]).T)
    sd["linear.bias"] = _t(dense["bias"])
    return sd


def jax_potes_to_torch(params: Mapping) -> dict:
    """Potes flax params (numpy leaves) → a ``Potes`` state_dict."""
    sd = {}
    for i, tname in enumerate(("cnn1.0.0", "cnn1.1.0")):
        conv = params["cnn1"][f"Conv1d_{i}"]["Conv_0"]
        sd[f"{tname}.weight"] = _t(np.transpose(conv["kernel"], (2, 1, 0)))
        sd[f"{tname}.bias"] = _t(conv["bias"])
    for name in ("dimreduc", "linear"):
        dense = params[name]["Dense_0"]
        sd[f"{name}.weight"] = _t(np.asarray(dense["kernel"]).T)
        sd[f"{name}.bias"] = _t(dense["bias"])
    return sd


#: flax recurrent cells → the port's ``Recurrent`` parameters: each torch
#: tensor is the listed flax Denses' kernels (transposed) or biases,
#: concatenated in torch's gate order
RECURRENT_CELLS = {
    "SimpleCell_0": {"weight_ih": ("i",), "weight_hh": ("h",), "bias_ih": ("i",)},
    "GRUCell_0": {"weight_ih": ("ir", "iz", "in"), "weight_hh": ("hr", "hz", "hn"),
                  "bias_ih": ("ir", "iz", "in"), "bias_hn": ("hn",)},
    "OptimizedLSTMCell_0": {"weight_ih": ("ii", "if", "ig", "io"),
                            "weight_hh": ("hi", "hf", "hg", "ho"),
                            "bias_hh": ("hi", "hf", "hg", "ho")},
}
# the flax wrappers' inner modules (pcgmix_tpu/models/layers.py: Conv1d and
# Conv2d hold an nn.Conv "Conv_0", Dense an nn.Dense "Dense_0", BatchNorm an
# nn.BatchNorm "BatchNorm_0") and ConvBNAct's unnamed wrappers
_INNER = ("Conv_0", "Dense_0", "BatchNorm_0")
_CONVBNACT = {"Conv1d_0": "conv", "BatchNorm_0": "bn"}
_LEAVES = {"kernel": "weight", "scale": "weight", "alpha": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _torch_key(path: tuple) -> str:
    """A flax leaf path → the port's state_dict key: the wrapper's inner
    module is dropped, ConvBNAct's unnamed ``Conv1d_0``/``BatchNorm_0`` are
    its ``conv``/``bn``, every other module keeps its flax name."""
    *mods, leaf = path
    if mods and mods[-1] in _INNER:
        mods.pop()
    return ".".join([_CONVBNACT.get(m, m) for m in mods] + [_LEAVES[leaf]])


def _torch_tensor(leaf: str, a) -> torch.Tensor:
    a = np.asarray(a)
    if leaf == "kernel":
        a = np.transpose(a, {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[a.ndim])
    return _t(a)


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_to_torch(name: str, params: Mapping,
                 batch_stats: Optional[Mapping] = None) -> dict:
    """The JAX package's variables of registry model ``name`` (numpy
    leaves) → the port's ``build_model(name)`` state_dict."""
    batch_stats = batch_stats or {}
    if name in RESNET9_PRESETS:
        return jax_resnet9_to_torch(params, batch_stats)
    if name in POTES_PRESETS:
        return jax_potes_to_torch(params)
    sd = {}
    for cell, spec in RECURRENT_CELLS.items():
        if cell in params:
            tree = params[cell]
            for key, parts in spec.items():
                leaf = "kernel" if key.startswith("weight") else "bias"
                sd[f"rnn.{key}"] = _t(np.concatenate(
                    [np.asarray(tree[p][leaf]).T if leaf == "kernel"
                     else np.asarray(tree[p][leaf]) for p in parts]))
    for path, a in _leaves(params):
        if path[0] not in RECURRENT_CELLS:
            sd[_torch_key(path)] = _torch_tensor(path[-1], a)
    for path, a in _leaves(batch_stats):
        key = _torch_key(path)
        sd[key] = _t(a)
        sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def _member(tree: Mapping, s: int) -> dict:
    """Member ``s``'s slice of a tree stacked on a leading member axis."""
    return {k: _member(v, s) if isinstance(v, Mapping) else np.asarray(v)[s]
            for k, v in tree.items()}


def jax_gang_to_torch(name: str, params: Mapping,
                      batch_stats: Optional[Mapping] = None) -> list:
    """A JAX gang's stacked variables (numpy leaves, a leading member axis,
    ``pcgmix_tpu/train/gang.py``) → one ``build_model(name)`` state_dict
    per member, each member's slice through :func:`jax_to_torch`."""
    members = len(np.asarray(next(v for _, v in _leaves(params))))
    return [jax_to_torch(name, _member(params, s), _member(batch_stats or {}, s))
            for s in range(members)]


def seeded_init(model: nn.Module, seed: int = 4) -> nn.Module:
    """Re-draw the model's Conv1d/Conv2d/Linear parameters as a fresh reference
    model built under ``torch.manual_seed(seed)`` would hold them
    (reference train_model.py:293), without touching the global RNG.

    PyTorch's default init is kaiming_uniform(a=√5) on the weight — i.e.
    U(±1/√fan_in) — then U(±1/√fan_in) on the bias, drawn module by module
    in construction order; BatchNorm draws nothing.  The draws run on a CPU
    generator (a CUDA generator gives other numbers) and are copied to the
    model's device.  For Potes the same rule covers its four live layers;
    the reference also draws its dead ``cnn2``–``cnn4`` branches, so no
    reference-exact init stream is claimed there (the JAX package has no
    torch-seeded Potes init either).  A module with an init of its own
    (the recurrent cells, gMLP's spatial projection, mWDN's wave linears)
    draws it from the same generator through its ``seeded_reset``.
    """
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "seeded_reset"):
                m.seeded_reset(g)
                continue
            if not isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                continue
            w = torch.empty(m.weight.shape)
            nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                fan_in = w[0].numel()
                bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                b = torch.empty(m.bias.shape)
                nn.init.uniform_(b, -bound, bound, generator=g)
                m.bias.copy_(b)
    return model

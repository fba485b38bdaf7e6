"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, written from the published description (the
reference code base named in each configuration's ``source``), with TF32
off.  It imports nothing of the port, of the JAX package or of JAX, and
takes nothing the port made: it works out the batch order, the plans, the
mixed batches, the forward, the loss, the gradients and the optimizer's
updates again from the benchmark's corpus and first weights.

- :mod:`.common`: BatchNorm (biased variance), pools, the soft-target
  cross-entropy, gradient-value clipping, Adam with L2 weight decay,
  OneCycle, the batch order, and :func:`.common.follow`, which runs the
  first training steps.
- ``models/<family>.py``: a model family, named by a configuration's
  ``family``.  It gives ``forward(params, x, ops, config)``, the forward
  from a parameter dict; ``param_specs(config)``, (name, shape, init) of
  every parameter in the model's order, ``init`` being ``("uniform",
  fan_in)``, ``("normal", std)`` or ``("fill", value)``, from which
  ``benchmark/inputs.py::make_weights`` draws the first weights; and
  ``forward_macs(config)``, the forward's multiply-adds for one sample,
  which ``benchmark/counts.py`` turns into ``step_mfu``'s operations.
- ``plans/<method>.py``: a method's host plan and its mix.

Module files are found by name (:func:`load`), so a configuration or a
method that a later change adds brings a file of its own: a model whose
parameters are not the convolution and BatchNorm pairs of a layer table
is a configuration file (``configs/<name>.json``) and a family file here,
with no edit elsewhere.
"""

from __future__ import annotations

import importlib.util
import os
import re

_HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this package (``kind``: models or
    plans)."""
    path = os.path.join(_HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise NotImplementedError(f"the reference has no {kind[:-1]} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def method_parts(method: str) -> tuple:
    """(base, numbers) of a plain method string such as ``durratiomixup``
    or ``durmixmagwarp(0.2,4)``; a method with modifiers has no plain plan
    here yet."""
    m = re.fullmatch(r"([A-Za-z][A-Za-z0-9-]*)(?:\(([-\d.,\s]*)\))?", method)
    if not m:
        raise NotImplementedError(f"the reference has no plan for method {method!r}")
    nums = tuple(float(v) for v in m.group(2).split(",")) if m.group(2) else ()
    return m.group(1), nums

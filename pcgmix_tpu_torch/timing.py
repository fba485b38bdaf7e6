"""Host wall time per named phase of the training loop.

The model-in-the-loop methods do host work inside a step that the plain
methods do not: a saliency pass, the (salopt…) displacement search, a
latent embedding and its TSP pairing, the candidate forward and
``lc_select`` of ``lc-nointrusion``.  Each runs inside :func:`timed`, which
adds its wall time (the device work it waits for included) to a total per
name; :func:`host_times` reads the totals and :func:`reset_host_times` sets
them to 0, as the kernels' launch counts are read and reset.
"""

from __future__ import annotations

import contextlib
import time

_ms: dict = {}
_calls: dict = {}


@contextlib.contextmanager
def timed(name: str):
    """Add the wall time of the block to ``name``'s total."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ms[name] = _ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        _calls[name] = _calls.get(name, 0) + 1


def host_times() -> dict:
    """{name: (total ms, calls)} since the last reset."""
    return {k: (_ms[k], _calls[k]) for k in _ms}


def reset_host_times() -> None:
    _ms.clear()
    _calls.clear()

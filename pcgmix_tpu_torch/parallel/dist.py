"""Data parallelism over ``torch.distributed`` (counterpart:
``pcgmix_tpu/parallel/mesh.py``).

The JAX package runs the same program on every device of a mesh under
GSPMD: train state replicated, batch and plan arrays sharded on the batch
axis, a gradient all-reduce inserted by XLA.  The port does the same by
hand, one process per device:

- every rank holds the whole corpus and builds the same global plan from
  the step number, then takes its contiguous block of the global batch
  (:meth:`DataParallel.block`, the counterpart of ``shard_batch``);
- parameters start equal (:meth:`DataParallel.broadcast_module`), the
  gradients are averaged before clipping (:meth:`average_gradients`), so
  every rank applies the same update;
- BatchNorm's statistics are global (``models/resnet9.py::BatchNorm1d``)
  and the SELC table stays replicated (``train/losses.py``);
- a global batch that does not divide over the ranks is not split: every
  rank runs all of it, as the single-device step does, the counterpart of
  the JAX package replicating a leaf that does not divide
  (``pcgmix_tpu/parallel/mesh.py:39-43``).  :func:`batch_rows` tells the
  modules, during a step's forward, which rows of how large a global batch
  this process holds: BatchNorm takes local statistics on a replicated
  batch, and dropout draws the global batch's masks and keeps its rows.

Groups are NCCL on CUDA and gloo on the CPU; the CPU route exists for the
tests.  :func:`spawn` starts one worker per device and returns rank 0's
result; the workers rendezvous through a ``FileStore`` in a temporary
directory, so no port is chosen.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """This process's ``rows`` of a global batch of ``n`` rows;
    ``replicated`` when every rank of the group holds all of them."""

    n: int
    rows: slice
    replicated: bool = False


_batch_rows: Optional[BatchRows] = None


@contextlib.contextmanager
def batch_rows(n: int, rows: slice, replicated: bool = False):
    """Within: the forward of a step over ``rows`` of a global batch of
    ``n`` rows, replicated over the ranks or not (see
    :func:`current_batch_rows`)."""
    global _batch_rows
    prev, _batch_rows = _batch_rows, BatchRows(n, rows, replicated)
    try:
        yield
    finally:
        _batch_rows = prev


def current_batch_rows() -> Optional[BatchRows]:
    """The rows set by :func:`batch_rows`, or None outside a step."""
    return _batch_rows


def init_group(backend: str, rank: int, world_size: int, store_path: str) -> None:
    """Initialize the default process group through a ``FileStore``."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def _entry(rank: int, world_size: int, backend: str, tmp: str,
           fn: Callable, args: tuple) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        # the CPU route is for the tests, which run several such groups side
        # by side: one thread per rank keeps them from oversubscribing
        torch.set_num_threads(1)
    init_group(backend, rank, world_size, os.path.join(tmp, "store"))
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, args: tuple = (),
          all_ranks: bool = False) -> Any:
    """Run ``fn(*args)`` in ``world_size`` spawned processes, each a rank of
    a fresh default group (rank r on ``cuda:r`` under NCCL); returns rank 0's
    result, or with ``all_ranks`` every rank's in rank order.  ``fn`` must
    be importable by name: a spawned child imports ``fn``'s module and
    nothing of the caller's."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="pcgmix_dist_") as tmp:
        mp.start_processes(
            _entry, args=(world_size, backend, tmp, fn, args),
            nprocs=world_size, join=True, start_method="spawn",
        )
        outs = []
        for rank in range(world_size if all_ranks else 1):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs if all_ranks else outs[0]


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the default group: its rank of ``world``."""

    rank: int
    world: int

    @classmethod
    def current(cls) -> "DataParallel":
        return cls(dist.get_rank(), dist.get_world_size())

    def divides(self, n: int) -> bool:
        """True when a global batch of ``n`` rows splits over the ranks."""
        return n % self.world == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a global batch of ``n`` rows."""
        if not self.divides(n):
            raise ValueError(
                f"batch of {n} rows does not divide over {self.world} ranks"
            )
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_arrays(self, arrays: dict, n: int, shared=()) -> dict:
        """This rank's block of every batch-leading array of a plan (NumPy
        or device tensors); scalars and the ``shared`` arrays pass through
        (the counterpart of ``mesh.shard_batch``)."""
        sl = self.block(n)
        return {
            k: v[sl] if (k not in shared and isinstance(v, (np.ndarray, torch.Tensor))
                         and v.ndim and len(v) == n) else v
            for k, v in arrays.items()
        }

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Copy rank 0's parameters and buffers to every rank."""
        with torch.no_grad():
            for t in module.state_dict().values():
                dist.broadcast(t, src=0)

    def average_gradients(self, params) -> None:
        """Replace every gradient by its mean over the ranks (one flat
        all-reduce)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(self.world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a tensor each rank holds."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out.div_(self.world)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated in rank order on
        the leading axis: the global batch from the ranks' blocks."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

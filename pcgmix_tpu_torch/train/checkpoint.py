"""Periodic checkpoints and exact resume (counterpart:
``pcgmix_tpu/train/checkpoint.py``).

The reference saves only the final weights (train_model.py:481-482) and
resumes a grid by skipping finished run directories.  Like the JAX
package, the port can also save the whole training state every
``TrainConfig.checkpoint_every`` epochs, so an interrupted run continues
where its last checkpoint left it.  The JAX package writes orbax
checkpoints; the port writes one ``torch.save`` file per step,
``ckpt_<step>.pt``, beside the metric history ``metrics_<step>.pkl``.
Each is written to a temporary name and renamed into place, so a crash in
the middle of a write leaves the last complete checkpoint as the latest.
The newest ``max_to_keep`` of each are kept.

What a checkpoint holds is the caller's dict of state (``train/loop.py``:
the model's ``state_dict`` with its BatchNorm buffers, the optimizer's and
the scheduler's, the SELC table, the step, and the state of every
generator the run draws from, such as Potes' dropout generator).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Optional

import torch

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def _write(path: str, write) -> None:
    """Write through a temporary file renamed into place."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    @property
    def directory(self) -> str:
        return self._dir

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step}.pt")

    def _metrics_path(self, step: int) -> str:
        return os.path.join(self._dir, f"metrics_{step}.pkl")

    def steps(self) -> list[int]:
        """The steps of the complete checkpoints on disk, oldest first."""
        found = (_CKPT.search(os.path.basename(p))
                 for p in glob.glob(os.path.join(self._dir, "ckpt_*.pt")))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, metrics: Optional[dict] = None) -> None:
        """Save ``state`` (anything ``torch.save`` takes) as step ``step``, and
        ``metrics`` beside it; then drop all but the newest ``max_to_keep``."""
        if metrics is not None:
            _write(self._metrics_path(step), lambda f: pickle.dump(metrics, f))
        _write(self._path(step), lambda f: torch.save(state, f))
        for old in self.steps()[:-self._max_to_keep]:
            for path in (self._path(old), self._metrics_path(old)):
                if os.path.exists(path):
                    os.remove(path)

    def restore(self, map_location=None) -> tuple[dict, int]:
        """The latest checkpoint's state and its step."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        # tensors and plain containers only: a tampered file runs no code
        state = torch.load(self._path(step), map_location=map_location, weights_only=True)
        return state, step

    def restore_metrics(self, step: int) -> Optional[dict]:
        """The metric history saved with step ``step``'s checkpoint: without
        it a resumed run's performance.pkl would lose the curve before the
        crash and restart ``times`` at zero."""
        path = self._metrics_path(step)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        """Nothing is held open between saves (the JAX package's manager
        has a ``close``; kept for the same call sites)."""

"""Run-directory naming (counterpart: ``pcgmix_tpu/exp/dirs.py``).

The reference encodes every hyperparameter into the run directory name
(utils.experiment_dir, utils.py:34-53) and treats an existing final
checkpoint as "experiment done".  The names are the JAX package's, so run
directories from either package interoperate; this package writes
``model.pth``.
"""

from __future__ import annotations

import os


def experiment_dir(cfg, experiments_root: str | None = None) -> str:
    """Directory name encoding the full config."""
    root = experiments_root or getattr(cfg, "experiments_root", "experiments")
    name = (
        f"{cfg.dataset}_{cfg.model}_{cfg.method}_epochs={cfg.num_epochs}"
        f"_bs={cfg.batch_size}_nfrac={cfg.n_fraction}_op={cfg.op}"
        f"_sched={cfg.use_sched}_lrmax={cfg.lr_max}_tbal={cfg.train_balance}"
        f"_chs={cfg.num_channels}_gc={cfg.grad_clip}_seed(data)={cfg.seed_data}"
        f"_valid={cfg.valid}_seed={cfg.seed}"
    )
    return os.path.join(root, name)


def experiment_already_done(cfg, experiments_root: str | None = None) -> bool:
    """True iff a final checkpoint of either package exists."""
    d = experiment_dir(cfg, experiments_root)
    return any(
        os.path.exists(os.path.join(d, f)) for f in ("model.msgpack", "model.pth")
    )

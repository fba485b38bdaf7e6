"""Run-directory naming (counterpart: ``pcgmix_tpu/exp/dirs.py``).

The reference encodes every hyperparameter into the run directory name
(utils.experiment_dir, utils.py:34-53) and treats an existing final
checkpoint as "experiment done".  The names are the JAX package's, so run
directories from either package interoperate; this package writes
``model.pth``, and a run that loads another run's weights (a dependency of
the model-in-the-loop methods) reads ``model.pth`` only.
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


CHECKPOINT = "model.pth"  # the final weights this package writes and loads


def require_checkpoint(run_dir: str, what: str) -> str:
    """The path of ``run_dir``'s ``model.pth``; raises FileNotFoundError
    naming it when it is missing (``what`` says who needs it).  A JAX
    package's ``model.msgpack`` in its place marks the run done, but this
    package cannot load it."""
    path = os.path.join(run_dir, CHECKPOINT)
    if not os.path.exists(path):
        jax_ckpt = os.path.exists(os.path.join(run_dir, "model.msgpack"))
        raise FileNotFoundError(
            f"{what} needs the checkpoint {path}"
            + (" (the run dir holds the JAX package's model.msgpack, which this "
               "package does not load: train the run with pcgmix_tpu_torch)"
               if jax_ckpt else "; train that run first")
        )
    return path

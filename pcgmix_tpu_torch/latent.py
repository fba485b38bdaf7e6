"""Latent space (counterpart: ``pcgmix_tpu/latent.py``; reference
latent_space.py).

A frozen pretrained ResCNN embeds batches as its depth-5 features (B, 128)
(latent_space.py:43-47) for the closestknn/closestbins pairings; the
training loop's ``latent_space`` option dumps the embeddings of each
augmented batch (train_model.py:508-518).  The canonical embedder is the
reference's hardcoded run (latent_space.py:27-29): ResCNN, ``base``, 10
epochs at batch 32, n_fraction 1.0, lr 0.00089, seed_data 3, seed 1;
:func:`latent_space_for` loads its ``model.pth`` and the runner trains it
first when it is missing.  The JAX package's t-SNE/PCA plots need sklearn
and matplotlib and are not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.exp.dirs import experiment_dir, require_checkpoint

#: the canonical pretrained latent-space run (latent_space.py:27-29)
LATENT_PRETRAIN_OVERRIDES = dict(
    model="ResCNN", method="base", num_epochs=10, batch_size=32,
    lr_max=0.00089, n_fraction=1.0, seed_data=3, seed=1, op="adam",
    valid=False,
)
#: the split depth whose features are each model's embedding
EMBED_DEPTH = {"ResCNN": 5, "resnet9": 3, "FCN": 4, "Potes": 1}


def latent_pretrain_config(cfg):
    """The frozen embedder's run config for ``cfg``'s environment.

    Built fresh from the defaults, so the run is the canonical one: only
    environment fields (the dataset's geometry, the experiments root, the
    loader mode, the devices) come from ``cfg``; every field the run-dir
    name does not encode keeps its default."""
    from pcgmix_tpu_torch.train.loop import TrainConfig

    if cfg.spectrogram:
        raise ValueError(
            "closestknn/closestbins pairing is a 1-D surface; the reference "
            "has no 2-D latent-space model (augmentations2d.py has no "
            "closest* branches)"
        )
    return TrainConfig(
        dataset=cfg.dataset,
        num_channels=cfg.num_channels,
        num_classes=cfg.num_classes,
        sample_rate=cfg.sample_rate,
        experiments_root=cfg.experiments_root,
        loader_parity=cfg.loader_parity,
        n_devices=cfg.n_devices,
        eval_batch_size=cfg.eval_batch_size,
        device=cfg.device,
        compute_dtype=cfg.compute_dtype,
        save_artifacts=True,  # the checkpoint is the artifact
        **LATENT_PRETRAIN_OVERRIDES,
    )


def latent_space_for(cfg, sig_len: int) -> "LatentSpace":
    """The canonical frozen embedder of ``cfg``'s experiments root, for
    inputs of ``sig_len`` steps; raises FileNotFoundError naming its
    ``model.pth`` when that run has not been trained."""
    dep = latent_pretrain_config(cfg)
    path = require_checkpoint(
        experiment_dir(dep),
        "(closestknn/closestbins) pairing (latent_space.py:27-29; the runner "
        "trains it first, or pass latent_feature_fn to train_model)",
    )
    return LatentSpace(path, num_channels=cfg.num_channels, sig_len=sig_len,
                       num_classes=cfg.num_classes, device=cfg.device)


class LatentSpace:
    """A frozen embedder: ``model_name``'s split forward at its embedding
    depth (ResCNN: the pooled depth-5 features, (B, 128)), in eval mode.

    It pickles as what builds it, with its device's type: a spawned
    data-parallel rank loads the checkpoint onto its own card.  Embeddings
    are per row, so a rank embeds its block of a batch."""

    def __init__(self, checkpoint_path: str, model_name: str = "ResCNN",
                 num_channels: int = 4, sig_len: int = 2500, num_classes: int = 2,
                 device="cuda"):
        from pcgmix_tpu_torch.models import build_model
        from pcgmix_tpu_torch.saliency import load_weights

        self._args = (checkpoint_path, model_name, num_channels, sig_len, num_classes)
        self.model = build_model(model_name, num_classes, num_channels, sig_len)
        self.model.load_state_dict(load_weights(checkpoint_path))
        self.model.to(device).eval()
        self.device = torch.device(device)
        self.depth = EMBED_DEPTH.get(model_name, 5)

    def __reduce__(self):
        return type(self), (*self._args, self.device.type)

    @torch.no_grad()
    def generate(self, data) -> np.ndarray:
        """(B, D) embeddings of a batch (a tensor, or an array moved to the
        embedder's device) (generate_latent_space, latent_space.py:43-47)."""
        x = torch.as_tensor(data, device=self.device)
        return self.model(x, depth=self.depth, part="first").cpu().numpy()


def save_latent_space(dct: dict, split: str, step: int, results_dir: str) -> None:
    """Dump a {'fts', 'target'} dict to
    latent_space/latent_space_<split>_<step>.pkl (latent_space.py:49-52)."""
    d = utils.check_folder(os.path.join(results_dir, "latent_space"))
    utils.save_dict(dct, os.path.join(d, f"latent_space_{split}_{step}.pkl"))


@torch.no_grad()
def get_hidden_features(model, ds, *, batch_size: int = 256, device="cuda"):
    """Whole-split features: (fts, trgts, confs, indcs) (latent_space.py:66-90)
    — the ``part='latent_space'`` features and the full forward's logits as
    the confidence head, as the JAX package computes them (the reference's
    'hidden_rep' parts are implemented by none of its models).  ``model``
    runs in eval mode; ``ds`` has ``.data`` and ``.label``."""
    from pcgmix_tpu_torch.train.steps import eval_mode

    fts_l, confs_l = [], []
    n = len(ds.data)
    with eval_mode(model):
        for start in range(0, n, batch_size):
            x = torch.as_tensor(ds.data[start : start + batch_size], device=device)
            fts_l.append(model(x, depth=0, part="latent_space").cpu().numpy())
            confs_l.append(model(x).cpu().numpy())
    fts = np.concatenate(fts_l) if fts_l else np.zeros((0, 0))
    confs = np.concatenate(confs_l) if confs_l else np.zeros((0, 0))
    return fts, list(np.asarray(ds.label)), confs, list(range(n))

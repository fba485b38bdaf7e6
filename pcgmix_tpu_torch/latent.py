"""Latent space (counterpart: ``pcgmix_tpu/latent.py``; reference
latent_space.py).

A frozen pretrained ResCNN embeds batches as its depth-5 features (B, 128)
(latent_space.py:43-47) for the closestknn/closestbins pairings; the
training loop's ``latent_space`` option dumps the embeddings of each
augmented batch (train_model.py:508-518).  The canonical embedder is the
reference's hardcoded run (latent_space.py:27-29): ResCNN, ``base``, 10
epochs at batch 32, n_fraction 1.0, lr 0.00089, seed_data 3, seed 1;
:func:`latent_space_for` loads its ``model.pth`` and the runner trains it
first when it is missing.

The latent-space plots (latent_space.py:92-311) reduce the features to two
dimensions, by PCA (``dim_reduc_pca``: an exact decomposition on the card
in float64) or t-SNE (``dim_reduc_tsne``: ``manifold.tsne`` on the card),
and scatter each class with its centroid and medoid as a 600 × 600 PNG
drawn by ``exp.raster``.  Each plot has a ``*_figure`` description.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.exp.dirs import experiment_dir, require_checkpoint
from pcgmix_tpu_torch.exp.raster import Axes, Figure, Series, save

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


def dim_reduc_tsne(fts: np.ndarray, fts_new: np.ndarray, num_components: int = 2,
                   device="cuda"):
    """Joint t-SNE of the original and augmented features
    (latent_space.py:92-106): scikit-learn's ``TSNE(num_components,
    learning_rate="auto", init="random", perplexity=min(15, n − 1),
    random_state=4)`` as ``manifold.tsne`` computes it; (originals, new
    points, −1.0).  The JAX function also seeds numpy's global generator;
    this one leaves it alone."""
    from pcgmix_tpu_torch.manifold import tsne

    n = len(fts)
    both = np.concatenate([fts, fts_new], axis=0)
    emb = tsne(both, num_components, perplexity=min(15, len(both) - 1), device=device)
    return emb[:n], emb[n:], -1.0


def dim_reduc_pca(fts: np.ndarray, fts_new: np.ndarray, num_components: int = 2,
                  device="cuda"):
    """PCA fitted on the originals, both transformed (latent_space.py:108-118):
    (originals, new points — ``zeros((0, k))`` without any — and the sum of
    the explained-variance ratios), in float64 on ``device``.

    The components come from the exact eigendecomposition of the smaller
    Gram matrix of the centred originals (their covariance, or X Xᵀ where
    there are fewer rows than features), with scikit-learn 1.9's sign rule
    (``svd_flip(u_based_decision=False)``: each component's entry of largest
    magnitude positive); scikit-learn's ``svd_solver="auto"`` takes
    ``covariance_eigh``, ``full`` or a ``randomized`` approximation of the
    same decomposition by the data's shape."""
    from pcgmix_tpu_torch.train.loop import resolve_device

    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(fts), device=dev).double()
    n, d = x.shape
    if not 0 < num_components <= min(n, d):
        raise ValueError(f"n_components={num_components} must be between 1 and "
                         f"min(n_samples, n_features)={min(n, d)}")
    mean = x.mean(0)
    centred = x - mean
    if n >= d:
        values, vectors = torch.linalg.eigh(centred.T @ centred)
        top = vectors[:, -num_components:].flip(1).T
    else:
        values, vectors = torch.linalg.eigh(centred @ centred.T)
        top = (centred.T @ vectors[:, -num_components:].flip(1)).T
        top = top / torch.linalg.vector_norm(top, dim=1, keepdim=True)
    biggest = top.abs().argmax(dim=1, keepdim=True)
    components = top * torch.sign(top.gather(1, biggest))
    ratio = values.flip(0)[:num_components].clamp(min=0) / (centred * centred).sum()

    def transform(a):
        return (a @ components.T - mean[None, :] @ components.T).cpu().numpy()

    new = (transform(torch.as_tensor(np.asarray(fts_new), device=dev).double())
           if len(fts_new) else np.zeros((0, num_components)))
    return transform(x), new, float(ratio.sum())


def _targets(features: dict, *keys):
    """The first of ``keys`` that ``features`` holds, as an array."""
    return np.asarray(next(features[k] for k in keys if k in features))


def medoid(points: np.ndarray) -> int:
    """The point whose Euclidean distances to the others sum least
    (float64, summed over the rows in order, as
    ``scipy.spatial.distance_matrix(...).sum(axis=0)``)."""
    points = np.asarray(points, dtype=np.float64)
    total = np.zeros(len(points))
    for row in points:
        total += np.sqrt(((points - row) ** 2).sum(axis=-1))
    return int(np.argmin(total))


def _classes(fts, trgts, num_classes, colors, marker, alpha, tag) -> list:
    """Each class's scatter with its centroid "x" and its medoid's label
    (the body of the reference's three plots)."""
    series = []
    for lbl, color in zip(range(num_classes), colors):
        pts = fts[np.asarray(trgts) == lbl]
        if len(pts) == 0:
            continue
        med = medoid(pts)
        series += [
            Series("scatter", pts[:, 0], pts[:, 1], color, label=f"{lbl}{tag}", marker=marker,
                   size=30, hollow=True, alpha=alpha),
            Series("scatter", np.array([pts[:, 0].mean()]), np.array([pts[:, 1].mean()]),
                   color, marker="x"),
            Series("annotate", x=pts[med, 0], y=pts[med, 1], text=str(lbl)),
        ]
    return series


def _figure(series: list, title: str) -> Figure:
    return Figure(600, 600, [Axes(series=series, title=title, legend=True, grid=True)])


def _reduce(dim_reduc, fts, fts_new, device):
    reduce = dim_reduc_tsne if dim_reduc == "tsne" else dim_reduc_pca
    return reduce(fts, fts_new, device=device)


def latent_space_figure(latent_features: dict, split: str, epoch: int, num_classes: int,
                        method: str, dim_reduc: str = "pca", device="cuda") -> Figure:
    """The originals (and, for a method other than ``base``, the augmented
    points) reduced to two dimensions, min/max-normalized by the
    originals, each class with its centroid and medoid
    (latent_space.py:134-195).  ``latent_features``: ``fts`` with
    ``target`` (the training loop's dump) or ``trgts``, optionally
    ``fts_new`` and ``trgts_new``; without ``fts_new`` the originals are
    embedded alone."""
    fts = np.asarray(latent_features["fts"])
    trgts = _targets(latent_features, "target", "trgts")
    has_new = "fts_new" in latent_features
    if has_new:
        trgts_new = np.asarray(latent_features.get("trgts_new", trgts))
        fts, fts_new, expl = _reduce(dim_reduc, fts, np.asarray(latent_features["fts_new"]),
                                     device)
    else:
        fts, _, expl = _reduce(dim_reduc, fts, fts[:0], device)
        fts_new, trgts_new = fts, trgts
    lo = fts.min(axis=0)
    rng = fts.max(axis=0) - lo
    rng[rng == 0] = 1.0
    fts, fts_new = (fts - lo) / rng, (fts_new - lo) / rng
    series = _classes(fts, trgts, num_classes, ("red", "blue"), "o", 0.15, "")
    if method != "base":
        series += _classes(fts_new, trgts_new, num_classes, ("darkred", "darkblue"), "P", 1.0,
                           "_new")
    return _figure(series, f"{dim_reduc}; Data: {split}; Total explained variance: "
                           f"{round(expl, 3)}; Epoch: {epoch}")


def plot_latent_space(latent_features: dict, split: str, epoch: int, num_classes: int,
                      method: str, results_dir: str, dim_reduc: str = "pca",
                      device="cuda") -> str:
    """``latent_space_figure`` written to
    ``latent_space/{dim_reduc}_{split}_{epoch}.png`` under ``results_dir``;
    returns its path."""
    fig = latent_space_figure(latent_features, split, epoch, num_classes, method, dim_reduc,
                              device)
    out_dir = utils.check_folder(os.path.join(results_dir, "latent_space"))
    return save(fig, os.path.join(out_dir, f"{dim_reduc}_{split}_{epoch}.png"))


def plot_latent_space_test(latent_features: dict, split: str, epoch: int, num_classes: int,
                           method: str, results_dir: str, dim_reduc: str = "tsne",
                           device="cuda") -> str:
    """The test set's cloud alone (latent_space.py:197-240):
    ``plot_latent_space`` of its ``fts`` and targets as ``base``.
    ``method`` is taken and not read, as in the reference."""
    feats = {"fts": np.asarray(latent_features["fts"]),
             "trgts": _targets(latent_features, "target", "trgts")}
    return plot_latent_space(feats, split, epoch, num_classes, "base", results_dir, dim_reduc,
                             device)


def latent_space_test_train_figures(latent_features_test: dict,
                                    latent_features_train: dict, split: str, epoch: int,
                                    num_classes: int, dim_reduc: str = "tsne",
                                    device="cuda") -> tuple[Figure, Figure]:
    """The test ``fts`` and the train ``fts_new`` reduced together,
    normalized by their joint min/max, as two figures: the test cloud
    (o marks) and the train cloud (P marks, the dark palette)
    (latent_space.py:242-311)."""
    fts_test, fts_train, expl = _reduce(dim_reduc, np.asarray(latent_features_test["fts"]),
                                        np.asarray(latent_features_train["fts_new"]), device)
    trgts_test = _targets(latent_features_test, "target", "trgts")
    trgts_train = _targets(latent_features_train, "trgts_new", "target")
    lo = np.minimum(fts_test.min(axis=0), fts_train.min(axis=0))
    rng = np.maximum(fts_test.max(axis=0), fts_train.max(axis=0)) - lo
    rng[rng == 0] = 1.0
    figs = []
    for tag, fts, trgts, colors, marker in (
            ("test", (fts_test - lo) / rng, trgts_test, ("red", "blue"), "o"),
            ("train", (fts_train - lo) / rng, trgts_train, ("darkred", "darkblue"), "P")):
        figs.append(_figure(
            _classes(fts, trgts, num_classes, colors, marker, 0.05, f" {tag}"),
            f"{dim_reduc}; Data: {split}({tag}); Total explained variance: "
            f"{round(expl, 3)}; Epoch: {epoch}"))
    return tuple(figs)


def plot_latent_space_test_train(latent_features_test: dict, latent_features_train: dict,
                                 split: str, epoch: int, num_classes: int, method: str,
                                 results_dir: str, dim_reduc: str = "tsne",
                                 device="cuda") -> tuple[str, str]:
    """``latent_space_test_train_figures`` written as
    ``latent_space/{dim_reduc}_{split}(test)_{epoch}.png`` and
    ``…(train)_{epoch}.png``; returns both paths.  ``method`` is not read,
    as in the reference."""
    figs = latent_space_test_train_figures(latent_features_test, latent_features_train,
                                           split, epoch, num_classes, dim_reduc, device)
    out_dir = utils.check_folder(os.path.join(results_dir, "latent_space"))
    return tuple(save(fig, os.path.join(out_dir, f"{dim_reduc}_{split}({tag})_{epoch}.png"))
                 for tag, fig in zip(("test", "train"), figs))

"""Input-gradient saliency (counterpart: ``pcgmix_tpu/saliency.py``;
reference saliency.get_saliency_maps (saliency.py:20-116),
saliency.saliency_map (:132-202), bin_tensor (:118-130)).

A map is |∂ score_correct / ∂ x|, zero at and after the row's last frame,
summed over channels (and a spectrogram's frequency rows), smoothed with a
Gaussian and scaled to [0, 1] per row.  The gradient is
``torch.autograd.grad`` of the correct-class score sum with respect to the
input alone, with the model in eval mode: BatchNorm reads its running
statistics and updates nothing, no parameter's ``.grad`` is touched, and
every module gets its own training flag back afterwards.

Two users: the ``(salopt…)`` displacement search takes maps of a
pretrained checkpoint of the same configuration, which
:func:`make_pretrained_saliency_fn` loads once (``model.pth`` of the run
the runner trains first); ``saliency-cutmix`` takes the live model's map
binned per heart-sound segment (:func:`training_saliency_bins`).  The
smoothing and scaling run on the model's device; the binning is host work.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from pcgmix_tpu_torch.exp.dirs import require_checkpoint
from pcgmix_tpu_torch.ops.masks import zero_after
from pcgmix_tpu_torch.train.steps import eval_mode

#: salopt_model index → the pretrained run's method (saliency.py:26-37);
#: the runner's dependency DAG trains exactly the run the provider loads
SALOPT_PRETRAIN_METHODS: dict[int, str] = {
    0: "base", 1: "durratiomixup", 2: "durmixmagwarp(0.2,4)",
}
SEGMENT_BINS = (1, 4, 1, 8)  # S1, systole, S2, diastole (saliency.py:177-196)


def gaussian_kernel(n: int = 11, sigma: float = 1.0) -> np.ndarray:
    """Unnormalized Gaussian taps over [-n//2, n//2] (saliency.py:15-18)."""
    r = np.arange(-(n // 2), n // 2 + 1, dtype=np.float64)
    return (1.0 / (sigma * math.sqrt(2 * math.pi)) * np.exp(-(r**2) / (2 * sigma**2))).astype(
        np.float32
    )


def _smooth_same(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """'same' 1-D correlation of (B, T) rows with ``kernel``, padded
    (n//2, (n−1)//2) as XLA's conv."""
    n = kernel.shape[0]
    k = torch.from_numpy(kernel).to(x.device)[None, None, :]
    return F.conv1d(F.pad(x[:, None, :], (n // 2, (n - 1) // 2)), k)[:, 0, :]


def _normalize01(x: torch.Tensor) -> torch.Tensor:
    x = x - x.amin(dim=-1, keepdim=True)
    x = x / x.amax(dim=-1, keepdim=True)
    return torch.nan_to_num(x, nan=0.0)


def _saliency_core(model, data: torch.Tensor, target_ohe: torch.Tensor, end, n: int,
                   sigma: float, post_zero_tail: bool = True) -> torch.Tensor:
    """|∂score_correct/∂x| → tail-zero → channel sum → Gaussian smooth →
    (tail-zero) → per-row 0–1 scaling (saliency.py:53-91); (B, T) fp32."""
    target_hard = F.one_hot(target_ohe.argmax(dim=1), target_ohe.shape[1]).to(data.dtype)
    with eval_mode(model), torch.enable_grad():
        x = data.detach().requires_grad_(True)
        score = (model(x) * target_hard).sum()
        (g,) = torch.autograd.grad(score, x)
    g = zero_after(g.abs().reshape(g.shape[0], -1, g.shape[-1]), end)
    sal = _smooth_same(g.sum(dim=1).float(), gaussian_kernel(n, sigma))
    if post_zero_tail:
        sal = zero_after(sal, end)
    return _normalize01(sal)


def _ends(frames, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(frames)[:, -1].astype(np.int64)).to(device)


def saliency_maps(model, data: torch.Tensor, target_ohe: torch.Tensor, frames,
                  dim: int = 1, gauss_k_n: int = 101) -> np.ndarray:
    """(B, T) smoothed, normalized saliency maps (get_saliency_maps,
    saliency.py:20-116): kernel n = 101, σ = 12 in 1-D; for spectrograms
    (``dim`` 2) the frequency axis sums with the channels (saliency.py:96-97)
    and the kernel is n = 11, σ = 1."""
    n = gauss_k_n if dim == 1 else 11
    sigma = (12.0 / 101.0) * gauss_k_n if dim == 1 else 1.0
    sal = _saliency_core(model, data, target_ohe, _ends(frames, data.device), n, sigma)
    return sal.cpu().numpy()


def load_weights(path: str) -> dict:
    """A ``model.pth`` state dict, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def make_pretrained_saliency_fn(
    cfg, checkpoint_dir_for: Callable[[str], str]
) -> Callable[[int], Callable]:
    """The (salopt…) saliency provider: ``provider(salopt_model)`` returns
    ``fn(data, target_ohe, frames) → (B, T)`` maps under the pretrained run
    ``checkpoint_dir_for(method)`` names (the same configuration with its
    method swapped to 'base', or for the '-1'/'-2' variants the robust
    'durratiomixup' / 'durmixmagwarp(0.2,4)' run; saliency.py:26-37).  Its
    ``model.pth`` loads once per provider (raising, with the path, when it
    is missing); the model is built for the first batch's shape on the
    batch's device and kept in eval mode.  It is built without the run's
    ``compute_dtype``, as the JAX package builds it (``saliency.py:122``):
    float32 whatever the run computes in.  The live saliency of
    ``saliency-cutmix`` uses the run's own model.

    The provider pickles as ``cfg`` and ``checkpoint_dir_for`` (which must
    pickle, a module-level function or a ``functools.partial`` of one), so
    each spawned data-parallel rank loads the checkpoint itself; maps are
    per row, so a rank takes its block of the batch."""
    return _PretrainedSaliency(cfg, checkpoint_dir_for)


class _PretrainedSaliency:
    """See :func:`make_pretrained_saliency_fn`."""

    def __init__(self, cfg, checkpoint_dir_for: Callable[[str], str]):
        self.cfg, self.checkpoint_dir_for = cfg, checkpoint_dir_for
        self._fns: dict = {}

    def __getstate__(self) -> dict:
        return {"cfg": self.cfg, "checkpoint_dir_for": self.checkpoint_dir_for}

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["cfg"], state["checkpoint_dir_for"])

    def __call__(self, salopt_model: int) -> Callable:
        if salopt_model not in self._fns:
            self._fns[salopt_model] = self._load(salopt_model)
        return self._fns[salopt_model]

    def _load(self, salopt_model: int) -> Callable:
        from pcgmix_tpu_torch.models import build_model

        cfg = self.cfg
        method = SALOPT_PRETRAIN_METHODS[salopt_model]
        state = load_weights(require_checkpoint(
            self.checkpoint_dir_for(method), f"(salopt…) with the {method!r} saliency model"))
        built = {}

        def fn(data, target_ohe, frames):
            key = (tuple(data.shape[1:]), data.device)
            if key not in built:
                freq = data.shape[-2] if cfg.spectrogram else None
                model = build_model(cfg.model, cfg.num_classes, data.shape[1], data.shape[-1],
                                    dataset=cfg.dataset, freq=freq)
                model.load_state_dict(state)
                built[key] = model.to(data.device).eval()
            return saliency_maps(built[key], data, target_ohe, frames,
                                 dim=2 if cfg.spectrogram else 1)

        return fn


def _interp_downsample(x: np.ndarray, bins: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False) downsample of a
    1-D array to ``bins`` values (bin_tensor, saliency.py:122-123)."""
    L = len(x)
    if L == 0:
        return np.zeros(bins, x.dtype)
    pos = (np.arange(bins) + 0.5) * (L / bins) - 0.5
    pos = np.clip(pos, 0, L - 1)
    return np.interp(pos, np.arange(L), x)


def training_saliency_raw(model, data: torch.Tensor, target_ohe: torch.Tensor,
                          end) -> torch.Tensor:
    """The live model's smoothed saliency map, (B, T) on its device: the
    reference's in-training kernel is the last of three successive
    assignments, n = 57, σ = 7.54 (saliency.py:154-157), and the tail is not
    zeroed again after smoothing (saliency.py:158-166)."""
    end = torch.as_tensor(np.asarray(end, np.int64), device=data.device)
    return _saliency_core(model, data, target_ohe, end, 57, 7.54, post_zero_tail=False)


def bin_training_saliency(sal: np.ndarray, frames: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment binning of saliency maps (saliency.py:177-196): each of
    S1, systole, S2 and diastole downsampled linearly to 1, 4, 1 and 8
    bins; a bin's start is its segment's start plus j·ceil(L/bins).
    Returns (bin_values (B, 14), bin_frames (B, 15))."""
    B = sal.shape[0]
    nbins = sum(SEGMENT_BINS)
    bin_values = np.zeros((B, nbins), np.float32)
    bin_frames = np.zeros((B, nbins + 1), np.int64)
    for i in range(B):
        col = 0
        for k, nb in enumerate(SEGMENT_BINS):
            seg = sal[i, frames[i, k] : frames[i, k + 1]]
            vals = _interp_downsample(seg, nb)
            L = len(seg)
            samples_per_bin = int(np.ceil(L / nb)) if L else 0
            for j in range(nb):
                bin_values[i, col] = vals[j]
                bin_frames[i, col] = frames[i, k] + j * samples_per_bin
                col += 1
        bin_frames[i, -1] = frames[i, 4]
    return bin_values, bin_frames


def training_saliency_bins(model, data: torch.Tensor, target_ohe: torch.Tensor,
                           frames) -> tuple[np.ndarray, np.ndarray]:
    """``saliency-cutmix``'s bins of the live model (saliency.py:132-202):
    (bin_values (B, 14), bin_frames (B, 15))."""
    frames = np.asarray(frames)
    sal = training_saliency_raw(model, data, target_ohe, frames[:, -1])
    return bin_training_saliency(sal.cpu().numpy(), frames)

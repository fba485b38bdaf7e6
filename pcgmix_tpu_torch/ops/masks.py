"""Mask-style augmentation ops (counterpart: ``pcgmix_tpu/ops/masks.py``
and the spectrogram masks of ``pcgmix_tpu/augment/engine.py::
_apply_mask_2d``).

The reference zeroes slices per sample in Python loops
(augmentations.py:823-827 timemask, :1595-1614 cutout, :1628-1632
s1s2mask; augmentations2d.py:322-325, :455-458 on spectrograms); here each
is one ``where`` over the time axis, the frequency axis, or their box.  These are plain
tensor functions: the JAX package computes them in XLA outside any Pallas
kernel.
"""

from __future__ import annotations

import torch


def interval_mask(sig_len: int, start, stop, device=None) -> torch.Tensor:
    """(..., T) boolean mask that is True on [start, stop).

    ``start``/``stop`` may carry leading batch dims; they broadcast against
    the trailing time axis.
    """
    start = torch.as_tensor(start, device=device)
    stop = torch.as_tensor(stop, device=start.device)
    t = torch.arange(sig_len, dtype=torch.int64, device=start.device)
    return (t >= start.long()[..., None]) & (t < stop.long()[..., None])


def _per_sample(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (B, T) mask shaped to broadcast over a (B, ..., T) batch."""
    return mask.reshape(mask.shape[0], *([1] * (ndim - 2)), mask.shape[-1])


def time_mask(data: torch.Tensor, start, stop) -> torch.Tensor:
    """Zero data[..., start:stop) per sample; data (B, C, T), start/stop (B,),
    or (B, C) for a window per channel (``cutout(ch)``)."""
    mask = interval_mask(data.shape[-1], start, stop, data.device)
    if mask.dim() == 2:
        mask = _per_sample(mask, data.ndim)
    return torch.where(mask, torch.zeros((), dtype=data.dtype, device=data.device), data)


def s1s2_mask(data: torch.Tensor, frames) -> torch.Tensor:
    """Zero the S1 and S2 regions per sample (augmentations.py:1628-1632);
    data (B, C, T), frames (B, 5)."""
    frames = torch.as_tensor(frames, device=data.device)
    T = data.shape[-1]
    mask = (interval_mask(T, frames[:, 0], frames[:, 1])
            | interval_mask(T, frames[:, 2], frames[:, 3]))[:, None, :]
    return torch.where(mask, torch.zeros((), dtype=data.dtype, device=data.device), data)


def zero_after(data: torch.Tensor, end) -> torch.Tensor:
    """Zero everything at/after per-sample index ``end`` on the time axis
    (keeps zero-padded tails zero after additive transforms, e.g. gaussian
    noise, augmentations.py:1076); data (B, ..., T), end (B,)."""
    end = torch.as_tensor(end, device=data.device).long()
    t = torch.arange(data.shape[-1], dtype=torch.int64, device=data.device)
    keep = _per_sample(t[None, :] < end[:, None], data.ndim)
    return torch.where(keep, data, torch.zeros((), dtype=data.dtype, device=data.device))


def _band(data: torch.Tensor, start, stop) -> torch.Tensor:
    """(F,) mask of the frequency rows [start, stop) of a (..., F, T) batch."""
    f = torch.arange(data.shape[-2], dtype=torch.int64, device=data.device)
    start = torch.as_tensor(start, device=data.device)
    stop = torch.as_tensor(stop, device=data.device)
    return (f >= start) & (f < stop)


def freq_mask(data: torch.Tensor, start, stop) -> torch.Tensor:
    """Zero the frequency rows [start, stop), one band for the whole batch;
    data (B, C, F, T), start/stop scalars."""
    band = _band(data, start, stop)[:, None]
    return torch.where(band, torch.zeros((), dtype=data.dtype, device=data.device), data)


def box_mask(data: torch.Tensor, t_start, t_stop, f_start, f_stop) -> torch.Tensor:
    """Zero the box of the time window [t_start, t_stop) per sample and the
    frequency band [f_start, f_stop) shared by the batch (2-D cutout);
    data (B, C, F, T), t_start/t_stop (B,), f_start/f_stop scalars."""
    window = _per_sample(interval_mask(data.shape[-1], t_start, t_stop, data.device),
                         data.ndim)
    box = window & _band(data, f_start, f_stop)[:, None]
    return torch.where(box, torch.zeros((), dtype=data.dtype, device=data.device), data)

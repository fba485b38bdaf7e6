"""Mel spectrograms with librosa-0.9.2 semantics, on the tensor's device
(counterpart: ``pcgmix_tpu/ops/spectrogram.py``).

The reference builds its spectrogram datasets with
``librosa.feature.melspectrogram(y, sr, n_mels, fmin, fmax, hop_length,
n_fft=4·hop)`` and ``librosa.power_to_db(ref=np.max)``: a centred,
reflect-padded STFT with a periodic Hann window → power → a slaney-scale,
slaney-normalized mel filterbank → 10·log10 against the spectrogram's own
max, floored 80 dB below its top.  The window and the filterbank are numpy
(bit-equal to the JAX package's); the STFT is ``torch.fft.rfft`` and the
filterbank product a float32 matmul with TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pcgmix_tpu_torch.ops.filtering import strict_fp32


def hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann window (librosa's default STFT window)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # log(0) of f = 0, in the branch not taken
        return np.where(
            f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels
        )


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr: float, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (n_mels, 1 + n_fft//2)."""
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # slaney area normalization
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def stft_power(y: torch.Tensor, n_fft: int, hop_length: int,
               center: bool = True) -> torch.Tensor:
    """|STFT|² with librosa's conventions: win_length = n_fft, a periodic
    Hann window, centred with reflect padding (the edge sample not
    repeated).  y: (..., T) → (..., 1 + n_fft//2, 1 + (T' − n_fft)//hop),
    T' the padded length."""
    lead = y.shape[:-1]
    if center:
        pad = n_fft // 2
        y = F.pad(y.reshape(1, -1, y.shape[-1]), (pad, pad), mode="reflect")
        y = y.reshape(*lead, y.shape[-1])
    segs = y.unfold(-1, n_fft, hop_length)  # (..., frames, n_fft)
    win = torch.from_numpy(hann_periodic(n_fft)).to(y.device, y.dtype)
    power = torch.fft.rfft(segs * win, dim=-1).abs().square()
    return power.transpose(-1, -2)  # (..., freq, frames)


def melspectrogram(y: torch.Tensor, sr: float, n_mels: int, fmin: float, fmax: float,
                   hop_length: int, n_fft: int | None = None) -> torch.Tensor:
    """librosa.feature.melspectrogram (power 2) on ``y``'s device; the
    reference uses n_fft = 4·hop.  The filterbank product is full float32
    (the JAX package's ``Precision.HIGHEST``), TF32 off on a card."""
    strict_fp32(y.device)
    n_fft = n_fft or 4 * hop_length
    power = stft_power(y, n_fft, hop_length)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(y.device)
    return torch.matmul(fb, power)


def power_to_db(s: torch.Tensor, amin: float = 1e-10, top_db: float = 80.0) -> torch.Tensor:
    """librosa.power_to_db(S, ref=np.max) with the max taken per
    spectrogram, over the trailing (freq, time) axes: a batch of
    spectrograms keeps one reference and one floor each."""
    dims = (-2, -1)
    ref = torch.amax(s, dim=dims, keepdim=True)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    floor = torch.amax(log_spec, dim=dims, keepdim=True) - top_db
    return torch.maximum(log_spec, floor)

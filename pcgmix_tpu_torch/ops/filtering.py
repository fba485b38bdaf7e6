"""Zero-phase IIR filtering and polyphase resampling, the offline builder's
signal path (counterpart: ``pcgmix_tpu/ops/filtering.py``): a 4th-order
zero-phase Butterworth band-pass per band, RMS normalization, then
resampling to 1 kHz.

Filter design and application delegate to scipy on the host, in float64,
as the JAX package does: scipy is the parity target of the reference's
preprocessing, so the host path is bit-equal to it by definition.  The
polyphase resampler :func:`resample_poly` runs on the tensor's device as a
zero-stuffed strided ``conv1d`` (the JAX package's
``lax.conv_general_dilated``).
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F


def strict_fp32(device) -> None:
    """On a card, float32 means float32: cuDNN convolutions default to TF32
    on Hopper (float32 matmuls do not, unless asked); turn both off, as
    ``train/loop.py`` does."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


@functools.lru_cache(maxsize=32)
def butter_bandpass(lo: float, hi: float, fs: float, order: int = 4):
    """Butterworth band-pass (b, a) from scipy's design routine (host)."""
    from scipy.signal import butter

    # a band edge at Nyquist (the 25-1000 band at fs=2000) is clipped just
    # below it: the digital design requires Wn < 1
    hi = min(hi, 0.999 * fs / 2.0)
    b, a = butter(order, [lo, hi], btype="bandpass", fs=fs)
    return np.asarray(b), np.asarray(a)


def filtfilt(b: np.ndarray, a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Zero-phase filtering with scipy.signal.filtfilt's defaults
    (padtype='odd', padlen=3·max(len(a), len(b))) along the last axis, in
    float64 on the host, cast back to the input's dtype.  x: (..., T) with
    T > padlen."""
    from scipy.signal import filtfilt as _scipy_filtfilt

    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError(f"signal length {x.shape[-1]} must exceed padlen {padlen}")
    y = _scipy_filtfilt(b, a, np.asarray(x, np.float64), axis=-1)
    return y.astype(np.asarray(x).dtype)


def bandpass_filtfilt(x: np.ndarray, lo: float, hi: float, fs: float,
                      order: int = 4) -> np.ndarray:
    """The 4th-order zero-phase Butterworth band-pass that the reference's
    wavs were preprocessed with ('raw_filtBandIIR(ZP)4-{band}')."""
    b, a = butter_bandpass(lo, hi, fs, order)
    return filtfilt(b, a, x)


def rms_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Unit RMS along ``dim`` (the '_normRMS' step), on the tensor's device."""
    rms = torch.sqrt(torch.mean(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(rms, min=eps)


def rms_normalize_host(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """NumPy twin of :func:`rms_normalize` for the host builder path."""
    rms = float(np.sqrt(np.mean(np.square(x))))
    return x / max(rms, eps)


def resample_poly_host(y: np.ndarray, up: int, down: int) -> np.ndarray:
    """scipy's polyphase resample on the host: float64 compute, float32
    out; the corpus builds' stand-in for librosa.resample."""
    from scipy.signal import resample_poly as _scipy_resample

    g = gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == down == 1:
        return np.asarray(y, np.float32)
    return _scipy_resample(np.asarray(y, np.float64), up, down).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _resample_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly's default FIR prototype: a kaiser(β=5)
    windowed sinc with its cutoff at min(up, down)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    return firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Polyphase resampling along the last axis as
    scipy.signal.resample_poly(x, up, down) computes it (kaiser β=5
    prototype, zero padding), on the tensor's device: zero-stuff by
    ``up``, one strided ``conv1d`` with the centred filter, keep
    ceil(n·up/down) outputs."""
    g = gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x
    strict_fp32(x.device)
    h = _resample_filter(up, down) * up
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    half = (len(h) - 1) // 2
    x2 = x.reshape(-1, 1, n_in)
    stuffed = x.new_zeros((x2.shape[0], 1, n_in * up))
    stuffed[..., ::up] = x2
    # centre the filter as scipy does; the right pad is generous, the exact
    # outputs are sliced below
    stuffed = F.pad(stuffed, (half, len(h)))
    weight = torch.from_numpy(h[::-1].copy()).to(x.device, x.dtype)[None, None, :]
    y = F.conv1d(stuffed, weight, stride=down)[..., :n_out]
    return y.reshape(*x.shape[:-1], n_out)

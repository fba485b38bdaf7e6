"""The audio-feature primitives the reference gets from librosa / pywt /
antropy, in numpy and scipy (counterpart: ``pcgmix_tpu/classical/dsp.py``):
framed RMS, spectral centroid/bandwidth/flatness/rolloff/contrast/poly,
chroma, MFCC, zero crossings, sample entropy, and a db4 wavelet
decomposition.  Conventions follow librosa 0.9.2 (centered frames, reflect
padding, periodic Hann) and pywt's 'symmetric' mode so values track the
reference's extractor closely; chroma uses tuning=0 instead of librosa's
signal-estimated tuning (the chroma features are discarded by the
reference's own feature filter, classical.py:1446).  Sample entropy is
the C++ scan of :mod:`pcgmix_tpu_torch.native`, which raises where it
cannot be built.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.fft import dct

from pcgmix_tpu_torch import native
from pcgmix_tpu_torch.ops.spectrogram import hann_periodic, mel_filterbank


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int,
                 pad_mode: str = "reflect") -> np.ndarray:
    """Centered frames, librosa-style padding: (frame_length, n_frames).

    np.pad 'reflect' handles pad > len(y) via repeated reflection for any
    len(y) >= 2 — exactly what librosa.stft does for short segments; only a
    length-<2 signal needs the constant fallback."""
    pad = frame_length // 2
    if pad_mode == "reflect" and len(y) < 2:
        pad_mode = "constant"
    ypad = np.pad(y, pad, mode=pad_mode)
    n_frames = 1 + (len(ypad) - frame_length) // hop_length
    idx = np.arange(frame_length)[:, None] + hop_length * np.arange(n_frames)[None, :]
    return ypad[idx]


def stft_mag(y: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    """|STFT| with librosa conventions: (1 + n_fft//2, n_frames)."""
    frames = frame_signal(y.astype(np.float64), n_fft, hop_length)
    win = hann_periodic(n_fft)[:, None]
    return np.abs(np.fft.rfft(frames * win, axis=0))


def rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """librosa.feature.rms: per-frame root-mean-square.  Unlike the STFT
    path, rms center-pads with ZEROS (librosa 0.9.2 pad_mode='constant' —
    the reference's classical.py:879-883 relies on that)."""
    frames = frame_signal(
        y.astype(np.float64), frame_length, hop_length, pad_mode="constant"
    )
    return np.sqrt(np.mean(frames**2, axis=0))


def zero_crossings(y: np.ndarray, threshold: float = 1e-10) -> int:
    """Count of sign changes (librosa.zero_crossings(y).sum() semantics:
    the boolean array's first element is always False)."""
    y = np.asarray(y, np.float64).copy()
    y[np.abs(y) <= threshold] = 0.0
    signs = np.signbit(y)
    return int(np.sum(signs[1:] != signs[:-1]))


def spectral_centroid(y, sr, n_fft, hop_length) -> np.ndarray:
    S = stft_mag(y, n_fft, hop_length)
    freqs = np.linspace(0, sr / 2, S.shape[0])[:, None]
    denom = np.maximum(S.sum(axis=0), 1e-10)
    return (freqs * S).sum(axis=0) / denom


def spectral_bandwidth(y, sr, n_fft, hop_length, p: float = 2.0) -> np.ndarray:
    S = stft_mag(y, n_fft, hop_length)
    freqs = np.linspace(0, sr / 2, S.shape[0])[:, None]
    cent = spectral_centroid(y, sr, n_fft, hop_length)[None, :]
    Snorm = S / np.maximum(S.sum(axis=0, keepdims=True), 1e-10)
    return (Snorm * np.abs(freqs - cent) ** p).sum(axis=0) ** (1.0 / p)


def spectral_flatness(y, n_fft, hop_length, amin: float = 1e-10) -> np.ndarray:
    # librosa floors the POWER spectrum at amin (np.maximum(amin, S**2)),
    # not the magnitude — matters for near-silent frames
    S = np.maximum(stft_mag(y, n_fft, hop_length) ** 2.0, amin)
    gmean = np.exp(np.mean(np.log(S), axis=0))
    return gmean / np.mean(S, axis=0)


def spectral_rolloff(y, sr, n_fft, hop_length, roll_percent: float = 0.85):
    S = stft_mag(y, n_fft, hop_length)
    freqs = np.linspace(0, sr / 2, S.shape[0])
    total = np.cumsum(S, axis=0)
    thresh = roll_percent * total[-1]
    idx = np.argmax(total >= thresh[None, :], axis=0)
    return freqs[idx]


def spectral_contrast(y, sr, n_fft, hop_length, fmin: float = 200.0,
                      n_bands: int = 6, quantile: float = 0.02) -> np.ndarray:
    """librosa.feature.spectral_contrast: per-octave-band peak−valley dB
    contrast; (n_bands+1, n_frames)."""
    S = stft_mag(y, n_fft, hop_length)
    freqs = np.linspace(0, sr / 2, S.shape[0])
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    out = np.zeros((n_bands + 1, S.shape[1]))
    for k in range(n_bands + 1):
        f_low, f_high = octa[k], octa[k + 1]
        current = (freqs >= f_low) & (freqs <= f_high)
        idx = np.flatnonzero(current)
        if len(idx) == 0:
            continue
        if idx[0] > 0:
            current[idx[0] - 1] = True
        sub = np.sort(S[current], axis=0)
        n_q = max(int(quantile * np.sum(current)), 1)
        valley = np.mean(sub[:n_q], axis=0)
        peak = np.mean(sub[-n_q:], axis=0)
        out[k] = np.log10(np.maximum(peak, 1e-10)) - np.log10(
            np.maximum(valley, 1e-10)
        )
    return out


def poly_features(y, sr, n_fft, hop_length, order: int = 1) -> np.ndarray:
    """librosa.feature.poly_features: per-frame polynomial fit coefficients
    of the magnitude spectrum over frequency; (order+1, n_frames)."""
    S = stft_mag(y, n_fft, hop_length)
    freqs = np.linspace(0, sr / 2, S.shape[0])
    return np.polyfit(freqs, S, order)


def chroma_stft(y, sr, n_fft, hop_length, n_chroma: int = 12) -> np.ndarray:
    """Energy-normalized chroma from the power spectrogram with librosa's
    chroma filterbank (tuning fixed at 0)."""
    S = stft_mag(y, n_fft, hop_length) ** 2
    fb = _chroma_filters(sr, n_fft, n_chroma)
    raw = fb @ S
    return raw / np.maximum(raw.max(axis=0, keepdims=True), 1e-10)


@functools.lru_cache(maxsize=8)
def _chroma_filters(sr: float, n_fft: int, n_chroma: int = 12,
                    octwidth: float = 2.0, ctroct: float = 5.0) -> np.ndarray:
    """librosa.filters.chroma with default A440 tuning."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1 : n_fft // 2 + 1]
    frqbins = n_chroma * np.log2(frequencies / (440.0 / 16))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts /= np.maximum(np.sqrt(np.sum(wts**2, axis=0)), 1e-10)
    wts *= np.tile(
        np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
        (n_chroma, 1),
    )
    wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : n_fft // 2 + 1])


def melspectrogram_np(y, sr, n_fft, hop_length, n_mels: int = 128) -> np.ndarray:
    """librosa.feature.melspectrogram defaults (fmin=0, fmax=sr/2, power=2)."""
    S = stft_mag(y, n_fft, hop_length) ** 2
    fb = mel_filterbank(sr, n_fft, n_mels, 0.0, sr / 2.0)
    return fb @ S


def mfcc(y, sr, n_fft, hop_length, n_mfcc: int = 13) -> np.ndarray:
    """librosa.feature.mfcc defaults: dct-II(ortho) of power_to_db(mel)
    with ref=1.0 (power_to_db's default — NOT ref=max, which would shift
    every dB value by the signal's peak energy), amin=1e-10, top_db=80."""
    mel = melspectrogram_np(y, sr, n_fft, hop_length)
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max() - 80.0)
    return dct(db, axis=0, type=2, norm="ortho")[:n_mfcc]


def sample_entropy(y: np.ndarray, order: int = 2) -> float:
    """antropy.sample_entropy defaults: order=2, Chebyshev distance,
    tolerance r = 0.2·std(y); both match counts range over the n−order
    templates (antropy's convention); the C++ scan
    (:func:`pcgmix_tpu_torch.native.sample_entropy`)."""
    y = np.asarray(y, np.float64)
    if len(y) <= order + 1:
        return np.nan
    return native.sample_entropy(y, order, 0.2 * np.std(y, ddof=0))


# Daubechies-4 decomposition filters (standard published coefficients).
_DB4_LO = np.array(
    [
        -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
        -0.18703481171888114, -0.02798376941698385, 0.6308807679295904,
        0.7148465705525415, 0.23037781330885523,
    ]
)
_DB4_HI = np.array(
    [
        -0.23037781330885523, 0.7148465705525415, -0.6308807679295904,
        -0.02798376941698385, 0.18703481171888114, 0.030841381835986965,
        -0.032883011666982945, -0.010597401784997278,
    ]
)


def _dwt_step(y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One DWT level with pywt's 'symmetric' signal extension.

    pywt performs TRUE convolution with dec_lo/dec_hi (not correlation):
    verified against the documented ``pywt.dwt([1,2,3,4], 'db1')`` example,
    whose cD = [-0.7071, -0.7071] only falls out of the unreversed-filter
    direction (the reversed-filter variant flips the detail signs)."""
    flen = len(_DB4_LO)
    pad = flen - 1
    ext = np.concatenate([y[:pad][::-1], y, y[-pad:][::-1]])
    lo = np.convolve(ext, _DB4_LO, mode="valid")[1::2]
    hi = np.convolve(ext, _DB4_HI, mode="valid")[1::2]
    return lo, hi


def wavedec_db4(y: np.ndarray, level: int = 5) -> list[np.ndarray]:
    """pywt.wavedec(y, 'db4', level) equivalent: [cA_n, cD_n, ..., cD_1]."""
    coeffs = []
    approx = np.asarray(y, np.float64)
    for _ in range(level):
        approx, detail = _dwt_step(approx)
        coeffs.append(detail)
    coeffs.append(approx)
    return coeffs[::-1]

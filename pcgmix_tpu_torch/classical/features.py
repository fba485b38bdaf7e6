"""Per-segment feature vector (feature_vector_seg, classical.py:245-1292;
counterpart: ``pcgmix_tpu/classical/features.py``).

Produces the same named features as the reference: duration/BPM ratios,
per-state max amplitudes, Hilbert-envelope integrals and means, Welch PSD
means in 12 bands for RR/systole/diastole, zero crossings, chroma/mel/mfcc
summaries, framed RMS, skew/kurtosis, spectral centroid/bandwidth/contrast/
flatness/rolloff/poly, sample entropy, and db4 DWT detail-coefficient means.

The JAX package returns a pandas Series per segment and a DataFrame per
dataset; the port has no pandas, so a segment's features are an
insertion-ordered ``dict`` (the Series' index, in its order: the 5 meta
keys, then the features), a dataset's are the list of those rows, and
:func:`write_csv` writes what ``pd.DataFrame(rows).to_csv(path,
index=False)`` writes.
"""

from __future__ import annotations

import csv
import warnings
from typing import Iterable

import numpy as np
from scipy import stats
from scipy.signal import hilbert, welch

from pcgmix_tpu_torch.classical import dsp

FS = 1000
N_FFT = 256
HOP = 64
PSD_BANDS = [
    (25, 40), (40, 60), (60, 80), (80, 100), (100, 120), (120, 140),
    (140, 160), (160, 180), (180, 200), (200, 250), (250, 300), (300, 400),
]
STATES = ("RR", "S1", "Sys", "S2", "Dia")


def _envelope(x: np.ndarray) -> np.ndarray:
    return np.abs(hilbert(x))


def _band_means(freqs: np.ndarray, psd: np.ndarray) -> list[float]:
    out = []
    for lo, hi in PSD_BANDS:
        sel = psd[(lo <= freqs) & (freqs <= hi)]
        out.append(float(np.mean(sel)) if len(sel) else np.nan)
    return out


def feature_vector_seg(
    data: np.ndarray,
    label: int,
    frames: np.ndarray,
    wav: str,
    sig_qual: int,
    segment: int,
    split: str,
) -> dict:
    """One heart-cycle segment (wide 25-400 band) → {feature name: value},
    in the JAX package's order."""
    rr = np.asarray(data[: frames[-1]], np.float64)
    s1 = np.asarray(data[: frames[1]], np.float64)
    sys_ = np.asarray(data[frames[1] : frames[2]], np.float64)
    s2 = np.asarray(data[frames[2] : frames[3]], np.float64)
    dia = np.asarray(data[frames[3] : frames[4]], np.float64)
    parts = {"RR": rr, "S1": s1, "Sys": sys_, "S2": s2, "Dia": dia}

    vec: dict = {}
    vec["class"] = label
    vec["wav"] = wav
    vec["segment"] = segment
    vec["sig_qual"] = sig_qual
    vec["split"] = split

    # durations (ms at 1 kHz) and ratios (classical.py:256-283)
    dur = {k: int(len(v) * 1000 / FS) for k, v in parts.items()}
    vec["BPM"] = round(60000 / dur["RR"], 4)
    for k in STATES:
        vec[f"Dur_{k}"] = dur[k]
    for a, b in [("S1", "RR"), ("Sys", "RR"), ("S2", "RR"), ("Dia", "RR"),
                 ("S1", "S2"), ("Sys", "Dia"), ("Sys", "S1"), ("Dia", "S2")]:
        vec[f"Dur_Ratio_{a}{b}"] = round(dur[a] / dur[b], 4)

    # max amplitudes + ratios (classical.py:285-304)
    mx = {k: float(np.max(parts[k])) for k in ("S1", "Sys", "S2", "Dia")}
    for k, v in mx.items():
        vec[f"MaxAmp_{k}"] = v
    for a, b in [("S1", "S2"), ("Sys", "S1"), ("Sys", "S2"), ("Dia", "S1"),
                 ("Dia", "S2"), ("Sys", "Dia")]:
        vec[f"MaxAmp_Ratio_{a}{b}"] = round(mx[a] / mx[b], 4)

    # Hilbert-envelope integrals (dx=5 trapezoids) and means (classical.py:306-356)
    env = {k: _envelope(v) for k, v in parts.items()}
    integral = {k: float(np.trapezoid(e, dx=5)) for k, e in env.items()}
    meanenv = {k: float(np.mean(e)) for k, e in env.items()}
    for a, b in [("S1", "RR"), ("Sys", "RR"), ("S2", "RR"), ("Dia", "RR"),
                 ("S1", "S2"), ("Sys", "Dia"), ("Sys", "S1"), ("Dia", "S2")]:
        vec[f"EnvInt_Ratio_{a}{b}"] = round(integral[a] / integral[b], 4)
    vec["MeanEnv_RR"] = meanenv["RR"]  # drives segment pruning
    for a, b in [("S1", "RR"), ("Sys", "RR"), ("S2", "RR"), ("Dia", "RR"),
                 ("S1", "S2"), ("Sys", "Dia"), ("Sys", "S1"), ("Dia", "S2")]:
        vec[f"MeanEnv_Ratio_{a}{b}"] = meanenv[a] / meanenv[b]

    # Welch PSD band means for RR / systole / diastole (classical.py:358-638)
    for key in ("RR", "Sys", "Dia"):
        with warnings.catch_warnings():
            # a state shorter than Welch's 256-sample segment takes its own
            # length as the segment, as scipy says for each such state
            warnings.filterwarnings("ignore", "nperseg=256 is greater", UserWarning)
            freqs, psd = welch(parts[key], FS)
        for (lo, hi), m in zip(PSD_BANDS, _band_means(freqs, psd)):
            vec[f"PSD_{key}_{lo}_{hi}Hz"] = m

    # zero crossings (classical.py:645-654)
    for k in STATES:
        vec[f"ZC_{k}"] = dsp.zero_crossings(parts[k])

    # chroma / mel first-band means (classical.py:656-799; only band 1 of
    # each lands in the vector, classical.py:1101-1111)
    for k in STATES:
        vec[f"chroma_stft1_{k}"] = float(
            np.mean(dsp.chroma_stft(parts[k], FS, N_FFT, HOP)[0])
        )
    for k in STATES:
        vec[f"melspectrogram1_{k}"] = float(
            np.mean(dsp.melspectrogram_np(parts[k], FS, N_FFT, HOP)[0])
        )

    # 13 MFCCs per state (classical.py:801-876)
    for k in STATES:
        m = dsp.mfcc(parts[k], FS, N_FFT, HOP, n_mfcc=13)
        for j in range(13):
            vec[f"mfcc{j + 1}_{k}"] = float(np.mean(m[j]))

    # framed RMS + ratios (classical.py:878-891)
    rm = {k: float(np.mean(dsp.rms(parts[k], N_FFT, HOP))) for k in STATES}
    for k in STATES:
        vec[f"RMS_{k}"] = rm[k]
    for a, b in [("S1", "RR"), ("Sys", "RR"), ("S2", "RR"), ("Dia", "RR"),
                 ("Sys", "S1"), ("Dia", "S2"), ("Sys", "Dia"), ("S1", "S2")]:
        vec[f"RMS_Ratio_{a}{b}"] = round(rm[a] / rm[b], 4)

    # shape statistics (classical.py:893-905)
    for k in STATES:
        vec[f"Skewness_{k}"] = float(stats.skew(parts[k]))
    for k in STATES:
        vec[f"Kurtosis_{k}"] = float(stats.kurtosis(parts[k]))

    # spectral summaries (classical.py:907-982)
    for k in STATES:
        vec[f"SpecCentroid_{k}"] = float(
            np.mean(dsp.spectral_centroid(parts[k], FS, N_FFT, HOP))
        )
    for k in STATES:
        vec[f"SpecBandwidth_{k}"] = float(
            np.mean(dsp.spectral_bandwidth(parts[k], FS, N_FFT, HOP))
        )
    for k in STATES:
        sc = dsp.spectral_contrast(parts[k], FS, N_FFT, HOP, fmin=25, n_bands=5)
        for j in range(1, 5):  # bands 2..5 (classical.py:1217-1240)
            vec[f"SpecContrast{j + 1}_{k}"] = float(np.mean(sc[j]))
    for k in STATES:
        vec[f"SpecFlatness_{k}"] = float(
            np.mean(dsp.spectral_flatness(parts[k], N_FFT, HOP))
        )
    for k in STATES:
        vec[f"SpecRolloff_{k}"] = float(
            np.mean(dsp.spectral_rolloff(parts[k], FS, N_FFT, HOP))
        )
    for k in STATES:
        vec[f"PolyFeatures_{k}"] = float(
            np.mean(dsp.poly_features(parts[k], FS, N_FFT, HOP)[0])
        )

    # sample entropy (classical.py:984-989)
    for k in STATES:
        vec[f"SE_{k}"] = dsp.sample_entropy(parts[k])

    # db4 DWT detail means, levels 5..1 (classical.py:991-1001, :1266-1290)
    for k in STATES:
        coeffs = dsp.wavedec_db4(parts[k], level=5)  # [cA5, cD5, ..., cD1]
        for lvl in range(5, 0, -1):
            vec[f"dwt{lvl}_{k}"] = float(np.mean(coeffs[6 - lvl]))
    return vec


def extract_features(
    dataset: dict,
    splits: Iterable[str] = ("train", "test"),
    band: str = "25-400",
    start_counter: int = 0,
    skip: Iterable[int] = (),
    save_path: str | None = None,
) -> list[dict]:
    """Extract features for a whole dataset dict (extract_features_python,
    classical.py:62-113) as a list of rows: segment counters restart per
    recording; a skip list guards degenerate cycles; periodic CSV
    checkpoints via save_path."""
    skip = set(skip)
    rows = []
    counter = 0
    for split in splits:
        d = dataset[split]
        w_last, segment = "", 0
        for sig, label, frames, wav, sq in zip(
            d["data"][band], d["label"], d["frames"], d["wav"], d["sig_qual"]
        ):
            counter += 1
            segment = segment + 1 if wav == w_last else 0
            w_last = wav
            if counter in skip or counter < start_counter:
                continue
            rows.append(
                feature_vector_seg(sig, label, frames, wav, sq, segment, split)
            )
            if save_path and counter % 2000 == 0:
                write_csv(rows, save_path)
    if save_path:
        write_csv(rows, save_path)
    return rows


def _csv_field(v) -> str:
    """A value as pandas' ``to_csv`` writes it: integers and strings as
    they are, floats by ``repr`` (numpy's shortest round-trip form), NaN
    and None as an empty field."""
    if v is None:
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def write_csv(rows: list[dict], path: str) -> None:
    """Write feature rows as ``pd.DataFrame(rows).to_csv(path,
    index=False)`` does: a header of the columns in order of first
    appearance, one line per row, a missing value as an empty field."""
    columns: dict = {}
    for row in rows:
        columns.update(dict.fromkeys(row))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for row in rows:
            w.writerow([_csv_field(row.get(c)) for c in columns])

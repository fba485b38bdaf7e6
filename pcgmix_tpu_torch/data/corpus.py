"""Real-corpus ingestion front-ends for the offline databuilder
(counterpart: ``pcgmix_tpu/data/corpus.py``).

Reproduces the reference's notebook-driven dataset builds from a corpus
laid out exactly like its PhysioNet-2016 / UMC trees (databuilder.ipynb;
reference README.md:80-110):

  PhysioNet root (databuilder.ipynb cells 5-7, 21, 23, 25-26)::

    validation/REFERENCE.csv                          # rec,class → test split
    annotations/updated/training-{a..f}/REFERENCE_withSQI.csv
    annotations/hand_corrected/training-{s}_StateAns/{wav}_StateAns.mat
    annotations/springer_alg/training-{s}-Aut/{wav}_StateAns0.mat
    training-{s}/raw/{wav}.wav                        # raw (spectrogram build)
    training-{s}/raw_filtBandIIR(ZP)4-{band}_normRMS/
        {wav}_filtBandIIR(ZP)4-{band}_normRMS.wav     # pre-filtered (1-D build)

  UMC root (cells 3, 12, 14)::

    {DKMP_OLD,DKMP_UMC,RKMP_OLD,RKMP_UMC}/segments/{rec}_*.txt
    {dataset}/raw/{rec}.wav
    {dataset}/raw_filtBandIIR(ZP)4-{band}_normRMS/{rec}_filt...normRMS.wav

The hardcoded per-channel train statistics the reference bakes into its
notebook cells ship here as named constants and are applied by default.
Every behavioral quirk of the notebook is kept on purpose (1-based .mat
frame values used as-is, ndarray.resize truncation of over-long cycles,
transition-only UMC state streams, the opposite UMC label polarity of the
1-D and spectrogram builds) — the goal is that a dataset built from a real
corpus is distribution-identical to a reference-built one.

Known deviations (documented, intentional):
  - recordings whose annotation file is missing are skipped with a warning
    (the reference's updated CSVs already exclude them; a raw PhysioNet
    mirror may not — reference README.md:90 names e00001/e00032/e00039/
    e00044 as excluded-for-missing-segmentation),
  - UMC recordings are visited in sorted filename order (the reference uses
    filesystem glob order, which is unspecified; row order differs at most
    within a dataset directory, and all downstream splits key on ids/wavs),
  - wav decoding is scipy.io.wavfile + polyphase resampling rather than
    librosa/resampy (windowed-sinc in both; not bit-identical).

The 1-D builds are host work (scipy, as the JAX package's); the two
spectrogram builds compute each recording's mel spectrogram and its dB
scale on ``device`` (the card unless ``device="cpu"``), one recording per
call, and add the time of that part to :mod:`pcgmix_tpu_torch.timing`'s
"mel spectrogram".
"""

from __future__ import annotations

import csv
import os
import warnings
from typing import Sequence

import numpy as np
import torch

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.ops.filtering import resample_poly_host
from pcgmix_tpu_torch.ops.spectrogram import melspectrogram, power_to_db
from pcgmix_tpu_torch.timing import timed

# ---------------------------------------------------------------------------
# Hardcoded reference constants (normalization statistics, band lists)
# ---------------------------------------------------------------------------

#: PhysioNet band order and per-channel train stats (databuilder.ipynb cell 21).
PHYSIONET_BANDS: tuple[str, ...] = (
    "25-45", "45-80", "80-200", "200-400", "400-600", "600-1000",
    "25-400", "25-1000",
)
PHYSIONET_PC_MEANS: tuple[float, ...] = (
    -8.522174e-05, -9.561972e-05, -0.0001494191, -0.00080938824,
    -0.0025577587, -0.0001152527, -5.2299594e-05, -1.4092535e-05,
)
PHYSIONET_PC_STDS: tuple[float, ...] = (
    0.09962083, 0.09932303, 0.097970456, 0.095019236,
    0.052084293, 0.004212678, 0.09908513, 0.06640719,
)
PHYSIONET_PC_STATS: dict[str, tuple[float, float]] = {
    b: (m, s)
    for b, m, s in zip(PHYSIONET_BANDS, PHYSIONET_PC_MEANS, PHYSIONET_PC_STDS)
}

#: PhysioNet spectrogram train stats (databuilder.ipynb cell 5).
PHYSIONET_SPEC_STATS: tuple[float, float] = (
    -59.606563568115234, 15.96771240234375,
)

#: UMC band order and per-channel train stats (databuilder.ipynb cell 12).
UMC_BANDS: tuple[str, ...] = ("25-45", "45-80", "80-200", "200-400", "25-400")
UMC_PC_MEANS: tuple[float, ...] = (
    -0.00070414954, -0.00070995715, -0.0015120364, -0.013083812, -0.00044722442,
)
UMC_PC_STDS: tuple[float, ...] = (
    0.10012293, 0.09927997, 0.097917296, 0.11611214, 0.09939657,
)
UMC_PC_STATS: dict[str, tuple[float, float]] = {
    b: (m, s) for b, m, s in zip(UMC_BANDS, UMC_PC_MEANS, UMC_PC_STDS)
}

#: UMC spectrogram train stats by image size (databuilder.ipynb cell 3).
UMC_SPEC_STATS: dict[int, tuple[float, float]] = {
    128: (-71.84363555908203, 13.924535751342773),
    64: (-58.466644287109375, 19.023942947387695),
}

#: UMC noisy / excluded patient ids (databuilder.ipynb cells 3, 12).
UMC_EXCLUDE_NOISY: tuple[str, ...] = (
    "ID_12", "ID_14", "ID_24", "ID_004", "ID_007", "ID_013", "ID_3",
)
UMC_EXCLUDE_BAD: tuple[str, ...] = ("ID_17", "ID_18", "ID_21")

UMC_DATASETS: tuple[str, ...] = ("DKMP_OLD", "DKMP_UMC", "RKMP_OLD", "RKMP_UMC")
PHYSIONET_SUBSETS: tuple[str, ...] = ("a", "b", "c", "d", "e", "f")

STATE_NAMES = ("S1", "systole", "S2", "diastole")


# ---------------------------------------------------------------------------
# Raw IO
# ---------------------------------------------------------------------------

def read_wav(path: str, sr: int | None = None) -> tuple[np.ndarray, int]:
    """Read a .wav into float32 with librosa.load conventions (PCM scaled to
    [-1, 1), channel-mean mono, optional resample to ``sr``).

    Resampling is scipy.signal.resample_poly (polyphase windowed-sinc) where
    librosa 0.9.2 uses resampy 'kaiser_best' — both anti-aliased sinc
    interpolators, equivalent well below the corpus band-pass ripple but not
    bit-identical (the raw corpora are not redistributable, so only
    behavioral parity is testable).
    """
    from scipy.io import wavfile

    native_sr, y = wavfile.read(path)
    if y.dtype == np.int16:
        y = y.astype(np.float32) / 32768.0
    elif y.dtype == np.int32:
        y = y.astype(np.float32) / 2147483648.0
    elif y.dtype == np.uint8:
        y = (y.astype(np.float32) - 128.0) / 128.0
    else:
        y = y.astype(np.float32)
    if y.ndim > 1:
        y = y.mean(axis=1)
    if sr is not None and sr != native_sr:
        y = resample_poly_host(y, sr, native_sr)
        native_sr = sr
    return y, int(native_sr)


def _resize(seg: np.ndarray, n: int) -> np.ndarray:
    """ndarray.resize semantics: truncate or zero-pad to length n (the
    reference's ``seg_y.resize(2500)``, databuilder.ipynb cell 25 — long
    cycles are *truncated and kept*, not dropped)."""
    out = np.zeros(n, np.float32)
    m = min(len(seg), n)
    out[:m] = seg[:m]
    return out


def _read_csv_rows(path: str, n_cols: int) -> list[list[str]]:
    """Header-less reference csv (rec,class[,sig_quality])."""
    rows = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or not row[0].strip():
                continue
            if len(row) < n_cols:
                raise ValueError(f"{path}: expected {n_cols} columns, got {row}")
            rows.append([c.strip() for c in row[:n_cols]])
    return rows


def read_test_wavs(root: str) -> set[str]:
    """validation/REFERENCE.csv → the reference's test split
    (databuilder.ipynb cell 21; reference README.md:88-90)."""
    path = os.path.join(root, "validation", "REFERENCE.csv")
    return {r[0] for r in _read_csv_rows(path, 2)}


def read_subset_reference(root: str, subset: str) -> list[tuple[str, int, int]]:
    """annotations/updated/training-{s}/REFERENCE_withSQI.csv →
    [(wav, label∈{0,1}, sig_qual∈{0,1})] with the reference's -1→0 label
    rewrite (databuilder.ipynb cell 25)."""
    path = os.path.join(
        root, "annotations", "updated", f"training-{subset}",
        "REFERENCE_withSQI.csv",
    )
    out = []
    for rec, cls, sq in _read_csv_rows(path, 3):
        label = int(cls)
        if label == -1:
            label = 0
        out.append((rec, label, int(sq)))
    return out


def load_physionet_annotation(
    root: str, subset: str, wav: str, sig_qual: int
) -> tuple[np.ndarray, list[str]]:
    """Load a StateAns annotation stream: hand-corrected for sig_qual==1,
    Springer-algorithm for sig_qual==0 (databuilder.ipynb cell 25).

    Returns (frames, states) with the .mat's 1-based 2 kHz sample values
    used AS-IS — the reference never converts to 0-based, and parity means
    keeping that.
    """
    from scipy.io import loadmat

    if sig_qual == 1:
        path = os.path.join(
            root, "annotations", "hand_corrected", f"training-{subset}_StateAns",
            f"{wav}_StateAns.mat",
        )
        key = "state_ans"
    elif sig_qual == 0:
        path = os.path.join(
            root, "annotations", "springer_alg", f"training-{subset}-Aut",
            f"{wav}_StateAns0.mat",
        )
        key = "state_ans0"
    else:
        raise ValueError("Signal quality has not been determined!")
    m = loadmat(path)
    return stateans_stream(m[key])


def _scalar(x):
    """Unwrap arbitrarily nested 1-element arrays (the .mat cell nesting the
    reference flattens with iteration_utilities.deepflatten)."""
    while isinstance(x, np.ndarray):
        x = x.ravel()[0]
    return x


def stateans_stream(rows) -> tuple[np.ndarray, list[str]]:
    """(sample, state) StateAns rows → (frames, states).

    The single home for the two reference row conventions (shared by
    corpus-mode and builder.parse_springer_mat): the .mat frame values are
    1-based sample indices used AS-IS (databuilder.ipynb cell 25 never
    subtracts 1), and state cells are stripped of quote/paren wrappers —
    '(N' noise markers become 'N', which the cell-25 noise check still
    catches; without this, wrapped state cells would silently yield zero
    cycles for a recording."""
    frames = np.array([int(_scalar(np.asarray(r[0]))) for r in rows])
    states = [str(_scalar(np.asarray(r[1]))).strip("()'\" ") for r in rows]
    return frames, states


# ---------------------------------------------------------------------------
# Cycle scans (reference-exact)
# ---------------------------------------------------------------------------

def scan_cycle_starts(states: Sequence[str], wav: str = "?") -> list[int]:
    """The cell-25 cycle scan: every S1 with a later S1 starts a candidate
    4-state cycle; cycles containing a noise marker ('N' substring) are
    skipped, any other malformed window raises ('Segment states are not
    correct!').  No first-state skip (that belongs to the 'full' scan,
    cell 23)."""
    starts = []
    for i, state in enumerate(states):
        if state == "S1" and "S1" in states[i + 1:]:
            seg_states = list(states[i : i + 4])
            if "N" in "".join(str(s) for s in seg_states):
                continue
            if seg_states != list(STATE_NAMES):
                raise ValueError(
                    f"{wav}: segment states are not correct at {i}: {seg_states}"
                )
            starts.append(i)
    return starts


def scan_cycle_starts_umc(states: Sequence[float], rec: str = "?") -> list[int]:
    """Cell-14/3 variant on numeric state codes 1..4 (no noise markers in
    the UMC traces; malformed windows raise)."""
    starts = []
    for i, state in enumerate(states):
        if state == 1 and 1 in states[i + 1:]:
            if list(states[i : i + 4]) != [1, 2, 3, 4]:
                raise ValueError(
                    f"{rec}: segment states are not correct at {i}: "
                    f"{states[i:i + 4]}"
                )
            starts.append(i)
    return starts


def umc_transitions(trace: np.ndarray) -> tuple[np.ndarray, list[float]]:
    """Per-sample state trace → (frames, states) at state *transitions* only
    (databuilder.ipynb cell 14: ``np.where(states[:-1] != states[1:]) + 1``).
    The first (always clipped) state run carries no transition and is
    therefore never a cycle start — reference semantics."""
    trace = np.asarray(trace).ravel()
    frames = np.flatnonzero(trace[:-1] != trace[1:]) + 1
    states = [float(trace[f]) for f in frames]
    return frames, states


def _spec_columns(frames: Sequence[int], width: int, n_samples: int) -> list[int]:
    """Annotation frames → spectrogram columns:
    ``round(f * W / len(y))`` (databuilder.ipynb cell 6; python round =
    banker's rounding, matched via np.round)."""
    return [int(np.round(f * width / n_samples)) for f in frames]


def _resolve(device) -> torch.device:
    """``device`` as a torch device; "cuda" without a card raises."""
    from pcgmix_tpu_torch.train.loop import resolve_device

    return resolve_device(str(device))


def _mel_device(device) -> torch.device:
    """The device of a build's mel spectrograms, its context created here,
    outside the timed mel part."""
    device = _resolve(device)
    torch.empty(0, device=device)
    return device


def recording_mel_db(y: np.ndarray, sr: int, n_mels: int, fmin: float, fmax: float,
                     hop: int, device) -> np.ndarray:
    """One recording's mel-power-dB spectrogram (n_mels, frames), computed
    on ``device`` and brought back to the host; its time, the copies
    included, adds to the "mel spectrogram" total of
    :mod:`pcgmix_tpu_torch.timing`."""
    with timed("mel spectrogram"):
        mel = melspectrogram(torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device),
                             sr, n_mels, fmin, fmax, hop_length=hop)
        return power_to_db(mel).cpu().numpy()


# ---------------------------------------------------------------------------
# PhysioNet builds
# ---------------------------------------------------------------------------

def _physionet_band_wav(root: str, subset: str, wav: str, band: str) -> str:
    return os.path.join(
        root, f"training-{subset}", f"raw_filtBandIIR(ZP)4-{band}_normRMS",
        f"{wav}_filtBandIIR(ZP)4-{band}_normRMS.wav",
    )


def _empty_split(bands: Sequence[str] | None) -> dict:
    d: dict = {
        "label": [], "frames": [], "wav": [], "sig_qual": [],
    }
    d["data"] = {b: [] for b in bands} if bands is not None else []
    return d


def _finalize(split: dict, feat_shape: tuple[int, ...]) -> dict:
    """Stack a split's accumulator lists into arrays.  ``feat_shape`` is the
    per-sample data shape — (sig_len,) for 1-D bands, (size, size) for
    spectrograms — so an *empty* split still honors the (N, *feat_shape)
    .dat contract instead of collapsing to (0, 0)."""
    split["label"] = np.asarray(split["label"], np.int64)
    split["frames"] = (
        np.stack(split["frames"]).astype(np.int64)
        if split["frames"] else np.zeros((0, 5), np.int64)
    )
    split["wav"] = np.asarray(split["wav"], object)
    split["sig_qual"] = np.asarray(split["sig_qual"], np.int64)
    empty = np.zeros((0, *feat_shape), np.float32)
    if isinstance(split["data"], dict):
        split["data"] = {
            b: np.stack(v).astype(np.float32) if v else empty
            for b, v in split["data"].items()
        }
    else:
        split["data"] = (
            np.stack(split["data"]).astype(np.float32)
            if split["data"] else empty
        )
    for k in ("id", "excluded"):
        if k in split:
            split[k] = np.asarray(split[k])
    return split


def _iter_physionet(root: str, subsets: Sequence[str]):
    """Yield (subset, wav, label, sig_qual, frames, states) for every
    annotated recording, skipping (with a warning) records whose annotation
    file is absent and subsets without a REFERENCE_withSQI.csv (partial
    corpus mirrors)."""
    for subset in subsets:
        try:
            rows = read_subset_reference(root, subset)
        except FileNotFoundError:
            warnings.warn(f"training-{subset}: no REFERENCE_withSQI.csv, skipped")
            continue
        for wav, label, sig_qual in rows:
            try:
                frames, states = load_physionet_annotation(
                    root, subset, wav, sig_qual
                )
            except FileNotFoundError:
                warnings.warn(
                    f"{wav}: segmentation annotation missing, skipped "
                    "(reference README.md:90 — e00001/e00032/e00039/e00044 "
                    "have no segmentation files)"
                )
                continue
            yield subset, wav, label, sig_qual, frames, states


def build_physionet_1d(
    root: str,
    *,
    bands: Sequence[str] = PHYSIONET_BANDS,
    sig_len: int = 2500,
    stats: dict | None = None,
    subsets: Sequence[str] = PHYSIONET_SUBSETS,
) -> dict:
    """databuilder.ipynb cell 25: the PhysioNet 1-D zero-pad dataset.

    Per subset csv row: annotation → frames//2 (2 kHz → 1 kHz) → cell-25
    cycle scan; per band: pre-filtered wav at 2 kHz → resample to 1 kHz →
    hardcoded per-channel standardization → per-cycle slice → resize(sig_len)
    (zero-pad or truncate).  Returns {'train': …, 'test': …} split by
    validation/REFERENCE.csv.
    """
    stats = PHYSIONET_PC_STATS if stats is None else stats
    test_wavs = read_test_wavs(root)
    train, test = _empty_split(bands), _empty_split(bands)
    for subset, wav, label, sig_qual, raw_frames, states in _iter_physionet(
        root, subsets
    ):
        frames = [f // 2 for f in raw_frames]
        starts = scan_cycle_starts(states, wav)
        if not starts:
            continue
        dest = test if wav in test_wavs else train
        for i in starts:
            seg_frames = np.asarray(frames[i : i + 5], np.int64) - frames[i]
            dest["frames"].append(seg_frames)
            dest["label"].append(label)
            dest["wav"].append(wav)
            dest["sig_qual"].append(sig_qual)
        for band in bands:
            y, _ = read_wav(_physionet_band_wav(root, subset, wav, band), sr=2000)
            y_hat = _resample_2to1(y)
            mu, sd = stats[band]
            y_hat = (y_hat - mu) / sd
            for i in starts:
                seg = y_hat[frames[i] : frames[i + 4]]
                # warn once per cycle, not once per band × cycle
                if band == bands[0] and len(seg) > sig_len:
                    warnings.warn(f"{wav}: cycle at {i} longer than {sig_len}, truncated")
                dest["data"][band].append(_resize(seg, sig_len))
    return {
        "train": _finalize(train, (sig_len,)),
        "test": _finalize(test, (sig_len,)),
    }


def _resample_2to1(y: np.ndarray) -> np.ndarray:
    """The databuilder's librosa.resample(2000→1000) step (polyphase here)."""
    return resample_poly_host(y, 1, 2)


def _resample_4to1(y: np.ndarray) -> np.ndarray:
    return resample_poly_host(y, 1, 4)


def build_physionet_full(
    root: str,
    *,
    bands: Sequence[str] = PHYSIONET_BANDS,
    sig_len: int = 2500,
    max_frames: int = 28,
    stats: dict | None = None,
    subsets: Sequence[str] = PHYSIONET_SUBSETS,
) -> dict:
    """databuilder.ipynb cell 23: the "full" multi-cycle window dataset —
    sig_len-sample windows starting at (non-first) S1 onsets with at least
    sig_len samples left, frames padded to max_frames with −1, no zero tail.
    """
    from pcgmix_tpu_torch.data.builder import scan_full_windows

    stats = PHYSIONET_PC_STATS if stats is None else stats
    test_wavs = read_test_wavs(root)
    train = _empty_split(bands)
    test = _empty_split(bands)
    for subset, wav, label, sig_qual, raw_frames, states in _iter_physionet(
        root, subsets
    ):
        frames = np.asarray([f // 2 for f in raw_frames], np.int64)
        # the window scan needs the 1 kHz signal length; all bands share it,
        # so read/resample bands[0] once and reuse it in the band loop
        y0, _ = read_wav(_physionet_band_wav(root, subset, wav, bands[0]), sr=2000)
        y0_hat = _resample_2to1(y0)
        windows = scan_full_windows(frames, states, len(y0_hat), sig_len, max_frames)
        if not windows:
            continue
        dest = test if wav in test_wavs else train
        for _, wf in windows:
            dest["frames"].append(wf)
            dest["label"].append(label)
            dest["wav"].append(wav)
            dest["sig_qual"].append(sig_qual)
        for band in bands:
            if band == bands[0]:
                y_hat = y0_hat
            else:
                y, _ = read_wav(
                    _physionet_band_wav(root, subset, wav, band), sr=2000
                )
                y_hat = _resample_2to1(y)
            mu, sd = stats[band]
            y_hat = (y_hat - mu) / sd
            for s, _wf in windows:
                dest["data"][band].append(y_hat[s : s + sig_len])
    out = {
        "train": _finalize(train, (sig_len,)),
        "test": _finalize(test, (sig_len,)),
    }
    for split in out.values():
        if len(split["frames"]):
            split["frames"] = split["frames"].reshape(-1, max_frames)
        else:
            split["frames"] = np.zeros((0, max_frames), np.int64)
    return out


def build_physionet_spec(
    root: str,
    *,
    size: int = 128,
    window_seconds: float = 2.2,
    fmin: float = 25.0,
    fmax: float = 1000.0,
    stats: tuple[float, float] | None = None,
    train_wavs: Sequence[str] | None = None,
    subsets: Sequence[str] = PHYSIONET_SUBSETS,
    device: str = "cuda",
) -> dict:
    """databuilder.ipynb cells 5-7: the PhysioNet spectrogram dataset.

    One mel-power-dB spectrogram over the WHOLE raw recording at its native
    rate (hop = int(sr·2.2/size), n_fft = 4·hop, n_mels = size, fmin 25,
    fmax 1000, power_to_db ref=per-recording max), standardized with the
    hardcoded train stats, then sliced per cycle in *spectrogram columns*
    (frames mapped by round(f·W/len(y))) and right-padded to size columns.

    train_wavs: the reference restricts the train side to its published
    nfrac=1.0 recording list (cell 5; shipped as
    'PhysioNet_seed(data)=1100001_nfrac=1.0_valid=False.txt') — pass that
    list (or a path via the CLI) to reproduce it; None keeps every non-test
    recording (selection then happens in the loader).  The mel spectrograms
    run on ``device``.
    """
    device = _mel_device(device)
    mu, sd = PHYSIONET_SPEC_STATS if stats is None else stats
    test_wavs = read_test_wavs(root)
    train_set = set(train_wavs) if train_wavs is not None else None
    train, test = _empty_split(None), _empty_split(None)
    for subset, wav, label, sig_qual, frames, states in _iter_physionet(
        root, subsets
    ):
        in_test = wav in test_wavs
        if train_set is not None and not in_test and wav not in train_set:
            continue  # cell 6: 'if wav not in list(test_wavs) + train_wavs'
        starts = scan_cycle_starts(states, wav)
        if not starts:
            continue
        y, sr = read_wav(os.path.join(root, f"training-{subset}", "raw", f"{wav}.wav"))
        hop = int(sr * window_seconds / size)
        spec_db = recording_mel_db(y, sr, size, fmin, fmax, hop, device)
        spec_db = (spec_db - mu) / sd
        # NOTE: cell 6 maps the *native-rate* annotation frames (no //2 —
        # the spectrogram is computed on the native-rate signal)
        frames_spec = _spec_columns(frames, spec_db.shape[1], len(y))
        dest = test if in_test else train
        for i in starts:
            fs = np.asarray(frames_spec[i : i + 5], np.int64) - frames_spec[i]
            spec = spec_db[:, frames_spec[i] : frames_spec[i + 4]]
            if spec.shape[1] > size:
                warnings.warn(f"{wav}: cycle at {i} wider than {size} columns, truncated")
                spec = spec[:, :size]
            spec = np.pad(spec, ((0, 0), (0, size - spec.shape[1])))
            dest["data"].append(spec.astype(np.float32))
            dest["frames"].append(fs)
            dest["label"].append(label)
            dest["wav"].append(wav)
            dest["sig_qual"].append(sig_qual)
    return {
        "train": _finalize(train, (size, size)),
        "test": _finalize(test, (size, size)),
    }


# ---------------------------------------------------------------------------
# UMC builds
# ---------------------------------------------------------------------------

def _iter_umc(root: str, datasets: Sequence[str] = UMC_DATASETS):
    """Yield (dataset, rec, id, sig_qual, excluded, seg_path) per recording.

    Names come from the segments/*.txt basenames: OLD sets use the first two
    '_' fields, UMC sets the first three; patient id is 'ID_{first field}'
    (databuilder.ipynb cell 14).  Sorted for determinism (the reference
    relies on unspecified glob order).
    """
    import glob as _glob

    for dataset in datasets:
        seg_paths = sorted(
            _glob.glob(os.path.join(root, dataset, "segments", "*.txt"))
        )
        for seg_path in seg_paths:
            base = os.path.basename(seg_path)
            parts = base.split("_")
            n = 2 if dataset.endswith("_OLD") else 3
            rec = "_".join(parts[:n])
            idx = f"ID_{parts[0]}"
            sig_qual = 0 if idx in UMC_EXCLUDE_NOISY else 1
            excluded = 0 if idx in UMC_EXCLUDE_BAD else 1
            yield dataset, rec, idx, sig_qual, excluded, seg_path


def build_umc_1d(
    root: str,
    *,
    bands: Sequence[str] = UMC_BANDS,
    sig_len: int = 2000,
    stats: dict | None = None,
    datasets: Sequence[str] = UMC_DATASETS,
) -> dict:
    """databuilder.ipynb cell 14: the UMC 1-D dataset (single dict, split
    later by the hardcoded patient folds).

    Labels: DKMP→0, RKMP→1 — note this is the OPPOSITE of the spectrogram
    build (cell 3) and is itself flipped again by the dataloader's label^1
    (dataloader_umc.py:42).  frames//4 (4 kHz → 1 kHz).
    """
    stats = UMC_PC_STATS if stats is None else stats
    out = _empty_split(bands)
    out["id"], out["excluded"] = [], []
    for dataset, rec, idx, sig_qual, excluded, seg_path in _iter_umc(
        root, datasets
    ):
        label = 0 if dataset.startswith("DKMP") else 1
        trace = np.loadtxt(seg_path)
        frames, states = umc_transitions(trace)
        frames = np.asarray([f // 4 for f in frames], np.int64)
        starts = scan_cycle_starts_umc(states, rec)
        if not starts:
            continue
        for i in starts:
            out["frames"].append(frames[i : i + 5] - frames[i])
            out["label"].append(label)
            out["wav"].append(rec)
            out["id"].append(idx)
            out["sig_qual"].append(sig_qual)
            out["excluded"].append(excluded)
        for band in bands:
            path = os.path.join(
                root, dataset, f"raw_filtBandIIR(ZP)4-{band}_normRMS",
                f"{rec}_filtBandIIR(ZP)4-{band}_normRMS.wav",
            )
            y, _ = read_wav(path, sr=4000)
            y_hat = _resample_4to1(y)
            mu, sd = stats[band]
            y_hat = (y_hat - mu) / sd
            for i in starts:
                seg = y_hat[frames[i] : frames[i + 4]]
                # warn once per cycle, not once per band × cycle
                if band == bands[0] and len(seg) > sig_len:
                    warnings.warn(f"{rec}: cycle at {i} longer than {sig_len}, truncated")
                out["data"][band].append(_resize(seg, sig_len))
    return _finalize(out, (sig_len,))


def build_umc_spec(
    root: str,
    *,
    size: int = 128,
    window_seconds: float = 2.0,
    fmin: float = 25.0,
    fmax: float = 1000.0,
    stats: tuple[float, float] | None = None,
    datasets: Sequence[str] = UMC_DATASETS,
    device: str = "cuda",
) -> dict:
    """databuilder.ipynb cell 3: the UMC spectrogram dataset (2.0 s columns,
    128 or 64 mels, native-rate frames, labels DKMP→1 / RKMP→0); the mel
    spectrograms run on ``device``."""
    device = _mel_device(device)
    mu, sd = UMC_SPEC_STATS[size] if stats is None else stats
    out = _empty_split(None)
    out["id"], out["excluded"] = [], []
    for dataset, rec, idx, sig_qual, excluded, seg_path in _iter_umc(
        root, datasets
    ):
        label = 1 if dataset.startswith("DKMP") else 0
        trace = np.loadtxt(seg_path)
        frames, states = umc_transitions(trace)  # native 4 kHz, no //4
        starts = scan_cycle_starts_umc(states, rec)
        if not starts:
            continue
        y, sr = read_wav(os.path.join(root, dataset, "raw", f"{rec}.wav"))
        hop = int(sr * window_seconds / size)
        spec_db = recording_mel_db(y, sr, size, fmin, fmax, hop, device)
        spec_db = (spec_db - mu) / sd
        frames_spec = _spec_columns(frames, spec_db.shape[1], len(y))
        for i in starts:
            fs = np.asarray(frames_spec[i : i + 5], np.int64) - frames_spec[i]
            spec = spec_db[:, frames_spec[i] : frames_spec[i + 4]]
            if spec.shape[1] > size:
                warnings.warn(f"{rec}: cycle at {i} wider than {size} columns, truncated")
                spec = spec[:, :size]
            spec = np.pad(spec, ((0, 0), (0, size - spec.shape[1])))
            out["data"].append(spec.astype(np.float32))
            out["frames"].append(fs)
            out["label"].append(label)
            out["wav"].append(rec)
            out["id"].append(idx)
            out["sig_qual"].append(sig_qual)
            out["excluded"].append(excluded)
    return _finalize(out, (size, size))


# ---------------------------------------------------------------------------
# Train-list derivation
# ---------------------------------------------------------------------------

def read_train_wavs_file(path: str) -> list[str]:
    """Parse the published recording list
    ('PhysioNet_seed(data)=1100001_nfrac=1.0_valid=False.txt' — one name
    per line, or comma-separated; reference README.md:96-100)."""
    with open(path) as f:
        text = f.read()
    names = [t.strip().strip("'\"") for t in text.replace(",", "\n").split()]
    return [n for n in names if n]


def physionet_train_selection(dataset_1d: dict, **split_kw) -> list[str]:
    """Derive the nfrac=1.0 train recording list from a built 1-D dict by
    running the exact selection pipeline (seed_data=1100001, train_balance,
    no valid split) — reproduces the published list without vendoring it."""
    from pcgmix_tpu_torch.data.physionet import physionet_split

    kw = dict(seed_data=1100001, n_fraction=1.0, train_balance=True, valid=False)
    kw.update(split_kw)
    ds = physionet_split(dataset_1d, "train", **kw)
    seen: dict[str, None] = {}
    for w in ds.wav:
        seen.setdefault(str(w))
    return list(seen)


BUILDERS = {
    "physionet-1d": build_physionet_1d,
    "physionet-full": build_physionet_full,
    "physionet-spec128": lambda root, **kw: build_physionet_spec(root, size=128, **kw),
    "umc-1d": build_umc_1d,
    "umc-spec128": lambda root, **kw: build_umc_spec(root, size=128, **kw),
    "umc-spec64": lambda root, **kw: build_umc_spec(root, size=64, **kw),
}


SPECTROGRAM_KINDS = ("physionet-spec128", "umc-spec128", "umc-spec64")


def build_corpus(kind: str, root: str, out: str, train_wavs: str | None = None,
                 device: str = "cuda"):
    """Run one corpus build and write the zlib-pickled .dat; a spectrogram
    build computes its mel spectrograms on ``device``."""
    device = _resolve(device)
    kw = {"device": device} if kind in SPECTROGRAM_KINDS else {}
    if train_wavs:
        if kind != "physionet-spec128":
            # only the spectrogram build restricts its train side to the
            # published list (databuilder.ipynb cell 6) — dropping the flag
            # silently would fake a successful reproduction
            raise ValueError(
                f"--train-wavs applies only to physionet-spec128 (cell 6's "
                f"'wav not in test_wavs + train_wavs' filter), not {kind!r}"
            )
        kw["train_wavs"] = read_train_wavs_file(train_wavs)
    d = BUILDERS[kind](root, **kw)
    utils.dict2file(d, out)
    n = (
        len(d["label"])
        if "label" in d
        else len(d["train"]["label"]) + len(d["test"]["label"])
    )
    print(f"wrote {out}: {n} cycles ({kind})")
    return d

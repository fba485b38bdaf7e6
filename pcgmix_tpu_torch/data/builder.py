"""Offline databuilder (counterpart: ``pcgmix_tpu/data/builder.py``).

Converts raw recordings + segmentation annotations into packed dataset
dicts with the reference contract (SURVEY.md §2.2).  Mirrors
databuilder.ipynb:

  cell 25 (PhysioNet 1-D): StateAns .mat parsing → complete-cycle starts →
    per-band band-pass/RMS-normalized wavs at 2 kHz → resample to 1 kHz →
    per-channel standardize → cycle slicing → zero-pad to sig_len;
  cells 5-6 (spectrograms): 2.2 s windows → mel-power-dB 128×128 → frames
    rescaled into spectrogram columns → global standardize;
  cell 14 (UMC): per-recording state-trace txt parsing, 4 kHz → 1 kHz.

Filtering and resampling run on the host with scipy (the parity target,
``ops/filtering.py``); the mel spectrograms run on a torch device, the card
unless ``device="cpu"`` or ``--device cpu`` is given
(``ops/spectrogram.py``); parsing and packing is host work.  Raw corpora
are not shipped with the reference; these functions are exercised by
synthetic-input tests and a CLI is provided for real data:

  python -m pcgmix_tpu_torch.data.builder --corpus physionet-spec128 \
      --root <corpus root> --out spec128.dat [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Sequence

import numpy as np

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.data.corpus import (  # shared reference-exact scan primitives
    STATE_NAMES,
    _resize,
    _mel_device,
    _resolve,
    recording_mel_db,
    scan_cycle_starts,
    stateans_stream,
    umc_transitions,
)
from pcgmix_tpu_torch.ops.filtering import (
    butter_bandpass,
    resample_poly_host,
    rms_normalize_host,
)
from pcgmix_tpu_torch.timing import host_times

# The eight band definitions the reference builds (databuilder.ipynb cell 21).
BANDS = {
    "25-45": (25.0, 45.0),
    "45-80": (45.0, 80.0),
    "80-200": (80.0, 200.0),
    "200-400": (200.0, 400.0),
    "400-600": (400.0, 600.0),
    "600-1000": (600.0, 1000.0),
    "25-400": (25.0, 400.0),
    "25-1000": (25.0, 1000.0),
}


def parse_state_sequence(
    frames: np.ndarray, states: Sequence[str], wav: str = "?"
) -> list[np.ndarray]:
    """Scan a (frame, state) annotation stream for complete
    [S1, systole, S2, diastole] cycles, returning one [start, e1, e2, e3, e4]
    frames vector per cycle.

    Delegates to the reference-exact cell-25 scan
    (corpus.scan_cycle_starts): only the 4 cycle states are checked for the
    noise marker — a cycle whose *closing* boundary is the start of a noise
    run is kept, as the reference keeps it — and a malformed window raises
    ('Segment states are not correct!') rather than being silently skipped.

    frames: (K,) sample indices where each state begins; states: (K,) names
    ('S1'/'systole'/'S2'/'diastole', 'N' marks noise).
    """
    frames = np.asarray(frames)
    return [
        frames[i : i + 5].astype(np.int64)
        for i in scan_cycle_starts(list(states), wav)
    ]


def parse_springer_mat(path: str) -> tuple[np.ndarray, list[str]]:
    """Load a PhysioNet StateAns(.mat) annotation: rows of (sample, state).

    Works for both the hand-corrected and Springer-algorithm outputs
    (databuilder.ipynb cell 25 loads 'annotations/hand_corrected/
    *_StateAns.mat' or 'annotations/springer_alg/*_StateAns0.mat').
    """
    from scipy.io import loadmat

    m = loadmat(path, simplify_cells=True)
    key = next(k for k in m if not k.startswith("__"))
    # row semantics (1-based frames used AS-IS, quote/paren stripping) live
    # in one place: corpus.stateans_stream
    return stateans_stream(m[key])


def parse_umc_state_trace(path: str) -> tuple[np.ndarray, list[str]]:
    """UMC per-recording state traces: a text file of per-sample state codes
    1..4 (S1, systole, S2, diastole); state *transitions* become the
    (frame, state) stream (databuilder.ipynb cell 14:
    ``np.where(states[:-1] != states[1:]) + 1`` — the first, always-clipped
    state run carries no transition and is never a cycle start)."""
    trace = np.loadtxt(path).astype(int).ravel()
    bad = (trace < 1) | (trace > 4)
    if bad.any():
        raise ValueError(
            f"{path}: state codes must be 1..4 (S1, systole, S2, diastole); "
            f"found {sorted(set(trace[bad].tolist()))} — unsegmented/noise "
            "samples must be handled upstream, not silently mislabeled"
        )
    frames, codes = umc_transitions(trace)
    states = [STATE_NAMES[int(c) - 1] for c in codes]
    return frames, states


def preprocess_wav(
    y: np.ndarray, sr_in: int, sr_out: int, band: tuple[float, float]
) -> np.ndarray:
    """Band-pass (zero-phase order-4 Butterworth) + RMS normalize at the
    native rate, then resample — the 'raw_filtBandIIR(ZP)4-{band}_normRMS'
    preprocessing plus the databuilder's librosa.resample step.

    Runs entirely on the host via scipy, the parity target itself, as the
    JAX package's does."""
    from scipy.signal import filtfilt as _scipy_filtfilt

    b, a = butter_bandpass(band[0], band[1], sr_in)
    x = _scipy_filtfilt(b, a, np.asarray(y, np.float64)).astype(np.float32)
    x = rms_normalize_host(x)
    if sr_in != sr_out:
        x = resample_poly_host(x, sr_out, sr_in)
    return x


def slice_cycles(
    y: np.ndarray, cycle_frames: Iterable[np.ndarray], sig_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Cut [start, end] windows, re-zero the frame origin, zero-pad to
    sig_len (databuilder.ipynb cell 25's final packing; over-long cycles are
    *truncated and kept* with unclipped frames — the reference's
    ``seg_y.resize(2500)`` semantics, not a drop).

    Returns (cycles (N, sig_len), frames (N, 5))."""
    sigs, frames = [], []
    for f in cycle_frames:
        sigs.append(_resize(y[f[0] : f[4]], sig_len))
        frames.append(f - f[0])
    if not sigs:
        return np.zeros((0, sig_len), np.float32), np.zeros((0, 5), np.int64)
    return np.stack(sigs), np.stack(frames)


def scan_full_windows(
    frames: np.ndarray,
    states: Sequence[str],
    n_samples: int,
    sig_len: int = 2500,
    max_frames: int = 28,
) -> list[tuple[int, np.ndarray]]:
    """The "full" multi-cycle window scan (databuilder.ipynb cell 23).

    For every S1 start (skipping a clipped first state) with at least one
    more S1 after it and sig_len samples of recording left: collect every
    boundary whose offset from the window start is <= sig_len, skip windows
    whose covered states contain a noise marker, shift boundaries to 0 and
    pad to max_frames with −1.

    Returns [(window_start_sample, padded_frames (max_frames,)), ...].
    """
    out = []
    states = list(states)
    for i, (frame, state) in enumerate(zip(frames, states)):
        if i == 0 and state == "S1":
            continue  # first state is always clipped (cell 23)
        if state != "S1" or "S1" not in states[i + 1:]:
            continue
        if n_samples - frame < sig_len:
            continue
        last_i = i
        for j in range(i, len(frames)):
            if frames[j] - frames[i] <= sig_len:
                last_i = j
            else:
                break
        if "N" in "".join(states[i : last_i + 1]):
            continue
        seg_frames = np.asarray(frames[i : last_i + 1], np.int64) - frames[i]
        seg_frames = seg_frames[:max_frames]
        seg_frames = np.pad(
            seg_frames, (0, max_frames - len(seg_frames)), constant_values=-1
        )
        out.append((int(frames[i]), seg_frames))
    return out


def build_full_dataset(
    recordings: dict,
    *,
    sr_in: int = 2000,
    sr_out: int = 1000,
    sig_len: int = 2500,
    max_frames: int = 28,
    bands: Sequence[str] = ("25-45", "45-80", "80-200", "200-400", "25-400"),
    normalize_stats: dict | None = None,
) -> dict:
    """Assemble the PhysioNet "full" multi-cycle dataset dict
    (databuilder.ipynb cell 23): sig_len windows of raw (filtered,
    normalized) recording starting at S1 onsets — no zero tail — with
    frames padded to max_frames using −1."""
    rate = sr_in // sr_out
    data = {b: [] for b in bands}
    labels, frames_out, wavs, sq = [], [], [], []
    for name, rec in recordings.items():
        ann_frames = np.asarray(rec["frames"]) // rate
        per_band = {}
        for b in bands:
            y = preprocess_wav(np.asarray(rec["y"]), sr_in, sr_out, BANDS[b])
            if normalize_stats and b in normalize_stats:
                mu, sd = normalize_stats[b]
                y = (y - mu) / sd
            per_band[b] = y
        n = len(per_band[bands[0]])
        windows = scan_full_windows(
            ann_frames, rec["states"], n, sig_len, max_frames
        )
        if not windows:
            continue
        for b in bands:
            y = per_band[b]
            data[b].append(
                np.stack([y[s : s + sig_len] for s, _ in windows]).astype(
                    np.float32
                )
            )
        labels += [int(rec["label"])] * len(windows)
        frames_out += [f for _, f in windows]
        wavs += [name] * len(windows)
        sq += [int(rec.get("sig_qual", 1))] * len(windows)
    return {
        "data": {
            b: np.concatenate(v) if v else np.zeros((0, sig_len), np.float32)
            for b, v in data.items()
        },
        "label": np.asarray(labels, np.int64),
        "frames": (
            np.stack(frames_out)
            if frames_out
            else np.zeros((0, max_frames), np.int64)
        ),
        "wav": np.asarray(wavs, object),
        "sig_qual": np.asarray(sq, np.int64),
    }


def build_1d_dataset(
    recordings: dict,
    *,
    sr_in: int = 2000,
    sr_out: int = 1000,
    sig_len: int = 2500,
    bands: Sequence[str] = ("25-45", "45-80", "80-200", "200-400", "25-400"),
    normalize_stats: dict | None = None,
) -> dict:
    """Assemble a 1-D dataset dict from raw recordings.

    recordings: {wav_name: {"y": raw mono signal @ sr_in,
                            "frames": annotation frame stream @ sr_in,
                            "states": state names,
                            "label": 0/1, "sig_qual": 0/1}}.
    Annotation frames are divided by sr_in/sr_out like the reference
    (databuilder.ipynb cell 25: frames //2 for 2 kHz→1 kHz).
    normalize_stats: optional {band: (mean, std)} per-channel standardization
    (the reference hardcodes train-set stats, databuilder.ipynb cell 21).
    """
    rate = sr_in // sr_out
    data = {b: [] for b in bands}
    labels, frames_out, wavs, sq = [], [], [], []
    for name, rec in recordings.items():
        cycle_frames = parse_state_sequence(
            np.asarray(rec["frames"]) // rate, rec["states"], wav=name
        )
        if not cycle_frames:
            continue
        per_band = {}
        for b in bands:
            y = preprocess_wav(np.asarray(rec["y"]), sr_in, sr_out, BANDS[b])
            if normalize_stats and b in normalize_stats:
                mu, sd = normalize_stats[b]
                y = (y - mu) / sd
            per_band[b] = y
        fr = None
        for b in bands:
            sigs, fr = slice_cycles(per_band[b], cycle_frames, sig_len)
            data[b].append(sigs)
        n_cycles = fr.shape[0]  # identical across bands (same cycle_frames)
        labels += [int(rec["label"])] * n_cycles
        frames_out += list(fr)
        wavs += [name] * n_cycles
        sq += [int(rec.get("sig_qual", 1))] * n_cycles
    return {
        "data": {b: np.concatenate(v) if v else np.zeros((0, sig_len)) for b, v in data.items()},
        "label": np.asarray(labels, np.int64),
        "frames": np.stack(frames_out) if frames_out else np.zeros((0, 5), np.int64),
        "wav": np.asarray(wavs, object),
        "sig_qual": np.asarray(sq, np.int64),
    }


def build_spectrogram_dataset(
    recordings: dict,
    *,
    sr_in: int = 2000,
    sr_out: int = 1000,
    window_seconds: float = 2.2,
    size: int = 128,
    fmin: float = 25.0,
    fmax: float = 1000.0,
    band: str = "25-1000",
    normalize: tuple[float, float] | None = None,
    device: str = "cuda",
) -> dict:
    """Mel-spectrogram dataset (databuilder.ipynb cells 5-6): per cycle, a
    window_seconds slice from the cycle start → size×size mel-power-dB image;
    frames rescaled into spectrogram columns; optional global standardize
    with train stats (the reference hardcodes mean=−59.6066, std=15.9677 for
    PhysioNet spec128).  Each window's mel spectrogram runs on
    ``device``, one window a call (its dB reference is its own max)."""
    device = _mel_device(device)
    win = int(sr_out * window_seconds)
    hop = int(sr_out * window_seconds / size)
    data, labels, frames_out, wavs, sq = [], [], [], [], []
    for name, rec in recordings.items():
        rate = sr_in // sr_out
        cycle_frames = parse_state_sequence(
            np.asarray(rec["frames"]) // rate, rec["states"], wav=name
        )
        if not cycle_frames:
            continue
        y = preprocess_wav(np.asarray(rec["y"]), sr_in, sr_out, BANDS[band])
        for f in cycle_frames:
            seg = np.zeros(win, np.float32)
            chunk = y[f[0] : min(f[4], f[0] + win)]
            seg[: len(chunk)] = chunk
            spec = recording_mel_db(seg, sr_out, size, fmin, fmax, hop, device)[:, :size]
            if spec.shape[1] < size:
                spec = np.pad(spec, ((0, 0), (0, size - spec.shape[1])))
            if normalize:
                spec = (spec - normalize[0]) / normalize[1]
            data.append(spec.astype(np.float32))
            fr = np.round((f - f[0]) * size / win).astype(np.int64)
            frames_out.append(np.minimum(fr, size))
            labels.append(int(rec["label"]))
            wavs.append(name)
            sq.append(int(rec.get("sig_qual", 1)))
    return {
        "data": np.stack(data) if data else np.zeros((0, size, size), np.float32),
        "label": np.asarray(labels, np.int64),
        "frames": np.stack(frames_out) if frames_out else np.zeros((0, 5), np.int64),
        "wav": np.asarray(wavs, object),
        "sig_qual": np.asarray(sq, np.int64),
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description=(
            "Build packed dataset dicts.  Two modes: --corpus ingests a "
            "reference-layout corpus tree (PhysioNet-2016 / UMC, "
            "databuilder.ipynb parity — pre-filtered band wavs, per-subset "
            "REFERENCE_withSQI.csv, hardcoded train normalization stats "
            "applied by default); the generic mode builds from a flat "
            "directory of raw signals + annotations."
        )
    )
    p.add_argument(
        "--corpus",
        choices=[
            "physionet-1d", "physionet-full", "physionet-spec128",
            "umc-1d", "umc-spec128", "umc-spec64",
        ],
        help="reference-layout corpus build (use with --root)",
    )
    p.add_argument("--root", help="corpus root directory (--corpus mode)")
    p.add_argument(
        "--train-wavs",
        help="recording-list txt restricting the spectrogram train side "
        "(the published nfrac=1.0 list; physionet-spec128 only)",
    )
    p.add_argument("--wav-dir", help="directory of .npy/.wav signals (generic mode)")
    p.add_argument("--ann-dir", help="StateAns .mat / state .txt dir (generic mode)")
    p.add_argument("--labels-csv", help="csv: wav,label,sig_qual (generic mode)")
    p.add_argument("--out", required=True, help="output .dat (zlib pickle)")
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the mel spectrograms ('cpu' only when asked for; "
        "without a card 'cuda' raises)",
    )
    # generic-mode-only flags default to None so --corpus mode can DETECT
    # (and reject) an explicitly passed value instead of silently ignoring
    # it; generic mode resolves the real defaults after parsing
    p.add_argument(
        "--kind", choices=["1d", "full", "spec128", "spec64"], default=None,
        help="generic-mode dataset kind (default: 1d)",
    )
    p.add_argument(
        "--sr-in", type=int, default=None,
        help="generic-mode input sample rate (default: 2000)",
    )
    p.add_argument(
        "--normalize",
        choices=["physionet", "umc", "none"],
        default=None,
        help="per-band standardization stats for generic 1d/full builds — "
        "REQUIRED there: 'physionet'/'umc' apply the reference's hardcoded "
        "train stats (databuilder.ipynb cells 21/12, only correct for data "
        "distributed like that corpus), 'none' leaves bands unstandardized",
    )
    args = p.parse_args(argv)

    if args.corpus:
        from pcgmix_tpu_torch.data import corpus as _corpus

        if not args.root:
            p.error("--corpus requires --root")
        passed_generic = [
            flag
            for flag, val in (
                ("--wav-dir", args.wav_dir), ("--ann-dir", args.ann_dir),
                ("--labels-csv", args.labels_csv), ("--kind", args.kind),
                ("--sr-in", args.sr_in), ("--normalize", args.normalize),
            )
            if val is not None
        ]
        if passed_generic:
            p.error(
                f"{'/'.join(passed_generic)} are generic-mode flags; "
                "--corpus mode reads everything from --root and applies "
                "the reference's hardcoded preprocessing"
            )
        if args.train_wavs and args.corpus != "physionet-spec128":
            # flag-combination mistakes are usage errors; corpus
            # data-integrity errors from build_corpus propagate with their
            # tracebacks intact
            p.error(
                "--train-wavs applies only to physionet-spec128 (cell 6's "
                "'wav not in test_wavs + train_wavs' filter), not "
                f"{args.corpus!r}"
            )
        _resolve(args.device)
        _corpus.build_corpus(args.corpus, args.root, args.out, args.train_wavs,
                             device=args.device)
        _print_times()
        return

    if not (args.wav_dir and args.ann_dir and args.labels_csv):
        p.error("generic mode requires --wav-dir, --ann-dir and --labels-csv")
    if args.normalize is None:
        # explicit choice required: hardcoded corpus train stats are only
        # correct for data distributed like that corpus, so never apply
        # them (or skip them) silently
        p.error(
            "generic mode requires --normalize physionet|umc|none "
            "(hardcoded corpus train stats are only correct for matching "
            "data; pass 'none' to build unstandardized bands)"
        )
    _resolve(args.device)
    args.kind = args.kind or "1d"
    args.sr_in = 2000 if args.sr_in is None else args.sr_in

    import csv

    from pcgmix_tpu_torch.data.corpus import (
        PHYSIONET_PC_STATS, UMC_PC_STATS, read_wav,
    )

    recs = {}
    with open(args.labels_csv) as f:
        for row in csv.DictReader(f):
            name = row["wav"]
            npy_path = os.path.join(args.wav_dir, name + ".npy")
            wav_path = os.path.join(args.wav_dir, name + ".wav")
            if os.path.exists(npy_path):
                y = np.load(npy_path)
            elif os.path.exists(wav_path):
                y, sr = read_wav(wav_path, sr=args.sr_in)
            else:
                raise FileNotFoundError(
                    f"no {name}.npy or {name}.wav under {args.wav_dir}"
                )
            mat = os.path.join(args.ann_dir, name + "_StateAns.mat")
            txt = os.path.join(args.ann_dir, name + ".txt")
            if os.path.exists(mat):
                frames, states = parse_springer_mat(mat)
            else:
                frames, states = parse_umc_state_trace(txt)
            recs[name] = {
                "y": y,
                "frames": frames,
                "states": states,
                "label": int(row["label"]),
                "sig_qual": int(row.get("sig_qual", 1)),
            }
    if args.kind == "1d":
        stats = {
            "physionet": PHYSIONET_PC_STATS, "umc": UMC_PC_STATS, "none": None
        }[args.normalize]
        out = build_1d_dataset(recs, sr_in=args.sr_in, normalize_stats=stats)
    elif args.kind == "full":
        stats = {
            "physionet": PHYSIONET_PC_STATS, "umc": UMC_PC_STATS, "none": None
        }[args.normalize]
        out = build_full_dataset(recs, sr_in=args.sr_in, normalize_stats=stats)
    else:
        from pcgmix_tpu_torch.data.corpus import PHYSIONET_SPEC_STATS, UMC_SPEC_STATS

        size = 128 if args.kind == "spec128" else 64
        spec_stats = {
            # the reference's hardcoded global train stats for each build
            # (databuilder.ipynb cells 5-6 / cell 3)
            "physionet": PHYSIONET_SPEC_STATS,
            "umc": UMC_SPEC_STATS[size],
            "none": None,
        }[args.normalize]
        out = build_spectrogram_dataset(
            recs, sr_in=args.sr_in, size=size, normalize=spec_stats,
            device=args.device,
        )
    utils.dict2file(out, args.out)
    print(f"wrote {args.out}: {len(out['label'])} cycles")
    _print_times()


def _print_times() -> None:
    """The build's timed parts (the mel spectrograms: total ms and calls),
    one JSON line, when it had any."""
    import json

    times = host_times()
    if times:
        print(f"timing: {json.dumps({k: [ms, n] for k, (ms, n) in times.items()})}")


if __name__ == "__main__":
    main()

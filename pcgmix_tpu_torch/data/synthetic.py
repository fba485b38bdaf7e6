"""Synthetic PhysioNet- and UMC-shaped datasets (counterpart:
``pcgmix_tpu/data/synthetic.py::synthetic_physionet_dict``,
``synthetic_effect_dict``, ``synthetic_physionet_full_dict``,
``synthetic_umc_dict`` and ``synthetic_spectrogram_dict``).

Dataset dicts with the exact reference contract — per-band signal arrays,
binary labels, [0, e1, e2, e3, e4] frames, wav names with subset letters,
sig_qual flags — so splits, loaders, augmentation, training and eval run
without the real corpus.  Class 1 ("abnormal") carries a systolic
murmur-like noise burst so models can learn.  The same seed gives the same
arrays as the JAX package's generator.
"""

from __future__ import annotations

import numpy as np

from pcgmix_tpu_torch.data.datasets import MODEL_BANDS, WIDE_BAND
from pcgmix_tpu_torch.data.umc import ALL_PATIENTS


def synthetic_physionet_dict(
    num_wavs_train: int = 40,
    num_wavs_test: int = 12,
    segments_per_wav: int = 4,
    sig_len: int = 2500,
    seed: int = 0,
    subsets: str = "abcdef",
) -> dict:
    rng = np.random.default_rng(seed)
    bands = list(MODEL_BANDS) + [WIDE_BAND]

    def make_split(num_wavs, prefix):
        data = {b: [] for b in bands}
        labels, frames, wavs, sq = [], [], [], []
        for w in range(num_wavs):
            label = int(w % 2)
            # decouple subset letter from label so every (subset, class)
            # bucket is populated and train-balance keeps data
            subset = subsets[(w // 2) % len(subsets)]
            name = f"{subset}{prefix}{w:04d}"
            for _ in range(segments_per_wav):
                # S1, sys, S2, dia length ranges, scaled so the cycle always
                # fits into sig_len (ranges match real PhysioNet at T=2500)
                scale = sig_len / 2500.0
                lo = np.maximum((np.array([80, 150, 60, 300]) * scale), 4).astype(int)
                hi = np.maximum((np.array([140, 350, 120, 700]) * scale), 8).astype(int)
                lens = rng.integers(lo, hi)
                f = np.concatenate([[0], np.cumsum(lens)])
                t = np.arange(f[-1])
                for b_i, b in enumerate(bands):
                    freq = 30.0 + 40.0 * b_i
                    sig = np.zeros(sig_len, np.float32)
                    s1 = np.sin(2 * np.pi * freq * t[: lens[0]] / 1000.0)
                    s2 = np.sin(2 * np.pi * freq * 1.3 * np.arange(lens[2]) / 1000.0)
                    sig[f[0] : f[1]] = 2.0 * s1
                    sig[f[2] : f[3]] = 1.5 * s2
                    sig[: f[4]] += 0.1 * rng.standard_normal(f[4])
                    if label == 1:
                        sig[f[1] : f[2]] += 0.8 * rng.standard_normal(lens[1])
                    data[b].append(sig)
                labels.append(label)
                frames.append(f)
                wavs.append(name)
                sq.append(1 if rng.random() > 0.05 else 0)
        return {
            "data": {
                b: (np.stack(v) if v else np.zeros((0, sig_len), np.float32))
                for b, v in data.items()
            },
            "label": np.array(labels, np.int64),
            "frames": (
                np.stack(frames) if frames else np.zeros((0, 5), np.int64)
            ),
            "wav": np.array(wavs, object),
            "sig_qual": np.array(sq, np.int64),
        }

    return {
        "train": make_split(num_wavs_train, "tr"),
        "test": make_split(num_wavs_test, "te"),
    }


def synthetic_effect_dict(
    num_wavs_train: int = 240,
    num_wavs_test: int = 200,
    segments_per_wav: int = 4,
    sig_len: int = 2500,
    seed: int = 0,
    murmur_amp: float = 0.35,
    confounder_amp: float = 0.8,
    noise_amp: float = 0.25,
    gain_range: tuple = (0.6, 1.4),
    murmur_band: tuple = (120.0, 180.0),
    murmur_amp_spread: tuple = (0.3, 1.7),
) -> dict:
    """Synthetic corpus engineered so segment-aligned mixing provably adds
    information — the scientific-replication fixture.

    The *only* label-reliable feature is a systolic murmur: a Hann-enveloped
    tone burst of amplitude ``murmur_amp`` in the systole window of class-1
    recordings — the mechanism the real PCGmix paper targets (murmurs
    between S1 and S2).  The murmur FREQUENCY is drawn once per RECORDING
    from ``murmur_band`` (phase and a small amplitude jitter are fresh per
    cycle), so a low-``n_fraction`` training subset exposes only a handful
    of points from the band and the model must generalize across it.  The
    murmur AMPLITUDE is likewise per-recording, spread over
    ``murmur_amp_spread × murmur_amp`` — a continuous difficulty axis:
    recordings near the low end sit at/below the noise floor (irreducibly
    hard), the high end is easy, and test accuracy measures where the
    model's detection threshold landed rather than a binary learned/not.
    Everything else is label-INDEPENDENT per-recording nuisance a small-n
    model can memorize:

    * a per-recording gain ``g ~ U[gain_range]`` on the whole signal,
    * a per-recording diastolic tone (random frequency 50-110 Hz — disjoint
      from ``murmur_band`` — random amplitude, random phase) repeated in
      every cycle of that recording,
    * per-recording S1/S2 pitch jitter.

    Why ``durratiomixup`` (reference augmentations.py:289-338) helps here,
    by construction: it blends two same-class recordings *per segment*, so

    * mixed class-1 systoles carry TWO murmur tones from the band — new
      frequency/amplitude combinations the subset never shows vanilla
      training — densifying band coverage exactly where data is scarce,
      and interpolating the per-recording amplitudes ON-manifold (a blend
      of two murmurs is a murmur of intermediate strength), which smooths
      the detection threshold the test set grades;
    * the per-recording confounders appear only in attenuated two-recording
      superpositions, combinatorially harder to memorize;
    * in-band SNR is preserved under blending: tone energies and the noise
      floor shrink by the same lam^2+(1-lam)^2 factor (an earlier white-
      noise-murmur design keyed the class on broadband *energy*, which the
      same shrink pushed off the test manifold — measured to hurt).

    The mix is only label-preserving because it is segment-ALIGNED: the
    murmur never bleeds outside systole.  At ``n_fraction`` 1.0 the band is
    densely covered and the effect fades, matching the paper's low-data
    story.  :mod:`pcgmix_tpu_torch.exp.replicate` runs the grid that
    measures the effect (results_final_full.ipynb cell 4 shape).  The same
    arguments give the same arrays as the JAX package's generator (numpy
    only).
    """
    rng = np.random.default_rng(seed)
    bands = list(MODEL_BANDS) + [WIDE_BAND]

    def make_split(num_wavs, prefix):
        data = {b: [] for b in bands}
        labels, frames, wavs, sq = [], [], [], []
        for w in range(num_wavs):
            label = int(w % 2)
            subset = "abcdef"[(w // 2) % 6]
            name = f"{subset}{prefix}{w:04d}"
            # per-RECORDING nuisance (shared by all cycles of this wav)
            gain = rng.uniform(*gain_range)
            conf_freq = rng.uniform(50.0, 110.0)
            conf_amp = confounder_amp * rng.uniform(0.5, 1.0)
            conf_phase = rng.uniform(0.0, 2 * np.pi)
            s1_freq = 30.0 * rng.uniform(0.85, 1.15)
            s2_freq = s1_freq * 1.3
            # the label-reliable feature: per-recording murmur tone
            # frequency and strength (the continuous difficulty axis)
            m_freq = rng.uniform(*murmur_band)
            m_amp = murmur_amp * rng.uniform(*murmur_amp_spread)
            for _ in range(segments_per_wav):
                scale = sig_len / 2500.0
                lo = np.maximum((np.array([80, 150, 60, 300]) * scale), 4).astype(int)
                hi = np.maximum((np.array([140, 350, 120, 700]) * scale), 8).astype(int)
                lens = rng.integers(lo, hi)
                f = np.concatenate([[0], np.cumsum(lens)])
                murmur = None
                if label == 1:
                    m_t = np.arange(lens[1])
                    env = np.sin(np.pi * (m_t + 0.5) / lens[1]) ** 2
                    murmur = (
                        m_amp * rng.uniform(0.9, 1.1) * env
                        * np.sin(2 * np.pi * m_freq * m_t / 1000.0
                                 + rng.uniform(0.0, 2 * np.pi))
                    )
                base_noise = noise_amp * rng.standard_normal(f[4])
                dia_t = np.arange(lens[3])
                conf = conf_amp * np.sin(
                    2 * np.pi * conf_freq * dia_t / 1000.0 + conf_phase
                )
                for b_i, b in enumerate(bands):
                    jitter = 1.0 + 0.15 * b_i
                    sig = np.zeros(sig_len, np.float32)
                    sig[f[0] : f[1]] = 2.0 * np.sin(
                        2 * np.pi * s1_freq * jitter * np.arange(lens[0]) / 1000.0
                    )
                    sig[f[2] : f[3]] = 1.5 * np.sin(
                        2 * np.pi * s2_freq * jitter * np.arange(lens[2]) / 1000.0
                    )
                    sig[f[3] : f[4]] += conf
                    sig[: f[4]] += base_noise
                    if murmur is not None:
                        sig[f[1] : f[2]] += murmur
                    sig[: f[4]] *= gain
                    data[b].append(sig)
                labels.append(label)
                frames.append(f)
                wavs.append(name)
                sq.append(1)
        return {
            "data": {
                b: (np.stack(v) if v else np.zeros((0, sig_len), np.float32))
                for b, v in data.items()
            },
            "label": np.array(labels, np.int64),
            "frames": (
                np.stack(frames) if frames else np.zeros((0, 5), np.int64)
            ),
            "wav": np.array(wavs, object),
            "sig_qual": np.array(sq, np.int64),
        }

    return {
        "train": make_split(num_wavs_train, "tr"),
        "test": make_split(num_wavs_test, "te"),
    }


def synthetic_physionet_full_dict(
    num_wavs_train: int = 16,
    num_wavs_test: int = 6,
    windows_per_wav: int = 2,
    sig_len: int = 2500,
    max_frames: int = 28,
    seed: int = 0,
) -> dict:
    """The PhysioNet "full" multi-cycle variant (databuilder.ipynb cell 23):
    each row is a whole sig_len window starting at an S1, with no zero
    tail, and ``frames`` lists every segment boundary inside the window,
    padded to ``max_frames`` with −1.  Cycle states run S1 → systole → S2 →
    diastole, so segment k has state k mod 4."""
    rng = np.random.default_rng(seed)
    bands = list(MODEL_BANDS) + [WIDE_BAND]

    def make_split(num_wavs, prefix):
        data = {b: [] for b in bands}
        labels, frames, wavs, sq = [], [], [], []
        for w in range(num_wavs):
            label = int(w % 2)
            name = f"{'abcdef'[(w // 2) % 6]}{prefix}{w:04d}"
            for _ in range(windows_per_wav):
                scale = sig_len / 2500.0
                lo = np.maximum((np.array([80, 150, 60, 300]) * scale), 4).astype(int)
                hi = np.maximum((np.array([140, 350, 120, 700]) * scale), 8).astype(int)
                # draw cycles until the window is over-full, keep the
                # boundaries at offsets <= sig_len (cell 23's last_i scan)
                bounds = [0]
                while bounds[-1] <= sig_len and len(bounds) < max_frames + 8:
                    bounds.extend(bounds[-1] + np.cumsum(rng.integers(lo, hi)))
                f_valid = np.array([b for b in bounds if b <= sig_len][:max_frames],
                                   np.int64)
                if len(f_valid) < 5:
                    raise ValueError("a window must hold one full cycle")
                f = np.pad(f_valid, (0, max_frames - len(f_valid)), constant_values=-1)
                for b_i, b in enumerate(bands):
                    freq = 30.0 + 40.0 * b_i
                    sig = 0.1 * rng.standard_normal(sig_len).astype(np.float32)
                    for k in range(len(f_valid) - 1):
                        s, e = f_valid[k], f_valid[k + 1]
                        seg = np.arange(e - s)
                        if k % 4 == 0:  # S1
                            sig[s:e] += 2.0 * np.sin(2 * np.pi * freq * seg / 1000.0)
                        elif k % 4 == 2:  # S2
                            sig[s:e] += 1.5 * np.sin(2 * np.pi * freq * 1.3 * seg / 1000.0)
                        elif k % 4 == 1 and label == 1:  # systolic murmur
                            sig[s:e] += 0.8 * rng.standard_normal(e - s)
                    data[b].append(sig)
                labels.append(label)
                frames.append(f)
                wavs.append(name)
                sq.append(1)
        return {
            "data": {
                b: (np.stack(v) if v else np.zeros((0, sig_len), np.float32))
                for b, v in data.items()
            },
            "label": np.array(labels, np.int64),
            "frames": (np.stack(frames) if frames
                       else np.zeros((0, max_frames), np.int64)),
            "wav": np.array(wavs, object),
            "sig_qual": np.array(sq, np.int64),
        }

    return {
        "train": make_split(num_wavs_train, "tr"),
        "test": make_split(num_wavs_test, "te"),
    }


def synthetic_umc_dict(
    segments_per_patient: int = 4, sig_len: int = 2000, seed: int = 0
) -> dict:
    """A UMC-shaped dict over the real patient-id universe (so the
    hardcoded folds apply), one level with 'id' and 'excluded'
    (dataloader_umc.py:46-47); every row kept and of good quality."""
    base = synthetic_physionet_dict(
        num_wavs_train=len(ALL_PATIENTS) * 2, num_wavs_test=0,
        segments_per_wav=segments_per_patient, sig_len=sig_len, seed=seed,
    )["train"]
    n = len(base["label"])
    per_patient = 2 * segments_per_patient
    base["id"] = np.array(
        [ALL_PATIENTS[(i // per_patient) % len(ALL_PATIENTS)] for i in range(n)], object
    )
    base["excluded"] = np.ones(n, np.int64)
    base["sig_qual"] = np.ones(n, np.int64)
    return base


def synthetic_spectrogram_dict(
    num_wavs_train: int = 24,
    num_wavs_test: int = 8,
    segments_per_wav: int = 3,
    size: int = 64,
    seed: int = 0,
) -> dict:
    """Spectrogram-shaped dict: data (N, F, T) = (N, size, size) mel-dB-like,
    frames rescaled into spectrogram columns (reference databuilder.ipynb
    cell 6).  Class 1 carries energy in the low bands over systole."""
    rng = np.random.default_rng(seed)

    def make_split(num_wavs, prefix):
        data, labels, frames, wavs, sq = [], [], [], [], []
        for w in range(num_wavs):
            label = int(w % 2)
            name = f"{'abcdef'[(w // 2) % 6]}{prefix}{w:04d}"
            for _ in range(segments_per_wav):
                lens = rng.integers([4, 8, 3, 12], [8, 16, 6, 24])
                f = np.concatenate([[0], np.cumsum(lens)])
                f = np.minimum(f, size)
                spec = rng.standard_normal((size, size)).astype(np.float32) * 0.1
                spec[: size // 3, f[1] : f[2]] += 1.0 * label
                spec[size // 2 :, f[0] : f[1]] += 0.8
                data.append(spec)
                labels.append(label)
                frames.append(f)
                wavs.append(name)
                sq.append(1)
        return {
            "data": (
                np.stack(data) if data else np.zeros((0, size, size), np.float32)
            ),
            "label": np.array(labels, np.int64),
            "frames": np.stack(frames) if frames else np.zeros((0, 5), np.int64),
            "wav": np.array(wavs, object),
            "sig_qual": np.array(sq, np.int64),
        }

    return {
        "train": make_split(num_wavs_train, "tr"),
        "test": make_split(num_wavs_test, "te"),
    }

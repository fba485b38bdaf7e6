"""Synthetic PhysioNet-shaped datasets (counterpart:
``pcgmix_tpu/data/synthetic.py::synthetic_physionet_dict``).

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

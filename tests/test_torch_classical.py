"""The port's classical features (``classical/dsp.py``,
``classical/features.py``, ``native.sample_entropy``) against
``pcgmix_tpu``'s on the same numpy inputs from a seed.

Bars: every dsp primitive bit-equal on the same float64 input (numpy and
scipy on both sides); the feature vector's names and order equal to the
JAX package's ``pd.Series`` index and its values bit-equal (NaN where
NaN); the native sample entropy equal to its plain NumPy loop and to the
JAX package's; the CSV writer's file byte-equal to pandas' ``to_csv`` and
read back by ``pandas.read_csv`` as that file reads back."""

import numpy as np
import pandas as pd
import pytest
import torch

from pcgmix_tpu.classical import dsp as jdsp
from pcgmix_tpu.classical import features as jfeatures
from pcgmix_tpu.data.synthetic import synthetic_physionet_dict
from pcgmix_tpu_torch import native
from pcgmix_tpu_torch.classical import dsp, extract_features, feature_vector_seg, write_csv

FS, N_FFT, HOP = 1000, 256, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _segment(seed: int, n: int = 900):
    """A heart-cycle-like segment: S1/S2 bursts over noise, with its frames."""
    rng = np.random.default_rng(seed)
    t = np.arange(2500) / FS
    y = 0.05 * rng.standard_normal(2500) + 0.3 * np.sin(2 * np.pi * 40 * t)
    frames = np.array([0, n // 8, n // 2, 5 * n // 8, n])
    y[frames[0]:frames[1]] += np.sin(2 * np.pi * 60 * t[:frames[1]])
    y[frames[2]:frames[3]] += 0.7 * np.sin(2 * np.pi * 90 * t[:frames[3] - frames[2]])
    return y.astype(np.float32), frames


DSP_CALLS = {
    "frame_signal": lambda m, y: m.frame_signal(y, N_FFT, HOP),
    "frame_signal_short": lambda m, y: m.frame_signal(y[:1], N_FFT, HOP),
    "stft_mag": lambda m, y: m.stft_mag(y, N_FFT, HOP),
    "rms": lambda m, y: m.rms(y, N_FFT, HOP),
    "zero_crossings": lambda m, y: m.zero_crossings(y),
    "spectral_centroid": lambda m, y: m.spectral_centroid(y, FS, N_FFT, HOP),
    "spectral_bandwidth": lambda m, y: m.spectral_bandwidth(y, FS, N_FFT, HOP),
    "spectral_flatness": lambda m, y: m.spectral_flatness(y, N_FFT, HOP),
    "spectral_rolloff": lambda m, y: m.spectral_rolloff(y, FS, N_FFT, HOP),
    "spectral_contrast": lambda m, y: m.spectral_contrast(y, FS, N_FFT, HOP, fmin=25,
                                                          n_bands=5),
    "poly_features": lambda m, y: m.poly_features(y, FS, N_FFT, HOP),
    "chroma_stft": lambda m, y: m.chroma_stft(y, FS, N_FFT, HOP),
    "melspectrogram_np": lambda m, y: m.melspectrogram_np(y, FS, N_FFT, HOP),
    "mfcc": lambda m, y: m.mfcc(y, FS, N_FFT, HOP),
    "sample_entropy": lambda m, y: m.sample_entropy(y[:400]),
    "wavedec_db4": lambda m, y: np.concatenate(m.wavedec_db4(y, level=5)),
}


@pytest.mark.parametrize("name", list(DSP_CALLS))
def test_dsp_bit_equal(name):
    y = _segment(3)[0][:700].astype(np.float64)
    got, exp = DSP_CALLS[name](dsp, y), DSP_CALLS[name](jdsp, y)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))


@pytest.mark.parametrize("seed,n", [(0, 900), (1, 620), (2, 1400), (3, 300)])
def test_feature_vector_equals_reference(seed, n):
    y, frames = _segment(seed, n)
    got = feature_vector_seg(y, 1, frames, "a0007", 1, seed, "train")
    exp = jfeatures.feature_vector_seg(y, 1, frames, "a0007", 1, seed, "train")
    assert isinstance(got, dict)
    assert list(got) == list(exp.index)
    assert len(got) == 5 + 255
    for k, v in exp.items():
        if isinstance(v, str):
            assert got[k] == v, k
        elif np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("n,order,kind", [(3, 2, "short"), (60, 2, "noise"),
                                          (700, 2, "noise"), (700, 3, "noise"),
                                          (200, 2, "constant"), (500, 2, "tone")])
def test_native_sample_entropy(n, order, kind):
    rng = np.random.default_rng(n + order)
    y = {"short": rng.standard_normal(n), "noise": rng.standard_normal(n),
         "constant": np.ones(n), "tone": np.sin(np.arange(n) * 0.07)}[kind]
    r = 0.2 * np.std(y)
    got = native.sample_entropy(y, order, r)
    plain = native.sample_entropy_plain(y, order, r)
    exp = jdsp.sample_entropy(y, order) if kind != "short" else np.nan
    for v in (plain, exp):
        assert (np.isnan(got) and np.isnan(v)) or got == v, (got, v)
    if kind in ("short", "constant"):  # no template pair within r
        assert np.isnan(got)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.sample_entropy(np.ones(10), 2, 0.1)


@pytest.fixture(scope="module")
def tiny_dataset():
    """Three train and two test recordings; one cycle's systole and S2 are
    25 samples, too short for some PSD bands: NaN features."""
    d = synthetic_physionet_dict(num_wavs_train=3, num_wavs_test=2,
                                 segments_per_wav=2, sig_len=1000, seed=5)
    d["train"]["frames"][2] = [0, 20, 45, 70, 300]
    return d


def test_extract_features_and_csv_match_reference(tiny_dataset, tmp_path):
    """The port's rows through its CSV writer and the JAX package's
    DataFrame through ``to_csv``: the same bytes, and ``read_csv`` reads
    both as the same frame (NaN fields included)."""
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    rows = extract_features(tiny_dataset, skip=[2], save_path=str(ours))
    df = jfeatures.extract_features(tiny_dataset, skip=[2], save_path=str(theirs))
    assert len(rows) == len(df) == 3 * 2 + 2 * 2 - 1
    assert ours.read_bytes() == theirs.read_bytes()
    a, b = pd.read_csv(ours), pd.read_csv(theirs)
    pd.testing.assert_frame_equal(a, b)
    assert a.isna().any().any()  # the short states' empty PSD bands


def test_csv_writer_formats_like_pandas(tmp_path):
    rows = [{"class": 1, "wav": "a0001", "x": 0.1, "y": np.float64(1e-5), "z": np.nan,
             "n": np.int64(7), "big": 1.5e16, "neg": -0.0},
            {"class": 0, "wav": "b0002", "x": 75.0, "y": np.float64(2.0), "z": 3.25,
             "n": np.int64(-2), "big": 12345.678, "neg": 1.0}]
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    write_csv(rows, str(ours))
    pd.DataFrame([pd.Series(r, dtype=object) for r in rows]).to_csv(theirs, index=False)
    assert ours.read_text() == theirs.read_text()

"""The offline signal path of the port (``ops/filtering.py``,
``ops/spectrogram.py``) against ``pcgmix_tpu``'s on the same numpy inputs
from a seed.

Bars: the window, the mel scale and filterbank, the host filters and the
host resampler bit-equal (numpy and scipy on both sides); the device
resampler within the bars of ``tests/test_signal_ops.py`` (rtol 2e-3, atol
2e-4; measured 7e-7 on the CPU); the STFT power and the mel spectrogram
within 1e-5 of each spectrogram's max (float32 FFTs of two libraries);
``power_to_db`` with the same -80 dB floor and within 1e-2 dB above it
(float32 FFT error grows in relative terms toward the floor: measured
7.8e-4 dB below -60 dB, 7.6e-6 dB above -20 dB on this file's inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.ops import filtering as jf
from pcgmix_tpu.ops import spectrogram as js
from pcgmix_tpu_torch.ops import filtering as tf
from pcgmix_tpu_torch.ops import spectrogram as ts

DB_BAR = 1e-2
SPEC_BAR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def signals():
    return np.random.default_rng(17).standard_normal((3, 4400)).astype(np.float32)


@pytest.mark.parametrize("n", [68, 136, 248, 256])
def test_window_bit_equal(n):
    np.testing.assert_array_equal(ts.hann_periodic(n), js.hann_periodic(n))


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_bit_equal(htk):
    f = np.linspace(0.0, 2000.0, 513)
    np.testing.assert_array_equal(ts.hz_to_mel(f, htk), js.hz_to_mel(f, htk))
    m = np.asarray(js.hz_to_mel(f, htk))
    np.testing.assert_array_equal(ts.mel_to_hz(m, htk), js.mel_to_hz(m, htk))


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (2000, 136, 128, 25.0, 1000.0),  # PhysioNet spec128 at its native 2 kHz
    (4000, 248, 128, 25.0, 1000.0),  # UMC spec128 at 4 kHz
    (4000, 500, 64, 25.0, 1000.0),  # UMC spec64
    (1000, 68, 128, 25.0, 1000.0),  # the generic build at 1 kHz
    (1000, 256, 128, 0.0, 500.0),  # the classical features' mel
])
def test_mel_filterbank_bit_equal(sr, n_fft, n_mels, fmin, fmax):
    got = ts.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    exp = js.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.dtype == exp.dtype == np.float32
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("band", [(25.0, 45.0), (200.0, 400.0), (25.0, 400.0), (25.0, 1000.0)])
def test_host_filters_bit_equal(band, signals):
    b, a = tf.butter_bandpass(*band, 2000.0)
    jb, ja = jf.butter_bandpass(*band, 2000.0)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    got = tf.filtfilt(b, a, signals)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jf.filtfilt(jb, ja, signals)))
    np.testing.assert_array_equal(tf.bandpass_filtfilt(signals, *band, 2000.0),
                                  np.asarray(jf.bandpass_filtfilt(signals, *band, 2000.0)))


def test_filtfilt_refuses_a_short_signal():
    b, a = tf.butter_bandpass(25.0, 400.0, 2000.0)
    with pytest.raises(ValueError, match="must exceed padlen"):
        tf.filtfilt(b, a, np.zeros(20, np.float32))


@pytest.mark.parametrize("up,down", [(1, 2), (1, 4), (3, 2), (2, 2)])
def test_resample_poly_host_bit_equal(up, down, signals):
    got = tf.resample_poly_host(signals[0], up, down)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jf.resample_poly_host(signals[0], up, down))


def test_rms_normalize_matches_reference(signals):
    x = signals * 7.3
    got = tf.rms_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jf.rms_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tf.rms_normalize_host(x[0]), jf.rms_normalize_host(x[0]))


@pytest.mark.parametrize("up,down", [(1, 2), (1, 4), (3, 2), (2, 2)])
def test_resample_poly_matches_reference(up, down, signals):
    got = tf.resample_poly(torch.from_numpy(signals), up, down).numpy()
    exp = np.asarray(jf.resample_poly(jnp.asarray(signals), up, down))
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("sr,hop", [(2000, 34), (4000, 62), (1000, 17)])
def test_stft_power_and_melspectrogram_match_reference(sr, hop, signals):
    n_fft = 4 * hop
    got = ts.stft_power(torch.from_numpy(signals), n_fft, hop).numpy()
    exp = np.asarray(js.stft_power(jnp.asarray(signals), n_fft, hop))
    assert got.shape == exp.shape
    err = np.abs(got - exp).max(axis=(-2, -1)) / exp.max(axis=(-2, -1))
    assert err.max() < SPEC_BAR, err
    got = ts.melspectrogram(torch.from_numpy(signals), sr, 128, 25.0, sr / 2, hop).numpy()
    exp = np.asarray(js.melspectrogram(jnp.asarray(signals), sr, 128, 25.0, sr / 2, hop))
    assert got.shape == exp.shape
    err = np.abs(got - exp).max(axis=(-2, -1)) / exp.max(axis=(-2, -1))
    assert err.max() < SPEC_BAR, err


def test_power_to_db_matches_reference(signals):
    """Noise and a tone over faint noise, whose spectrogram reaches the
    -80 dB floor: each top is 0 dB in both, each floor -80 dB, and the
    values within DB_BAR."""
    t = np.arange(signals.shape[-1]) / 2000.0
    tone = (np.sin(2 * np.pi * 150.0 * t) + 1e-6 * signals[0]).astype(np.float32)
    y = np.concatenate([signals, tone[None]])
    mel = np.asarray(js.melspectrogram(jnp.asarray(y), 2000, 128, 25.0, 1000.0, 34))
    exp = np.asarray(js.power_to_db(jnp.asarray(mel)))
    got = ts.power_to_db(ts.melspectrogram(torch.from_numpy(y), 2000, 128, 25.0,
                                           1000.0, 34)).numpy()
    np.testing.assert_array_equal(got.max(axis=(-2, -1)), 0.0)
    np.testing.assert_array_equal(exp.max(axis=(-2, -1)), 0.0)
    floored = exp == -80.0
    assert floored[-1].any() and not floored[:-1].any()
    np.testing.assert_array_equal(got[-1].min(), -80.0)
    assert np.abs(got - exp).max() < DB_BAR


def test_power_to_db_keeps_each_spectrograms_max(signals):
    """A batch keeps one reference per spectrogram, never one over the batch."""
    scaled = signals * np.array([1.0, 30.0, 0.01], np.float32)[:, None]
    mel = ts.melspectrogram(torch.from_numpy(scaled), 2000, 128, 25.0, 1000.0, 34)
    batched = ts.power_to_db(mel).numpy()
    for i in range(len(scaled)):
        np.testing.assert_array_equal(batched[i], ts.power_to_db(mel[i]).numpy())

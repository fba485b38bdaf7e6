"""The benchmark's inputs, made from ``--seed``: the corpus (a dataset dict
in the port's contract) and the model's first weights, as the
configuration's model family declares them (:func:`param_specs`).

The corpus follows the PhysioNet dataset-dict contract: ``train`` and
``test`` splits, each ``{'data', 'label', 'frames', 'wav', 'sig_qual'}``.
A 1-D corpus holds four band arrays (N × T) under the band names; a
spectrogram corpus (``PhysioNet(spec128)``) one (N, F, T) array with its
frames in spectrogram columns.  Recording ``w`` has label ``w % 2`` and
subset letter ``"abcdef"[(w // 2) % 6]``, so every (subset, class) holds
as many recordings and the loader's class balancing keeps every row; every
``sig_qual`` is 1.  Segment lengths (S1, systole, S2, diastole) are drawn
from the traffic file's ranges; the signal is zero after the cycle (the
zero-pad variant).  Sizes and ranges are the same for every seed: the seed
changes the values only.

Metadata is drawn on the host with NumPy, the signals and the weights on
the device with a ``torch.Generator``, each from a stream of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import load

BANDS = ("25-45", "45-80", "80-200", "200-400")  # the model's four band channels
BAND_HZ = (35.0, 62.0, 140.0, 300.0)  # a tone inside each band
SUBSETS = "abcdef"
SEGMENTS = ("S1", "systole", "S2", "diastole")
STREAMS = {"train": 0, "test": 1, "weights": 2}


def stream_seed(seed: int, stream: int, part: int = 0) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    words = np.random.SeedSequence([int(seed) % (1 << 128), stream, part]).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


def spectrogram(config: dict) -> bool:
    return len(config["input"]) == 3


def _frames(rng: np.random.Generator, n: int, frame_ms: dict, config: dict) -> np.ndarray:
    """(n, 5) int64 boundaries [0, e1, e2, e3, e4] in samples (1-D) or
    spectrogram columns."""
    lo = np.array([frame_ms[s][0] for s in SEGMENTS])
    hi = np.array([frame_ms[s][1] for s in SEGMENTS])
    ms = rng.integers(lo, hi + 1, size=(n, 4))
    ends = np.cumsum(ms, axis=1)
    if spectrogram(config):
        ends = np.rint(ends / config["column_ms"]).astype(np.int64)
    else:
        ends = ends * config["sample_rate"] // 1000
    return np.concatenate([np.zeros((n, 1), np.int64), ends], axis=1).astype(np.int64)


def _signals_1d(frames: torch.Tensor, label: torch.Tensor, length: int, rate: int,
                gen: torch.Generator) -> torch.Tensor:
    """(N, 4, T) float32: a tone burst over S1 and (higher) over S2 in each
    band, noise over the cycle, a systolic murmur in class 1, zero after."""
    n, dev = frames.shape[0], frames.device
    t = torch.arange(length, device=dev, dtype=torch.float32)[None, None, :]
    f = frames.to(torch.float32)[:, :, None, None]  # (N, 5, 1, 1)
    hz = torch.tensor(BAND_HZ, device=dev)[None, :, None]
    amp = 0.5 + torch.rand((n, 1, 1), generator=gen, device=dev)
    s1 = (t >= f[:, 0]) & (t < f[:, 1])
    sys_ = (t >= f[:, 1]) & (t < f[:, 2])
    s2 = (t >= f[:, 2]) & (t < f[:, 3])
    cycle = t < f[:, 4]
    x = 0.1 * torch.randn((n, 4, length), generator=gen, device=dev)
    x = x + s1 * 2.0 * torch.sin(2 * math.pi * hz * (t - f[:, 0]) / rate)
    x = x + s2 * 1.5 * torch.sin(2 * math.pi * 1.3 * hz * (t - f[:, 2]) / rate)
    murmur = 0.8 * torch.randn((n, 4, length), generator=gen, device=dev)
    x = x + sys_ * (label[:, None, None] == 1) * murmur
    return (amp * x * cycle).contiguous()


def _signals_2d(frames: torch.Tensor, label: torch.Tensor, freq: int, cols: int,
                gen: torch.Generator) -> torch.Tensor:
    """(N, F, T) float32 standardized mel-dB-like maps: noise, energy over
    S1 and S2 in the upper mels, over systole in the lower mels in class 1,
    zero columns after the cycle."""
    n, dev = frames.shape[0], frames.device
    t = torch.arange(cols, device=dev)[None, None, :]
    m = torch.arange(freq, device=dev)[None, :, None]
    f = frames[:, :, None, None]
    beats = (((t >= f[:, 0]) & (t < f[:, 1])) | ((t >= f[:, 2]) & (t < f[:, 3]))) & (m >= freq // 2)
    murmur = (t >= f[:, 1]) & (t < f[:, 2]) & (m < freq // 3) & (label[:, None, None] == 1)
    x = torch.randn((n, freq, cols), generator=gen, device=dev)
    x = x + 0.8 * beats + 1.0 * murmur
    return (x * (t < f[:, 4])).contiguous()


def _split(config: dict, traffic: dict, seed: int, split: str, device) -> dict:
    prefix = "tr" if split == "train" else "te"
    n_wavs = traffic["train_wavs" if split == "train" else "test_wavs"]
    segs = traffic["segments_per_wav" if split == "train" else "test_segments_per_wav"]
    if n_wavs % (2 * len(SUBSETS)):
        raise ValueError(f"{split}: the recordings must fill every (subset, class) alike")
    w = np.repeat(np.arange(n_wavs), segs)
    label = (w % 2).astype(np.int64)
    wav = np.array([f"{SUBSETS[(i // 2) % len(SUBSETS)]}{prefix}{i:05d}" for i in range(n_wavs)],
                   object)[w]
    rng = np.random.default_rng(stream_seed(seed, STREAMS[split]))
    frames = _frames(rng, len(w), traffic["frame_ms"], config)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, STREAMS[split], 1))
    f_dev = torch.from_numpy(frames).to(device)
    l_dev = torch.from_numpy(label).to(device)
    if spectrogram(config):
        _, freq, cols = config["input"]
        data = _signals_2d(f_dev, l_dev, freq, cols, gen).cpu().numpy()
    else:
        channels, length = config["input"]
        if channels != len(BANDS):
            raise ValueError(f"a 1-D corpus has {len(BANDS)} bands, the config asks {channels}")
        x = _signals_1d(f_dev, l_dev, length, config["sample_rate"], gen).cpu().numpy()
        data = {b: x[:, i] for i, b in enumerate(BANDS)}
    return {"data": data, "label": label, "frames": frames, "wav": wav,
            "sig_qual": np.ones(len(w), np.int64)}


def make_dataset(config: dict, traffic: dict, seed: int, device) -> dict:
    """The corpus of one run: a dataset dict with ``train`` and ``test``."""
    return {s: _split(config, traffic, seed, s, device) for s in ("train", "test")}


def train_rows(dataset: dict, config: dict) -> np.ndarray:
    """The train split's rows as the model sees them: (N, C, T), or
    (N, 1, F, T) for spectrograms (every row is kept, see the docstring)."""
    d = dataset["train"]["data"]
    if spectrogram(config):
        return d[:, None]
    return np.stack([d[b] for b in BANDS], axis=1)


def param_specs(config: dict) -> list:
    """(name, shape, init) of every parameter in the model's order, as the
    configuration's model family gives them; ``init`` is ``("uniform",
    fan_in)`` for U(±1/√fan_in) (PyTorch's default), ``("normal", std)`` or
    ``("fill", value)`` (``reference/models/<family>.py::param_specs``)."""
    return load("models", config["family"]).param_specs(config)


def make_weights(config: dict, seed: int, device) -> dict:
    """First weights, {name: float32 tensor on ``device``}, by
    :func:`param_specs`: the uniform parameters drawn in one call, in the
    specs' order, from the weights' stream; the normal ones in one call
    from a stream of their own; the fills as written."""
    specs = param_specs(config)
    for name, _, (kind, _) in specs:
        if kind not in ("uniform", "normal", "fill"):
            raise ValueError(f"{name}: no init {kind!r}")

    def draw(kind, fn, part):
        n = sum(math.prod(s) for _, s, (k, _) in specs if k == kind)
        if not n:
            return None
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, STREAMS["weights"], part))
        return fn(n, generator=gen, device=device)

    drawn = {"uniform": draw("uniform", torch.rand, 0), "normal": draw("normal", torch.randn, 1)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, (kind, arg) in specs:
        if kind == "fill":
            out[name] = torch.full(shape, float(arg), device=device)
            continue
        n, i = math.prod(shape), at[kind]
        x = drawn[kind][i:i + n]
        at[kind] = i + n
        if kind == "uniform":
            out[name] = ((2.0 * x - 1.0) / math.sqrt(arg)).view(shape)
        else:
            out[name] = (x * arg).view(shape)
    return out

"""XCM, OmniScaleCNN and mWDN from the reference's tsai zoo (counterpart:
``pcgmix_tpu/models/tsai_misc.py``; reference train_model.py:324-327,
:382-384).

- XCM (Fauvel et al.): a 2-D branch that convolves each variable over time
  with (1, window) kernels on the (C, T) plane of a (B, 1, C, T) image,
  BatchNorm2d, ReLU, a 1×1 conv down to one map; a 1-D branch, a
  window-tap conv over all variables, BatchNorm, ReLU, a 1×1 conv to one
  channel; both concatenated to C + 1 channels, a window-tap conv,
  BatchNorm, ReLU, global average pool, linear head.  window = round(T ·
  1.0) = T, an even kernel at T = 2500, padded (1249, 1250) as XLA's
  "SAME" pads it.  XCMPlus is the same class.
- OmniScaleCNN (Tang et al.): three layers of parallel conv + BatchNorm
  branches with kernel sizes {1, 2} ∪ primes up to min(T/4, 89) and
  channel counts from fixed parameter budgets
  (:func:`omniscale_layer_parameters`, tsai's rule), each concatenated and
  ReLU'd; even kernels pad ((k−1)//2, k//2); global average pool, linear
  head ``hidden``.
- mWDN (Wang et al.): per level, two (T, T) linears along time, initialized
  with the db4 high- and low-pass filters on their band diagonals plus
  small noise, a sigmoid and AvgPool(2); the high-pass outputs of every
  level and the last low-pass are concatenated along time and classified
  by an InceptionTime trunk (``base``).

No split forward; ``part="latent_space"`` gives the features before the
head.

``compute_dtype=torch.bfloat16`` follows the JAX modules layer by layer:
XCM's and OmniScaleCNN's convolutions and BatchNorms compute in bf16 and
their heads (``head``, ``hidden``) are built without a dtype (float32
logits); mWDN's wave linears stay float32 (built without a dtype there) and
its InceptionTime trunk takes the dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.models.layers import (
    BatchNorm1d,
    BatchNorm2d,
    Conv1d,
    Conv2d,
    Linear,
    check_part,
    gap_1d,
    same_padding,
)
from pcgmix_tpu_torch.models.tsai_inception import InceptionTime


class XCM(nn.Module):
    """tsai XCM(c_in, c_out, seq_len, nf=128, window_perc=1.0).  Input (B,
    C, T) with T = ``sig_len``; returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, nf: int = 128, window_perc: float = 1.0,
                 num_channels: int = 4, sig_len: int = 2500, compute_dtype=None):
        super().__init__()
        window = max(1, int(round(sig_len * window_perc)))
        dt = compute_dtype
        self.pad = same_padding(window)
        self.conv2d = Conv2d(1, nf, (1, window), compute_dtype=dt)
        self.bn2d = BatchNorm2d(nf, compute_dtype=dt)
        self.conv2d_1x1 = Conv2d(nf, 1, 1, compute_dtype=dt)
        self.conv1d = Conv1d(num_channels, nf, window, compute_dtype=dt)
        self.bn1d = BatchNorm1d(nf, compute_dtype=dt)
        self.conv1d_1x1 = Conv1d(nf, 1, 1, compute_dtype=dt)
        self.conv1d_top = Conv1d(num_channels + 1, nf, window, compute_dtype=dt)
        self.bn_top = BatchNorm1d(nf, compute_dtype=dt)
        self.head = Linear(nf, num_classes)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "XCM")
        h2 = self.conv2d(F.pad(x.unsqueeze(1), self.pad))  # (B, nf, C, T)
        h2 = torch.relu(self.conv2d_1x1(torch.relu(self.bn2d(h2)))).squeeze(1)
        h1 = torch.relu(self.conv1d_1x1(torch.relu(self.bn1d(self.conv1d(x)))))
        h = torch.cat([h2, h1], dim=1)  # (B, C + 1, T)
        h = gap_1d(torch.relu(self.bn_top(self.conv1d_top(h))))
        return h if part == "latent_space" else self.head(h)


def _primes_incl_one(start: int, end: int) -> list[int]:
    """tsai's get_Prime_number_in_a_range: trial division that admits 1
    (the OS-CNN kernel set is {1, 2} ∪ primes)."""
    out = []
    for val in range(start, end + 1):
        if all(val % n for n in range(2, val)):
            out.append(val)
    return out


def omniscale_layer_parameters(seq_len: int, c_in: int) -> list[list[tuple[int, int, int]]]:
    """tsai's generate_layer_parameter_list with the OmniScaleCNN defaults:
    budgets [8·128·c_in, 5·128·256 + 2·256·128], kernel range [1,
    min(seq_len//4, 89)].  Returns each layer's (in, out, ks) tuples."""
    budgets = [8 * 128 * c_in, 5 * 128 * 256 + 2 * 256 * 128]
    end = max(1, min(int(seq_len / 4), 89))
    primes = _primes_incl_one(1, end)
    s = sum(primes)

    def out_ch(budget: int, in_ch: int) -> int:
        return max(1, int(budget / (in_ch * s)))

    layers = []
    in_ch = c_in
    for budget in budgets:
        oc = out_ch(budget, in_ch)
        layers.append([(in_ch, oc, p) for p in primes])
        in_ch = len(primes) * oc
    first_oc = len(primes) * out_ch(budgets[0], c_in)
    layers.append([(in_ch, first_oc, 1), (in_ch, first_oc, 2)])
    return layers


class OmniScaleLayer(nn.Module):
    """Parallel conv + BatchNorm branches, concatenated, ReLU."""

    def __init__(self, params: Sequence[tuple[int, int, int]], compute_dtype=None):
        super().__init__()
        self.n = len(params)
        dt = compute_dtype
        for i, (ic, oc, ks) in enumerate(params):
            self.add_module(f"conv{i}", Conv1d(ic, oc, ks, padding=same_padding(ks),
                                               compute_dtype=dt))
            self.add_module(f"bn{i}", BatchNorm1d(oc, compute_dtype=dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(torch.cat(
            [getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)) for i in range(self.n)],
            dim=1))


class OmniScaleCNN(nn.Module):
    """tsai OmniScaleCNN(c_in, c_out, seq_len).  Input (B, C, T) with T =
    ``sig_len``; returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, num_channels: int = 4, sig_len: int = 2500,
                 compute_dtype=None):
        super().__init__()
        layers = omniscale_layer_parameters(sig_len, num_channels)
        self.n = len(layers)
        for li, layer in enumerate(layers):
            self.add_module(f"layer{li}", OmniScaleLayer(layer, compute_dtype))
        self.hidden = Linear(sum(oc for _, oc, _ in layers[-1]), num_classes)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "OmniScaleCNN")
        h = x
        for li in range(self.n):
            h = getattr(self, f"layer{li}")(h)
        h = gap_1d(h)
        return h if part == "latent_space" else self.hidden(h)


# db4 decomposition filters as tsai hardcodes them (mWDN.py).
MWDN_H = (-0.2304, 0.7148, -0.6309, -0.0280, 0.1870, 0.0308, -0.0329, -0.0106)
MWDN_L = (-0.0106, 0.0329, 0.0308, -0.1870, -0.0280, 0.6309, 0.7148, 0.2304)


def mwdn_band(filters: Sequence[float], p: int) -> tuple[np.ndarray, np.ndarray]:
    """The (p, p) band of a wave linear's weight (torch's (out, in) layout:
    filter k on the k-th diagonal above the main one, weight[i, i + k]) and
    its mask."""
    band = np.zeros((p, p), np.float32)
    mask = np.zeros((p, p), bool)
    for k, f in enumerate(filters):
        idx = np.arange(p - k)
        band[idx, idx + k] = f
        mask[idx, idx + k] = True
    return band, mask


class WaveLinear(nn.Linear):
    """tsai WaveBlock's (T, T) linear along time: weight N(0, 1)·0.1·ε with
    the filter on its band diagonals (ε = the smallest |filter| tap), bias
    torch's default U(±1/√T)."""

    def __init__(self, p: int, filters: Sequence[float]):
        self.filters = tuple(filters)
        super().__init__(p, p)

    def reset_parameters(self) -> None:
        self.seeded_reset(None)

    def seeded_reset(self, generator: Optional[torch.Generator]) -> None:
        p = self.in_features
        band, mask = mwdn_band(self.filters, p)
        eps = min(abs(f) for f in self.filters)
        with torch.no_grad():
            noise = torch.empty(p, p)
            nn.init.normal_(noise, 0.0, 1.0, generator=generator)
            self.weight.copy_(torch.where(torch.from_numpy(mask), torch.from_numpy(band),
                                          noise * (0.1 * eps)))
            b = torch.empty(p)
            nn.init.uniform_(b, -1.0 / p ** 0.5, 1.0 / p ** 0.5, generator=generator)
            self.bias.copy_(b)


class WaveBlock(nn.Module):
    """sigmoid(H·x) and sigmoid(L·x) along time, each AvgPool(2)'d (floor);
    returns (low, high) on (B, C, T // 2)."""

    def __init__(self, p: int):
        super().__init__()
        self.mWDN_H = WaveLinear(p, MWDN_H)
        self.mWDN_L = WaveLinear(p, MWDN_L)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        hp = torch.sigmoid(self.mWDN_H(x))
        lp = torch.sigmoid(self.mWDN_L(x))
        return F.avg_pool1d(lp, 2), F.avg_pool1d(hp, 2)


class MWDN(nn.Module):
    """tsai mWDN(c_in, c_out, seq_len): three levels, an InceptionTime
    trunk.  Input (B, C, T) with T = ``sig_len``; returns (B, num_classes)
    logits."""

    def __init__(self, num_classes: int = 2, levels: int = 3, num_channels: int = 4,
                 sig_len: int = 2500, compute_dtype=None):
        super().__init__()
        self.levels = levels
        p = sig_len
        for i in range(levels):
            self.add_module(f"wdn{i + 1}", WaveBlock(p))
            p //= 2
        self.base = InceptionTime(num_classes, num_channels=num_channels,
                                  compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "mWDN")
        h, highs = x, []
        for i in range(self.levels):
            h, hp = getattr(self, f"wdn{i + 1}")(h)
            highs.append(hp)
        return self.base(torch.cat(highs + [h], dim=-1), part=part)

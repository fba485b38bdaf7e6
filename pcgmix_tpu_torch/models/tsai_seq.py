"""Recurrent and gated-MLP models from the reference's tsai zoo
(counterpart: ``pcgmix_tpu/models/tsai_seq.py``; reference
train_model.py:377-381, RNN/LSTM/GRU(4, 2), and :322-323, gMLP(4, 2,
sig_len)).

RNN, LSTM, GRU: one recurrent layer, hidden 100, over the (B, T, C)
sequence; the head ``fc`` reads the last step's output.  The parameters
are flax's, not ``torch.nn.RNN``'s: flax's cells carry one bias per gate,
where torch's carry two sets, which would change the parameter count and
Adam's trajectory.  So the model keeps only flax's biases as parameters
and calls the functional cuDNN ops (``torch.rnn_tanh``, ``torch.gru``,
``torch.lstm``) with zeros in the other bias slot:

- RNN (flax ``SimpleCell``): ``bias_ih`` only;
- GRU (``GRUCell``): ``bias_ih`` (r, z, n) and ``bias_hn``, the recurrent
  bias of the n gate alone, inside r·(W_hn h + b_hn); the recurrent bias
  slot is cat(0, 0, b_hn);
- LSTM (``OptimizedLSTMCell``): ``bias_hh`` (i, f, g, o), the input slot
  zero.

Every recurrent weight and bias is drawn from U(±1/√hidden), as torch's
``nn.RNNBase`` draws them and as the JAX package initializes its cells.

gMLP: a 1×1 conv embedding to d_model = 256, six blocks (LayerNorm →
linear to d_ffn = 512 → GELU (tanh approximation, flax's ``nn.gelu``) →
spatial gating unit → linear back, plus the residual), the mean over time
and a linear head.  The gating unit splits the channels in half,
LayerNorms the gate half and applies a (T, T) linear along time,
initialized N(0, 1e-4) with a bias of ones (the gMLP paper's init), then
multiplies.  flax's LayerNorm has eps 1e-6 (torch's default is 1e-5).

No split forward; ``part="latent_space"`` gives the features before the
head.

``compute_dtype=torch.bfloat16`` (JAX ``GMLP.dtype``): the patch embedding,
``proj_in``, ``spatial_proj`` and ``proj_out`` compute in bf16; the
LayerNorms are built without a dtype (float32 statistics and output, as
flax's), so are ``head`` (float32 logits) and the recurrent models, which
ignore the dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pcgmix_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, check_part

#: gates per cell, in torch's (and flax's) order
GATES = {"rnn": 1, "gru": 3, "lstm": 4}
#: the bias parameters each cell keeps, with their sizes in units of hidden
CELL_BIASES = {"rnn": {"bias_ih": 1}, "gru": {"bias_ih": 3, "bias_hn": 1},
               "lstm": {"bias_hh": 4}}


class Recurrent(nn.Module):
    """One recurrent layer over (B, T, C) with flax's bias layout; returns
    the (B, T, H) outputs."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int):
        super().__init__()
        if cell_type not in GATES:
            raise ValueError(f"cell_type must be one of {sorted(GATES)}, got {cell_type!r}")
        self.cell_type, self.hidden_size = cell_type, hidden_size
        g = GATES[cell_type]
        self.weight_ih = nn.Parameter(torch.empty(g * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(g * hidden_size, hidden_size))
        for name, n in CELL_BIASES[cell_type].items():
            self.register_parameter(name, nn.Parameter(torch.empty(n * hidden_size)))
        self.seeded_reset(None)

    def seeded_reset(self, generator: Optional[torch.Generator]) -> None:
        """U(±1/√hidden) for every weight and bias, in registration order."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                w = torch.empty(p.shape)
                nn.init.uniform_(w, -bound, bound, generator=generator)
                p.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x.new_zeros(1, x.shape[0], self.hidden_size)
        g = GATES[self.cell_type]
        zeros = x.new_zeros(g * self.hidden_size)
        # has_biases, num_layers, dropout, train, bidirectional, batch_first
        common = (True, 1, 0.0, self.training, False, True)
        if self.cell_type == "rnn":
            params = [self.weight_ih, self.weight_hh, self.bias_ih, zeros]
            return torch.rnn_tanh(x, h0, params, *common)[0]
        if self.cell_type == "gru":
            b_hh = torch.cat([zeros[:2 * self.hidden_size], self.bias_hn])
            params = [self.weight_ih, self.weight_hh, self.bias_ih, b_hh]
            return torch.gru(x, h0, params, *common)[0]
        params = [self.weight_ih, self.weight_hh, zeros, self.bias_hh]
        return torch.lstm(x, (h0, h0), params, *common)[0]


class TsaiRNN(nn.Module):
    """tsai's _RNN_Base with cell_type rnn, lstm or gru.  Input (B, C, T);
    returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, hidden_size: int = 100,
                 cell_type: str = "lstm", num_channels: int = 4):
        super().__init__()
        self.rnn = Recurrent(cell_type, num_channels, hidden_size)
        self.fc = nn.Linear(hidden_size, num_classes)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, self.rnn.cell_type.upper())
        last = self.rnn(x.transpose(1, 2))[:, -1]
        return last if part == "latent_space" else self.fc(last)


class SpatialProjection(Linear):
    """The gating unit's (T, T) linear along time: weight N(0, 1e-4),
    bias ones."""

    def reset_parameters(self) -> None:
        self.seeded_reset(None)

    def seeded_reset(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            w = torch.empty(self.weight.shape)
            nn.init.normal_(w, 0.0, 1e-4, generator=generator)
            self.weight.copy_(w)
            self.bias.fill_(1.0)


class SpatialGatingUnit(nn.Module):
    def __init__(self, d_ffn: int, seq_len: int, compute_dtype=None):
        super().__init__()
        self.norm = LayerNorm(d_ffn // 2, eps=1e-6)
        self.spatial_proj = SpatialProjection(seq_len, seq_len, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, d_ffn)
        u, v = x.chunk(2, dim=-1)
        v = self.spatial_proj(self.norm(v).transpose(1, 2)).transpose(1, 2)
        return u * v


class GMLPBlock(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, seq_len: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.norm = LayerNorm(d_model, eps=1e-6)
        self.proj_in = Linear(d_model, d_ffn, compute_dtype=dt)
        self.sgu = SpatialGatingUnit(d_ffn, seq_len, compute_dtype=dt)
        self.proj_out = Linear(d_ffn // 2, d_model, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, d_model)
        h = F.gelu(self.proj_in(self.norm(x)), approximate="tanh")
        return x + self.proj_out(self.sgu(h))


class GMLP(nn.Module):
    """tsai gMLP(c_in, c_out, seq_len): patch size 1, d_model 256, d_ffn
    512, six blocks.  Input (B, C, T); returns (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2, d_model: int = 256, d_ffn: int = 512,
                 depth: int = 6, num_channels: int = 4, sig_len: int = 2500,
                 compute_dtype=None):
        super().__init__()
        self.depth = depth
        self.patcher = Conv1d(num_channels, d_model, 1, padding=0, compute_dtype=compute_dtype)
        for i in range(depth):
            self.add_module(f"block{i}", GMLPBlock(d_model, d_ffn, sig_len, compute_dtype))
        self.head = Linear(d_model, num_classes)

    def forward(self, x: torch.Tensor, depth: int = 0,
                part: Optional[str] = None) -> torch.Tensor:
        check_part(part, "gMLP")
        h = self.patcher(x).transpose(1, 2)  # (B, T, d_model)
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h)
        h = h.mean(dim=1)
        return h if part == "latent_space" else self.head(h)

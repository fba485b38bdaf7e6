"""The tsai zoo in the PyTorch port against pcgmix_tpu: InceptionTime,
XceptionTime, XResNet1d18, gMLP, XCM, RNN, LSTM, GRU, mWDN and
OmniScaleCNN, carried over from the JAX package's weights by
``jax_to_torch``, at the tolerances and with the module-scoped JAX runs of
tests/test_torch_zoo_ref.py (the recurrent models against the JAX package
in float32: its flax scan keeps a float32 carry).  Then the
port's own pieces: the recurrent cells against their equations with
flax's bias layout, mWDN's band init, gMLP's spatial init, XCM's even
window and the models without a split forward refusing one."""

import functools

import numpy as np
import pytest
import torch

from pcgmix_tpu.models.tsai_misc import omniscale_layer_parameters as j_omniscale
from pcgmix_tpu_torch.models import build_model, max_latent_depth
from pcgmix_tpu_torch.models.registry import TSAI_NAMES
from pcgmix_tpu_torch.models.tsai_misc import (
    MWDN_H,
    MWDN_L,
    mwdn_band,
    omniscale_layer_parameters,
)
from pcgmix_tpu_torch.models.tsai_seq import Recurrent
from pcgmix_tpu_torch.train.convert import seeded_init
from tests.test_torch_zoo_ref import (
    assert_close_to_reference,
    assert_grads_close,
    assert_stats_close,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    port_run,
    reference_run,
)

B, C, T = 3, 4, 128
# each architecture's length: XResNet1d18 halves T five times, so its
# last stage needs 128 steps to hold its BatchNorm's statistics to 1e-6;
# OmniScaleCNN's kernel set grows with T (primes up to T/4)
LENGTHS = {"InceptionTime": 64, "XceptionTime": 64, "XResNet1d18": 128, "gMLP": 64,
           "XCM": 64, "RNN": 64, "LSTM": 64, "GRU": 64, "mWDN": 64, "OmniScaleCNN": 32}
TSAI = list(LENGTHS)


@functools.lru_cache(maxsize=None)
def runs(name):
    ref = reference_run(name, (B, C, LENGTHS[name]))
    return name, ref, port_run(name, ref)


@pytest.fixture(params=TSAI)
def pair(request):
    return runs(request.param)


def test_logits_and_latent_match_reference(pair):
    assert_close_to_reference(*pair)


def test_running_statistics_match_reference(pair):
    assert_stats_close(*pair)


def test_gradients_match_reference(pair):
    assert_grads_close(*pair)


def _cell_loop(cell, x):
    """flax's cells step by step (zero initial state), with their biases."""
    h = x.new_zeros(x.shape[0], cell.hidden_size)
    c = torch.zeros_like(h)
    H = cell.hidden_size
    outs = []
    for t in range(x.shape[1]):
        gi, gh = x[:, t] @ cell.weight_ih.T, h @ cell.weight_hh.T
        if cell.cell_type == "rnn":
            h = torch.tanh(gi + cell.bias_ih + gh)
        elif cell.cell_type == "gru":
            gi = gi + cell.bias_ih
            r = torch.sigmoid(gi[:, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[:, 2 * H:] + r * (gh[:, 2 * H:] + cell.bias_hn))
            h = (1 - z) * n + z * h
        else:
            g = gi + gh + cell.bias_hh
            i, f = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H])
            c = f * c + i * torch.tanh(g[:, 2 * H:3 * H])
            h = torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("cell_type,biases", [
    ("rnn", {"bias_ih": 8}), ("gru", {"bias_ih": 24, "bias_hn": 8}),
    ("lstm", {"bias_hh": 32})])
def test_recurrent_cells_keep_flax_biases_only(cell_type, biases):
    """One bias per gate, as flax's cells: the cuDNN op's other bias slot is
    zeros, not a parameter; outputs equal the cell's equations."""
    torch.manual_seed(0)
    cell = Recurrent(cell_type, 3, 8)
    shapes = {k: tuple(p.shape) for k, p in cell.named_parameters()}
    gates = {"rnn": 1, "gru": 3, "lstm": 4}[cell_type]
    assert shapes == {"weight_ih": (gates * 8, 3), "weight_hh": (gates * 8, 8),
                      **{k: (n,) for k, n in biases.items()}}
    bound = 1 / np.sqrt(8)
    assert all(p.abs().max() <= bound for p in cell.parameters())
    x = torch.randn(2, 11, 3)
    np.testing.assert_allclose(cell(x).detach().numpy(), _cell_loop(cell, x).detach().numpy(),
                               rtol=0, atol=1e-6)


def test_mwdn_band_init():
    """The wave linears hold the db4 taps on their band diagonals exactly
    (weight[i, i + k]) and small noise elsewhere; a seeded init redraws
    the noise reproducibly and keeps the band."""
    for filters in (MWDN_H, MWDN_L):
        band, mask = mwdn_band(filters, 16)
        for k, f in enumerate(filters):
            np.testing.assert_array_equal(np.diag(band, k), np.float32(f))
        assert mask.sum() == sum(16 - k for k in range(8))
    a = seeded_init(build_model("mWDN", 2, C, 64), 4)
    b = seeded_init(build_model("mWDN", 2, C, 64), 4)
    for w in (a.wdn1.mWDN_L.weight, a.wdn3.mWDN_H.weight):
        w = w.detach().numpy()
        filters = MWDN_L if w.shape[0] == 64 else MWDN_H
        band, mask = mwdn_band(filters, w.shape[0])
        np.testing.assert_array_equal(w[mask], band[mask])
        eps = 0.1 * min(abs(f) for f in filters)
        assert 0 < np.abs(w[~mask]).max() < 6 * eps
    assert torch.equal(a.wdn2.mWDN_H.weight, b.wdn2.mWDN_H.weight)
    assert a.wdn1.mWDN_H.weight.shape == (64, 64) and a.wdn3.mWDN_H.weight.shape == (16, 16)


def test_gmlp_spatial_projection_init():
    """The gating unit's (T, T) projection: N(0, 1e-4) weights and a bias of
    ones, also after the seeded init (which redraws every other linear)."""
    model = seeded_init(build_model("gMLP", 2, C, 200), 4)
    proj = model.block3.sgu.spatial_proj
    assert proj.weight.shape == (200, 200)
    assert torch.equal(proj.bias, torch.ones(200))
    assert 0.5e-4 < proj.weight.std().item() < 1.5e-4
    assert model.block3.norm.eps == model.block3.sgu.norm.eps == 1e-6


def test_xcm_pads_its_even_window_as_xla():
    """window = T: at an even T the convs pad (T/2 − 1, T/2), XLA's SAME."""
    model = build_model("XCM", 2, C, 10)
    assert model.conv1d.pad == model.conv1d_top.pad == model.pad == (4, 5)
    assert model(torch.randn(2, C, 10)).shape == (2, 2)


def test_omniscale_layer_parameters_equal_reference():
    for t, c in ((2500, 4), (128, 4), (100, 3)):
        assert omniscale_layer_parameters(t, c) == j_omniscale(t, c)


@pytest.mark.parametrize("name", TSAI_NAMES)
def test_tsai_models_refuse_a_split_forward(name):
    """latentmixup's depth table refuses every tsai name, as the JAX
    package's does, and so does every model but FCNPlus, whose class is
    FCN's."""
    with pytest.raises(NotImplementedError, match="split"):
        max_latent_depth(name)
    model = build_model(name, 2, C, 64)
    if name != "FCNPlus":
        with pytest.raises(NotImplementedError, match="split"):
            model(torch.zeros(2, C, 64), depth=1, part="first")
    assert model(torch.zeros(2, C, 64), part="latent_space").shape[0] == 2

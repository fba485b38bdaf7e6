"""The graph route on the CPU, where ``MultiStep`` runs each chunk as eager
steps: a dispatch trains K steps (fewer at an epoch's end), keeps what the
harness reads, and its first dispatch gives the record the check takes."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs
from benchmark.reference import common
from benchmark.routes import graph
from conftest import tiny_cell

CELL = "resnet9_1d-pcgmixplus-graph8"
CPU = torch.device("cpu")
SEED = 2**31 + 41


def state(cell, seed=SEED):
    dataset = inputs.make_dataset(cell.config, cell.traffic, seed, CPU)
    weights = inputs.make_weights(cell.config, seed, CPU)
    st = harness.Trainer(cell, dataset, weights, CPU)
    graph.prepare(st)
    return st, dataset, {k: v.clone() for k, v in weights.items()}


def test_a_dispatch_trains_a_chunk_and_an_epoch_ends_in_a_shorter_one():
    cell = tiny_cell(CELL)
    st, _, _ = state(cell)
    k = st.multi.k
    per_epoch = st.num_steps // st.cfg.num_epochs
    assert k == cell.traffic["steps_per_dispatch"] == 8 and per_epoch == 12
    spans = {"plan": [], "step": []}
    graph.step(st, spans)
    assert st.step_count == k and len(st.losses) == k and len(st.last_plans) == k
    assert len(spans["plan"]) == len(spans["step"]) == k
    assert len(set(spans["plan"])) == 1 and spans["plan"][0] > 0  # a step's share of the chunk
    assert all(t.shape == (1,) and torch.isfinite(t).all() for t in st.losses)
    assert len(st.lr_per_step) == k
    graph.step(st, spans)  # the epoch's last 4 steps
    assert st.step_count == per_epoch and len(st.losses) == per_epoch
    assert len(st.last_plans) == per_epoch - k and len(spans["step"]) == per_epoch
    assert st.epoch == 1
    graph.step(st, spans)
    assert st.step_count == per_epoch + k and st.epoch == 2


def test_the_first_dispatch_gives_the_checks_record():
    cell = tiny_cell(CELL)
    st, dataset, weights = state(cell)
    n = cell.traffic["check_steps"]
    rec = graph.first_steps(st, n)
    assert st.step_count == n and len(rec["plans"]) == len(rec["mixed"]) == len(rec["losses"]) == n
    assert rec["exp_avg"] is not None
    obs = harness.observed_record(rec, st.model, weights, cell.config["recipe"], st.num_steps)
    ref = harness.reference_record(cell, dataset, weights, CPU, common.Ops())
    values = check.readings(obs, ref)
    assert values["plan"] == 0
    assert all(np.isfinite(values[k]) for k in check.NUMBERS)
    assert values["loss_steps"][0] == values["loss1"] < 1e-5


def test_the_first_dispatch_is_a_whole_chunk():
    st, _, _ = state(tiny_cell(CELL))
    with pytest.raises(ValueError, match="8 steps, not 3"):
        graph.first_steps(st, 3)


def test_a_chunk_takes_two_steps_or_more():
    cell = tiny_cell(CELL)
    cell.traffic["steps_per_dispatch"] = 1
    with pytest.raises(ValueError, match="at least 2 steps"):
        state(cell)

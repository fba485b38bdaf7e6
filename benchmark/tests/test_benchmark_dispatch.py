"""The traffic owns what a step launches and the route owns the dispatch:
the launch check reads the traffic's map, a route may train several steps
a dispatch."""

import types

import pytest
import torch

from benchmark import harness
from benchmark.routes import eager
from conftest import CELLS, tiny_cell
from test_benchmark_reference import TINY_LIMITS

K2 = {"pcgmix_plus_fused": {"per_step": 1, "device_kernel": "mix_warp_kernel"}}


@pytest.mark.parametrize("expected, launches, on_card, gap", [
    (K2, {"pcgmix_plus_fused": 10, "piecewise_mix_pairs": 0}, True, 0.0),
    (K2, {"pcgmix_plus_fused": 9}, True, 1.0),
    (K2, {"pcgmix_plus_fused": 10, "piecewise_mix_pairs": 2}, True, 2.0),
    (K2, {"pcgmix_plus_fused": 0}, False, 0.0),
    ({}, {"pcgmix_plus_fused": 0}, True, 0.0),
    ({}, {"pcgmix_plus_fused": 3}, True, 3.0),
], ids=["one-a-step", "one-missing", "another-wrapper", "cpu", "none-due", "none-due-some-made"])
def test_launch_gap(expected, launches, on_card, gap):
    assert harness.launch_gap(expected, launches, 10, on_card) == gap


def test_eager_route_refuses_several_steps_a_dispatch():
    st = types.SimpleNamespace(cfg=types.SimpleNamespace(steps_per_dispatch=8))
    with pytest.raises(ValueError, match="one step a dispatch"):
        eager.prepare(st)


def _two_steps_a_dispatch():
    """A route that trains two eager steps a dispatch."""
    def step(st, spans=None, profiled=False):
        plans = []
        for _ in range(2):
            eager.step(st, spans, profiled)
            plans += st.last_plans
        st.last_plans = plans

    return types.SimpleNamespace(prepare=lambda st: None, step=step,
                                 first_steps=eager.first_steps)


@pytest.mark.parametrize("name", CELLS)
def test_a_route_of_two_steps_a_dispatch(name, monkeypatch):
    route = _two_steps_a_dispatch()
    monkeypatch.setattr(harness, "route_module", lambda traffic: route)
    out = harness.measure(tiny_cell(name), 2**31 + 31, 0.2, False, torch.device("cpu"),
                          limits=TINY_LIMITS)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["attempted"] % 2 == 0


def test_steps_counts_every_step_of_a_dispatch():
    route = _two_steps_a_dispatch()
    st = types.SimpleNamespace(step_count=0, last_plans=[])

    def step(st, **kw):
        st.step_count += 2
        st.last_plans = [{"k": 1}, {"k": 2}]
    route.step = step
    plans = []
    assert harness._steps(st, route, 5, plans) == 6
    assert len(plans) == 6

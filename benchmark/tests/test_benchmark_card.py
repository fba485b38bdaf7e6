"""On a card: a short run of each cell at a tiny size goes through the mix
kernel once a step and agrees with the reference (skips without a card)."""

import pytest

from benchmark import harness
from conftest import CELLS, tiny_cell
from test_benchmark_reference import TINY_LIMITS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    out = harness.measure(tiny_cell(name), 2**31 + 29, 0.5, False, card, limits=TINY_LIMITS)
    assert out["correct"], out["checks"]
    assert out["_values"]["launches"] == 0

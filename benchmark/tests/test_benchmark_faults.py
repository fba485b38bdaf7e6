"""A run with the timed path broken underneath comes out not correct: the
harness driven on the CPU (its look for a card skipped) at a tiny size,
each fault a one-card cell can have planted in the port's state."""

import pytest
import torch

from benchmark import faults, harness
from conftest import CELLS, tiny_cell
from test_benchmark_reference import TINY_LIMITS


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    out = harness.measure(tiny_cell(name), 2**31 + 23, 0.0, False, torch.device("cpu"),
                          faults=(faults.FAULTS[fault],), limits=TINY_LIMITS)
    assert not out["correct"], out["checks"]


def test_faults_are_mended():
    from pcgmix_tpu_torch.augment import engine
    from pcgmix_tpu_torch.train import steps

    def patched():
        return (steps.selc_update, engine.pcgmix_plus_fused, engine.piecewise_mix_batch,
                steps.ScalarFedUpdate.apply)

    before = patched()
    harness.measure(tiny_cell(CELLS[0]), 3, 0.0, False, torch.device("cpu"),
                    faults=(faults.half_batch, faults.altered_mix, faults.frozen),
                    limits=TINY_LIMITS)
    assert patched() == before

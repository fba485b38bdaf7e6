"""An eager step's uploads (``TrainStep.stage``, ``train/steps.py::Staging``):
the row indices and the plan's arrays go to the device in one pinned,
non-blocking copy, and the step trains on views of that buffer exactly as
on tensors uploaded one by one; the buffers grow to a larger layout and are
reused by a smaller one; on a card, a ring of two slots keeps every step's
arrays intact while the host runs ahead of the device.

The card's test imports neither JAX nor ``tests/conftest.py``: run it as
``python -m pytest tests/test_torch_eager_staging.py --noconftest -q``."""

import numpy as np
import pytest
import torch

from pcgmix_tpu_torch import timing
from pcgmix_tpu_torch.augment.engine import staged_dtype
from pcgmix_tpu_torch.data import EpochIterator
from tests.test_torch_timing import _step

# the rows of each step's batch: a smaller layout after a larger one, and
# a larger one after a smaller one
ROWS = (32, 64, 64, 32, 64)


@pytest.fixture(autouse=True)
def clean():
    timing.reset_host_times()
    yield
    timing.reset_host_times()


def _steps(method, rows=ROWS):
    """(indices, host plan arrays or None) of each step: the first ``r`` rows
    of each batch, planned for those rows; ``base`` has no plan."""
    cell = "durmixmagwarp(0.2,4)" if method == "base" else method
    _, engine, ds = _step(cell, n=64 * len(rows))
    out = []
    for s, (r, b) in enumerate(zip(rows, EpochIterator(ds, 64, 1, 0))):
        arrays = None
        if method != "base":
            arrays = engine.plan(s, b["frames"][:r], b["label"][:r], b["wav"][:r]).arrays
        out.append((np.asarray(b["indices"][:r]), arrays))
    return cell, out


def _uploaded(indices, arrays, device):
    """The step's indices and plan as tensors built directly on ``device``,
    one by one."""
    idx = torch.from_numpy(np.asarray(indices, np.int64)).to(device)
    if arrays is None:
        return idx, None
    plan = {}
    for k, v in arrays.items():
        if k == "lam" and np.ndim(v) == 0:
            plan[k] = float(v)
        else:
            v = np.asarray(v)
            plan[k] = torch.from_numpy(np.ascontiguousarray(v, staged_dtype(v))).to(device)
    return idx, plan


@pytest.mark.parametrize("method", ["durmixmagwarp(0.2,4)", "durratiomixup", "base"])
def test_a_staged_step_equals_the_step_on_tensors_uploaded_one_by_one(method):
    cell, steps = _steps(method)
    staged, _, _ = _step(cell, n=64 * len(ROWS))
    direct, _, _ = _step(cell, n=64 * len(ROWS))
    buffers = []
    for indices, arrays in steps:
        got = staged(indices, arrays, 1)
        want = direct.run(*_uploaded(indices, arrays, "cpu"), 1)
        for name in ("loss", "preds", "target"):
            assert torch.equal(got[name], want[name]), name
        for p, q in zip(staged.model.parameters(), direct.model.parameters()):
            assert torch.equal(p, q)
        assert torch.equal(staged.soft_labels, direct.soft_labels)
        buffers.append(staged._staging.host[0])
    assert timing.counts()["h2d_copies.pinned"] == len(ROWS)
    assert "h2d_copies.pageable" not in timing.counts()
    # 32 rows, then 64: the buffer grows; 64 again, then 32 and 64: reused
    assert buffers[1] is not buffers[0] and buffers[1].numel() > buffers[0].numel()
    assert all(b is buffers[1] for b in buffers[2:])
    # on the CPU the device buffer is the host's
    assert staged._staging.dev is buffers[1]


@pytest.mark.cuda
def test_the_ring_keeps_each_step_intact_while_the_host_runs_ahead():
    """Each step's kernels queue behind a sleep on the stream, so the host
    stages later steps while earlier copies wait: every step still reads
    its own indices and plan, the host meets a slot in use, and the losses
    equal those of the same steps with the stream synced after each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell, steps = _steps("durmixmagwarp(0.2,4)", rows=(64,) * 8)
    losses = {}
    for ahead in (True, False):
        timing.reset_host_times()
        step, _, _ = _step(cell, n=64 * 8, device="cuda")
        seen = []
        run = step.run

        def spy(idx, plan, *args, **kw):  # what the step reads, copied in stream order
            seen.append((step.train_data.index_select(0, idx),
                         {k: v.clone() for k, v in plan.items() if torch.is_tensor(v)}))
            return run(idx, plan, *args, **kw)

        step.run = spy
        out = []
        for indices, arrays in steps:
            if ahead:
                torch.cuda._sleep(20_000_000)  # about 10 ms of device time
            out.append(step(indices, arrays, 1)["loss"])
            if not ahead:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        losses[ahead] = torch.stack(out).cpu()
        data = step.train_data.cpu()
        for (indices, arrays), (rows, plan) in zip(steps, seen):
            assert torch.equal(rows.cpu(), data[torch.from_numpy(indices)])
            for k, v in plan.items():
                a = np.asarray(arrays[k])
                assert np.array_equal(v.cpu().numpy(), a.astype(staged_dtype(a))), k
        assert timing.counts()["h2d_copies.pinned"] == len(steps)
        if ahead:
            assert timing.counts()["h2d_slot_waits"] > 0
    assert torch.equal(losses[True], losses[False])

"""The plain reference against the port at a tiny size on the CPU: the
plans equal, the model's forward agrees in float64, a sound run comes out
correct, and the lower-precision controls fail."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs
from benchmark.reference import common, load, method_parts
from conftest import CELLS, tiny_cell

# limits at this size on the CPU (the cells' own limits are set on the card
# at their sizes): sound runs read far under them, the controls over
TINY_LIMITS = {"plan": 0.0, "launches": 0.0, "mix": 1e-5, "loss1": 1e-5, "grad1_median": 1e-4,
               "change": 2e-2}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=CELLS)
def sound(request):
    cell = tiny_cell(request.param)
    return cell, harness.measure(cell, 2**31 + 11, 0.2, False, CPU, limits=TINY_LIMITS)


def test_sound_run_is_correct(sound):
    cell, out = sound
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["_values"]["plan"] == 0


def test_bf16_control_fails(sound):
    cell, _ = sound
    out = harness.measure(cell, 2**31 + 11, 0.0, False, CPU, compute_dtype="bfloat16",
                          limits=TINY_LIMITS)
    assert not out["correct"], out["checks"]


def test_tf32_control_fails(sound):
    cell, out = sound
    dataset = inputs.make_dataset(cell.config, cell.traffic, 2**31 + 11, CPU)
    weights = inputs.make_weights(cell.config, 2**31 + 11, CPU)
    control = harness.reference_record(cell, dataset, weights, CPU, common.Ops(tf32=True))
    values = check.readings(control, out["_reference"])
    values["launches"] = 0.0
    assert values["plan"] == 0
    assert not check.judge(values, TINY_LIMITS), values


@pytest.mark.parametrize("name", CELLS)
def test_model_forward_matches_the_port(name):
    from pcgmix_tpu_torch.models import build_model

    cell = tiny_cell(name)
    c = cell.config
    weights = inputs.make_weights(c, 5, CPU)
    freq = c["input"][1] if len(c["input"]) == 3 else None
    model = build_model(c["model"], 2, c["input"][0], c["input"][-1], dataset=c["dataset"],
                        freq=freq).double().train()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    x = torch.randn(6, *c["input"], dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    x[..., c["input"][-1] // 2:] = 0.0  # a zero tail: windows of equal values
    params = {k: v.double().requires_grad_(True) for k, v in weights.items()}
    ref = load("models", c["family"]).forward(params, x, common.Ops(), c)
    out = model(x)
    assert torch.allclose(out, ref, rtol=1e-10, atol=1e-10)
    # the gradients too: the pools route them to the same steps
    (ref[:, 0] - ref[:, 1].square()).sum().backward()
    (out[:, 0] - out[:, 1].square()).sum().backward()
    for n, p in model.named_parameters():
        assert torch.allclose(p.grad, params[n].grad, rtol=1e-9, atol=1e-12), n


@pytest.mark.parametrize("name", CELLS)
def test_plan_matches_the_port(name):
    from pcgmix_tpu_torch.augment.engine import AugmentConfig, AugmentEngine

    cell = tiny_cell(name)
    c, t = cell.config, cell.traffic
    spectrogram = len(c["input"]) == 3
    data = inputs.make_dataset(c, t, 17, CPU)["train"]
    engine = AugmentEngine(AugmentConfig(
        method=t["method"], batch_size=8, num_channels=c["input"][-2], sig_len=c["input"][-1],
        spectrogram=spectrogram, spec_freq=c["input"][1] if spectrogram else 0))
    base, numbers = method_parts(t["method"])
    planner = load("plans", base)
    for step in range(4):
        idx = np.arange(step * 8, step * 8 + 8)
        got = engine.plan(step, data["frames"][idx], data["label"][idx], data["wav"][idx]).arrays
        want = planner.plan(step, data["frames"][idx], data["label"][idx], numbers,
                            c["input"][-2])
        assert check.plan_mismatches([got], [want]) == 0


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10, 3.0e-3])
    y = common.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2**-9 and y[3] == -1.0 - 2**-10
    assert (y.view(torch.int32) & 0x1FFF == 0).all()


def test_onecycle_matches_torch():
    recipe = tiny_cell(CELLS[0]).config["recipe"]
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=recipe["lr_max"])
    sched = torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=recipe["lr_max"], total_steps=50)
    for step in range(50):
        lr, beta1 = common.onecycle(recipe, 50, step)
        assert lr == pytest.approx(opt.param_groups[0]["lr"], rel=1e-12)
        assert beta1 == pytest.approx(opt.param_groups[0]["betas"][0], rel=1e-12)
        opt.step()
        sched.step()

"""The port's data-parallel path on the CPU: two gloo ranks against one
process on the same global batch (counterpart of tests/test_parallel.py).

Held: BatchNorm over 2 ranks equals BatchNorm over the concatenated batch
(outputs, input gradients, running statistics within 1e-6); one
data-parallel train step equals one single-device step (loss within rtol
1e-5, ``linear.weight`` within rtol 1e-4, the SELC table equal once the
epoch is past ``es``, predictions identical), for ResNet9, for Potes
with its dropout on and for FCN (global BatchNorm in the zoo's ConvBlocks); ``train_model`` over 2 ranks with a batch that does
not divide (7 rows, replicated) returns the single-device run's numbers
(loss trace within 1e-6, identical recording-level predictions).

This module imports neither JAX nor the JAX package: the spawned ranks
import it to find their entry point."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
from pcgmix_tpu_torch.models import build_model
from pcgmix_tpu_torch.models.resnet9 import BatchNorm1d
from pcgmix_tpu_torch.parallel import DataParallel, init_group, spawn
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train.convert import seeded_init
from pcgmix_tpu_torch.train.losses import init_selc_table
from pcgmix_tpu_torch.train.steps import TrainStep, make_optimizer

B, C, T = 16, 4, 320
WORLD = 2


def _bn_case(dp):
    """Two train-mode forwards of a BatchNorm with a non-trivial affine map,
    the backward of a random linear functional of the second; returns the
    global batch's outputs and input gradients and the running buffers."""
    rng = np.random.default_rng(5)
    xs = [rng.normal(1.5, 2.0, (8, 6, 40)).astype(np.float32) for _ in range(2)]
    g = torch.from_numpy(rng.normal(size=(8, 6, 40)).astype(np.float32))
    bn = BatchNorm1d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
    sl = dp.block(8) if dp is not None else slice(None)
    bn(torch.from_numpy(xs[0][sl]))
    x = torch.from_numpy(xs[1][sl]).requires_grad_(True)
    y = bn(x)
    (y * g[sl]).sum().backward()
    out, grad = y.detach(), x.grad
    if dp is not None:
        out, grad = dp.gather(out), dp.gather(grad)
    return {"out": out, "grad": grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(),
            "weight_grad": bn.weight.grad.clone() if dp is None
            else dp.mean(bn.weight.grad) * dp.world}


def _one_step(dp, name="resnet9-5k"):
    """One train step with PCGmix and SELC active (es=0, epoch 1) over a
    batch of B rows: the whole batch, or this rank's block of it."""
    ds = synthetic_physionet_dict(num_wavs_train=12, num_wavs_test=2,
                                  segments_per_wav=2, sig_len=T, seed=6)
    train = physionet_split(ds, "train", train_balance=False)
    model = seeded_init(build_model(name, 2, C, T, seed=3), 4)
    if dp is not None:
        dp.broadcast_module(model)
    opt, sched = make_optimizer(model, "adam", 0.01, 1e-4, 10, True)
    engine = AugmentEngine(AugmentConfig("durratiomixup", B, C, T))
    table = init_selc_table(train.label, 2)
    step = TrainStep(model, opt, sched, torch.from_numpy(train.data),
                     torch.from_numpy(train.label), table, num_classes=2,
                     grad_clip=0.1, selc_es=0, engine=engine, dp=dp)
    idx = np.arange(B) % len(train)
    plan = engine.plan(0, train.frames[idx], train.label[idx])
    out = step(idx, plan.arrays, epoch=1)
    head = [m for m in model.modules() if isinstance(m, torch.nn.Linear)][-1]
    return {"loss": float(out["loss"]), "preds": out["preds"].numpy(),
            "linear": head.weight.detach().numpy().copy(),
            "table": table.numpy().copy(),
            "table0": init_selc_table(train.label, 2).numpy()}


INDIVISIBLE = dict(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=3,
                   batch_size=7, save_artifacts=False, device="cpu")


def _indivisible():
    """train_model with a batch of 7 rows: inside a group of 2 ranks every
    rank runs all of it."""
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4,
                                  segments_per_wav=2, sig_len=256, seed=3)
    return train_model(TrainConfig(**INDIVISIBLE), ds)


def _rank_cases():
    """Entry point of each spawned rank."""
    dp = DataParallel.current()
    return {"bn": _bn_case(dp), "step": _one_step(dp),
            "potes": _one_step(dp, "Potes"), "fcn": _one_step(dp, "FCN"),
            "indivisible": _indivisible()}


@pytest.fixture(scope="module")
def cases():
    dp = spawn(_rank_cases, WORLD, "gloo")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' thread count: the same sum orders
    try:
        one = {"bn": _bn_case(None), "step": _one_step(None),
               "potes": _one_step(None, "Potes"), "fcn": _one_step(None, "FCN"),
               "indivisible": _indivisible()}
    finally:
        torch.set_num_threads(threads)
    return {"dp": dp, "one": one}


@pytest.mark.parametrize("key", ["out", "grad", "running_mean", "running_var"])
def test_batchnorm_over_two_ranks_equals_the_concatenated_batch(cases, key):
    got, ref = cases["dp"]["bn"][key], cases["one"]["bn"][key]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_batchnorm_weight_gradients_sum_to_the_concatenated_batch(cases):
    # each rank holds its share of Σ_i g_i·x̂_i (320 terms, |Σ| up to ~25),
    # summed in another order than one pass over the batch: rtol 1e-5
    got, ref = cases["dp"]["bn"]["weight_grad"], cases["one"]["bn"]["weight_grad"]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["step", "potes", "fcn"])
def test_dp_step_loss_matches_single_device(cases, model):
    np.testing.assert_allclose(cases["dp"][model]["loss"],
                               cases["one"][model]["loss"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["step", "potes", "fcn"])
def test_dp_step_update_matches_single_device(cases, model):
    np.testing.assert_allclose(cases["dp"][model]["linear"],
                               cases["one"][model]["linear"], rtol=1e-4, atol=1e-6)


def test_dp_step_selc_table_is_replicated_and_updated(cases):
    dp, one = cases["dp"]["step"], cases["one"]["step"]
    np.testing.assert_allclose(dp["table"], one["table"], rtol=1e-5, atol=1e-6)
    # rows of both ranks' blocks moved away from their one-hot start
    moved = np.abs(dp["table"] - dp["table0"]).sum(axis=1) > 0
    assert moved[:B // 2].any() and moved[B // 2:B].any()


@pytest.mark.parametrize("model", ["step", "potes", "fcn"])
def test_dp_step_preds_identical(cases, model):
    np.testing.assert_array_equal(cases["dp"][model]["preds"],
                                  cases["one"][model]["preds"])


def test_indivisible_batch_is_replicated_and_equals_single_device(cases):
    got, ref = cases["dp"]["indivisible"], cases["one"]["indivisible"]
    assert got["steps"] == ref["steps"]
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=0, atol=1e-6)
    assert got["test_wav_preds"] == ref["test_wav_preds"]


def test_batch_that_does_not_divide_raises():
    """A batch that does not divide has no rank blocks: ``block`` raises,
    and the train step replicates such a batch instead of splitting it."""
    dp = DataParallel(rank=0, world=3)
    assert not dp.divides(8) and dp.divides(9)
    with pytest.raises(ValueError, match="8 rows .* 3 ranks"):
        dp.block(8)


def test_rank_blocks_cover_the_batch_in_order():
    arrays = {"mix": np.arange(8)[::-1].copy(), "knots": np.zeros((8, 6, 4)),
              "lam": np.float32(0.3)}
    blocks = [DataParallel(rank=r, world=4).shard_arrays(arrays, 8) for r in range(4)]
    assert [DataParallel(rank=r, world=4).block(8) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    np.testing.assert_array_equal(np.concatenate([b["mix"] for b in blocks]),
                                  arrays["mix"])
    assert all(b["knots"].shape == (2, 6, 4) and b["lam"] == arrays["lam"]
               for b in blocks)


def test_train_model_inside_a_group_takes_the_group_route(tmp_path):
    """The torchrun way: train_model called inside an initialized (here
    1-rank gloo) group trains through the data-parallel step, global
    BatchNorm included, and gives the single-device numbers."""
    ds = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4,
                                  segments_per_wav=2, sig_len=256, seed=3)
    kw = dict(model="resnet9-5k", method="durmixmagwarp(0.2,4)", num_epochs=3,
              batch_size=8, save_artifacts=False, device="cpu")
    ref = train_model(TrainConfig(**kw), ds)
    init_group("gloo", 0, 1, str(tmp_path / "store"))
    try:
        with pytest.raises(ValueError, match="n_devices=2 inside a process group of 1"):
            train_model(TrainConfig(**kw, n_devices=2), ds)
        got = train_model(TrainConfig(**kw), ds)
    finally:
        dist.destroy_process_group()
    assert abs(got["train_loss"][0] - ref["train_loss"][0]) < 1e-5
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-3)
    assert got["test_wav_preds"] == ref["test_wav_preds"]

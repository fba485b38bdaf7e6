"""``steps_per_dispatch`` on the CPU: a chunk of K steps (one staged buffer,
identity plans for gated-off steps, the host draws made ahead, the noise
drawn per step, a partial chunk at an epoch's end) gives the performance
dict of one step per dispatch bit for bit; the methods the JAX package
keeps out of its scan mode run one step at a time; the pieces a captured
step relies on (host draws fed in order, launches counted per replay) hold
on their own.  On a card the chunk is a CUDA graph: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.models.layers import feed_draws, host_uniform, record_draws
from pcgmix_tpu_torch.ops import build
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train import steps as steps_mod

T, BATCH = 512, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset():
    # 22 recordings × 2 segments: 5 steps of 8 an epoch, so K = 4 gives a
    # full chunk and a partial one of a step each epoch
    return synthetic_physionet_dict(num_wavs_train=22, num_wavs_test=6,
                                    segments_per_wav=2, sig_len=T, seed=3)


def _run(dataset, k, **kw):
    cfg = dict(model="resnet9-5k", method="durratiomixup", num_epochs=3, batch_size=BATCH,
               save_artifacts=False, device="cpu", track_variability=True)
    return train_model(TrainConfig(**{**cfg, **kw}, steps_per_dispatch=k), dataset)


@pytest.mark.parametrize("model,method", [
    ("resnet9-5k", "base"), ("resnet9-5k", "durratiomixup"),
    ("resnet9-5k", "durmixmagwarp(0.2,4)+0.5"), ("resnet9-5k", "mixup(same)"),
    ("resnet9-5k", "gaussiannoise"), ("Potes", "durmixmagwarp(0.2,4)"),
    ("resnet9-5k", "magnitudewarp(0.2,4)"), ("resnet9-5k", "cutmix"),
])
def test_chunks_equal_single_steps(model, method, dataset, monkeypatch):
    chunks = []
    run = steps_mod.MultiStep.run
    monkeypatch.setattr(steps_mod.MultiStep, "run",
                        lambda self, c, e: chunks.append(len(c)) or run(self, c, e))
    one, four = _run(dataset, 1, model=model, method=method), _run(
        dataset, 4, model=model, method=method)
    assert chunks == [4, 1] * 3  # a full and a partial chunk an epoch
    assert one["steps"] == four["steps"] == [5, 10, 15]
    for key in one:
        if key != "times":
            assert four[key] == one[key], key


@pytest.mark.parametrize("method", ["latentmixup", "manifold-cutout", "lc-nointrusion",
                                    "saliency-cutmix"])
def test_methods_outside_the_scan_run_one_step_at_a_time(method, dataset, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a chunk ran")

    monkeypatch.setattr(steps_mod.MultiStep, "run", refuse)
    got = _run(dataset, 4, method=method, num_epochs=1)
    assert got == {**_run(dataset, 1, method=method, num_epochs=1), "times": got["times"]}


def test_latent_space_runs_one_step_at_a_time(dataset, monkeypatch):
    monkeypatch.setattr(steps_mod.MultiStep, "run",
                        lambda *a: (_ for _ in ()).throw(AssertionError("a chunk ran")))
    _run(dataset, 4, num_epochs=1, latent_space=True)


def test_steps_per_dispatch_must_be_positive(dataset):
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        _run(dataset, 0, num_epochs=1)


def test_host_draws_fed_in_recorded_order():
    gen = torch.Generator().manual_seed(7)
    with record_draws() as log:
        a = host_uniform(gen, (3, 2), torch.device("cpu"))
        b = host_uniform(gen, (4,), torch.device("cpu"))
    assert [s for _, s in log] == [(3, 2), (4,)] and all(g is gen for g, _ in log)
    gen.manual_seed(7)
    ahead = [torch.rand(s, generator=g) for g, s in log]
    assert torch.equal(ahead[0], a) and torch.equal(ahead[1], b)
    before = gen.get_state()
    with feed_draws(ahead):
        assert host_uniform(gen, (3, 2), torch.device("cpu")) is ahead[0]
        assert host_uniform(gen, (4,), torch.device("cpu")) is ahead[1]
    assert torch.equal(gen.get_state(), before)  # fed draws draw nothing


def test_launches_recorded_in_a_capture_count_per_replay():
    build.reset_launch_counts()
    with build.capturing() as captured:
        build._captured["pcgmix_plus_fused"] += 1  # what launch() does in a capture
    assert build.launch_counts()["pcgmix_plus_fused"] == 0
    for _ in range(3):
        build.count_replay(captured)
    assert build.launch_counts()["pcgmix_plus_fused"] == 3
    build.reset_launch_counts()


def test_warm_up_launches_count_apart():
    """A graph warm-up's launches are real but undone: counted in
    warm_up_counts, not in launch_counts, and reset with them."""
    build.reset_launch_counts()
    with build.capturing(warm_up=True):
        build._captured["pcgmix_plus_fused"] += 4  # what launch() does in a warm-up
    assert build.launch_counts()["pcgmix_plus_fused"] == 0
    assert build.warm_up_counts()["pcgmix_plus_fused"] == 4
    build.reset_launch_counts()
    assert build.warm_up_counts()["pcgmix_plus_fused"] == 0


@pytest.mark.parametrize("op", ["adam", "SGD"])
@pytest.mark.parametrize("use_sched", [True, False])
def test_scalar_fed_update_matches_the_optimizer(op, use_sched):
    """The update a CUDA graph replays (per-step scalars from a tensor)
    against torch's own eager step, fed from the same scheduler: within
    float32 rounding after 20 steps."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(), torch.nn.Linear(5, 2))
    twin = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(), torch.nn.Linear(5, 2))
    twin.load_state_dict(net.state_dict())
    opt, sched = steps_mod.make_optimizer(net, op, 0.01, 1e-4, 20, use_sched)
    topt, tsched = steps_mod.make_optimizer(twin, op, 0.01, 1e-4, 20, use_sched)
    fed = steps_mod.ScalarFedUpdate(topt)
    x, y = torch.randn(16, 6), torch.randint(0, 2, (16,))
    for _ in range(20):
        for m in (net, twin):
            m.zero_grad(set_to_none=True)
            torch.nn.functional.cross_entropy(m(x), y).backward()
        opt.step()
        if sched is not None:
            sched.step()
        lr, momentum = steps_mod.schedule_values(topt, tsched)
        fed.apply(torch.tensor(fed.host_scalars(lr, momentum), dtype=torch.float32))
    for a, b in zip(net.parameters(), twin.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-5,
                                   atol=1e-7)
    if op == "adam":
        assert all(int(topt.state[p]["step"]) == 20 for p in twin.parameters())


def test_warm_up_snapshot_restores_every_state_in_place(dataset):
    """What a card's warm-up chunk changes comes back, in the same tensors
    (a graph captures their addresses): weights, BatchNorm buffers,
    optimizer and scheduler state with the learning rate and momentum it
    wrote into the group, the SELC table, Potes' generator, Adam's count."""
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.train.losses import init_selc_table

    model = build_model("Potes", 2, 4, T, seed=1).train()
    opt, sched = steps_mod.make_optimizer(model, "adam", 0.01, 1e-4, 10, True)
    labels = torch.randint(0, 2, (16,))
    step = steps_mod.TrainStep(model, opt, sched, torch.randn(16, 4, T), labels,
                               init_selc_table(labels.numpy(), 2), num_classes=2,
                               grad_clip=0.1, selc_es=0)
    multi = steps_mod.MultiStep(step, 2)
    step.fed = steps_mod.ScalarFedUpdate(opt)
    tensors = {**dict(model.state_dict()), "soft": step.soft_labels,
               **{f"{i}{k}": v for i, p in enumerate(step.fed.params)
                  for k, v in opt.state[p].items()}}
    before = {k: v.clone() for k, v in tensors.items()}
    gen_state = model.generator.get_state()
    snap = multi._snapshot()
    for _ in range(3):
        lr, momentum = steps_mod.schedule_values(opt, sched)
        scal = torch.tensor(step.fed.host_scalars(lr, momentum), dtype=torch.float32)
        step.run(torch.arange(8), None, epoch=2, scalars=scal)
    assert not torch.equal(tensors["soft"], before["soft"])
    multi._restore(snap)
    for k, v in tensors.items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(model.generator.get_state(), gen_state)
    assert opt.param_groups[0]["lr"] == sched.get_last_lr()[0] == snap["group"]["lr"]
    assert opt.param_groups[0]["betas"] == snap["group"]["betas"] and step.fed.t == 0

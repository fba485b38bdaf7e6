"""ResNet9 of the PyTorch port against pcgmix_tpu.models: transplanted
weights give the same logits, seeded init equals torch_seeded_init, and
BatchNorm running statistics follow flax (biased batch variance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.train.convert import torch_resnet9_to_flax, torch_seeded_init
from pcgmix_tpu_torch.models import RESNET9_PRESETS, build_model, count_parameters
from pcgmix_tpu_torch.train.convert import jax_resnet9_to_torch, seeded_init

C = 4
LOGIT_RTOL = 1e-4  # fp32 convs summed in another order, through 9 layers


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variables(name, T, seed=0):
    model = jbuild(name, train=True)
    return model.init(jax.random.PRNGKey(seed), jnp.zeros((1, C, T), jnp.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_from_jax(name, T, variables):
    model = build_model(name, 2, C, T)
    model.load_state_dict(jax_resnet9_to_torch(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])
    ))
    return model


def _assert_logits_close(got, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_RTOL * scale)


@pytest.mark.parametrize("name,T,B", [("resnet9-5k", 512, 8), ("resnet9", 512, 2)])
@pytest.mark.parametrize("train", [True, False])
def test_transplanted_logits_match(name, T, B, train, rng):
    variables = _jax_variables(name, T)
    # non-trivial running statistics, so eval mode is really tested
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, v.shape).astype(np.float32),
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    model = _port_from_jax(name, T, variables)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jmodel = jbuild(name, train=train)
    if train:
        ref, _ = jmodel.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    else:
        ref = jmodel.apply(variables, jnp.asarray(x))
    _assert_logits_close(got, np.asarray(ref))


def test_state_dict_roundtrip_through_flax_layout():
    model = seeded_init(build_model("resnet9-5k", 2, C, 256), 7)
    flax_tree = torch_resnet9_to_flax(model.state_dict())
    back = jax_resnet9_to_torch(flax_tree["params"], flax_tree["batch_stats"])
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.mark.parametrize("name,T", [("resnet9-5k", 512), ("resnet9-50k", 2500)])
def test_seeded_init_equals_torch_seeded_init(name, T):
    model = seeded_init(build_model(name, 2, C, T), seed=4)
    got = torch_resnet9_to_flax(model.state_dict())
    exp = torch_seeded_init(name, num_channels=C, sig_len=T, seed=4)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_e = jax.tree_util.tree_leaves_with_path(exp)
    assert len(flat_g) == len(flat_e)
    for (pg, lg), (pe, le) in zip(flat_g, flat_e):
        assert pg == pe
        np.testing.assert_array_equal(lg, le, err_msg=str(pg))


def test_seeded_init_leaves_global_rng_alone():
    model = build_model("resnet9-5k", 2, C, 256)
    torch.manual_seed(123)
    expect = torch.rand(3)
    torch.manual_seed(123)
    seeded_init(model, 4)
    assert torch.equal(torch.rand(3), expect)


def test_batchnorm_running_stats_follow_flax(rng):
    """A few train-mode forwards: the running mean/var equal flax's, which
    folds the biased batch variance (nn.BatchNorm1d alone folds the unbiased
    one and would differ by n/(n-1))."""
    T, B = 256, 4
    variables = _jax_variables("resnet9-5k", T, seed=1)
    model = _port_from_jax("resnet9-5k", T, variables)
    model.train()
    jmodel = jbuild("resnet9-5k", train=True)
    stats = variables["batch_stats"]
    for _ in range(3):
        x = rng.normal(size=(B, C, T)).astype(np.float32) * 2.0 + 0.5
        with torch.no_grad():
            model(torch.from_numpy(x))
        _, mut = jmodel.apply({"params": variables["params"], "batch_stats": stats},
                              jnp.asarray(x), mutable=["batch_stats"])
        stats = mut["batch_stats"]
    ref = jax_resnet9_to_torch(_np_tree(variables["params"]), _np_tree(stats))
    sd = model.state_dict()
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


def test_registry_presets_and_parameter_counts():
    for name, f in RESNET9_PRESETS.items():
        model = build_model(name, 2, C, 2500)
        assert model.conv1[0].out_channels == f[0]
        assert model.linear.in_features == f[3] * (2500 // 32)
    assert count_parameters(build_model("resnet9-5k", 2, C, 2500)) > 0
    assert count_parameters(build_model("FCN")) > 0  # the zoo is ported too
    with pytest.raises(ValueError, match="unknown model"):
        build_model("FCN(huge)")

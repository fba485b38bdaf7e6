"""The reference's own models in the PyTorch port against pcgmix_tpu:
FCN, FCN(custom), ResCNN, ResNet and Singstad d3/d6/d10, carried over from
the JAX package's weights by ``jax_to_torch``; and the registry's 39 names
with the JAX package's parameter counts.

For each architecture one JAX run (one jitted function at a small size,
shared by the module's tests; weights drawn from a numpy seed into the
shapes of ``jax.eval_shape(model.init)``) gives: the train-mode logits, the
``latent_space`` features, the updated running statistics, the eval-mode
activation at every split depth (the running statistics' path), and the
gradient of
the soft-target cross entropy.  Held: logits, features and split
activations within 1e-5, running statistics within 1e-6, gradients within
1e-4 of each tensor's largest entry, and for FCN, ResCNN and Singstad_d10
first ∘ second equal to the full forward at every depth.

The JAX package runs in float64 on the same float32 inputs and weights:
its own float32 gradients read up to 8 % off its float64 ones at this size
on ResNet's first block (1 % on Singstad_d10), where the port's float32
gradients stay within 1e-6 of them, and its float32 running variances
(E[x²] − E[x]²) 2.8e-6 off on mWDN's.  The recurrent models' flax scan
keeps a float32 carry, so they run in float32
(tests/test_torch_zoo_tsai.py)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pcgmix_tpu.models import build_model as jbuild
from pcgmix_tpu.models.registry import MODEL_NAMES as J_MODEL_NAMES
from pcgmix_tpu.models.registry import count_parameters as jcount
from pcgmix_tpu_torch.models import MODEL_NAMES, build_model, count_parameters
from pcgmix_tpu_torch.models.registry import ALIASES
from pcgmix_tpu_torch.train.convert import jax_to_torch, seeded_init

B, C, T = 3, 4, 64
SPLIT = {"FCN": 4, "FCN(custom)": 4, "ResCNN": 5, "Singstad_d10": 3}
REF_NAMES = ["FCN", "FCN(custom)", "ResCNN", "ResNet", "Singstad_d3", "Singstad_d6",
             "Singstad_d10"]
RECURRENT = ("RNN", "LSTM", "GRU")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (the zoo test files share this):
    these small models run many short ops, and a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers (the
    runner test took 565 s there instead of 5)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_variables(jmodel, shape, seed):
    """The JAX model's variables, drawn with numpy into the shapes that
    ``jax.eval_shape(model.init)`` gives (no compile): kernels U(±1/√fan_in),
    biases U(±0.1), scales U(0.8, 1.2), PReLU 0.25, running means N(0, 0.1²)
    and variances U(0.5, 1.5)."""
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            b = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            a = rng.uniform(-b, b, s.shape)
        elif leaf == "bias":
            a = rng.uniform(-0.1, 0.1, s.shape)
        elif leaf == "scale":
            a = rng.uniform(0.8, 1.2, s.shape)
        elif leaf == "alpha":
            a = np.full(s.shape, 0.25)
        elif leaf == "mean":
            a = rng.normal(0.0, 0.1, s.shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            raise KeyError(leaf)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def soft_ce(logits, target, xp):
    """The step's loss for targets without SELC: soft-target cross entropy."""
    if xp is torch:
        return -(target * torch.log_softmax(logits, dim=1)).sum(dim=1).mean()
    return -jnp.mean(jnp.sum(target * jax.nn.log_softmax(logits, axis=1), axis=1))


def reference_run(name, shape, seed=0):
    """One jitted run of the JAX package's model ``name`` on inputs of
    ``shape`` drawn from ``seed``, in float64 (float32 for the recurrent
    models); returns the float32 inputs and variables and the results, as
    numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    target = np.eye(2, dtype=np.float32)[rng.integers(0, 2, shape[0])]
    jm, je = jbuild(name, train=True), jbuild(name, train=False)
    variables = numpy_variables(jm, shape, seed)
    dt = np.float32 if name in RECURRENT else np.float64
    depths = range(SPLIT.get(name, -1) + 1)

    def run(v, x, target):
        def loss(params):
            out, mut = jm.apply({**v, "params": params}, x, mutable=["batch_stats"])
            return soft_ce(out, target, jnp), (out, mut.get("batch_stats", {}))

        (_, (out, stats)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
        latent, _ = jm.apply(v, x, part="latent_space", mutable=["batch_stats"])
        return {"logits": out, "latent": latent, "stats": stats, "grads": grads,
                "firsts": [je.apply(v, x, depth=d, part="first") for d in depths]}

    with jax.enable_x64(True):
        cast = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), (variables, x, target))
        res = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                     jax.jit(run)(*cast))
    return {"x": x, "target": target, "variables": variables, **res}


def port_run(name, ref):
    """The port's model carrying the reference's weights, on the same
    inputs: train-mode logits and gradients, the state after that step's
    forward, and ``latent_space`` from the carried state."""
    x, target, v = ref["x"], ref["target"], ref["variables"]
    model = build_model(name, 2, x.shape[1], x.shape[2])
    model.load_state_dict(jax_to_torch(name, v["params"], v.get("batch_stats", {})))
    fresh = copy.deepcopy(model)
    xt = torch.from_numpy(x)
    model.train()
    logits = model(xt)
    soft_ce(logits, torch.from_numpy(target), torch).backward()
    with torch.no_grad():
        latent = copy.deepcopy(fresh).train()(xt, part="latent_space")
    return {"model": model, "fresh": fresh.eval(), "logits": logits.detach(),
            "latent": latent}


@functools.lru_cache(maxsize=None)
def runs(name):
    """The JAX run of ``name`` and the port's, once per test process."""
    ref = reference_run(name, (B, C, T))
    return name, ref, port_run(name, ref)


@pytest.fixture(params=REF_NAMES)
def pair(request):
    return runs(request.param)


def assert_close_to_reference(name, ref, got):
    """Shared assertions of a carried model against its JAX run (both zoo
    test files hold their architectures with this)."""
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["latent"].numpy(), ref["latent"], rtol=1e-5, atol=1e-5)


def assert_stats_close(name, ref, got):
    want = jax_to_torch(name, ref["variables"]["params"], ref["stats"])
    sd = got["model"].state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys or not ref["stats"]
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def assert_grads_close(name, ref, got):
    want = jax_to_torch(name, ref["grads"])
    params = dict(got["model"].named_parameters())
    assert sorted(params) == sorted(want)
    for k, g in want.items():
        g = g.numpy()
        # within 1e-4 of the tensor's largest entry; the floor covers a
        # gradient that is zero in exact arithmetic (a conv bias before a
        # BatchNorm), which float32 leaves at rounding noise
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-6, err_msg=k)


def test_logits_and_latent_match_reference(pair):
    assert_close_to_reference(*pair)


def test_running_statistics_match_reference(pair):
    assert_stats_close(*pair)


def test_gradients_match_reference(pair):
    assert_grads_close(*pair)


@pytest.mark.parametrize("name", list(SPLIT))
def test_split_forward_at_every_depth(name):
    """The eval-mode activation at each depth equals the JAX package's, and
    the second part from it gives the full forward bit for bit."""
    _, ref, got = runs(name)
    model = got["fresh"]
    xt = torch.from_numpy(ref["x"])
    with torch.no_grad():
        full = model(xt)
        for depth, jfirst in enumerate(ref["firsts"]):
            first = model(xt, depth=depth, part="first")
            assert first.shape == jfirst.shape, depth
            np.testing.assert_allclose(first.numpy(), jfirst, rtol=0, atol=1e-5,
                                       err_msg=f"depth {depth}")
            assert torch.equal(model(first, depth=depth, part="second"), full), depth


@functools.lru_cache(maxsize=None)
def jax_tree(name):
    """The JAX package's variables of ``name`` at 4 × 2500, as shapes (an
    alias shares its model's)."""
    return jax.eval_shape(jbuild(ALIASES.get(name, name), train=True).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, C, 2500), jnp.float32))


@pytest.mark.parametrize("name", J_MODEL_NAMES)
def test_parameter_counts_equal_reference(name):
    """Every registry name builds, with the JAX package's parameter count at
    4 × 2500, the count ``chip_smoke.py`` prints beside the port's."""
    n = count_parameters(build_model(name, 2, C, 2500))
    assert n == jcount(jax_tree(name)["params"]) == chip_smoke.JAX_PARAM_COUNTS[name]


@pytest.mark.parametrize("name", J_MODEL_NAMES)
def test_jax_to_torch_carries_every_name(name):
    """Each name's JAX variables load into the port's model, every tensor
    of its state_dict filled (strict), in its shape."""
    variables = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                       jax_tree(name))
    model = build_model(name, 2, C, 2500)
    model.load_state_dict(jax_to_torch(name, variables["params"],
                                       variables.get("batch_stats")))
    assert all(bool((p == 1).all()) for p in model.parameters())


def test_registry_names_equal_reference():
    assert MODEL_NAMES == tuple(J_MODEL_NAMES)
    assert set(chip_smoke.JAX_PARAM_COUNTS) == set(MODEL_NAMES)
    with pytest.raises(ValueError, match="unknown model"):
        build_model("FCN(huge)")


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_aliases_build_their_model(alias):
    a, b = build_model(alias, 2, C, 128), build_model(ALIASES[alias], 2, C, 128)
    assert type(a) is type(b)
    assert {k: v.shape for k, v in a.state_dict().items()} == {
        k: v.shape for k, v in b.state_dict().items()}


@pytest.mark.parametrize("name", ["ResNet", "Singstad_d3", "Singstad_d6"])
def test_models_without_a_split_refuse_it(name):
    model = build_model(name, 2, C, T)
    for part in ("first", "second"):
        with pytest.raises(NotImplementedError, match="split"):
            model(torch.zeros(2, C, T), depth=1, part=part)


def test_singstad_reuses_its_shared_modules():
    """d10 applies ``deep2`` nine times and ``shortcut2`` twice: one module
    each, whose BatchNorm updates once per application (flax's shared
    module does the same); d3 has no ``shortcut2``."""
    model = build_model("Singstad_d10", 2, C, T).train()
    model(torch.randn(2, C, T))
    assert int(model.deep2.batchnorm.num_batches_tracked) == 9
    assert int(model.deep1.batchnorm.num_batches_tracked) == 1
    assert int(model.shortcut2.bn.num_batches_tracked) == 2
    assert not hasattr(build_model("Singstad_d3", 2, C, T), "shortcut2")


def test_seeded_init_is_deterministic_for_every_family():
    for name in ("FCN", "ResCNN", "Singstad_d10"):
        a = seeded_init(build_model(name, 2, C, T), 4).state_dict()
        b = seeded_init(build_model(name, 2, C, T), 4).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)

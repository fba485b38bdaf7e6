"""The port's latent-space reductions and plots (``latent.py``,
``manifold.py``, the raster's markers) against the JAX package's
``dim_reduc_pca``, ``dim_reduc_tsne`` and ``plot_latent_space*``
(scikit-learn 1.9.0 and matplotlib), on the CPU.

Bars, as measured on the CPU test machine:
- PCA in float64 against scikit-learn on float64 features, for each
  solver ``svd_solver="auto"`` picks by shape (``covariance_eigh``,
  ``full``, ``randomized``: an approximation, on data whose leading
  directions stand out): coordinates within 1e-12 of the largest
  coordinate (measured up to 1.4e-15), the explained-variance sum within
  1e-12 (6.7e-16).  On the JAX ``LatentSpace``'s float32 features
  scikit-learn computes in float32: 1e-4 of the largest coordinate and
  1e-5 absolute on the sum; cast to float64 first, 1e-12 again.
- P within 1e-6 relative of ``_joint_probabilities_nn`` on the port's
  neighbour graph (measured 1.0e-15); the neighbours equal
  ``NearestNeighbors``', their squared distances within 1e-6 relative
  (scikit-learn reckons float32 features' distances in float32: measured
  1.5e-7; the port in float64).
- The optimizer against scikit-learn's ``_gradient_descent`` driven by the
  port's exact objective, its whole schedule at n = 64 (1000 iterations,
  across the switch at 250): within 1e-5 (measured 0).
- ``dim_reduc_tsne`` against the JAX one on 2 × 150 points: trustworthiness
  (5 neighbours) within 0.02 (measured 0.0125), the KL divergence under
  the port's P within 5 % (measured 0.3 %).
- The plots with PCA, on float64 features (scikit-learn's PCA keeps
  float32 ones in float32): titles, legend labels, each scatter's offsets
  within 1e-9, edge colors, sizes and alpha, the medoid labels and their places,
  the file names; the PNG decodes at the JAX file's size and mode and
  equals the port's raster.  With t-SNE: labels, titles and file names.
"""

import os

import matplotlib.colors as mcolors
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from scipy.sparse import csr_array
from scipy.spatial import distance_matrix
from sklearn.manifold import trustworthiness
from sklearn.manifold._t_sne import _gradient_descent, _joint_probabilities_nn
from sklearn.neighbors import NearestNeighbors

import pcgmix_tpu.latent as jlatent
from pcgmix_tpu_torch import latent, manifold
from pcgmix_tpu_torch.exp import raster

Image = pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(n, d, seed, dtype=np.float64):
    """Features with three leading directions over isotropic noise."""
    rng = np.random.default_rng(seed)
    lead = (rng.normal(size=(n, 3)) * [6.0, 3.0, 1.5]) @ rng.normal(size=(3, d))
    return (rng.normal(size=(n, d)) + lead).astype(dtype)


# (n, d) that send scikit-learn's svd_solver="auto" to each solver
SOLVERS = {"covariance_eigh": (300, 16), "full": (100, 64), "randomized": (600, 128)}


def _pca_gap(fts, fts_new):
    np.random.seed(0)  # the randomized solver draws from numpy's global generator
    theirs = jlatent.dim_reduc_pca(fts, fts_new)
    ours = latent.dim_reduc_pca(fts, fts_new, device="cpu")
    scale = np.abs(theirs[0]).max()
    coords = max(np.abs(a - b).max() for a, b in zip(ours[:2], theirs[:2])) / scale
    return coords, abs(ours[2] - theirs[2]), ours, theirs


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_pca_matches_each_solver(solver):
    from sklearn.decomposition import PCA

    n, d = SOLVERS[solver]
    fts, fts_new = _features(n, d, 1), _features(40, d, 2)
    pca = PCA(n_components=2)
    pca.fit(fts)
    assert pca._fit_svd_solver == solver
    coords, expl, ours, _ = _pca_gap(fts, fts_new)
    assert coords <= 1e-12 and expl <= 1e-12, (coords, expl)
    assert ours[1].shape == (40, 2)


@pytest.fixture(scope="module")
def jax_latent_features(tmp_path_factory):
    """The JAX ``LatentSpace``'s ResCNN embeddings (128 features, float32)
    of a synthetic train split at sig_len 512, from weights initialized
    under ``jit`` and written as its msgpack checkpoint."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from pcgmix_tpu.data import physionet_split, synthetic_physionet_dict
    from pcgmix_tpu.models import build_model

    variables = jax.jit(build_model("ResCNN", num_classes=2, train=False).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 512)))
    path = tmp_path_factory.mktemp("latent") / "model.msgpack"
    path.write_bytes(serialization.to_bytes(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    ds = synthetic_physionet_dict(num_wavs_train=12, num_wavs_test=4, segments_per_wav=8,
                                  sig_len=512, seed=5)
    split = physionet_split(ds, "train")
    fts = jlatent.LatentSpace(str(path), sig_len=512).generate(split.data)
    return fts, np.asarray(split.label)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pca_on_latent_space_features(jax_latent_features, dtype):
    fts = jax_latent_features[0].astype(dtype)
    assert fts.shape[1] == 128
    coords, expl, _, _ = _pca_gap(fts[:64], fts[64:])
    bars = (1e-4, 1e-5) if dtype == "float32" else (1e-12, 1e-12)
    assert coords <= bars[0] and expl <= bars[1], (coords, expl)


def test_pca_without_new_points_and_its_refusals():
    fts = _features(30, 5, 3)
    a, b, expl = latent.dim_reduc_pca(fts, fts[:0], device="cpu")
    assert a.shape == (30, 2) and b.shape == (0, 2) and 0 < expl <= 1
    with pytest.raises(ValueError, match="n_components=6"):
        latent.dim_reduc_pca(fts, fts[:0], num_components=6, device="cpu")


def test_reductions_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    fts = _features(20, 4, 4)
    for reduce in (latent.dim_reduc_pca, latent.dim_reduc_tsne):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reduce(fts, fts[:3])


def _clouds(n_per_class, d, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0.0, 1.0, (n_per_class, d)),
                        rng.normal(2.0, 1.0, (n_per_class, d))]).astype(np.float32)
    return x, np.repeat([0, 1], n_per_class)


def _dense(p: manifold.JointProbabilities) -> np.ndarray:
    out = np.zeros((p.n, p.n))
    out[p.rows.numpy(), p.cols.numpy()] = p.values.numpy()
    return out


def _joint(x, perplexity=15):
    n = len(x)
    sqdist, neighbors = manifold.nearest_neighbors(torch.from_numpy(x),
                                                   min(n - 1, int(3 * perplexity + 1)))
    return manifold.joint_probabilities(sqdist, neighbors, perplexity)


def test_joint_probabilities_match_scikit_learn():
    x, _ = _clouds(100, 24, 6)
    n, perplexity = len(x), 15
    k = min(n - 1, int(3 * perplexity + 1))
    sqdist, neighbors = manifold.nearest_neighbors(torch.from_numpy(x), k)
    dist, ind = NearestNeighbors(n_neighbors=k).fit(x).kneighbors()
    np.testing.assert_array_equal(np.sort(neighbors.numpy(), 1), np.sort(ind, 1))
    np.testing.assert_allclose(sqdist.numpy(), dist ** 2, rtol=1e-6)
    graph = csr_array((sqdist.numpy().ravel(), neighbors.numpy().ravel(),
                       np.arange(0, n * k + 1, k)), shape=(n, n))
    theirs = _joint_probabilities_nn(graph, perplexity, 0).toarray()
    ours = _dense(manifold.joint_probabilities(sqdist, neighbors, perplexity))
    assert np.abs(ours.sum() - 1) < 1e-12
    np.testing.assert_array_equal(ours != 0, theirs != 0)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


def test_optimizer_matches_scikit_learn_across_the_switch():
    """The whole schedule at n = 64: 250 iterations exaggerated at momentum
    0.5, then at 0.8 up to 1000 or a stop, both driven by the port's exact
    objective."""
    x, _ = _clouds(32, 16, 7)
    n, p = len(x), _joint(x)
    y0 = 1e-4 * np.random.RandomState(4).standard_normal((n, 2)).astype(np.float32)
    learning_rate = np.maximum(n / 12 / 4, 50)
    held = {}

    def objective(params, compute_error=True):
        error, grad = manifold.kl_objective(torch.from_numpy(params).reshape(n, 2), p,
                                            held["p32"], compute_error)
        return error, grad.reshape(-1).numpy()

    common = dict(n_iter_check=50, learning_rate=learning_rate, min_gain=0.01,
                  min_grad_norm=1e-7)
    held["p32"] = (p.values * 12).float()
    params, _, it = _gradient_descent(objective, y0.ravel().copy(), 0, 250, momentum=0.5,
                                      n_iter_without_progress=250, **common)
    held["p32"] = (p.values * 12 / 12).float()
    params, error, it = _gradient_descent(objective, params, it + 1, 1000, momentum=0.8,
                                          n_iter_without_progress=300, **common)
    ours, our_error, our_it = manifold.optimize(p, torch.from_numpy(y0), float(learning_rate))
    assert (our_it, it) == (999, 999)
    np.testing.assert_allclose(ours.numpy().ravel(), params, rtol=0, atol=1e-5)
    assert abs(our_error - error) <= 1e-5 * abs(error)


def test_tsne_matches_scikit_learn_by_trustworthiness_and_kl():
    x, _ = _clouds(150, 32, 8)
    ours = latent.dim_reduc_tsne(x[:150], x[150:], device="cpu")
    emb = np.concatenate(ours[:2])
    assert emb.dtype == np.float32 and ours[0].shape == (150, 2) and ours[2] == -1.0
    state = np.random.get_state()
    theirs = jlatent.dim_reduc_tsne(x[:150], x[150:])
    np.random.set_state(state)
    theirs = np.concatenate(theirs[:2])
    t_ours, t_theirs = (trustworthiness(x, e, n_neighbors=5) for e in (emb, theirs))
    p = _joint(x)
    kl_ours, kl_theirs = (manifold.kl_divergence(p, e) for e in (emb, theirs))
    print(f"\nt-SNE, 2 x 150 points: trustworthiness {t_ours:.4f} against {t_theirs:.4f}, "
          f"KL {kl_ours:.4f} against {kl_theirs:.4f}")
    assert abs(t_ours - t_theirs) <= 0.02
    assert abs(kl_ours - kl_theirs) <= 0.05 * kl_theirs
    with pytest.raises(ValueError, match="perplexity"):
        manifold.tsne(x[:10], perplexity=10, device="cpu")


@pytest.mark.parametrize("k", [1, 5])
def test_chip_smoke_trustworthiness_is_scikit_learn(k, tmp_path):
    """The numpy trustworthiness and PNG header parse ``chip_smoke.py``'s
    phase 3j holds the card with (the GPU machine has no scikit-learn)."""
    import chip_smoke

    x, _ = _clouds(40, 8, 11)
    emb = np.random.default_rng(12).normal(size=(80, 2)) + x[:, :2]
    ours = chip_smoke.trustworthiness(np, x, emb, k)
    assert abs(ours - trustworthiness(x, emb, n_neighbors=k)) <= 1e-12
    path = raster.Canvas(30, 20).save(str(tmp_path / "a.png"))
    assert chip_smoke.png_size(path) == (30, 20)
    with pytest.raises(AssertionError, match="not a PNG"):
        chip_smoke.png_size(raster.Canvas(30, 20).save(str(tmp_path / "a.jpg")))


@pytest.mark.parametrize("seed", range(4))
def test_medoid_is_scipy_distance_matrix_argmin(seed):
    pts = np.random.default_rng(seed).random((60 + 40 * seed, 2)).astype(np.float32)
    assert latent.medoid(pts) == int(np.argmin(distance_matrix(pts, pts).sum(axis=0)))


# --------------------------------------------------------------------------- #
# the plots
# --------------------------------------------------------------------------- #


def _rgb(color) -> tuple:
    return tuple(int(round(c * 255)) for c in mcolors.to_rgb(color))


def assert_latent_axes_equal(desc: raster.Axes, ax, offsets: bool) -> None:
    """Title, legend labels and, with ``offsets``, each scatter's points
    (within 1e-9), edge color, size and alpha and the medoid labels."""
    assert desc.title == ax.get_title()
    assert desc.legend_labels() == [t.get_text() for t in ax.get_legend().get_texts()]
    scatters = [s for s in desc.series if s.kind == "scatter"]
    assert [s.label or "_" for s in scatters] == [
        c.get_label() if not c.get_label().startswith("_") else "_" for c in ax.collections]
    notes = [s for s in desc.series if s.kind == "annotate"]
    assert [s.text for s in notes] == [t.get_text() for t in ax.texts]
    if not offsets:
        return
    for s, col in zip(scatters, ax.collections):
        np.testing.assert_allclose(np.stack([s.x, s.y], 1), col.get_offsets(), rtol=0,
                                   atol=1e-9)
        assert raster.rgb(s.color) == _rgb(col.get_edgecolor()[0])
        assert s.size == col.get_sizes()[0]
        assert (s.alpha if s.hollow else None) == col.get_alpha()
        assert s.hollow == (len(col.get_facecolor()) == 0)
    for s, t in zip(notes, ax.texts):
        np.testing.assert_allclose((s.x, s.y), t.xy, rtol=0, atol=1e-9)


def _latent_cases():
    x, y = _clouds(60, 24, 9)
    x = x.astype(np.float64)
    new = x + np.random.default_rng(10).normal(0, 0.3, x.shape)
    augmented = {"fts": x, "target": y, "fts_new": new, "trgts_new": y}
    test = {"fts": x[::2], "trgts": y[::2]}
    train = {"fts_new": new[1::2], "trgts_new": y[1::2]}
    return {
        "augmented": ("plot_latent_space", (augmented, "train", 3, 2, "durratiomixup"),
                      "latent_space_figure", ["{r}_train_3.png"]),
        "base": ("plot_latent_space", ({"fts": x, "target": y}, "valid", 1, 2, "base"),
                 "latent_space_figure", ["{r}_valid_1.png"]),
        "test": ("plot_latent_space_test", (test, "test", 2, 2, "durratiomixup"),
                 None, ["{r}_test_2.png"]),
        "test_train": ("plot_latent_space_test_train", (test, train, "final", 4, 2, "m"),
                       "latent_space_test_train_figures",
                       ["{r}_final(test)_4.png", "{r}_final(train)_4.png"]),
    }


LATENT_CASES = _latent_cases()


def _describe(case, reduce):
    plot, args, describe, _ = LATENT_CASES[case]
    if describe is None:  # the test variant: the originals as "base"
        feats = {"fts": args[0]["fts"], "trgts": args[0]["trgts"]}
        return [latent.latent_space_figure(feats, *args[1:4], "base", reduce, device="cpu")]
    if case == "test_train":
        return list(latent.latent_space_test_train_figures(*args[:5], reduce, device="cpu"))
    return [latent.latent_space_figure(*args, reduce, device="cpu")]


@pytest.mark.parametrize("reduce", ["pca", "tsne"])
@pytest.mark.parametrize("case", list(LATENT_CASES))
def test_latent_plot_matches_reference_figure(case, reduce, tmp_path, monkeypatch):
    plot, args, _, names = LATENT_CASES[case]
    figs = []
    monkeypatch.setattr(plt, "close", lambda fig=None: figs.append(fig))
    state = np.random.get_state()
    jpaths = getattr(jlatent, plot)(*args, str(tmp_path / "jax"), dim_reduc=reduce)
    np.random.set_state(state)
    monkeypatch.undo()
    paths = getattr(latent, plot)(*args, str(tmp_path / "port"), dim_reduc=reduce,
                                  device="cpu")
    jpaths, paths = ([p] if isinstance(p, str) else list(p) for p in (jpaths, paths))
    want = [os.path.join("latent_space", name.format(r=reduce)) for name in names]
    assert [os.path.relpath(p, tmp_path / "jax") for p in jpaths] == want
    assert [os.path.relpath(p, tmp_path / "port") for p in paths] == want
    descs = _describe(case, reduce)
    assert len(descs) == len(figs) == len(paths)
    for desc, fig, path, jpath in zip(descs, figs, paths, jpaths):
        (ax,) = fig.axes
        assert_latent_axes_equal(desc.axes[0], ax, offsets=reduce == "pca")
        plt.close(fig)
        theirs, ours = Image.open(jpath), Image.open(path)
        assert (ours.format, ours.size, ours.mode) == (theirs.format, theirs.size,
                                                       theirs.mode) == ("PNG", (600, 600),
                                                                        "RGBA")
        if reduce == "pca":
            decoded = np.asarray(ours)
            assert np.array_equal(decoded[..., :3], raster.render(desc).pixels)


# --------------------------------------------------------------------------- #
# the raster's markers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("marker", ["o", "P", "x"])
def test_marker_cells(marker):
    """Each glyph is symmetric about its centre; a hollow "o" or "P" leaves
    its centre white, a filled one covers it; "x" covers its diagonals."""
    hollow = set(zip(*raster.marker_cells(marker, 30, hollow=True)))
    filled = set(zip(*raster.marker_cells(marker, 30)))
    assert hollow <= filled and hollow == {(-y, -x) for y, x in hollow}
    if marker == "x":
        assert hollow == filled and {(2, 2), (-2, 2), (0, 0)} <= filled
    else:
        assert (0, 0) in filled - hollow
    with pytest.raises(ValueError, match="o, P or x"):
        raster.marker_cells("s", 30)


def test_glyphs_composite_alpha_per_cover(tmp_path):
    canvas = raster.Canvas(20, 20)
    canvas.glyphs([10.2, 10.4], [10.1, 10.3], (255, 0, 0), "o", 36, alpha=0.5)
    # both disks cover the centre: white composited twice at 0.5
    assert tuple(canvas.pixels[10, 10]) == (255, 64, 64)
    canvas.glyphs([10.0], [3.0], (0, 0, 255), "o", 36, alpha=0.5)
    assert tuple(canvas.pixels[3, 10]) == (128, 128, 255)

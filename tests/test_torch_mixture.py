"""The port's Gaussian mixture (``exp/mixture.py``) and its plot
(``plotters.plot_epoch_loss_gmm``) against scikit-learn 1.9.0 and the JAX
package's ``plot_epoch_loss_gmm``.

Bars: the k-means++ centres and their rows bit-equal to
``sklearn.cluster._kmeans._kmeans_plusplus`` on the same centred data and
generator; the KMeans labels equal to ``KMeans(2, n_init=1,
random_state=RandomState(4))``'s, its centres within 1e-12 (scikit-learn
sums a cluster over threads); the mixture's weights, means, covariances,
Cholesky precisions, ``score_samples`` and iteration count against
``GaussianMixture(2, random_state=4)`` within 1e-12, and the plot's return
value within 1e-12 of the JAX one (all measured 0 on the CPU test
machine); the figure's description against the JAX matplotlib figure
(``assert_axes_equal``), the JPEG within 30 dB PSNR of the port's raster.
"""

import os
import warnings

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.cluster._kmeans import _kmeans_plusplus
from sklearn.mixture import GaussianMixture

import pcgmix_tpu.exp.plotters as jplotters
from pcgmix_tpu_torch.exp import mixture, plotters, raster
from tests.test_torch_plots import _psnr, assert_axes_equal

Image = pytest.importorskip("PIL.Image")
BAR = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _losses():
    """(correct, incorrect) per-sample losses of four kinds of epoch."""
    rng = np.random.default_rng(20)
    return {
        "bimodal": (rng.normal(0.2, 0.05, 700).clip(0.01), rng.normal(0.7, 0.1, 300)),
        "unimodal": (rng.gamma(2.0, 0.1, 1500), rng.gamma(2.0, 0.1, 500)),
        "tied": (np.round(rng.random(400) * 8) / 8 + 0.125, np.full(100, 0.5)),
        "n3": (np.array([0.1, 0.5]), np.array([0.9])),
    }


CASES = _losses()


def _normed(case):
    losses = np.append(*CASES[case]).astype(np.float64)
    return (losses / losses.max()).reshape(-1, 1)


@pytest.mark.parametrize("case", list(CASES))
def test_kmeans_plusplus_centres_bit_equal(case):
    x = _normed(case)
    x = x - x.mean(axis=0)
    norms = np.einsum("ij,ij->i", x, x)
    theirs = _kmeans_plusplus(x, 2, norms, np.ones(len(x)), np.random.RandomState(4))
    ours = mixture.kmeans_plusplus(x, np.random.RandomState(4), norms)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])


@pytest.mark.parametrize("case", list(CASES))
def test_kmeans_labels_equal(case):
    x = _normed(case)
    theirs = KMeans(n_clusters=2, n_init=1, random_state=np.random.RandomState(4)).fit(x)
    ours = mixture.kmeans(x)
    np.testing.assert_array_equal(ours.labels, theirs.labels_)
    np.testing.assert_allclose(ours.centers, theirs.cluster_centers_, rtol=0, atol=BAR)
    assert ours.n_iter == theirs.n_iter_


@pytest.mark.parametrize("case", list(CASES))
def test_mixture_matches_scikit_learn(case):
    x = _normed(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a non-converged fit warns there
        theirs = GaussianMixture(n_components=2, random_state=4).fit(x)
    ours = mixture.fit_gaussian_mixture(x)
    for mine, ref in ((ours.weights, theirs.weights_), (ours.means, theirs.means_),
                      (ours.covariances, theirs.covariances_),
                      (ours.precisions_cholesky, theirs.precisions_cholesky_)):
        np.testing.assert_allclose(mine, ref, rtol=0, atol=BAR)
    grid = np.linspace(0, 1, 100).reshape(-1, 1)
    np.testing.assert_allclose(ours.score_samples(grid), theirs.score_samples(grid), rtol=0,
                               atol=BAR)
    assert (ours.n_iter, ours.converged) == (theirs.n_iter_, theirs.converged_)


def test_mixture_refuses_fewer_than_two_samples():
    with pytest.raises(ValueError, match="at least 2 samples"):
        mixture.fit_gaussian_mixture(np.array([[0.5]]))


@pytest.mark.parametrize("case", list(CASES))
def test_plot_epoch_loss_gmm_matches_reference(case, tmp_path, monkeypatch):
    correct, incorrect = CASES[case]
    figs = []

    def capture(fig, path):
        figs.append(fig)
        fig.savefig(path)
        return path

    monkeypatch.setattr(jplotters, "_save", capture)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m1_jax = jplotters.plot_epoch_loss_gmm(correct, incorrect, 5, str(tmp_path / "jax"))
    m1 = plotters.plot_epoch_loss_gmm(correct, incorrect, 5, str(tmp_path / "port"))
    assert abs(m1 - m1_jax) <= BAR
    desc, m1_desc = plotters.epoch_loss_gmm_figure(correct, incorrect, 5)
    assert m1_desc == m1
    (fig,) = figs
    assert len(desc.axes) == len(fig.axes) == 1
    assert_axes_equal(desc.axes[0], fig.axes[0])
    plt.close(fig)
    rel = os.path.join("losses", "epoch_loss_dst_5.jpg")
    theirs, ours = Image.open(tmp_path / "jax" / rel), Image.open(tmp_path / "port" / rel)
    assert (ours.format, ours.size, ours.mode) == (theirs.format, theirs.size, theirs.mode) \
        == ("JPEG", (desc.width, desc.height), "RGB")
    assert _psnr(np.asarray(ours), raster.render(desc).pixels) >= 30

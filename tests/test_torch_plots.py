"""The port's run-dir plots and debug views (``exp/raster.py``,
``exp/plotters.py``, ``exp/viz.py``, ``TrainConfig.plot``) against the JAX
package's matplotlib figures.

Bars: each figure's description equals the JAX figure (captured through
``pcgmix_tpu.exp.plotters._save`` / ``pyplot.close``, which edits
nothing): line data, colors as RGB, line styles and widths, legend
strings, title, axis labels, the limits the plot sets and the y scale,
bars, histogram counts and images; each file decodes (PIL) at the JAX
file's size and mode, a JPEG within 30 dB PSNR of the port's raster, a
PNG exactly; a run dir holds the JAX run dir's file names with ``plot``
and no plot files without it."""

import io
import os

import matplotlib.colors as mcolors
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import pcgmix_tpu.exp.plotters as jplotters
import pcgmix_tpu.exp.viz as jviz
from pcgmix_tpu.train.counters import VariabilityCounter as JVariabilityCounter
from pcgmix_tpu_torch.exp import plotters, raster, viz
from pcgmix_tpu_torch.train.counters import VariabilityCounter

Image = pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counters():
    rng = np.random.default_rng(0)
    ours, theirs = VariabilityCounter(100), JVariabilityCounter(100)
    for step in range(40):
        rows, partners = rng.integers(0, 100, 8), rng.integers(0, 8, 8)
        ours.add(rows, partners, step % 3, step)
        theirs.add(rows, partners, step % 3, step)
    return ours, theirs


def _cases():
    rng = np.random.default_rng(1)
    steps = [4, 8, 12, 16]
    pred = {f"r{i:03d}": [(0.4, float(p)) for p in rng.random(3)] for i in range(12)}
    targets = {w: i % 2 for i, w in enumerate(pred)}
    correct, incorrect = rng.random(120), rng.random(30) + 0.4
    return {
        "accuracy": ("plot_train_test_acc", "train_test_acc_figure",
                     ([55.0, 61.5, 70.25, 69.0], [50.0, 66.5, 64.0, 65.5], False, steps),
                     "accuracy.jpg"),
        "accuracy_valid": ("plot_train_test_acc", "train_test_acc_figure",
                           ([55.0, 61.5], [50.0, 66.5], True, steps[:2]), "accuracy.jpg"),
        "loss": ("plot_train_test_loss", "train_test_loss_figure",
                 ([0.71, 0.62, 0.55, 0.5], [0.8, 0.7, 0.72, 0.69], False, steps), "loss.jpg"),
        "learning_rate": ("plot_lr_per_step", "lr_per_step_figure",
                          (list(np.sin(np.linspace(0, 3, 300)) * 0.01 + 0.01),),
                          "learning_rate.jpg"),
        "times": ("plot_times", "times_figure", ([1.5, 1.25, 1.3, 3700.2], [1, 2, 3, 4]),
                  "times.jpg"),
        "variability": ("plot_variability", "variability_figure", (None,), "variability.jpg"),
        "wav_predprobas": ("plot_wav_predprobas", "wav_predprobas_figure",
                           (pred, targets, 3), "test_wav_predprobas/test_wav_predprobas_3.jpg"),
        "epoch_loss": ("plot_epoch_loss", "epoch_loss_figure", (correct, incorrect, 2),
                       "losses/epoch_loss_2.jpg"),
        "m1": ("plot_m1", "m1_figure", ([0.1, 0.5, 0.3, 0.2],), "m1.jpg"),
    }


CASES = _cases()


def _rgb(color) -> tuple:
    return tuple(int(round(c * 255)) for c in mcolors.to_rgb(color))


def _is_axline(line) -> str:
    """"axhline"/"axvline" for a reference line, else "line"."""
    ax = line.axes
    if line.get_transform() == ax.get_yaxis_transform():
        return "axhline"
    if line.get_transform() == ax.get_xaxis_transform():
        return "axvline"
    return "line"


def assert_axes_equal(desc: raster.Axes, ax) -> None:
    """The description of one axes against a matplotlib axes."""
    lines = [s for s in desc.series if s.kind in ("line", "axhline", "axvline")]
    assert len(lines) == len(ax.lines)
    for s, line in zip(lines, ax.lines):
        kind = _is_axline(line)
        assert s.kind == kind
        if kind == "line":
            np.testing.assert_array_equal(np.asarray(s.x, float), line.get_xdata())
            np.testing.assert_array_equal(np.asarray(s.y, float), line.get_ydata())
        elif kind == "axhline":
            assert line.get_ydata()[0] == s.y
        else:
            assert line.get_xdata()[0] == s.x
        assert raster.rgb(s.color) == _rgb(line.get_color())
        assert s.style == line.get_linestyle()
        assert s.width == line.get_linewidth()
        assert (s.label or "_") [0] == "_" if line.get_label().startswith("_") else \
            s.label == line.get_label()
    bars = [s for s in desc.series if s.kind in ("bar", "hist")]
    patches = [p for p in ax.patches if isinstance(p, plt.Rectangle)]
    if bars:
        assert sum(len(s.y) for s in bars) == len(patches)
        at = 0
        for s in bars:
            mine = patches[at:at + len(s.y)]
            at += len(s.y)
            np.testing.assert_array_equal(s.y, [p.get_height() for p in mine])
            if s.kind == "bar":
                np.testing.assert_allclose(s.x, [p.get_x() + p.get_width() / 2 for p in mine])
                assert [raster.rgb(c) for c in s.colors] == [
                    _rgb(p.get_facecolor()) for p in mine]
            else:
                np.testing.assert_allclose(s.x[:-1], [p.get_x() for p in mine], atol=1e-12)
                assert all(_rgb(p.get_facecolor()) == raster.rgb(s.color) for p in mine)
                assert all(p.get_alpha() == s.alpha for p in mine)
    else:
        assert not patches
    scatters = [s for s in desc.series if s.kind == "scatter"]
    assert len(scatters) == len(ax.collections)
    for s, col in zip(scatters, ax.collections):
        np.testing.assert_array_equal(np.stack([s.x, s.y], 1), col.get_offsets())
        assert raster.rgb(s.color) == _rgb(col.get_facecolor()[0])
        assert s.label == col.get_label()
    images = [s for s in desc.series if s.kind == "image"]
    assert len(images) == len(ax.images)
    for s, im in zip(images, ax.images):
        np.testing.assert_array_equal(np.atleast_2d(s.image), im.get_array())
        assert s.cmap == im.get_cmap().name and s.origin == im.origin
        np.testing.assert_allclose(s.extent, im.get_extent())
        if s.vrange is not None:
            assert s.vrange == im.get_clim()
        assert s.alpha == (im.get_alpha() if im.get_alpha() is not None else 1.0)
    legend = ax.get_legend()
    assert desc.legend == (legend is not None)
    if legend is not None:
        assert desc.legend_labels() == [t.get_text() for t in legend.get_texts()]
    assert (desc.title, desc.xlabel, desc.ylabel) == (ax.get_title(), ax.get_xlabel(),
                                                      ax.get_ylabel())
    for mine, theirs in ((desc.xlim, ax.get_xlim()), (desc.ylim, ax.get_ylim())):
        for a, b in zip(mine, theirs):
            if a is not None:
                assert a == b
    assert desc.yscale == ax.get_yscale()
    if desc.xticks is not None and len(desc.xticks[0]):
        np.testing.assert_array_equal(desc.xticks[0], ax.get_xticks())
        assert list(desc.xticks[1]) == [t.get_text() for t in ax.get_xticklabels()]


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


PSNR = {}


@pytest.mark.parametrize("case", list(CASES))
def test_plot_matches_reference_figure(case, tmp_path, monkeypatch):
    plot, describe, args, rel = CASES[case]
    ours_args = theirs_args = args
    if case == "variability":
        ours_vc, theirs_vc = _counters()
        ours_args, theirs_args = (ours_vc,), (theirs_vc,)
    figs = []

    def capture(fig, path):
        figs.append(fig)
        fig.savefig(path)
        return path

    monkeypatch.setattr(jplotters, "_save", capture)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpath = getattr(jplotters, plot)(*theirs_args, str(tmp_path / "jax"))
    path = getattr(plotters, plot)(*ours_args, str(tmp_path / "port"))
    # the description takes the plot's arguments but the run dir (and the
    # epoch, where it only names the file)
    desc = getattr(plotters, describe)(*ours_args[:-1 if case == "wav_predprobas" else None])
    (fig,) = figs
    assert os.path.relpath(path, tmp_path / "port") == rel
    assert os.path.relpath(jpath, tmp_path / "jax") == rel
    assert len(desc.axes) == len(fig.axes) == 1
    assert_axes_equal(desc.axes[0], fig.axes[0])
    plt.close(fig)
    theirs, ours = Image.open(jpath), Image.open(path)
    assert (ours.format, ours.size, ours.mode) == (theirs.format, theirs.size, theirs.mode) \
        == ("JPEG", (desc.width, desc.height), "RGB")
    assert raster.jpeg_header(open(path, "rb").read())["width"] == desc.width
    PSNR[case] = _psnr(np.asarray(ours), raster.render(desc).pixels)
    assert PSNR[case] >= 30, PSNR
    if case == "variability":
        assert open(tmp_path / "port" / "variability.pkl", "rb").read() == \
            open(tmp_path / "jax" / "variability.pkl", "rb").read()


VIEWS = {
    "sig_4ch": ("show_sig", "sig_figure",
                dict(signal=np.cumsum(np.random.default_rng(2).standard_normal((4, 400)), 1) * .3,
                     frames=[0, 50, 150, 200, 380], cuts=[150],
                     sal=np.random.default_rng(3).random(400)), "signal.png"),
    "sig_3ch_no_sal": ("show_sig", "sig_figure",
                       dict(signal=np.random.default_rng(4).standard_normal((3, 300)),
                            frames=[10, 100]), "signal.jpg"),
    "sig_1d": ("show_sig", "sig_figure", dict(signal=np.linspace(-3, 3, 200)), "signal.png"),
    "spectrogram": ("show_spectrogram", "spectrogram_figure",
                    dict(spec=np.random.default_rng(1).normal(size=(64, 48)),
                         frames=[3, 20, 30, 40, 45]), "spectrogram.png"),
    "saliency": ("show_sal", "sal_figure",
                 dict(saliency=np.random.default_rng(2).random(400)), "saliency.png"),
}


@pytest.mark.parametrize("case", list(VIEWS))
def test_view_matches_reference_figure(case, tmp_path, monkeypatch):
    show, describe, kw, name = VIEWS[case]
    figs = []
    close = plt.close
    monkeypatch.setattr(jviz.plt, "close", lambda fig=None: figs.append(fig))
    jpath = getattr(jviz, show)(**kw, path=str(tmp_path / f"jax_{name}"))
    monkeypatch.undo()
    path = getattr(viz, show)(**kw, path=str(tmp_path / name))
    desc = getattr(viz, describe)(**kw)
    (fig,) = figs
    axes = [ax for ax in fig.axes if ax.get_label() != "<colorbar>"]
    assert len(desc.axes) == len(axes)
    for d, ax in zip(desc.axes, axes):
        assert_axes_equal(d, ax)
    assert (desc.axes[0].colorbar is not None) == (len(fig.axes) > len(axes))
    close(fig)
    theirs, ours = Image.open(jpath), Image.open(path)
    assert (ours.format, ours.size, ours.mode) == (theirs.format, theirs.size, theirs.mode)
    assert ours.size == (desc.width, desc.height)
    pixels = raster.render(desc).pixels
    if name.endswith(".png"):
        decoded = np.asarray(ours)
        assert np.array_equal(decoded[..., :3], pixels) and (decoded[..., 3] == 255).all()
    else:
        assert _psnr(np.asarray(ours), pixels) >= 30


def test_psnr_stated():
    """The JPEGs' PSNR against the port's raster, as measured above."""
    if len(PSNR) == len(CASES):
        print("\nJPEG PSNR against the raster (dB): "
              + ", ".join(f"{k} {v:.1f}" for k, v in PSNR.items()))
        assert min(PSNR.values()) >= 30


def test_unknown_extension_and_colormaps(tmp_path):
    canvas = raster.Canvas(20, 10)
    with pytest.raises(ValueError, match=".jpg, .jpeg or .png"):
        canvas.save(str(tmp_path / "x.gif"))
    for name in ("jet", "viridis"):
        want = np.round(plt.get_cmap(name)(np.arange(256))[:, :3] * 255)
        assert np.abs(raster.colormap(name).astype(int) - want).max() <= 1, name
    with pytest.raises(ValueError, match="jet or viridis"):
        raster.colormap("magma")


def test_jpeg_header_refuses_what_is_not_a_baseline_jpeg(tmp_path):
    data = raster.encode_jpeg(np.zeros((17, 33, 3), np.uint8))
    assert raster.jpeg_header(data) == {"width": 33, "height": 17, "components": 3}
    with pytest.raises(ValueError, match="SOI"):
        raster.jpeg_header(data[:-2])
    png = raster.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        raster.jpeg_header(png)


# --------------------------------------------------------------------------- #
# run dirs
# --------------------------------------------------------------------------- #

T = 512


@pytest.fixture(scope="module")
def dataset():
    from pcgmix_tpu.data.synthetic import synthetic_physionet_dict

    return synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=6, segments_per_wav=2,
                                    sig_len=T, seed=3)


COMMON = dict(model="resnet9-5k", method="base", num_epochs=1, batch_size=8,
              track_variability=True)


def _names(root) -> set:
    """The files of the one run dir under ``root`` (the model's file as
    ``model.*``)."""
    (run,) = [os.path.join(root, d) for d in os.listdir(root)]
    out = set()
    for path, _, files in os.walk(run):
        for f in files:
            rel = os.path.relpath(os.path.join(path, f), run)
            out.add("model.*" if rel.startswith("model.") else rel)
    return out


@pytest.fixture(scope="module")
def jax_run_dir(dataset, tmp_path_factory):
    """The JAX loop's run dir of ``COMMON`` (a mean-pool and dense model
    in place of ResNet9: the files do not depend on the model, its compile
    would cost seconds)."""
    import flax.linen as nn

    from pcgmix_tpu.train import TrainConfig as JTrainConfig
    from pcgmix_tpu.train import loop as jloop
    from pcgmix_tpu.train import train_model as jtrain

    class Tiny(nn.Module):
        num_classes: int = 2
        train: bool = True

        @nn.compact
        def __call__(self, x, **kw):
            return nn.Dense(self.num_classes)(
                nn.BatchNorm(use_running_average=not self.train)(x.mean(axis=-1)))

    root = tmp_path_factory.mktemp("jax_runs")
    mp = pytest.MonkeyPatch()
    mp.setattr(jloop, "build_model",
               lambda name, dataset, num_classes, train, **kw: Tiny(num_classes, train))
    try:
        jtrain(JTrainConfig(**COMMON, sig_len=T, experiments_root=str(root)), dataset)
    finally:
        mp.undo()
    return _names(root)


def test_run_dir_holds_the_reference_files(dataset, jax_run_dir, tmp_path):
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    assert {"accuracy.jpg", "loss.jpg", "learning_rate.jpg", "times.jpg", "variability.jpg",
            "variability.pkl"} <= jax_run_dir
    train_model(TrainConfig(**COMMON, experiments_root=str(tmp_path / "on"), device="cpu"),
                dataset)
    assert _names(tmp_path / "on") == jax_run_dir
    for name in ("accuracy.jpg", "loss.jpg", "learning_rate.jpg", "times.jpg",
                 "variability.jpg"):
        (run,) = os.listdir(tmp_path / "on")
        data = open(tmp_path / "on" / run / name, "rb").read()
        assert raster.jpeg_header(data)["width"] == 600
        assert Image.open(io.BytesIO(data)).size == (600, 600)
    train_model(TrainConfig(**COMMON, plot=False, experiments_root=str(tmp_path / "off"),
                            device="cpu"), dataset)
    assert _names(tmp_path / "off") == jax_run_dir - {
        "accuracy.jpg", "loss.jpg", "learning_rate.jpg", "times.jpg", "variability.jpg",
        "variability.pkl"}


def test_gang_member_run_dir_holds_the_reference_files(dataset, jax_run_dir, tmp_path):
    """Each gang member's run dir holds the JAX run dir's files but the
    variability ones (a gang tracks none, in either package)."""
    from pcgmix_tpu_torch.train import TrainConfig
    from pcgmix_tpu_torch.train.gang import train_gang

    common = {**COMMON, "track_variability": False}
    cfgs = [TrainConfig(**common, seed_data=sd, experiments_root=str(tmp_path / "gang"),
                        device="cpu") for sd in (1100001, 1100002)]
    train_gang(cfgs, dataset)
    runs = sorted(os.listdir(tmp_path / "gang"))
    assert len(runs) == 2
    for run in runs:
        os.makedirs(tmp_path / run)
        os.rename(tmp_path / "gang" / run, tmp_path / run / run)
        assert _names(tmp_path / run) == jax_run_dir - {"variability.jpg", "variability.pkl"}

"""Run-directory plots (counterpart: ``pcgmix_tpu/exp/plotters.py``;
reference plotters.py): the accuracy, loss, learning-rate and times
curves, the variability growth, the per-recording prediction bars, the
per-epoch loss histograms, their Gaussian-mixture fits and the M₁
trajectory, under the JAX package's file names and subfolders.

Each plot has a ``*_figure`` function that returns its description
(``exp.raster.Figure``: series with their colors and styles, reference
lines, labels, legend strings, title, limits and scale), which
``exp.raster`` draws and writes as a JPEG at matplotlib's pixel size
(figsize × 100 dpi).  ``plot_epoch_loss_gmm`` fits its two-component
Gaussian mixture with ``exp.mixture`` (scikit-learn's ``GaussianMixture``
as the JAX package fits it).
"""

from __future__ import annotations

import os

import numpy as np

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.exp.raster import Axes, Figure, Series, save


def _figure(width_in: float, height_in: float, ax: Axes, dpi: int = 100) -> Figure:
    return Figure(int(width_in * dpi), int(height_in * dpi), [ax])


def _test_style(valid: bool) -> tuple[str, str]:
    return ("valid", "royalblue") if valid else ("test", "forestgreen")


def train_test_acc_figure(acc_train, acc_test, valid, steps) -> Figure:
    """Accuracy curves with max/final test markers (plotters.py:88-107)."""
    label, color = _test_style(valid)
    best = float(np.max(acc_test))
    best_step = steps[int(np.argmax(acc_test))]
    return _figure(6, 6, Axes(series=[
        Series("line", np.asarray(steps), np.asarray(acc_train), "darkorange", label="train"),
        Series("line", np.asarray(steps), np.asarray(acc_test), color, label=label),
        Series("axhline", y=best, color=color, style="--",
               label=f"{label} max {best:.2f} @step {best_step}"),
        Series("axhline", y=acc_test[-1], color=color, style="-.",
               label=f"{label} final {acc_test[-1]:.2f}"),
    ], xlabel="Steps", ylabel="Accuracy [%]", ylim=(0, 110), legend=True, grid=True))


def plot_train_test_acc(acc_train, acc_test, valid, steps, run_dir) -> str:
    return save(train_test_acc_figure(acc_train, acc_test, valid, steps),
                os.path.join(run_dir, "accuracy.jpg"))


def train_test_loss_figure(loss_train, loss_test, valid, steps) -> Figure:
    """Loss curves (plotters.py:109-126)."""
    label, color = _test_style(valid)
    return _figure(6, 6, Axes(series=[
        Series("line", np.asarray(steps), np.asarray(loss_train), "darkorange", label="train"),
        Series("axhline", y=loss_train[-1], color="darkorange", style="-.",
               label=f"train final {loss_train[-1]:.2f}"),
        Series("line", np.asarray(steps), np.asarray(loss_test), color, label=label),
        Series("axhline", y=loss_test[-1], color=color, style="-.",
               label=f"{label} final {loss_test[-1]:.2f}"),
    ], xlabel="Step", ylabel="Loss", legend=True, grid=True))


def plot_train_test_loss(loss_train, loss_test, valid, steps, run_dir) -> str:
    return save(train_test_loss_figure(loss_train, loss_test, valid, steps),
                os.path.join(run_dir, "loss.jpg"))


def lr_per_step_figure(lr_per_step) -> Figure:
    """Learning-rate trajectory (plotters.py:171-187)."""
    return _figure(6, 6, Axes(series=[
        Series("line", np.arange(1, len(lr_per_step) + 1), np.asarray(lr_per_step), "k",
               label="learning_rate"),
    ], xlabel="Step", ylabel="Learning rate", ylim=(0, None), legend=True, grid=True))


def plot_lr_per_step(lr_per_step, run_dir) -> str:
    return save(lr_per_step_figure(lr_per_step), os.path.join(run_dir, "learning_rate.jpg"))


def times_figure(times, steps) -> Figure:
    """Per-epoch wall-clock with a total in the title (plotters.py:150-169)."""
    total = float(np.sum(times))
    return _figure(6, 6, Axes(series=[
        Series("line", np.asarray(steps), np.asarray(times), "k", label="times"),
    ], xlabel="Steps", ylabel="times [s]", ylim=(0, None),
        title="Total " + utils.timer(0.0, total), legend=True, grid=True))


def plot_times(times, steps, run_dir) -> str:
    return save(times_figure(times, steps), os.path.join(run_dir, "times.jpg"))


def variability_figure(variability_counter) -> Figure:
    """Cumulative unique base/pair/(pair,cut) counts on a log axis
    (plotters.py:128-148)."""
    vc = variability_counter
    steps = np.asarray(vc.steps)
    return _figure(6, 6, Axes(series=[
        Series("line", steps, np.asarray(vc.lens_base), "darkorange", label="base"),
        Series("axhline", y=vc.base_original, color="darkorange", style="--",
               label="base_original"),
        Series("line", steps, np.asarray(vc.lens_pairs), "forestgreen", label="pairs"),
        Series("line", steps, np.asarray(vc.lens_unique), "purple", style="--", label="unique"),
    ], xlabel="Steps", ylabel="Cumulative samples", yscale="log", legend=True, grid=True))


def plot_variability(variability_counter, run_dir) -> str:
    """The variability plot, plus the ``variability.pkl`` dump of its
    curves."""
    utils.save_dict(variability_counter.curves(), os.path.join(run_dir, "variability.pkl"))
    return save(variability_figure(variability_counter),
                os.path.join(run_dir, "variability.jpg"))


def wav_predprobas_figure(pred_dict, wav_targets_dict) -> Figure:
    """Per-recording mean abnormal-probability bars, colored by
    correctness (plot_wav_predprobas_boxplot, train_model.py:690-729)."""
    wav_sorted = sorted(wav_targets_dict, key=lambda k: wav_targets_dict[k])
    labels = [wav_targets_dict[w] for w in wav_sorted]
    means = [float(np.mean([p[1] for p in pred_dict[w]])) for w in wav_sorted]
    thresh = 0.5
    colors = ["green" if (lab == 1) == (m >= thresh) else "red"
              for lab, m in zip(labels, means)]
    n_normal = labels.count(0)
    xs = np.arange(len(wav_sorted))
    series = [Series("bar", xs, np.asarray(means), colors=colors),
              Series("axhline", y=thresh, color="k")]
    if 0 < n_normal < len(xs):
        series.append(Series("axvline", x=xs[n_normal - 1] + 0.5, color="k"))
    return _figure(45, 5, Axes(
        series=series, ylabel="Mean abnormal prediction probability", ylim=(0, 1),
        xticks=(xs, [f"{w}_{lab}" for w, lab in zip(wav_sorted, labels)]),
        box=(0.03, 0.3, 0.995, 0.97)))


def plot_wav_predprobas(pred_dict, wav_targets_dict, epoch, run_dir) -> str:
    d = utils.check_folder(os.path.join(run_dir, "test_wav_predprobas"))
    return save(wav_predprobas_figure(pred_dict, wav_targets_dict),
                os.path.join(d, f"test_wav_predprobas_{epoch}.jpg"))


def epoch_loss_figure(loss_correct, loss_incorrect, epoch) -> Figure:
    """Histogram of normalized per-sample losses, correct vs incorrect
    (plotters.py:19-40)."""
    all_losses = np.append(loss_correct, loss_incorrect)
    peak = np.max(all_losses) if len(all_losses) else 1.0
    bins = np.linspace(0, 1, 100)
    series = [Series("hist", bins, np.histogram(np.asarray(loss) / peak, bins)[0].astype(float),
                     color, alpha=0.5, label=label)
              for loss, label, color in ((loss_correct, "correct", "royalblue"),
                                         (loss_incorrect, "incorrect", "crimson"))]
    return _figure(6, 6, Axes(series=series, title=f"Epoch={epoch}",
                              xlabel="normalized loss", ylabel="#samples", legend=True,
                              grid=True))


def plot_epoch_loss(loss_correct, loss_incorrect, epoch, run_dir) -> str:
    d = utils.check_folder(os.path.join(run_dir, "losses"))
    return save(epoch_loss_figure(loss_correct, loss_incorrect, epoch),
                os.path.join(d, f"epoch_loss_{epoch}.jpg"))


def epoch_loss_gmm_figure(loss_correct, loss_incorrect, epoch) -> tuple[Figure, float]:
    """The normalized per-sample losses' density histogram with a
    two-component Gaussian mixture fitted to them, a dashed line at each
    mean (plotters.py:45-86), and the means' distance |μ₁−μ₂|."""
    from pcgmix_tpu_torch.exp.mixture import fit_gaussian_mixture

    all_losses = np.append(loss_correct, loss_incorrect).astype(np.float64)
    peak = np.max(all_losses) if len(all_losses) else 1.0
    normed = (all_losses / peak).reshape(-1, 1)
    gm = fit_gaussian_mixture(normed)
    means = gm.means.ravel()
    m1 = float(abs(means[1] - means[0]))
    xs = np.linspace(0, 1, 100)
    return _figure(6, 6, Axes(series=[
        Series("hist", xs, np.histogram(normed.ravel(), xs, density=True)[0], "grey",
               alpha=0.5),
        Series("line", xs, np.exp(gm.score_samples(xs.reshape(-1, 1))), "k",
               label="gaussian mixture"),
        *[Series("axvline", x=m, color="k", style="--", alpha=0.8) for m in means],
    ], title=f"epoch {epoch};   |mu1 - mu2| = {abs(means[1] - means[0]):.2f}",
        xlabel="normalized loss", ylabel="probability density", legend=True, grid=True)), m1


def plot_epoch_loss_gmm(loss_correct, loss_incorrect, epoch, run_dir) -> float:
    """Writes ``losses/epoch_loss_dst_{epoch}.jpg``; returns |μ₁−μ₂|, the
    epoch's M₁."""
    fig, m1 = epoch_loss_gmm_figure(loss_correct, loss_incorrect, epoch)
    d = utils.check_folder(os.path.join(run_dir, "losses"))
    save(fig, os.path.join(d, f"epoch_loss_dst_{epoch}.jpg"))
    return m1


def m1_figure(gmm_m1s) -> Figure:
    """M₁ (GMM mean-separation) trajectory over epochs with the maximum
    marked (plotters.py:189-207)."""
    m1s = [float(v) for v in gmm_m1s]
    epochs = np.arange(1, len(m1s) + 1)
    m1_max = max(m1s)
    epoch_max = int(epochs[m1s.index(m1_max)])
    return _figure(6, 6, Axes(series=[
        Series("line", epochs, np.asarray(m1s), "rebeccapurple", label=r"$M_1$"),
        Series("scatter", np.array([epoch_max]), np.array([m1_max]), "k",
               label=f"max@epoch {epoch_max}"),
    ], xlabel="Epoch", ylabel=r"$M_1$", ylim=(0, None), legend=True, grid=True))


def plot_m1(gmm_m1s, run_dir) -> str:
    """→ ``m1.jpg``; ``gmm_m1s``: one |μ₁−μ₂| an epoch, as
    ``plot_epoch_loss_gmm`` returns them."""
    return save(m1_figure(gmm_m1s), os.path.join(run_dir, "m1.jpg"))

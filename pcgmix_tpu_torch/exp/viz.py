"""Signal, spectrogram and saliency views for debugging (counterpart:
``pcgmix_tpu/exp/viz.py``; reference utils.py:86-165): segment boundaries
as dashed verticals, cut markers, a saliency heat overlay.  Each view has a
``*_figure`` description (``exp.raster``) and a function that writes it,
PNG or JPEG by the path's extension, at matplotlib's pixel size for 150
dpi."""

from __future__ import annotations

import numpy as np

from pcgmix_tpu_torch.exp.raster import Axes, Figure, Series, save

DPI = 150


def sig_figure(signal, frames=(), cuts=(), sal=None, ylim=(-8, 8)) -> Figure:
    """Up to 4 channels of a (C, T) signal stacked without gaps
    (utils.py:108-165)."""
    signal = np.asarray(signal)
    if signal.ndim == 1:
        signal = signal[None, :]
    n_ch = min(signal.shape[0], 4)
    T = signal.shape[-1]
    fig = Figure(int(20 * DPI), int(1.2 * n_ch * DPI))
    height = (0.88 - 0.11) / n_ch
    for ch in range(n_ch):
        series = [Series("line", np.arange(T), signal[ch], "k", width=0.6)]
        if sal is not None:
            series.append(Series("image", image=np.atleast_2d(np.asarray(sal)), cmap="jet",
                                 vrange=(0, 1), alpha=0.5, extent=(0, T, ylim[0], ylim[1])))
        series += [Series("axvline", x=f, color="k", style="--", width=0.6) for f in frames]
        series += [Series("axvline", x=c, color="red", width=0.8) for c in cuts]
        top = 0.88 - ch * height
        fig.axes.append(Axes(series=series, ylim=tuple(ylim),
                             xticks=None if ch == n_ch - 1 else ((), ()),
                             box=(0.125, top - height, 0.9, top)))
    return fig


def show_sig(signal, frames=(), cuts=(), sal=None, path="signal.png", ylim=(-8, 8)) -> str:
    return save(sig_figure(signal, frames, cuts, sal, ylim), path)


def spectrogram_figure(spec, frames=()) -> Figure:
    """A (F, T) spectrogram, low frequencies at the bottom, with the first
    four segment boundaries (utils.py:86-96)."""
    spec = np.asarray(spec)
    h, w = spec.shape
    series = [Series("image", image=spec, cmap="viridis", origin="lower",
                     extent=(-0.5, w - 0.5, -0.5, h - 0.5))]
    series += [Series("axvline", x=f, color="k") for f in list(frames)[:4]]
    return Figure(int(8 * DPI), int(3 * DPI),
                  [Axes(series=series, xlim=(0, w - 1), ylim=(-0.5, h - 0.5))])


def show_spectrogram(spec, frames=(), path="spectrogram.png") -> str:
    return save(spectrogram_figure(spec, frames), path)


def sal_figure(saliency) -> Figure:
    """A saliency heatmap with its colorbar (utils.py:99-105)."""
    sal = np.atleast_2d(np.asarray(saliency))
    h, w = sal.shape
    return Figure(int(5 * DPI), int(2 * DPI), [Axes(
        series=[Series("image", image=sal, cmap="jet",
                       vrange=(float(np.nanmin(sal)), float(np.nanmax(sal))),
                       extent=(-0.5, w - 0.5, h - 0.5, -0.5))],
        xlim=(-0.5, w - 0.5), ylim=(h - 0.5, -0.5), colorbar="jet",
        box=(0.125, 0.11, 0.77, 0.88))])


def show_sal(saliency, path="saliency.png") -> str:
    return save(sal_figure(saliency), path)

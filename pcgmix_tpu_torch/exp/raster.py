"""Figures drawn with numpy alone, for the run-dir plots (``plotters.py``)
and the debug views (``viz.py``); the GPU machine has no matplotlib and no
PIL.

A figure is described first (``Figure``: its size in pixels and its axes;
``Axes``: series, reference lines, labels, legend strings, limits and
scale), so that tests can hold the description against the JAX package's
matplotlib figure; ``render`` then rasterizes it on an RGB canvas with the
matplotlib figure's pixel size, and ``save`` writes a baseline JPEG
(YCbCr 4:2:0, the Annex K tables at quality 75, as PIL writes
matplotlib's ``.jpg``) or a PNG, by the path's extension.  The pixels are
not matplotlib's: the layout follows its defaults (subplot margins, 5 %
data margins, "nice" ticks, the legend in the corner that covers the
fewest points), and text comes from a bitmap font kept in
``raster_data.py``.
"""

from __future__ import annotations

import base64
import math
import struct
import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pcgmix_tpu_torch.exp import raster_data

# the named colors the plots use (CSS4, as matplotlib resolves them)
COLORS = {
    "k": (0, 0, 0), "black": (0, 0, 0), "white": (255, 255, 255),
    "darkorange": (255, 140, 0), "royalblue": (65, 105, 225),
    "forestgreen": (34, 139, 34), "purple": (128, 0, 128), "red": (255, 0, 0),
    "green": (0, 128, 0), "crimson": (220, 20, 60), "rebeccapurple": (102, 51, 153),
    "grey": (128, 128, 128), "gray": (128, 128, 128), "blue": (0, 0, 255),
    "darkred": (139, 0, 0), "darkblue": (0, 0, 139),
}
GRID = (176, 176, 176)  # matplotlib's grid.color "#b0b0b0"
DPI = 100


def rgb(color) -> tuple[int, int, int]:
    """A color name of ``COLORS`` or an RGB triple as 8-bit RGB."""
    if isinstance(color, str):
        return COLORS[color]
    return tuple(int(round(c)) for c in color)


# --------------------------------------------------------------------------- #
# the description
# --------------------------------------------------------------------------- #


@dataclass
class Series:
    """One artist.  ``kind``: "line" (x, y), "axhline" (y), "axvline" (x),
    "bar" (x, heights as y, ``colors`` one a bar), "hist" (bin edges as x,
    counts as y), "scatter" (x, y), "annotate" (``text`` at the data point
    x, y, its box's bottom left there) or "image" (``image``: a 2-D array of
    values drawn through ``cmap`` between ``vrange`` over ``extent`` =
    (left, right, bottom, top) in data coordinates, as matplotlib's
    ``get_extent``; ``origin`` "upper" puts its first row at the top).

    A scatter's ``marker`` is matplotlib's "o" (circle), "P" (plus) or
    "x", ``size`` its area in points² (``s``), ``hollow`` its
    ``facecolors="none"`` (the edge alone, in ``color``); without a
    marker, a filled disk of 6 pixels."""

    kind: str
    x: np.ndarray = None
    y: np.ndarray = None
    color: tuple = (0, 0, 0)
    style: str = "-"
    label: Optional[str] = None
    width: float = 1.5  # points
    alpha: float = 1.0
    colors: Optional[list] = None
    image: Optional[np.ndarray] = None
    extent: Optional[tuple] = None
    cmap: Optional[str] = None
    vrange: Optional[tuple] = None
    origin: str = "upper"
    marker: Optional[str] = None
    size: float = 36.0  # points², matplotlib's default ``s``
    hollow: bool = False
    text: Optional[str] = None


@dataclass
class Axes:
    series: list = field(default_factory=list)
    title: str = ""
    xlabel: str = ""
    ylabel: str = ""
    xlim: tuple = (None, None)  # limits the plot sets; None: from the data
    ylim: tuple = (None, None)
    yscale: str = "linear"
    legend: bool = False
    grid: bool = False
    xticks: Optional[tuple] = None  # (positions, labels), rotated 90°
    colorbar: Optional[str] = None  # a colormap name drawn beside the axes
    box: tuple = (0.125, 0.11, 0.9, 0.88)  # left, bottom, right, top (figure share)

    def legend_labels(self) -> list[str]:
        return [s.label for s in self.series if s.label and not s.label.startswith("_")]


@dataclass
class Figure:
    width: int  # pixels
    height: int
    axes: list = field(default_factory=list)


# --------------------------------------------------------------------------- #
# the canvas
# --------------------------------------------------------------------------- #


def _font():
    cells = np.frombuffer(zlib.decompress(base64.b64decode("".join(raster_data.FONT_CELLS))),
                          dtype=np.uint8)
    glyphs, at = {}, 0
    h = raster_data.FONT_HEIGHT
    for code, w in enumerate(raster_data.FONT_WIDTHS, start=32):
        glyphs[chr(code)] = cells[at:at + w * h].reshape(w, h).T
        at += w * h
    return glyphs


class Canvas:
    """An RGB uint8 image, white to start; (x, y) in pixels from the top
    left."""

    _glyphs = None

    def __init__(self, width: int, height: int):
        self.pixels = np.full((height, width, 3), 255, dtype=np.uint8)

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    def _blend(self, ys, xs, color, alpha) -> None:
        keep = (xs >= 0) & (xs < self.width) & (ys >= 0) & (ys < self.height)
        ys, xs = ys[keep], xs[keep]
        if np.ndim(alpha):
            alpha = alpha[keep]
        a = np.asarray(alpha, dtype=np.float32)[..., None]
        old = self.pixels[ys, xs].astype(np.float32)
        self.pixels[ys, xs] = np.round(old * (1 - a) + np.asarray(color, np.float32) * a)

    def fill_rect(self, x0, y0, x1, y1, color, alpha: float = 1.0, clip=None) -> None:
        """Fill [x0, x1) × [y0, y1), rounded to whole pixels."""
        if clip is not None:
            x0, y0 = max(x0, clip[0]), max(y0, clip[1])
            x1, y1 = min(x1, clip[2]), min(y1, clip[3])
        xa, xb = int(round(min(x0, x1))), int(round(max(x0, x1)))
        ya, yb = int(round(min(y0, y1))), int(round(max(y0, y1)))
        xa, ya = max(xa, 0), max(ya, 0)
        xb, yb = min(max(xb, xa + 1), self.width), min(max(yb, ya + 1), self.height)
        if xa >= xb or ya >= yb:
            return
        block = self.pixels[ya:yb, xa:xb].astype(np.float32)
        self.pixels[ya:yb, xa:xb] = np.round(block * (1 - alpha)
                                             + np.asarray(color, np.float32) * alpha)

    def polyline(self, xs, ys, color, width: float = 1.5, style: str = "-",
                 alpha: float = 1.0, clip=None) -> None:
        """A line through the points (pixels), ``width`` in pixels, solid,
        ``--`` or ``-.`` with matplotlib's dash lengths; NaN breaks it."""
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        if len(xs) == 1:
            xs, ys = np.repeat(xs, 2), np.repeat(ys, 2)
        ok = np.isfinite(xs) & np.isfinite(ys)
        seg = ok[:-1] & ok[1:]
        x0, y0, x1, y1 = xs[:-1][seg], ys[:-1][seg], xs[1:][seg], ys[1:][seg]
        if not len(x0):
            return
        length = np.hypot(x1 - x0, y1 - y0)
        n = np.maximum(np.ceil(length / 0.5).astype(np.int64), 1) + 1
        which = np.repeat(np.arange(len(x0)), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(n - 1, n)
        px = x0[which] + (x1 - x0)[which] * t
        py = y0[which] + (y1 - y0)[which] * t
        if style in ("--", "-."):
            pattern = np.array((3.7, 1.6) if style == "--" else (6.4, 1.6, 1.0, 1.6)) * width
            arc = (np.concatenate([[0.0], np.cumsum(length)[:-1]])[which]
                   + length[which] * t)
            phase = np.mod(arc, pattern.sum())
            edges = np.cumsum(pattern)
            on = np.searchsorted(edges, phase, side="right") % 2 == 0
            px, py = px[on], py[on]
        if clip is not None:
            inside = (px >= clip[0]) & (px <= clip[2]) & (py >= clip[1]) & (py <= clip[3])
            px, py = px[inside], py[inside]
        half = max(width, 1.0) / 2
        offsets = np.arange(-math.ceil(half) + 1, math.ceil(half) + 1) - 0.5
        offsets = offsets[np.abs(offsets) <= half]
        if not len(offsets):
            offsets = np.array([0.0])
        ox, oy = np.meshgrid(offsets, offsets)
        cx = np.floor(px[:, None] + ox.ravel()[None, :]).astype(np.int64).ravel()
        cy = np.floor(py[:, None] + oy.ravel()[None, :]).astype(np.int64).ravel()
        flat = np.unique(cy * (self.width + 1) + cx)
        self._blend(flat // (self.width + 1), flat % (self.width + 1), color, alpha)

    def markers(self, xs, ys, color, size: float = 6.0, clip=None) -> None:
        """Filled disks of diameter ``size`` pixels."""
        r = size / 2
        grid = np.arange(-math.ceil(r), math.ceil(r) + 1)
        ox, oy = np.meshgrid(grid, grid)
        disk = ox ** 2 + oy ** 2 <= r * r
        for x, y in zip(np.asarray(xs, float), np.asarray(ys, float)):
            if not (np.isfinite(x) and np.isfinite(y)):
                continue
            if clip is not None and not (clip[0] <= x <= clip[2] and clip[1] <= y <= clip[3]):
                continue
            self._blend(np.round(y + oy[disk]).astype(np.int64),
                        np.round(x + ox[disk]).astype(np.int64), color, 1.0)

    def glyphs(self, xs, ys, color, marker: str, size: float, hollow: bool = False,
               alpha: float = 1.0, clip=None) -> None:
        """One ``marker`` glyph (``marker_cells``) centred on each point
        (pixels, snapped to the pixel it falls in).  Where k glyphs of the
        call cover a pixel, it is composited k times at ``alpha``."""
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        keep = np.isfinite(xs) & np.isfinite(ys)
        if clip is not None:
            keep &= (xs >= clip[0]) & (xs <= clip[2]) & (ys >= clip[1]) & (ys <= clip[3])
        oy, ox = marker_cells(marker, size, hollow)
        cy = (np.floor(ys[keep]).astype(np.int64)[:, None] + oy[None, :]).ravel()
        cx = (np.floor(xs[keep]).astype(np.int64)[:, None] + ox[None, :]).ravel()
        inside = (cx >= 0) & (cx < self.width) & (cy >= 0) & (cy < self.height)
        flat, count = np.unique(cy[inside] * self.width + cx[inside], return_counts=True)
        self._blend(flat // self.width, flat % self.width, color,
                    1 - (1 - np.float32(alpha)) ** count.astype(np.float32))

    def image(self, rgb_image: np.ndarray, x0, y0, x1, y1, alpha: float = 1.0,
              clip=None) -> None:
        """An (H, W, 3) image resampled (nearest) onto the box, its first row
        at the top."""
        xa, xb = sorted((int(round(x0)), int(round(x1))))
        ya, yb = sorted((int(round(y0)), int(round(y1))))
        lo_x, lo_y, hi_x, hi_y = clip if clip is not None else (0, 0, self.width, self.height)
        xa, ya = max(xa, 0, int(round(lo_x))), max(ya, 0, int(round(lo_y)))
        xb, yb = min(xb, self.width, int(round(hi_x))), min(yb, self.height, int(round(hi_y)))
        if xa >= xb or ya >= yb:
            return
        h, w = rgb_image.shape[:2]
        rows = np.clip(((np.arange(ya, yb) + 0.5 - min(y0, y1)) / abs(y1 - y0) * h)
                       .astype(np.int64), 0, h - 1)
        cols = np.clip(((np.arange(xa, xb) + 0.5 - min(x0, x1)) / abs(x1 - x0) * w)
                       .astype(np.int64), 0, w - 1)
        src = rgb_image[rows][:, cols].astype(np.float32)
        old = self.pixels[ya:yb, xa:xb].astype(np.float32)
        self.pixels[ya:yb, xa:xb] = np.round(old * (1 - alpha) + src * alpha)

    def text_size(self, s: str) -> tuple[int, int]:
        s = s.replace("$", "")
        return (sum(raster_data.FONT_WIDTHS[ord(c) - 32] if 32 <= ord(c) < 127 else
                    raster_data.FONT_WIDTHS[ord("?") - 32] for c in s),
                raster_data.FONT_HEIGHT)

    def text(self, x, y, s: str, color=(0, 0, 0), ha: str = "left", va: str = "top",
             rotate: bool = False) -> None:
        """Text with its box anchored at (x, y): ``ha`` left/center/right,
        ``va`` top/center/bottom; ``rotate`` turns it 90° counter-clockwise
        (reading upwards)."""
        if Canvas._glyphs is None:
            Canvas._glyphs = _font()
        s = s.replace("$", "")  # mathtext's delimiters; its markup is drawn as typed
        if not s:
            return
        mask = np.concatenate([Canvas._glyphs.get(c, Canvas._glyphs["?"]) for c in s], axis=1)
        if rotate:
            mask = np.rot90(mask)
        h, w = mask.shape
        left = x - {"left": 0, "center": w / 2, "right": w}[ha]
        top = y - {"top": 0, "center": h / 2, "bottom": h}[va]
        ys, xs = np.nonzero(mask)
        self._blend(ys + int(round(top)), xs + int(round(left)), rgb(color),
                    mask[ys, xs].astype(np.float32) / 255)

    def save(self, path: str) -> str:
        """Write the canvas as a JPEG (``.jpg``/``.jpeg``) or a PNG
        (``.png``); another extension raises."""
        ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
        if ext in ("jpg", "jpeg"):
            data = encode_jpeg(self.pixels)
        elif ext == "png":
            data = encode_png(self.pixels)
        else:
            raise ValueError(f"{path}: the raster writes .jpg, .jpeg or .png")
        with open(path, "wb") as f:
            f.write(data)
        return path


# matplotlib's marker outlines, in units of the marker's size (points)
_PLUS = np.array([(-1, -3), (1, -3), (1, -1), (3, -1), (3, 1), (1, 1), (1, 3), (-1, 3),
                  (-1, 1), (-3, 1), (-3, -1), (-1, -1), (-1, -3)]) / 6
_CROSS = np.array([[(-0.5, -0.5), (0.5, 0.5)], [(-0.5, 0.5), (0.5, -0.5)]])


def _segment_distance(px, py, segments) -> np.ndarray:
    """The distance of each point to the nearest of the segments
    (k, 2, 2)."""
    a, b = segments[:, 0], segments[:, 1]
    d = b - a
    t = np.clip(((px[:, None] - a[:, 0]) * d[:, 0] + (py[:, None] - a[:, 1]) * d[:, 1])
                / (d ** 2).sum(1), 0, 1)
    return np.hypot(px[:, None] - a[:, 0] - t * d[:, 0],
                    py[:, None] - a[:, 1] - t * d[:, 1]).min(1)


def marker_cells(marker: str, size: float, hollow: bool = False) -> tuple:
    """(dy, dx) of the pixels a scatter ``marker`` of area ``size`` points²
    covers around its centre: the edge a stroke of matplotlib's scatter
    width wide (1 point; 1.5 for the unfilled "x") and, unless ``hollow``,
    the inside."""
    scale = math.sqrt(size) * DPI / 72  # the marker's size in pixels
    half = (1.5 if marker == "x" else 1.0) * DPI / 72 / 2
    reach = math.ceil(scale / 2 + half) + 1
    dy, dx = (g.ravel() for g in np.mgrid[-reach:reach + 1, -reach:reach + 1])
    px, py = dx / scale, dy / scale  # pixel centres in marker units
    if marker == "o":
        radius = np.hypot(px, py)
        edge = np.abs(radius - 0.5) <= half / scale
        inside = radius <= 0.5
    elif marker == "P":
        edge = _segment_distance(px, py, np.stack([_PLUS[:-1], _PLUS[1:]], 1)) <= half / scale
        inside = ((np.abs(px) <= 1 / 6) & (np.abs(py) <= 0.5)) | (
            (np.abs(px) <= 0.5) & (np.abs(py) <= 1 / 6))
    elif marker == "x":
        edge, inside = _segment_distance(px, py, _CROSS) <= half / scale, False
    else:
        raise ValueError(f"marker {marker!r}: o, P or x")
    cover = edge if hollow else edge | inside
    return dy[cover], dx[cover]


# --------------------------------------------------------------------------- #
# colormaps
# --------------------------------------------------------------------------- #

_JET = {  # matplotlib's _jet_data segments (x, value)
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}


def colormap(name: str) -> np.ndarray:
    """The 256-entry table of ``jet`` or ``viridis`` as (256, 3) uint8."""
    if name == "viridis":
        return np.frombuffer(bytes.fromhex("".join(raster_data.VIRIDIS)),
                             dtype=np.uint8).reshape(256, 3)
    if name == "jet":
        x = np.linspace(0, 1, 256)
        chans = [np.interp(x, *zip(*_JET[c])) for c in ("red", "green", "blue")]
        return np.round(np.stack(chans, 1) * 255).astype(np.uint8)
    raise ValueError(f"colormap {name!r}: jet or viridis")


def apply_colormap(values: np.ndarray, name: str, vmin=None, vmax=None) -> np.ndarray:
    """Values → (…, 3) uint8 through the table, linear between vmin and vmax
    (the data's range where not given)."""
    v = np.asarray(values, dtype=np.float64)
    lo = np.nanmin(v) if vmin is None else vmin
    hi = np.nanmax(v) if vmax is None else vmax
    scaled = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.clip((scaled * 256).astype(np.int64), 0, 255)
    return colormap(name)[idx]


# --------------------------------------------------------------------------- #
# axes: limits, ticks, drawing
# --------------------------------------------------------------------------- #


def _data_limits(ax: Axes) -> tuple[list, list]:
    xs, ys = [], []
    for s in ax.series:
        if s.kind in ("line", "scatter"):
            xs.append(np.asarray(s.x, float))
            ys.append(np.asarray(s.y, float))
        elif s.kind == "axhline":
            ys.append(np.atleast_1d(np.asarray(s.y, float)))
        elif s.kind == "axvline":
            xs.append(np.atleast_1d(np.asarray(s.x, float)))
        elif s.kind == "bar":
            x = np.asarray(s.x, float)
            xs.append(np.concatenate([x - 0.4, x + 0.4]))
            ys.append(np.concatenate([[0.0], np.asarray(s.y, float)]))
        elif s.kind == "hist":
            xs.append(np.asarray(s.x, float))
            ys.append(np.concatenate([[0.0], np.asarray(s.y, float)]))
        elif s.kind == "image":
            xs.append(np.asarray(s.extent[:2], float))
            ys.append(np.asarray(s.extent[2:], float))
    return xs, ys


def _span(parts: list, log: bool, margin: float, sticky_zero: bool) -> tuple[float, float]:
    vals = np.concatenate(parts) if parts else np.zeros(0)
    vals = vals[np.isfinite(vals)]
    if log:
        vals = vals[vals > 0]
    if not len(vals):
        return (1.0, 10.0) if log else (0.0, 1.0)
    lo, hi = float(vals.min()), float(vals.max())
    if log:
        lo, hi = math.log10(lo), math.log10(hi)
    if hi == lo:
        lo, hi = lo - (0.5 if log else max(abs(lo) * 0.05, 0.05)), hi + (
            0.5 if log else max(abs(hi) * 0.05, 0.05))
    pad = (hi - lo) * margin
    lo2, hi2 = lo - pad, hi + pad
    if sticky_zero and not log and lo == 0:  # bars stand on the axis
        lo2 = 0.0
    return (10 ** lo2, 10 ** hi2) if log else (lo2, hi2)


def _limits(ax: Axes) -> tuple[tuple, tuple]:
    xs, ys = _data_limits(ax)
    sticky = any(s.kind in ("bar", "hist") for s in ax.series)
    images = any(s.kind == "image" for s in ax.series)
    margin = 0.0 if images else 0.05
    xlim = _span(xs, False, margin, False)
    ylim = _span(ys, ax.yscale == "log", margin, sticky)
    xlim = tuple(v if v is not None else d for v, d in zip(ax.xlim, xlim))
    ylim = tuple(v if v is not None else d for v, d in zip(ax.ylim, ylim))
    return xlim, ylim


def nice_ticks(lo: float, hi: float, n: int = 7) -> np.ndarray:
    """Ticks at multiples of 1, 2, 2.5 or 5 × 10^k inside [lo, hi], at most
    ``n`` + 1 of them."""
    span = hi - lo
    if not span > 0 or not np.isfinite(span):
        return np.array([lo])
    raw = span / n
    mag = 10 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9)
    last = math.floor(hi / step + 1e-9)
    return np.arange(first, last + 1) * step


def tick_label(v: float, step: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:.1e}"
    digits = max(0, -math.floor(math.log10(step) + 1e-9))
    if round(step / 10 ** math.floor(math.log10(step) + 1e-9), 6) == 2.5:
        digits += 1
    return f"{v:.{digits}f}"


def _legend_box(canvas, labels, box, points) -> tuple:
    """The legend's box (x0, y0, x1, y1): the candidate corner or edge spot
    that covers the fewest points of the plotted lines, as "best"."""
    lw = max(canvas.text_size(s)[0] for s in labels) + 40
    lh = len(labels) * 19 + 8
    x0, y0, x1, y1 = box
    pad = 8
    spots = [(x1 - pad - lw, y0 + pad), (x0 + pad, y0 + pad), (x0 + pad, y1 - pad - lh),
             (x1 - pad - lw, y1 - pad - lh), (x1 - pad - lw, (y0 + y1 - lh) / 2),
             (x0 + pad, (y0 + y1 - lh) / 2), ((x0 + x1 - lw) / 2, y1 - pad - lh),
             ((x0 + x1 - lw) / 2, y0 + pad), ((x0 + x1 - lw) / 2, (y0 + y1 - lh) / 2)]
    best, cost = spots[0], None
    for sx, sy in spots:
        c = int(((points[:, 0] >= sx) & (points[:, 0] <= sx + lw) & (points[:, 1] >= sy)
                 & (points[:, 1] <= sy + lh)).sum()) if len(points) else 0
        if cost is None or c < cost:
            best, cost = (sx, sy), c
    return best[0], best[1], best[0] + lw, best[1] + lh


def draw_axes(canvas: Canvas, ax: Axes, fig_w: int, fig_h: int) -> None:
    left, bottom, right, top = ax.box
    x0, x1 = left * fig_w, right * fig_w
    y0, y1 = (1 - top) * fig_h, (1 - bottom) * fig_h
    box = (x0, y0, x1, y1)
    (xa, xb), (ya, yb) = _limits(ax)
    log = ax.yscale == "log"

    def px(x):
        return x0 + (np.asarray(x, float) - xa) / (xb - xa) * (x1 - x0)

    def py(y):
        y = np.asarray(y, float)
        if log:
            with np.errstate(divide="ignore", invalid="ignore"):
                y = np.where(y > 0, np.log10(np.where(y > 0, y, 1)), np.nan)
            lo, hi = math.log10(ya), math.log10(yb)
        else:
            lo, hi = ya, yb
        return y1 - (y - lo) / (hi - lo) * (y1 - y0)

    if log:
        decades = np.arange(math.ceil(math.log10(ya) - 1e-9), math.floor(math.log10(yb) + 1e-9) + 1)
        yticks, ylabels = 10.0 ** decades, [f"10^{int(d)}" for d in decades]
    else:
        yticks = nice_ticks(ya, yb)
        step = yticks[1] - yticks[0] if len(yticks) > 1 else 1.0
        ylabels = [tick_label(v, step) for v in yticks]
    if ax.xticks is not None:
        xticks, xlabels = np.asarray(ax.xticks[0], float), list(ax.xticks[1])
    else:
        xticks = nice_ticks(xa, xb)
        step = xticks[1] - xticks[0] if len(xticks) > 1 else 1.0
        xlabels = [tick_label(v, step) for v in xticks]
    xticks_px, yticks_px = px(xticks), py(yticks)
    if ax.grid:
        for t in xticks_px:
            canvas.polyline([t, t], [y0, y1], GRID, 0.8 * DPI / 72, clip=box)
        for t in yticks_px:
            canvas.polyline([x0, x1], [t, t], GRID, 0.8 * DPI / 72, clip=box)

    points = []
    for s in ax.series:
        color = rgb(s.color)
        width = s.width * DPI / 72
        if s.kind == "image":
            e = s.extent
            image = apply_colormap(s.image, s.cmap, *(s.vrange or (None, None)))
            if s.origin == "lower":
                image = image[::-1]
            canvas.image(image, px(e[0]), py(e[3]), px(e[1]), py(e[2]), s.alpha, clip=box)
        elif s.kind == "line":
            lx, ly = px(s.x), py(s.y)
            canvas.polyline(lx, ly, color, width, s.style, s.alpha, clip=box)
            points.append(np.stack([lx, ly], 1))
        elif s.kind == "axhline":
            canvas.polyline([x0, x1], [py(s.y)] * 2, color, width, s.style, s.alpha, clip=box)
        elif s.kind == "axvline":
            canvas.polyline([px(s.x)] * 2, [y0, y1], color, width, s.style, s.alpha, clip=box)
        elif s.kind == "bar":
            colors = s.colors or [s.color] * len(s.x)
            for x, h, c in zip(np.asarray(s.x, float), np.asarray(s.y, float), colors):
                canvas.fill_rect(px(x - 0.4), py(h), px(x + 0.4), py(0.0), rgb(c), s.alpha,
                                 clip=box)
        elif s.kind == "hist":
            edges, counts = np.asarray(s.x, float), np.asarray(s.y, float)
            for a, b, h in zip(edges[:-1], edges[1:], counts):
                if h > 0:
                    canvas.fill_rect(px(a), py(h), px(b), py(0.0), color, s.alpha, clip=box)
        elif s.kind == "scatter":
            sx, sy = np.atleast_1d(px(s.x)), np.atleast_1d(py(s.y))
            if s.marker is None:
                canvas.markers(sx, sy, color, clip=box)
            else:
                canvas.glyphs(sx, sy, color, s.marker, s.size, s.hollow, s.alpha, clip=box)
            points.append(np.stack([sx, sy], 1))
        elif s.kind == "annotate":
            canvas.text(float(px(s.x)), float(py(s.y)), s.text, color, va="bottom")

    # the frame, ticks and tick labels
    black = (0, 0, 0)
    for xs_, ys_ in (([x0, x1], [y0, y0]), ([x0, x1], [y1, y1]), ([x0, x0], [y0, y1]),
                     ([x1, x1], [y0, y1])):
        canvas.polyline(xs_, ys_, black, 1.1)
    for t, label in zip(xticks_px, xlabels):
        if x0 - 0.5 <= t <= x1 + 0.5:
            canvas.polyline([t, t], [y1, y1 + 4.9], black, 1.1)
            if ax.xticks is not None:
                canvas.text(t, y1 + 7, label, ha="center", va="top", rotate=True)
            else:
                canvas.text(t, y1 + 7, label, ha="center", va="top")
    for t, label in zip(yticks_px, ylabels):
        if y0 - 0.5 <= t <= y1 + 0.5:
            canvas.polyline([x0 - 4.9, x0], [t, t], black, 1.1)
            canvas.text(x0 - 7, t, label, ha="right", va="center")
    if ax.xlabel:
        below = 7 + (max((canvas.text_size(s)[0] for s in xlabels), default=0)
                     if ax.xticks is not None else 17) + 4
        canvas.text((x0 + x1) / 2, y1 + below, ax.xlabel, ha="center", va="top")
    if ax.ylabel:
        widest = max((canvas.text_size(s)[0] for s in ylabels), default=0)
        canvas.text(x0 - 7 - widest - 6, (y0 + y1) / 2, ax.ylabel, ha="right", va="center",
                    rotate=True)
    if ax.title:
        canvas.text((x0 + x1) / 2, y0 - 6, ax.title, ha="center", va="bottom")
    if ax.colorbar:
        bx0, bx1 = x1 + 0.03 * fig_w, x1 + 0.05 * fig_w
        table = colormap(ax.colorbar)[::-1][:, None, :]
        canvas.image(table, bx0, y0, bx1, y1)
        images = [s for s in ax.series if s.kind == "image"]
        lo, hi = (images[0].vrange or (float(np.nanmin(images[0].image)),
                                       float(np.nanmax(images[0].image)))
                  if images else (0.0, 1.0))
        for v in nice_ticks(lo, hi, 5):
            ty = y1 - (v - lo) / (hi - lo) * (y1 - y0) if hi > lo else y1
            canvas.text(bx1 + 4, ty, tick_label(v, (hi - lo) / 5 or 1.0), ha="left",
                        va="center")
    labels = ax.legend_labels()
    if ax.legend and labels:
        pts = np.concatenate(points) if points else np.zeros((0, 2))
        lx0, ly0, lx1, ly1 = _legend_box(canvas, labels, box, pts)
        canvas.fill_rect(lx0, ly0, lx1, ly1, (255, 255, 255), 0.8)
        for xs_, ys_ in (([lx0, lx1], [ly0, ly0]), ([lx0, lx1], [ly1, ly1]),
                         ([lx0, lx0], [ly0, ly1]), ([lx1, lx1], [ly0, ly1])):
            canvas.polyline(xs_, ys_, (204, 204, 204), 1.0)
        row = ly0 + 4
        for s in ax.series:
            if not (s.label and not s.label.startswith("_")):
                continue
            mid = row + 9
            color = rgb(s.color if s.colors is None else s.colors[0])
            if s.kind in ("bar", "hist"):
                canvas.fill_rect(lx0 + 6, mid - 4, lx0 + 30, mid + 5, color, s.alpha)
            elif s.kind == "scatter" and s.marker is None:
                canvas.markers([lx0 + 18], [mid], color)
            elif s.kind == "scatter":
                canvas.glyphs([lx0 + 18], [mid], color, s.marker, s.size, s.hollow, s.alpha)
            else:
                canvas.polyline([lx0 + 6, lx0 + 30], [mid, mid], color, s.width * DPI / 72,
                                s.style)
            canvas.text(lx0 + 36, mid, s.label, va="center")
            row += 19


def render(fig: Figure) -> Canvas:
    canvas = Canvas(fig.width, fig.height)
    for ax in fig.axes:
        draw_axes(canvas, ax, fig.width, fig.height)
    return canvas


def save(fig: Figure, path: str) -> str:
    """Render ``fig`` and write it to ``path`` (the format by extension)."""
    return render(fig).save(path)


# --------------------------------------------------------------------------- #
# JPEG (baseline, YCbCr 4:2:0, Annex K tables) and PNG
# --------------------------------------------------------------------------- #

_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                     + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 6 + [99] * 32)
# Annex K.3: (code lengths 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
    0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
    0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
    0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
    0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


# JFIF's RGB → YCbCr (before the +128 of the chroma)
_YCC = np.float32([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                   [0.5, -0.418688, -0.081312]])


def _zigzag() -> np.ndarray:
    cells = [(i, j) for i in range(8) for j in range(8)]
    cells.sort(key=lambda c: (c[0] + c[1], c[0] if (c[0] + c[1]) % 2 else -c[0]))
    return np.array([i * 8 + j for i, j in cells])


ZIGZAG = _zigzag()


def _huffman(spec) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0..255 from the (lengths, symbols) spec."""
    bits, symbols = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    m[0] = np.sqrt(1 / 8)
    return m


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) → (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _size(v: np.ndarray) -> np.ndarray:
    """JPEG's magnitude category: the bit length of |v|."""
    return np.where(v == 0, 0, np.frexp(np.abs(v).astype(np.float64))[1]).astype(np.int64)


def encode_jpeg(pixels: np.ndarray, quality: int = 75) -> bytes:
    """A baseline JPEG of an (H, W, 3) uint8 image: YCbCr, chroma averaged
    over 2 × 2 (4:2:0), the Annex K quantization tables scaled to
    ``quality`` and its Huffman tables."""
    h, w, _ = pixels.shape
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    img = np.pad(pixels, ((0, H - h), (0, W - w), (0, 0)), mode="edge")
    flat = img.reshape(-1, 3)
    ycc = np.empty(flat.shape, np.float32)
    ycc[:] = (255, 128, 128)  # white; converting only the other pixels saves most of it
    ink = np.flatnonzero((flat[:, 0] & flat[:, 1] & flat[:, 2]) != 255)
    rgb_ink = flat[ink].astype(np.float32)
    for i in range(3):
        ycc[ink, i] = (rgb_ink[:, 0] * _YCC[i, 0] + rgb_ink[:, 1] * _YCC[i, 1]
                       + rgb_ink[:, 2] * _YCC[i, 2] + (0 if i == 0 else 128))
    y, cb, cr = (ycc[:, i].reshape(H, W) for i in range(3))
    cb, cr = ((c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]) * 0.25
              for c in (cb, cr))
    qy, qc = _quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)
    m = _dct_matrix()

    # no BLAS call anywhere here: its worker threads would keep spinning on
    # the host cores after a plot and slow the training that follows
    m = m.astype(np.float32)

    def coefficients(plane, q):
        blocks = _blocks(plane - np.float32(128))
        rows, cols = blocks.shape[:2]
        flat = blocks.reshape(-1, 64)
        # a flat block (most of a plot's white) has its DC term alone: 8 × its value
        busy = flat.max(axis=1) != flat.min(axis=1)
        d = np.zeros(flat.shape, np.float32)
        d[~busy, 0] = flat[~busy, 0] * 8
        x = flat[busy].reshape(-1, 8, 8)
        d[busy] = np.einsum("ux,bxv->buv", m, np.einsum("bxy,vy->bxv", x, m)).reshape(
            -1, 64)[:, ZIGZAG]
        return np.round(d / q[ZIGZAG].astype(np.float32)).astype(np.int64).reshape(
            rows, cols, 64)

    cy, ccb, ccr = coefficients(y, qy), coefficients(cb, qc), coefficients(cr, qc)
    my, mx = H // 16, W // 16
    # MCU order: four luma blocks (2 × 2), then Cb, then Cr
    ys = cy.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    mcus = np.concatenate([ys, ccb.reshape(my * mx, 1, 64), ccr.reshape(my * mx, 1, 64)], 1)
    blocks = mcus.reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    chroma = comp > 0
    # DC differences per component
    dc = blocks[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(3):
        sel = comp == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    tables = {name: _huffman(spec) for name, spec in
              (("dcl", _DC_LUMA), ("dcc", _DC_CHROMA), ("acl", _AC_LUMA), ("acc", _AC_CHROMA))}
    n_blocks = len(blocks)
    events_block, events_key, events_val, events_len = [], [], [], []

    def emit(block, key, symbol, table_luma, table_chroma, is_chroma, extra, extra_len):
        code = np.where(is_chroma, table_chroma[0][symbol], table_luma[0][symbol])
        clen = np.where(is_chroma, table_chroma[1][symbol], table_luma[1][symbol])
        events_block.append(block)
        events_key.append(key)
        events_val.append((code << extra_len) | extra)
        events_len.append(clen + extra_len)

    s = _size(diff)
    extra = np.where(diff < 0, diff + (1 << s) - 1, diff)
    all_blocks = np.arange(n_blocks)
    emit(all_blocks, np.zeros(n_blocks, np.int64), s, tables["dcl"], tables["dcc"], chroma,
         extra, s)
    ac = blocks[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    zrl = run // 16
    for j in range(int(zrl.max(initial=0))):
        sel = zrl > j
        n = int(sel.sum())
        emit(b[sel], k[sel] * 32 + j, np.full(n, 0xF0), tables["acl"], tables["acc"],
             chroma[b[sel]], np.zeros(n, np.int64), np.zeros(n, np.int64))
    v = ac[b, k - 1]
    s = _size(v)
    emit(b, k * 32 + 20, (run % 16) * 16 + s, tables["acl"], tables["acc"], chroma[b],
         np.where(v < 0, v + (1 << s) - 1, v), s)
    last = np.zeros(n_blocks, np.int64)
    last[b] = k  # the last nonzero position of each block (k ascends per block)
    eob = last < 63
    n = int(eob.sum())
    emit(all_blocks[eob], np.full(n, 64 * 32), np.zeros(n, np.int64), tables["acl"],
         tables["acc"], chroma[eob], np.zeros(n, np.int64), np.zeros(n, np.int64))
    blk, key = np.concatenate(events_block), np.concatenate(events_key)
    val, length = np.concatenate(events_val), np.concatenate(events_len)
    order = np.lexsort((key, blk))
    val, length = val[order], length[order]
    total = int(length.sum())
    # each code left-aligned in 32 bits, big-endian, then its first `length` bits
    aligned = (val.astype(np.uint64) << (32 - length).astype(np.uint64)).astype(">u4")
    bits = np.unpackbits(aligned.view(np.uint8).reshape(-1, 4), axis=1)
    bits = bits[np.arange(32)[None, :] < length[:, None]]
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    data = np.insert(data, ff + 1, 0).tobytes()

    def segment(marker: int, payload: bytes) -> bytes:
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    def dht(cls_id: int, spec) -> bytes:
        bits_, symbols = spec
        return bytes([cls_id]) + bytes(bits_) + bytes(symbols)

    out = [b"\xff\xd8",
           segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           segment(0xFFDB, b"\x00" + bytes(qy[ZIGZAG].tolist())
                   + b"\x01" + bytes(qc[ZIGZAG].tolist())),
           segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                   + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
           segment(0xFFC4, dht(0x00, _DC_LUMA) + dht(0x10, _AC_LUMA)
                   + dht(0x01, _DC_CHROMA) + dht(0x11, _AC_CHROMA)),
           segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
           data, b"\xff\xd9"]
    return b"".join(out)


def jpeg_header(data: bytes) -> dict:
    """SOI, the SOF0 frame (width, height, components) and EOI of a
    baseline JPEG; raises where one is missing."""
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        raise ValueError("not a JPEG: no SOI or no EOI")
    at = 2
    while at + 4 <= len(data):
        if data[at] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {at}")
        marker, length = data[at + 1], struct.unpack(">H", data[at + 2:at + 4])[0]
        if marker == 0xC0:
            _, height, width, comps = struct.unpack(">BHHB", data[at + 4:at + 10])
            return {"width": width, "height": height, "components": comps}
        if marker == 0xDA:
            break
        at += 2 + length
    raise ValueError("JPEG: no baseline frame (SOF0)")


def encode_png(pixels: np.ndarray) -> bytes:
    """An 8-bit RGBA PNG (opaque, as matplotlib writes its ``.png``), each
    row unfiltered, one zlib stream."""
    h, w, _ = pixels.shape
    rgba = np.concatenate([pixels, np.full((h, w, 1), 255, np.uint8)], 2)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], 1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))

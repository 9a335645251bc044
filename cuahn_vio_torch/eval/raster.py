"""A raster plot writer: axes, lines, fills, arrows, images and text on an
(H, W, 3) uint8 canvas, with numpy only.

The port draws its figures (``eval/plots``) with this module in place of
matplotlib, which the card's machine lacks. It follows matplotlib's
defaults where a figure's content depends on them (the tab10 colour
cycle, named colours, autoscaled limits with 5 % margins, equal aspect by
widening the data limits, log-y), and is its own in what only shapes the
pixels: a 5x7 bitmap font held below, no antialiasing (a line is discs
stamped along it; a pixel is lit when its centre is within half the width
of the line), its own tick placement and legend position.

Coordinates: pixel (row r, column c) has its centre at (x, y) = (c, r),
y downward. ``Transform`` maps data coordinates into an axes box of the
canvas.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np

# matplotlib's default colour cycle (tab10) and the named colours the plots use
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf")
NAMED = {"b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0), "red": (1.0, 0.0, 0.0),
         "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0)}
# a dark-to-light ramp (viridis at 0, 1/8, ..., 1), linearly interpolated
RAMP = ((0.267, 0.0049, 0.3294), (0.2788, 0.1755, 0.4834), (0.2297, 0.3224, 0.5457),
        (0.1727, 0.4488, 0.5579), (0.1276, 0.5669, 0.5506), (0.1579, 0.6838, 0.5017),
        (0.3692, 0.7889, 0.3829), (0.6785, 0.8637, 0.1895), (0.9932, 0.9062, 0.1439))
GRID_RGB = (0.6902, 0.6902, 0.6902)  # matplotlib's grid colour, #b0b0b0
MARGIN = 0.05  # autoscale margin, a share of the data span at each end
DASH = (3.7, 1.6)  # "--": on and off lengths in line widths (matplotlib's)

# 5x7 glyphs, ASCII 32-126: seven rows top to bottom, bit 4 the leftmost column
_GLYPHS = {
    " ": "00 00 00 00 00 00 00", "!": "04 04 04 04 04 00 04", '"': "0a 0a 0a 00 00 00 00",
    "#": "0a 0a 1f 0a 1f 0a 0a", "$": "04 0f 14 0e 05 1e 04", "%": "18 19 02 04 08 13 03",
    "&": "0c 12 14 08 15 12 0d", "'": "0c 04 08 00 00 00 00", "(": "02 04 08 08 08 04 02",
    ")": "08 04 02 02 02 04 08", "*": "00 04 15 0e 15 04 00", "+": "00 04 04 1f 04 04 00",
    ",": "00 00 00 00 0c 04 08", "-": "00 00 00 1f 00 00 00", ".": "00 00 00 00 00 0c 0c",
    "/": "00 01 02 04 08 10 00", "0": "0e 11 13 15 19 11 0e", "1": "04 0c 04 04 04 04 0e",
    "2": "0e 11 01 02 04 08 1f", "3": "1f 02 04 02 01 11 0e", "4": "02 06 0a 12 1f 02 02",
    "5": "1f 10 1e 01 01 11 0e", "6": "06 08 10 1e 11 11 0e", "7": "1f 01 02 04 08 08 08",
    "8": "0e 11 11 0e 11 11 0e", "9": "0e 11 11 0f 01 02 0c", ":": "00 0c 0c 00 0c 0c 00",
    ";": "00 0c 0c 00 0c 04 08", "<": "02 04 08 10 08 04 02", "=": "00 00 1f 00 1f 00 00",
    ">": "08 04 02 01 02 04 08", "?": "0e 11 01 02 04 00 04", "@": "0e 11 01 0d 15 15 0e",
    "A": "0e 11 11 11 1f 11 11", "B": "1e 11 11 1e 11 11 1e", "C": "0e 11 10 10 10 11 0e",
    "D": "1c 12 11 11 11 12 1c", "E": "1f 10 10 1e 10 10 1f", "F": "1f 10 10 1e 10 10 10",
    "G": "0e 11 10 17 11 11 0f", "H": "11 11 11 1f 11 11 11", "I": "0e 04 04 04 04 04 0e",
    "J": "07 02 02 02 02 12 0c", "K": "11 12 14 18 14 12 11", "L": "10 10 10 10 10 10 1f",
    "M": "11 1b 15 15 11 11 11", "N": "11 11 19 15 13 11 11", "O": "0e 11 11 11 11 11 0e",
    "P": "1e 11 11 1e 10 10 10", "Q": "0e 11 11 11 15 12 0d", "R": "1e 11 11 1e 14 12 11",
    "S": "0f 10 10 0e 01 01 1e", "T": "1f 04 04 04 04 04 04", "U": "11 11 11 11 11 11 0e",
    "V": "11 11 11 11 11 0a 04", "W": "11 11 11 15 15 15 0a", "X": "11 11 0a 04 0a 11 11",
    "Y": "11 11 11 0a 04 04 04", "Z": "1f 01 02 04 08 10 1f", "[": "0e 08 08 08 08 08 0e",
    "\\": "00 10 08 04 02 01 00", "]": "0e 02 02 02 02 02 0e", "^": "04 0a 11 00 00 00 00",
    "_": "00 00 00 00 00 00 1f", "`": "08 04 02 00 00 00 00", "a": "00 00 0e 01 0f 11 0f",
    "b": "10 10 16 19 11 11 1e", "c": "00 00 0e 10 10 11 0e", "d": "01 01 0d 13 11 11 0f",
    "e": "00 00 0e 11 1f 10 0e", "f": "06 09 08 1c 08 08 08", "g": "00 0f 11 11 0f 01 0e",
    "h": "10 10 16 19 11 11 11", "i": "04 00 0c 04 04 04 0e", "j": "02 00 06 02 02 12 0c",
    "k": "10 10 12 14 18 14 12", "l": "0c 04 04 04 04 04 0e", "m": "00 00 1a 15 15 11 11",
    "n": "00 00 16 19 11 11 11", "o": "00 00 0e 11 11 11 0e", "p": "00 00 1e 11 1e 10 10",
    "q": "00 00 0d 13 0f 01 01", "r": "00 00 16 19 10 10 10", "s": "00 00 0e 10 0e 01 1e",
    "t": "08 08 1c 08 08 09 06", "u": "00 00 11 11 11 13 0d", "v": "00 00 11 11 11 0a 04",
    "w": "00 00 11 11 15 15 0a", "x": "00 00 11 0a 04 0a 11", "y": "00 00 11 11 0f 01 0e",
    "z": "00 00 1f 02 04 08 1f", "{": "02 04 04 08 04 04 02", "|": "04 04 04 04 04 04 04",
    "}": "08 04 04 02 04 04 08", "~": "00 00 08 15 02 00 00",
}
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6


def _glyph(ch: str) -> np.ndarray:
    rows = [int(v, 16) for v in _GLYPHS.get(ch, _GLYPHS["?"]).split()]
    return np.array([[(r >> (4 - c)) & 1 for c in range(GLYPH_W)] for r in rows], bool)


FONT = {ch: _glyph(ch) for ch in _GLYPHS}


def rgb(color) -> tuple:
    """A colour as (r, g, b) in [0, 1]: "C0".."C9" (the cycle), a name of
    ``NAMED``, "#rrggbb", or a 3- or 4-tuple (alpha dropped)."""
    if isinstance(color, str):
        if color in NAMED:
            return NAMED[color]
        if len(color) == 2 and color[0] == "C" and color[1].isdigit():
            color = TAB10[int(color[1])]
        if color.startswith("#") and len(color) == 7:
            return tuple(int(color[i:i + 2], 16) / 255.0 for i in (1, 3, 5))
        raise ValueError(f"unknown colour {color!r}")
    return tuple(float(c) for c in color[:3])


def ramp(t: float) -> tuple:
    """The dark-to-light ramp at ``t`` in [0, 1]."""
    t = min(max(float(t), 0.0), 1.0) * (len(RAMP) - 1)
    i = min(int(t), len(RAMP) - 2)
    f = t - i
    return tuple((1 - f) * a + f * b for a, b in zip(RAMP[i], RAMP[i + 1]))


def rgb_u8(color, alpha: float = 1.0, over=(1.0, 1.0, 1.0)) -> tuple:
    """The uint8 pixel a colour gives at ``alpha`` over ``over``."""
    return tuple(int(round(255.0 * ((1 - alpha) * o + alpha * c)))
                 for c, o in zip(rgb(color), over))


class Box(NamedTuple):
    """An axes box on the canvas, pixel coordinates (y downward)."""

    x0: float
    y0: float  # top
    x1: float
    y1: float  # bottom


class Transform(NamedTuple):
    """Data -> pixel coordinates of an axes box: ``xlim`` = (left, right),
    ``ylim`` = (bottom, top) (either may run backwards), y on a log10 scale
    when ``ylog``."""

    box: Box
    xlim: tuple
    ylim: tuple
    ylog: bool = False

    def __call__(self, x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        b = self.box
        px = b.x0 + (x - self.xlim[0]) / (self.xlim[1] - self.xlim[0]) * (b.x1 - b.x0)
        lo, hi = self.ylim
        if self.ylog:
            with np.errstate(divide="ignore", invalid="ignore"):
                y = np.where(y > 0, np.log10(np.where(y > 0, y, 1.0)), np.nan)
            lo, hi = math.log10(lo), math.log10(hi)
        py = b.y1 - (y - lo) / (hi - lo) * (b.y1 - b.y0)
        return px, py

    def inverse(self, px, py):
        b = self.box
        x = self.xlim[0] + (np.asarray(px, np.float64) - b.x0) / (b.x1 - b.x0) * (
            self.xlim[1] - self.xlim[0])
        lo, hi = self.ylim
        if self.ylog:
            lo, hi = math.log10(lo), math.log10(hi)
        y = lo + (b.y1 - np.asarray(py, np.float64)) / (b.y1 - b.y0) * (hi - lo)
        return x, (10.0 ** y if self.ylog else y)


def autoscale(values: Sequence[np.ndarray], log: bool = False) -> tuple:
    """(lo, hi) of the finite values (positive ones on a log scale) widened
    by ``MARGIN`` of their span at each end (in log10 on a log scale), as
    matplotlib autoscales; a single value gets +-1 (x 10 on a log scale)
    around it, no value (0, 1) ((1, 10) on a log scale)."""
    v = np.concatenate([np.asarray(a, np.float64).ravel() for a in values] or [np.zeros(0)])
    v = v[np.isfinite(v)]
    if log:
        v = np.log10(v[v > 0])
    if v.size == 0:
        lo, hi = 0.0, 1.0
    else:
        lo, hi = float(v.min()), float(v.max())
        if hi == lo:
            lo, hi = lo - 1.0, hi + 1.0
        else:
            pad = MARGIN * (hi - lo)
            lo, hi = lo - pad, hi + pad
    return (10.0 ** lo, 10.0 ** hi) if log else (lo, hi)


def equal_aspect(xlim: tuple, ylim: tuple, box: Box) -> tuple:
    """(xlim, ylim) with the narrower one widened about its centre so one
    data unit spans as many pixels on both axes (matplotlib's
    ``axis("equal")``: the box stays, the data limits give)."""
    w, h = box.x1 - box.x0, box.y1 - box.y0
    sx, sy = (xlim[1] - xlim[0]) / w, (ylim[1] - ylim[0]) / h  # data units a pixel
    if sx > sy:
        c, half = 0.5 * (ylim[0] + ylim[1]), 0.5 * sx * h
        ylim = (c - half, c + half)
    else:
        c, half = 0.5 * (xlim[0] + xlim[1]), 0.5 * sy * w
        xlim = (c - half, c + half)
    return xlim, ylim


def fit_box(box: Box, xlim: tuple, ylim: tuple) -> Box:
    """The largest box centred in ``box`` in which one data unit spans as
    many pixels on both axes (``imshow``'s equal aspect: the box gives,
    the data limits stay)."""
    dw, dh = abs(xlim[1] - xlim[0]), abs(ylim[1] - ylim[0])
    s = min((box.x1 - box.x0) / dw, (box.y1 - box.y0) / dh)
    cx, cy = 0.5 * (box.x0 + box.x1), 0.5 * (box.y0 + box.y1)
    return Box(cx - 0.5 * s * dw, cy - 0.5 * s * dh, cx + 0.5 * s * dw, cy + 0.5 * s * dh)


def nice_ticks(lo: float, hi: float, most: int = 8) -> np.ndarray:
    """Ticks at a step of 1, 2, 2.5 or 5 x 10^k inside [lo, hi], at most
    ``most`` of them."""
    lo, hi = min(lo, hi), max(lo, hi)
    span = hi - lo
    if not span > 0:
        return np.array([lo])
    base = 10.0 ** math.floor(math.log10(span / most))
    for m in (1.0, 2.0, 2.5, 5.0, 10.0, 20.0):
        step = m * base
        first, last = math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9)
        if last - first + 1 <= most:
            return np.arange(first, last + 1) * step
    return np.array([lo, hi])


def log_ticks(lo: float, hi: float) -> np.ndarray:
    """The powers of 10 inside [lo, hi] (both > 0)."""
    lo, hi = min(lo, hi), max(lo, hi)
    return 10.0 ** np.arange(math.ceil(math.log10(lo) - 1e-9),
                             math.floor(math.log10(hi) + 1e-9) + 1)


def tick_labels(ticks: np.ndarray, log: bool = False) -> list:
    """Labels of ``ticks``: "1e<k>" on a log scale, else as many decimals
    as the step needs."""
    if log:
        return [f"1e{int(round(math.log10(t)))}" for t in ticks]
    step = float(np.min(np.diff(ticks))) if len(ticks) > 1 else 1.0
    decimals = 0
    while decimals < 8 and abs(round(step, decimals) - step) > 1e-9 * max(step, 1e-300):
        decimals += 1
    return [f"{0.0 if abs(t) < 1e-12 * step else t:.{decimals}f}" for t in ticks]


def text_mask(s: str, scale: int) -> np.ndarray:
    """The bitmap of ``s`` in the 5x7 font, each font pixel ``scale`` x
    ``scale``: (7 scale, 6 scale len(s)) bool."""
    cells = np.zeros((GLYPH_H, max(ADVANCE * len(s) - 1, 1)), bool)
    for i, ch in enumerate(s):
        cells[:, ADVANCE * i:ADVANCE * i + GLYPH_W] = FONT.get(ch, FONT["?"])
    return np.kron(cells, np.ones((scale, scale), bool))


def font_scale(points: float, dpi: float) -> int:
    """Font pixels a glyph pixel for a ``points`` font at ``dpi``: the
    glyph's 7 rows span the font's cap height, ~0.7 of its size."""
    return max(1, int(round(0.7 * points * dpi / 72.0 / GLYPH_H)))


class Canvas:
    """An (H, W, 3) uint8 image, white, drawn on in pixel coordinates."""

    def __init__(self, width: int, height: int):
        self.px = np.full((int(height), int(width), 3), 255, np.uint8)

    @property
    def width(self) -> int:
        return self.px.shape[1]

    @property
    def height(self) -> int:
        return self.px.shape[0]

    def paint(self, rows, cols, color, alpha: float = 1.0, clip: Optional[Box] = None):
        """Blend ``color`` at ``alpha`` into the pixels (rows, cols), each
        pixel once, those outside the canvas (and ``clip``) dropped."""
        rows, cols = np.asarray(rows, np.int64).ravel(), np.asarray(cols, np.int64).ravel()
        keep = (rows >= 0) & (rows < self.height) & (cols >= 0) & (cols < self.width)
        if clip is not None:
            keep &= ((cols >= math.floor(clip.x0)) & (cols <= math.ceil(clip.x1))
                     & (rows >= math.floor(clip.y0)) & (rows <= math.ceil(clip.y1)))
        idx = np.unique(rows[keep] * self.width + cols[keep])
        flat = self.px.reshape(-1, 3)
        c = 255.0 * np.asarray(rgb(color))
        if alpha >= 1.0:
            flat[idx] = np.round(c).astype(np.uint8)
        else:
            flat[idx] = np.round((1 - alpha) * flat[idx] + alpha * c).astype(np.uint8)

    def discs(self, xs, ys, radius: float, color, alpha: float = 1.0,
              clip: Optional[Box] = None):
        """Filled discs of ``radius`` px centred at the points (xs, ys): the
        pixels whose centres lie within ``radius`` (the nearest pixel at
        least)."""
        xs, ys = np.asarray(xs, np.float64).ravel(), np.asarray(ys, np.float64).ravel()
        ok = np.isfinite(xs) & np.isfinite(ys)
        xs, ys = xs[ok], ys[ok]
        r = max(radius, 0.5)
        k = int(math.ceil(r))
        dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
        cx, cy = np.round(xs)[:, None], np.round(ys)[:, None]
        px, py = cx + dx.ravel()[None], cy + dy.ravel()[None]
        inside = (px - xs[:, None]) ** 2 + (py - ys[:, None]) ** 2 <= r * r
        inside |= (dx.ravel() == 0) & (dy.ravel() == 0)  # the nearest pixel
        self.paint(py[inside], px[inside], color, alpha, clip)

    def polyline(self, xs, ys, color, width: float, alpha: float = 1.0,
                 dash: Optional[tuple] = None, clip: Optional[Box] = None):
        """A polyline of ``width`` px through the points, broken at
        non-finite ones: the pixels whose centres lie within half the width
        (0.5 px at least) of a segment, and the pixel nearest each point;
        with ``dash`` = (on, off) px, only where the nearest point of the
        segment lies on a dash, counted along the line."""
        xs, ys = np.asarray(xs, np.float64).ravel(), np.asarray(ys, np.float64).ravel()
        r = max(0.5 * width, 0.5)
        if dash is None:
            self.discs(xs, ys, r, color, alpha, clip)
        if xs.size < 2:
            return
        x0, y0, x1, y1 = xs[:-1], ys[:-1], xs[1:], ys[1:]
        seg = np.hypot(x1 - x0, y1 - y0)
        start = np.concatenate([[0.0], np.cumsum(np.where(np.isfinite(seg), seg, 0.0))[:-1]])
        ok = np.isfinite(seg) & (seg > 0)
        if clip is not None:  # segments wholly off the box draw nothing
            pad = r + 2
            ok &= ~((np.maximum(x0, x1) < clip.x0 - pad) | (np.minimum(x0, x1) > clip.x1 + pad)
                    | (np.maximum(y0, y1) < clip.y0 - pad)
                    | (np.minimum(y0, y1) > clip.y1 + pad))
        x0, y0, x1, y1, seg, start = x0[ok], y0[ok], x1[ok], y1[ok], seg[ok], start[ok]
        # samples every 0.5 px along each segment; each pixel within r of a
        # segment lies within r + 0.5 of one of its samples
        n = np.minimum(np.ceil(seg / 0.5).astype(np.int64), 100000) + 1
        which = np.repeat(np.arange(len(seg)), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(n - 1, n)
        sx = x0[which] + t * (x1 - x0)[which]
        sy = y0[which] + t * (y1 - y0)[which]
        k = int(math.ceil(r + 0.5))
        dy, dx = (a.ravel()[None] for a in np.mgrid[-k:k + 1, -k:k + 1])
        px, py = np.round(sx)[:, None] + dx, np.round(sy)[:, None] + dy
        ux, uy = ((x1 - x0) / seg)[which][:, None], ((y1 - y0) / seg)[which][:, None]
        along = np.clip((px - x0[which][:, None]) * ux + (py - y0[which][:, None]) * uy, 0.0,
                        seg[which][:, None])
        near = np.hypot(px - x0[which][:, None] - along * ux, py - y0[which][:, None] - along * uy)
        lit = near <= r
        if dash is not None:
            lit &= np.mod(start[which][:, None] + along, dash[0] + dash[1]) < dash[0]
        self.paint(py[lit], px[lit], color, alpha, clip)

    def polygon(self, xs, ys, color, alpha: float = 1.0, clip: Optional[Box] = None):
        """A filled polygon (even-odd rule): on each pixel row, the pixels
        whose centres lie between an entering and a leaving edge."""
        xs, ys = np.asarray(xs, np.float64).ravel(), np.asarray(ys, np.float64).ravel()
        ok = np.isfinite(xs) & np.isfinite(ys)
        xs, ys = xs[ok], ys[ok]
        if xs.size < 3:
            return
        ax, ay, bx, by = xs, ys, np.roll(xs, -1), np.roll(ys, -1)
        flat = ay != by
        ax, ay, bx, by = ax[flat], ay[flat], bx[flat], by[flat]
        rows = np.arange(max(math.ceil(ys.min()), 0), min(math.floor(ys.max()), self.height - 1)
                         + 1)
        if rows.size == 0:
            return
        yc = rows[:, None].astype(np.float64)
        crosses = ((ay <= yc) & (yc < by)) | ((by <= yc) & (yc < ay))
        with np.errstate(divide="ignore", invalid="ignore"):
            xc = ax + (yc - ay) * (bx - ax) / (by - ay)
        xc = np.sort(np.where(crosses, xc, np.inf), axis=1)
        out_r, out_c = [], []
        for i, row in enumerate(rows):
            x = xc[i][np.isfinite(xc[i])]
            for left, right in zip(x[0::2], x[1::2]):
                cols = np.arange(math.ceil(left), math.ceil(right))
                out_c.append(cols)
                out_r.append(np.full(cols.size, row))
        if out_c:
            self.paint(np.concatenate(out_r), np.concatenate(out_c), color, alpha, clip)

    def rect(self, x0, y0, x1, y1, color, alpha: float = 1.0):
        """The pixels with centres in [x0, x1] x [y0, y1], filled."""
        r, c = np.mgrid[math.ceil(y0):math.floor(y1) + 1, math.ceil(x0):math.floor(x1) + 1]
        self.paint(r, c, color, alpha)

    def arrow(self, tail, head, color, width: float, head_width: float,
              clip: Optional[Box] = None):
        """A shaft of ``width`` px from ``tail`` to a filled triangular head
        of ``head_width`` px (as long as it is wide) whose tip is ``head``."""
        (x0, y0), (x1, y1) = tail, head
        length = math.hypot(x1 - x0, y1 - y0)
        if not length > 0:
            return
        ux, uy = (x1 - x0) / length, (y1 - y0) / length
        head_len = min(head_width, length)
        bx, by = x1 - head_len * ux, y1 - head_len * uy
        self.polyline([x0, bx], [y0, by], color, width, clip=clip)
        hw = 0.5 * head_width
        self.polygon([x1, bx - hw * uy, bx + hw * uy], [y1, by + hw * ux, by - hw * ux], color,
                     clip=clip)
        self.discs([x1], [y1], 0.5, color, clip=clip)  # the tip's own pixel

    def text(self, x: float, y: float, s: str, scale: int, color="k", ha: str = "left",
             va: str = "top", vertical: bool = False):
        """``s`` in the bitmap font, anchored at (x, y) by ``ha`` (left,
        center, right) and ``va`` (top, center, bottom); ``vertical`` turns
        it 90 degrees anticlockwise (reads bottom to top)."""
        mask = text_mask(s, scale)
        if vertical:
            mask = np.rot90(mask)
        h, w = mask.shape
        left = x - {"left": 0.0, "center": 0.5 * w, "right": float(w)}[ha]
        top = y - {"top": 0.0, "center": 0.5 * h, "bottom": float(h)}[va]
        r, c = np.nonzero(mask)
        self.paint(r + int(round(top)), c + int(round(left)), color)

    def image(self, tr: Transform, img: np.ndarray, vmin: float, vmax: float):
        """A greyscale image under the axes of ``tr``: pixel (i, j) of
        ``img`` covers data [j - 0.5, j + 0.5] x [i - 0.5, i + 0.5]
        (matplotlib's ``imshow`` extent), its level mapped linearly from
        [vmin, vmax] to black..white; nearest neighbour."""
        b = tr.box
        rows = np.arange(max(math.ceil(b.y0), 0), min(math.floor(b.y1), self.height - 1) + 1)
        cols = np.arange(max(math.ceil(b.x0), 0), min(math.floor(b.x1), self.width - 1) + 1)
        gc, gr = np.meshgrid(cols, rows)
        x, y = tr.inverse(gc, gr)
        j, i = np.floor(x + 0.5).astype(np.int64), np.floor(y + 0.5).astype(np.int64)
        inside = (i >= 0) & (i < img.shape[0]) & (j >= 0) & (j < img.shape[1])
        level = img[i[inside], j[inside]].astype(np.float64)
        span = vmax - vmin if vmax > vmin else 1.0
        grey = np.round(np.clip((level - vmin) / span, 0.0, 1.0) * 255.0).astype(np.uint8)
        self.px[gr[inside], gc[inside]] = grey[:, None]


def ticks_of(tr: Transform) -> tuple:
    """(x ticks, y ticks) inside the limits of ``tr``."""
    xt = nice_ticks(*tr.xlim)
    yt = log_ticks(*tr.ylim) if tr.ylog else nice_ticks(*tr.ylim)
    return xt, yt


def draw_grid(canvas: Canvas, tr: Transform, dpi: float, alpha: float = 0.3):
    """Light grid lines at the ticks (matplotlib's grid colour and 0.8 pt
    width) across the axes box."""
    b = tr.box
    xt, yt = ticks_of(tr)
    width = 0.8 * dpi / 72.0
    for x in tr(xt, np.full_like(xt, np.nan))[0]:
        canvas.polyline([x, x], [b.y0, b.y1], GRID_RGB, width, alpha, clip=b)
    for y in tr(np.full_like(yt, np.nan), yt)[1]:
        canvas.polyline([b.x0, b.x1], [y, y], GRID_RGB, width, alpha, clip=b)


def draw_frame(canvas: Canvas, tr: Transform, dpi: float, points: float = 10.0):
    """The axes' spines, outward ticks and tick labels (left and bottom)."""
    b = tr.box
    width = 0.8 * dpi / 72.0
    canvas.polyline([b.x0, b.x1, b.x1, b.x0, b.x0], [b.y0, b.y0, b.y1, b.y1, b.y0], "k", width)
    tick = 3.5 * dpi / 72.0
    scale = font_scale(points, dpi)
    xt, yt = ticks_of(tr)
    for x, label in zip(tr(xt, np.full_like(xt, np.nan))[0], tick_labels(xt)):
        canvas.polyline([x, x], [b.y1, b.y1 + tick], "k", width)
        canvas.text(x, b.y1 + tick + 2 * scale, label, scale, ha="center", va="top")
    for y, label in zip(tr(np.full_like(yt, np.nan), yt)[1], tick_labels(yt, tr.ylog)):
        canvas.polyline([b.x0 - tick, b.x0], [y, y], "k", width)
        canvas.text(b.x0 - tick - 2 * scale, y, label, scale, ha="right", va="center")


def draw_labels(canvas: Canvas, tr: Transform, dpi: float, xlabel: str = "",
                ylabel: str = "", title: str = "", label_points: float = 10.0,
                title_points: float = 12.0, with_ticks: bool = True):
    """The x label under the tick labels, the y label (vertical) left of
    them, the title above the box."""
    b = tr.box
    s = font_scale(label_points, dpi)
    below = (3.5 * dpi / 72.0 + 2 * s + GLYPH_H * font_scale(10.0, dpi) + 4 * s
             if with_ticks else 2 * s)
    if xlabel:
        canvas.text(0.5 * (b.x0 + b.x1), b.y1 + below, xlabel, s, ha="center", va="top")
    if ylabel:
        _, yt = ticks_of(tr)
        widest = max((len(t) for t in tick_labels(yt, tr.ylog)), default=0) if with_ticks else 0
        left = (3.5 * dpi / 72.0 + (ADVANCE * widest + 4) * font_scale(10.0, dpi) + 2 * s
                if with_ticks else 2 * s)
        canvas.text(b.x0 - left, 0.5 * (b.y0 + b.y1), ylabel, s, ha="right", va="center",
                    vertical=True)
    if title:
        st = font_scale(title_points, dpi)
        canvas.text(0.5 * (b.x0 + b.x1), b.y0 - 3 * st, title, st, ha="center", va="bottom")


class LegendEntry(NamedTuple):
    label: str
    color: object
    kind: str = "line"  # "line" or "fill"
    width: float = 1.0  # px
    dash: Optional[tuple] = None  # px
    alpha: float = 1.0


def draw_legend(canvas: Canvas, tr: Transform, entries: Sequence[LegendEntry], dpi: float,
                points: float = 10.0, loc: str = "best", avoid=None):
    """A white box of entries (a sample of each series and its label)
    inside a corner of the axes box: ``loc`` "upper right" / "upper left" /
    "lower left" / "lower right", or "best", the corner whose box covers
    fewest of the pixel points ``avoid`` = (xs, ys) (ties: upper right
    first, as that order)."""
    if not entries:
        return
    b = tr.box
    s = font_scale(points, dpi)
    line_h = (GLYPH_H + 4) * s
    sample = 4 * ADVANCE * s
    w = 3 * s + sample + 2 * s + max(ADVANCE * len(e.label) for e in entries) * s + 3 * s
    h = len(entries) * line_h + 2 * s
    pad = 4 * s
    corners = {"upper right": (b.x1 - pad - w, b.y0 + pad), "upper left": (b.x0 + pad, b.y0 + pad),
               "lower left": (b.x0 + pad, b.y1 - pad - h),
               "lower right": (b.x1 - pad - w, b.y1 - pad - h)}
    if loc == "best":
        xs, ys = (np.zeros(0), np.zeros(0)) if avoid is None else avoid

        def covered(corner):
            x0, y0 = corners[corner]
            return int(np.sum((xs >= x0) & (xs <= x0 + w) & (ys >= y0) & (ys <= y0 + h)))

        loc = min(corners, key=covered)
    x0, y0 = corners[loc]
    canvas.rect(x0, y0, x0 + w, y0 + h, "w")  # opaque: each sample on white
    edge = 0.8 * dpi / 72.0
    canvas.polyline([x0, x0 + w, x0 + w, x0, x0], [y0, y0, y0 + h, y0 + h, y0], (0.8, 0.8, 0.8),
                    edge)
    for i, e in enumerate(entries):
        cy = y0 + s + (i + 0.5) * line_h
        sx = x0 + 3 * s
        if e.kind == "fill":
            canvas.rect(sx, cy - 0.35 * line_h, sx + sample, cy + 0.35 * line_h, e.color, e.alpha)
        else:
            canvas.polyline([sx, sx + sample], [cy, cy], e.color, e.width, e.alpha, e.dash)
        canvas.text(sx + sample + 2 * s, cy, e.label, s, va="center")

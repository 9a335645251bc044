"""The figures of the plot verbs, as data, and their rendering with numpy.

Counterpart of the matplotlib figures of the JAX CLI's ``plot-trajectories``,
``plot-trackhist``, ``timing-flamegraph``, ``watch-run`` and
``error-simulation --plot``. Each figure function is a pure function from the
verb's inputs to a ``Figure``: the series in data coordinates exactly as
the JAX verb hands them to matplotlib (a ``Line`` for each ``plot``, a
``Fill`` polygon for each band of a ``stackplot``, an ``Arrow`` for each
``annotate``, an ``HLine`` for ``axhline``, the image of ``imshow``), the
colours as matplotlib's cycle assigns them, and each axes' scale, explicit
limits, labels, title and legend. ``render`` draws a figure with
``eval/raster`` as an (H, W, 3) uint8 image of figsize x dpi pixels.

The pixels are not matplotlib's: the font, the absence of antialiasing,
the tick placement, the axes' layout and the legend's position are the
port's own, and the canvas is not cropped to its content (no
``bbox_inches="tight"``). Autoscaled limits follow matplotlib (5 %
margins, ``axis("equal")`` by widening the data limits).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cuahn_vio_torch.eval import raster

# matplotlib's subplot parameters (left, right, bottom, top, wspace, hspace)
SUBPLOT = (0.125, 0.9, 0.11, 0.88, 0.2, 0.2)
CHI2_MEDIAN_8DOF = 7.3441  # plot-trackhist's reference line


@dataclass
class Line:
    """One ``ax.plot``: a polyline and/or markers at (x, y)."""

    x: np.ndarray
    y: np.ndarray
    color: object
    width: float = 1.5  # points
    style: str = "-"  # "-", "--", or "" (markers only)
    marker: str = ""  # "o": a filled circle at each point
    marker_size: float = 6.0  # points
    alpha: float = 1.0
    label: Optional[str] = None


@dataclass
class Fill:
    """One band of a ``stackplot``: its polygon, as ``fill_between`` builds
    it (the first point of the upper curve, the lower curve forward, the
    last point of the upper curve, the upper curve backward)."""

    x: np.ndarray
    y: np.ndarray
    color: object
    alpha: float = 1.0
    label: Optional[str] = None


@dataclass
class Arrow:
    """One ``annotate`` arrow from ``tail`` (xytext) to ``head`` (xy)."""

    tail: tuple
    head: tuple
    color: object
    width: float  # points
    head_width: float  # points


@dataclass
class HLine:
    """``axhline``: a horizontal line across the axes at ``y``."""

    y: float
    color: object
    style: str = "-"
    width: float = 1.5  # points
    label: Optional[str] = None


@dataclass
class Axes:
    box: tuple  # (left, bottom, width, height), figure fractions
    lines: list = field(default_factory=list)
    fills: list = field(default_factory=list)
    arrows: list = field(default_factory=list)
    hlines: list = field(default_factory=list)
    image: Optional[np.ndarray] = None  # (H, W) greyscale, levels from its min to its max
    xlim: Optional[tuple] = None  # explicit (left, right)
    ylim: Optional[tuple] = None  # explicit (bottom, top)
    yscale: str = "linear"  # or "log"
    equal: bool = False  # axis("equal")
    grid: bool = False  # grid(True, alpha=0.3)
    axis_off: bool = False
    xlabel: str = ""
    ylabel: str = ""
    title: str = ""
    label_size: float = 10.0  # points
    title_size: float = 12.0
    legend: Optional[str] = None  # its loc ("best", "upper right"), None: no legend
    legend_size: float = 10.0


@dataclass
class Figure:
    size: tuple  # inches (width, height)
    dpi: float
    axes: list

    @property
    def pixels(self) -> tuple:
        """(width, height) of the canvas."""
        return int(round(self.size[0] * self.dpi)), int(round(self.size[1] * self.dpi))


def grid_boxes(nrows: int, ncols: int, params=SUBPLOT, height_ratios=None) -> list:
    """The (left, bottom, width, height) of each cell of an nrows x ncols
    subplot grid, row by row, as matplotlib's ``subplots`` places them."""
    left, right, bottom, top, wspace, hspace = params
    ratios = np.ones(nrows) if height_ratios is None else np.asarray(height_ratios, float)
    cell_w = (right - left) / (ncols + wspace * (ncols - 1))
    unit_h = (top - bottom) / (ratios.sum() + hspace * ratios.mean() * (nrows - 1))
    boxes = []
    y = top
    for r in range(nrows):
        h = unit_h * ratios[r]
        for c in range(ncols):
            boxes.append((left + c * cell_w * (1 + wspace), y - h, cell_w, h))
        y -= h + hspace * ratios.mean() * unit_h
    return boxes


class _Cycle:
    """An axes' colour cycle: "C0", "C1", ... in turn."""

    def __init__(self):
        self.n = 0

    def __call__(self) -> str:
        self.n += 1
        return f"C{(self.n - 1) % 10}"


def trajectories(files: list) -> Figure:
    """``plot-trajectories``: the xy of each pose file, labelled by its
    base name, equal axes."""
    from cuahn_vio_torch.eval.traj_io import load_pose_file

    ax = Axes(box=grid_boxes(1, 1)[0], xlabel="x (m)", ylabel="y (m)", equal=True, grid=True,
              legend="best")
    cycle = _Cycle()
    for path in files:
        t = load_pose_file(path)
        ax.lines.append(Line(t.poses[:, 0], t.poses[:, 1], cycle(),
                             label=os.path.basename(path)))
    return Figure((8, 8), 130, [ax])


def trackhist(frames: np.ndarray, log, frame: Optional[int] = None,
              history: int = 45) -> Figure:
    """``plot-trackhist``: the last ``history`` frames' corner-flow vectors
    of a ``run-vio --state-out`` log (``net_mean``) at the four corners of
    the frame they end on, oldest darkest, the state-log row ``frame``'s
    (default: the last) as red arrows; under it the innovation chi2
    (``net_chi2``, when logged) on a log scale with the 8-DoF median."""
    flows = log["net_mean"]  # (F, 8) px, corner order UL BL BR UR
    chi2 = log["net_chi2"] if "net_chi2" in log else None
    # state-log row f is the frame pair (f, f + 1), offset by the frames
    # that initialization consumed
    off = len(frames) - len(flows)
    f = frame if frame is not None else len(flows) - 1
    f = int(np.clip(f, 0, len(flows) - 1))
    lo = max(0, f - history)
    img = frames[min(f + off, len(frames) - 1)]
    h, w = img.shape
    anchors = np.array([[0, 0], [0, h - 1], [w - 1, h - 1], [w - 1, 0]], np.float32)
    top_box, chi2_box = grid_boxes(2, 1, (0.1, 0.97, 0.07, 0.95, 0.2, 0.15), [4, 1])
    ax = Axes(box=top_box, image=img, xlim=(-30, w + 29), ylim=(h + 29, -30), axis_off=True,
              title=f"corner-flow track history, frames {lo}..{f} (red = frame {f})",
              title_size=9)
    for k in range(4):
        base = anchors[k]
        hist = flows[lo:f + 1, 2 * k:2 * k + 2]
        for i, v in enumerate(hist[:-1]):
            ax.lines.append(Line(np.array([base[0], base[0] + v[0]]),
                                 np.array([base[1], base[1] + v[1]]),
                                 raster.ramp(i / max(1, len(hist) - 1)), width=0.8, alpha=0.6))
        v = hist[-1]
        ax.arrows.append(Arrow((base[0], base[1]), (base[0] + v[0], base[1] + v[1]), "red",
                               width=1.2, head_width=5.0))
    axc = Axes(box=chi2_box)
    if chi2 is not None:
        axc.lines.append(Line(np.arange(lo, f + 1), chi2[lo:f + 1], "C0", width=1.0))
        axc.hlines.append(HLine(CHI2_MEDIAN_8DOF, "g", "--", 0.8, "8-DoF median"))
        axc.yscale, axc.xlabel, axc.ylabel, axc.label_size = "log", "frame", "innovation chi2", 8
        axc.legend, axc.legend_size, axc.grid = "best", 7, True
    return Figure((7, 6.4), 130, [ax, axc])


STAGES = ("load_img", "propagation", "network", "ekf_update")


def flamegraph(timing_file: str) -> Figure:
    """``timing-flamegraph``: the four stages of a timing csv as stacked
    bands against time from its first frame, the total as a black line."""
    from cuahn_vio_torch.eval.traj_io import load_timing_file

    t, stages = load_timing_file(timing_file)
    t = t - t[0]
    ax = Axes(box=grid_boxes(1, 1)[0], xlabel="time (s)", ylabel="ms / frame", grid=True,
              legend="upper right", legend_size=8)
    cycle = _Cycle()
    below = np.zeros_like(t)
    for i, name in enumerate(STAGES):
        above = below + stages[:, i]
        x = np.concatenate([[t[0]], t, [t[-1]], t[::-1]])
        y = np.concatenate([[above[0]], below, [above[-1]], above[::-1]])
        ax.fills.append(Fill(x, y, cycle(), alpha=0.85, label=name))
        below = above
    ax.lines.append(Line(t, stages[:, 4], "k", width=0.6, label="total"))
    return Figure((10, 4), 130, [ax])


def watch(est, gt=None, method: str = "posyaw") -> Figure:
    """``watch-run``'s figure of an estimate so far (a ``Trajectory``):
    its xy and last position, and with ``gt`` (3 or more associated poses)
    the GT aligned onto it (``eval/align``, ``method``) and the position
    RMSE so far as the title."""
    from cuahn_vio_torch.eval.align import align_trajectory, associate_indices

    n = len(est.times)
    ax = Axes(box=grid_boxes(1, 1)[0], equal=True, grid=True, legend="best", legend_size=8)
    ax.lines.append(Line(est.poses[:, 0], est.poses[:, 1], "b", width=1.2,
                         label=f"estimate ({n} poses)"))
    ax.lines.append(Line(est.poses[-1:, 0], est.poses[-1:, 1], "b", style="", marker="o",
                         marker_size=6))
    if gt is not None:
        ie, ig = associate_indices(est.times, gt.times)
        if len(ie) >= 3:
            r, t, sc = align_trajectory(gt.poses[ig], est.poses[ie], method=method)
            gta = sc * (r @ gt.poses[:, :3].T).T + t
            ax.lines.append(Line(gta[:, 0], gta[:, 1], "k", width=0.8, style="--",
                                 label="ground truth (aligned)"))
            err = np.linalg.norm(gta[ig] - est.poses[ie, :3], axis=1)
            ax.title = f"pos rmse so far: {np.sqrt(np.mean(err ** 2)):.3f} m"
    return Figure((7, 7), 110, [ax])


def simulation_errors(sim) -> Figure:
    """``error-simulation --plot``: for each error series of a
    ``ResultSimulation`` that exists (position, orientation, velocity and
    the two biases), one row of three axes, x / y / z against time from
    the first match, with the +-3 sigma bounds when covariances were
    logged."""
    blocks = [("position (m)", sim.error_position()),
              ("orientation (rad)", sim.error_orientation()),
              ("velocity (m/s)", sim.error_velocity()),
              ("accel bias", sim.error_bias_accel()),
              ("gyro bias", sim.error_bias_gyro())]
    blocks = [(n, e) for n, e in blocks if e is not None]
    boxes = grid_boxes(len(blocks), 3)
    axes = []
    for bi, (name, es) in enumerate(blocks):
        t = es.times - es.times[0]
        for i in range(3):
            ax = Axes(box=boxes[3 * bi + i], grid=True, label_size=8,
                      ylabel=name if i == 0 else "")
            ax.lines.append(Line(t, es.err[:, i], "C0", width=0.7))
            if es.bound3 is not None:
                ax.lines.append(Line(t, es.bound3[:, i], "r", width=0.6, style="--"))
                ax.lines.append(Line(t, -es.bound3[:, i], "r", width=0.6, style="--"))
            axes.append(ax)
    return Figure((12, 2.2 * len(blocks)), 130, axes)


def pixel_box(ax: Axes, fig: Figure) -> raster.Box:
    """The axes' box on the canvas."""
    w, h = fig.pixels
    left, bottom, bw, bh = ax.box
    return raster.Box(left * w, (1 - bottom - bh) * h, (left + bw) * w, (1 - bottom) * h)


def transform(ax: Axes, fig: Figure) -> raster.Transform:
    """The axes' data -> pixel transform: explicit limits where set, else
    autoscaled over every series (``raster.autoscale``; on a log scale over
    the positive values), then widened to equal aspect for ``equal``; an
    axes with an image keeps its pixels square by shrinking its box."""
    box = pixel_box(ax, fig)
    log = ax.yscale == "log"
    xs = [a.x for a in ax.lines] + [a.x for a in ax.fills]
    ys = ([a.y for a in ax.lines] + [a.y for a in ax.fills]
          + [np.array([a.y]) for a in ax.hlines])
    xs += [np.array([a.tail[0], a.head[0]]) for a in ax.arrows]
    ys += [np.array([a.tail[1], a.head[1]]) for a in ax.arrows]
    if ax.image is not None:
        xs.append(np.array([-0.5, ax.image.shape[1] - 0.5]))
        ys.append(np.array([ax.image.shape[0] - 0.5, -0.5]))
    xlim = ax.xlim if ax.xlim is not None else raster.autoscale(xs)
    ylim = ax.ylim if ax.ylim is not None else raster.autoscale(ys, log=log)
    if ax.equal:
        xlim, ylim = raster.equal_aspect(xlim, ylim, box)
    if ax.image is not None:  # square image pixels
        box = raster.fit_box(box, xlim, ylim)
    return raster.Transform(box, tuple(xlim), tuple(ylim), log)


def _dash(style: str, width_px: float):
    return tuple(d * width_px for d in raster.DASH) if style == "--" else None


def render(fig: Figure) -> np.ndarray:
    """The figure as an (H, W, 3) uint8 RGB image, figsize x dpi pixels:
    per axes the image, the fills, the grid, the lines, markers and
    reference lines, the arrows, then the frame, labels, title and legend
    (matplotlib's drawing order)."""
    canvas = raster.Canvas(*fig.pixels)
    px = fig.dpi / 72.0
    for ax in fig.axes:
        tr = transform(ax, fig)
        box = tr.box
        if ax.image is not None:
            canvas.image(tr, ax.image, float(ax.image.min()), float(ax.image.max()))
        entries, avoid_x, avoid_y = [], [], []
        for fill in ax.fills:
            x, y = tr(fill.x, fill.y)
            canvas.polygon(x, y, fill.color, fill.alpha, clip=box)
            if fill.label:
                entries.append(raster.LegendEntry(fill.label, fill.color, "fill",
                                                  alpha=fill.alpha))
            avoid_x.append(x)
            avoid_y.append(y)
        if ax.grid:
            raster.draw_grid(canvas, tr, fig.dpi)
        for line in ax.lines:
            x, y = tr(line.x, line.y)
            width = line.width * px
            if line.style:
                canvas.polyline(x, y, line.color, width, line.alpha, _dash(line.style, width),
                                clip=box)
            if line.marker:
                canvas.discs(x, y, 0.5 * line.marker_size * px, line.color, line.alpha, clip=box)
            if line.label:
                entries.append(raster.LegendEntry(line.label, line.color, "line", width,
                                                  _dash(line.style, width), line.alpha))
            avoid_x.append(x)
            avoid_y.append(y)
        for hl in ax.hlines:
            _, y = tr(np.nan, hl.y)
            width = hl.width * px
            canvas.polyline([box.x0, box.x1], [y, y], hl.color, width,
                            dash=_dash(hl.style, width), clip=box)
            if hl.label:
                entries.append(raster.LegendEntry(hl.label, hl.color, "line", width,
                                                  _dash(hl.style, width)))
        for arrow in ax.arrows:
            tail, head = tr(*arrow.tail), tr(*arrow.head)
            canvas.arrow(tail, head, arrow.color, arrow.width * px, arrow.head_width * px)
        if not ax.axis_off:
            raster.draw_frame(canvas, tr, fig.dpi)
        raster.draw_labels(canvas, tr, fig.dpi, ax.xlabel, ax.ylabel, ax.title, ax.label_size,
                           ax.title_size, with_ticks=not ax.axis_off)
        if ax.legend is not None:
            avoid = (np.concatenate(avoid_x), np.concatenate(avoid_y)) if avoid_x else None
            raster.draw_legend(canvas, tr, entries, fig.dpi, ax.legend_size, ax.legend, avoid)
    return canvas.px


def series_colours(fig: Figure) -> list:
    """(what, uint8 RGB) of each series that is drawn opaque or on the white
    ground, as it appears in ``render``'s image: the lines and reference
    lines at alpha 1 and the arrows in their colour, the fills blended over
    white. The track history's translucent lines are left out: they blend
    with the frame under them."""
    out = []
    for ax in fig.axes:
        for fill in ax.fills:
            out.append((fill.label or "fill", raster.rgb_u8(fill.color, fill.alpha)))
        for line in ax.lines:
            if line.alpha >= 1.0:
                out.append((line.label or "line", raster.rgb_u8(line.color)))
        for hl in ax.hlines:
            out.append((hl.label or "hline", raster.rgb_u8(hl.color)))
        for arrow in ax.arrows:
            out.append(("arrow", raster.rgb_u8(arrow.color)))
    return out

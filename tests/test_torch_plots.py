"""The port's plot verbs against the JAX verbs' matplotlib figures.

Each JAX verb (``plot-trajectories``, ``plot-trackhist``,
``timing-flamegraph``, ``watch-run``, ``error-simulation --plot``) runs on
the CPU with ``matplotlib.figure.Figure.savefig`` patched to keep the
figure instead of writing it, so the JAX package is untouched. Its axes
are held to the port's figure spec (``eval/plots``) on the same files,
made from a numpy seed: every ``Line2D``'s xy data (the ``axhline`` at
7.3441 too), the stackplot polygons, the annotate arrows' ends, the
imshow array, the y scale, explicit limits, and the label, title and
legend texts. Tolerance 1e-9 (both sides float64 numpy; the track
history's float32 sums are equal exactly). The port's verbs print the JAX
verbs' lines and write RGB PNGs of figsize x dpi pixels that the port's
PNG reader and PIL decode.

The rasteriser (``eval/raster``): a line's end points light the pixels
the data -> pixel transform gives, log and equal-aspect limits are as
specified, and the RGB PNG writer round-trips through PIL and the port's
reader while the greyscale bytes stay as they were.
"""

import os
import struct
import zlib

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")  # the JAX verbs draw with it
matplotlib.use("Agg")
import matplotlib.figure  # noqa: E402

from cuahn_vio.cli import main as jax_main  # noqa: E402
from cuahn_vio_torch import cli as tcli  # noqa: E402
from cuahn_vio_torch.eval import plots, raster  # noqa: E402
from cuahn_vio_torch.eval.simulation import (  # noqa: E402
    ResultSimulation,
    StateGT,
    load_state_gt,
    save_state_gt,
)
from cuahn_vio_torch.eval.traj_io import (  # noqa: E402
    load_pose_file,
    save_pose_file,
    save_timing_file,
)
from cuahn_vio_torch.utils.png import encode_png, read_png, write_png  # noqa: E402

TOL = 1e-9


@pytest.fixture
def captured(monkeypatch):
    """The figures the JAX verbs save, kept instead of written."""
    figs = []
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, *args, **kwargs: figs.append(self))
    yield figs
    import matplotlib.pyplot as plt

    plt.close("all")


@pytest.fixture
def files(tmp_path):
    """A GT flight and a drifting estimate (pose txt), a longer second
    estimate, a timing csv, a sequence's frames and a run-vio state log
    (``net_mean``, ``net_chi2``), a sim state GT and an estimate npz."""
    rng = np.random.default_rng(3)
    t = 100.0 + np.arange(240) * 0.05
    th = (t - t[0]) / 3.0
    gt = np.stack([np.cos(th), 0.5 * np.sin(2 * th), 1.5 + 0.1 * np.sin(th), 0 * th, 0 * th,
                   np.sin(th / 2), np.cos(th / 2)], 1)
    est = gt.copy()
    est[:, :3] += np.cumsum(rng.normal(0, 0.004, (240, 3)), 0)
    est[:, 3:] += rng.normal(0, 1e-3, (240, 4))
    est[:, 3:] /= np.linalg.norm(est[:, 3:], axis=1, keepdims=True)
    out = {}
    for name, times, poses in (("gt.txt", t, gt), ("est_a.txt", t[10:200], est[10:200]),
                               ("est_b.txt", t[5:], est[5:] + 0.02)):
        out[name] = str(tmp_path / name)
        save_pose_file(out[name], times, poses)
    stages = np.abs(rng.normal([0.2, 30, 7, 3, 0], [0.05, 5, 1, 0.5, 0], (90, 5)))
    stages[:, 4] = stages[:, :4].sum(1) + rng.uniform(0, 1, 90)
    out["t.csv"] = str(tmp_path / "t.csv")
    save_timing_file(out["t.csv"], 1000 + np.arange(90) / 30.0, stages)
    frames = rng.integers(0, 256, (40, 56, 80)).astype(np.uint8)
    out["seq.npz"] = str(tmp_path / "seq.npz")
    np.savez(out["seq.npz"], frames=frames)
    net_mean = rng.normal(0, 6, (37, 8)).astype(np.float32)
    out["state.npz"] = str(tmp_path / "state.npz")
    np.savez(out["state.npz"], net_mean=net_mean, net_chi2=np.exp(rng.normal(2, 1, 37)))
    out["state_nochi2.npz"] = str(tmp_path / "state_nochi2.npz")
    np.savez(out["state_nochi2.npz"], net_mean=net_mean)
    ts = np.arange(400) * 0.01
    pose = np.column_stack([np.sin(ts), ts, 1.5 + 0 * ts, 0.01 * np.sin(ts), 0 * ts, 0 * ts,
                            np.sqrt(1 - (0.01 * np.sin(ts)) ** 2)])
    z = np.zeros((400, 3))
    out["sim_gt.txt"] = str(tmp_path / "sim_gt.txt")
    save_state_gt(out["sim_gt.txt"], StateGT(times=ts, pose=pose, vel=z + 0.1, bg=z, ba=z))
    k = np.arange(10, 400, 4)
    cov = np.tile(np.diag(np.linspace(1e-4, 3e-4, 15)), (len(k), 1, 1))
    noisy = pose[k].copy()
    noisy[:, :3] += rng.normal(0, 0.01, (len(k), 3))
    sim = dict(times=ts[k], pose=noisy, v_body=rng.normal(0.1, 0.01, (len(k), 3)),
               ba=rng.normal(0, 1e-3, (len(k), 3)), bg=rng.normal(0, 1e-4, (len(k), 3)),
               cov_core=cov, cov_diag=np.einsum("fii->fi", cov))
    for name, keys in (("sim.npz", sim.keys()), ("sim_min.npz", ("times", "pose"))):
        out[name] = str(tmp_path / name)
        np.savez(out[name], **{key: sim[key] for key in keys})
    return out


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def _legend(ax):
    leg = ax.get_legend()
    return None if leg is None else [t.get_text() for t in leg.get_texts()]


def _port_legend(ax: plots.Axes):
    if ax.legend is None:
        return None
    return [a.label for a in ax.fills + ax.lines + ax.hlines if a.label]


def _same_axes(ref, ax: plots.Axes):
    """Titles, labels, legend, scale and each Line2D of ``ref`` in the order
    drawn: the spec's lines, then its reference lines."""
    assert ref.get_title() == ax.title
    assert ref.get_xlabel() == ax.xlabel and ref.get_ylabel() == ax.ylabel
    assert ref.get_yscale() == ax.yscale
    assert _legend(ref) == _port_legend(ax)
    ref_lines = list(ref.lines)
    assert len(ref_lines) == len(ax.lines) + len(ax.hlines)
    for got, want in zip(ax.lines, ref_lines):
        _close(got.x, want.get_xdata())
        _close(got.y, want.get_ydata())
        assert (got.label or None) == (None if want.get_label().startswith("_")
                                       else want.get_label())
    for got, want in zip(ax.hlines, ref_lines[len(ax.lines):]):
        _close([0.0, 1.0], want.get_xdata())  # axes coordinates: across the box
        _close([got.y, got.y], want.get_ydata())
        assert got.label == want.get_label()


def _said(main, argv, capsys) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _png(path, fig: plots.Figure):
    """The PNG at ``path`` is RGB of the figure's pixels; returns its pixels."""
    from PIL import Image

    with open(path, "rb") as f:
        head = f.read(26)
    assert struct.unpack(">II", head[16:24]) == fig.pixels and head[25] == 2
    rgb = np.asarray(Image.open(path).convert("RGB"))
    assert rgb.shape == (fig.pixels[1], fig.pixels[0], 3)
    np.testing.assert_array_equal(read_png(path, rgb=True), rgb)
    return rgb


def _colours_present(rgb: np.ndarray, fig: plots.Figure):
    have = {tuple(p) for p in np.unique(rgb.reshape(-1, 3), axis=0)}
    for what, colour in plots.series_colours(fig):
        assert colour in have, what


def test_trajectories_match_the_jax_figure(files, captured, capsys, tmp_path):
    paths = [files["gt.txt"], files["est_a.txt"], files["est_b.txt"]]
    jax_out, out = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    said = _said(jax_main, ["plot-trajectories", *paths, "--out", jax_out], capsys)
    (ref,) = captured
    fig = plots.trajectories(paths)
    assert len(ref.axes) == len(fig.axes) == 1
    _same_axes(ref.axes[0], fig.axes[0])
    assert [line.color for line in fig.axes[0].lines] == ["C0", "C1", "C2"]
    assert _said(tcli.main, ["plot-trajectories", *paths, "--out", out], capsys) == \
        said.replace(jax_out, out)
    _colours_present(_png(out, fig), fig)


@pytest.mark.parametrize("state,extra", [("state.npz", []),
                                         ("state.npz", ["--frame", "5", "--history", "3"]),
                                         ("state_nochi2.npz", ["--frame", "100"])],
                         ids=["default", "frame 5 history 3", "no chi2, frame clipped"])
def test_trackhist_matches_the_jax_figure(files, captured, capsys, tmp_path, state, extra):
    argv = ["plot-trackhist", files["seq.npz"], files[state], *extra]
    jax_out, out = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    said = _said(jax_main, [*argv, "--out", jax_out], capsys)
    (ref,) = captured
    args = tcli.build_parser().parse_args([*argv, "--out", out])
    fig = plots.trackhist(np.load(files["seq.npz"])["frames"], np.load(files[state]),
                          args.frame, args.history)
    top, chi2 = fig.axes
    assert len(ref.axes) == 2
    _same_axes(ref.axes[0], top)
    assert all(line.width == 0.8 and line.alpha == 0.6 for line in top.lines)
    np.testing.assert_array_equal(ref.axes[0].images[0].get_array(), top.image)
    _close(ref.axes[0].get_xlim(), top.xlim)
    _close(ref.axes[0].get_ylim(), top.ylim)
    arrows = list(ref.axes[0].texts)
    assert len(arrows) == len(top.arrows) == 4
    for got, want in zip(top.arrows, arrows):
        _close(got.head, want.xy)
        _close(got.tail, want.xyann)
    _same_axes(ref.axes[1], chi2)
    if state == "state.npz":
        assert chi2.hlines[0].y == 7.3441 and chi2.yscale == "log"
    assert _said(tcli.main, [*argv, "--out", out], capsys) == said.replace(jax_out, out)
    _colours_present(_png(out, fig), fig)


def test_trackhist_refuses_a_log_without_net_mean(files, tmp_path):
    np.savez(tmp_path / "bare.npz", pose=np.zeros((3, 7)))
    with pytest.raises(SystemExit, match="no net_mean"):
        tcli.main(["plot-trackhist", files["seq.npz"], str(tmp_path / "bare.npz"), "--out",
                   str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_flamegraph_matches_the_jax_figure(files, captured, capsys, tmp_path):
    jax_out, out = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    said = _said(jax_main, ["timing-flamegraph", files["t.csv"], "--out", jax_out], capsys)
    (ref,) = captured
    fig = plots.flamegraph(files["t.csv"])
    (ax,) = fig.axes
    _same_axes(ref.axes[0], ax)
    polys = list(ref.axes[0].collections)
    assert len(polys) == len(ax.fills) == 4
    for got, want in zip(ax.fills, polys):
        verts = want.get_paths()[0].vertices
        _close(np.stack([got.x, got.y], 1), verts[:len(got.x)])
        _close(verts[-1], verts[0])  # the rest is the closing vertex
        assert len(verts) == len(got.x) + 1
        assert want.get_alpha() == got.alpha == 0.85
    assert _legend(ref.axes[0]) == ["load_img", "propagation", "network", "ekf_update", "total"]
    assert _said(tcli.main, ["timing-flamegraph", files["t.csv"], "--out", out], capsys) == \
        said.replace(jax_out, out)
    _colours_present(_png(out, fig), fig)


@pytest.mark.parametrize("extra,gt", [(["--max-ticks", "1"], True),
                                      (["--stale-ticks", "1", "--interval", "0"], True),
                                      (["--max-ticks", "1", "--method", "se3"], True),
                                      (["--max-ticks", "1"], False)],
                         ids=["max ticks", "stale", "se3", "no gt"])
def test_watch_run_matches_the_jax_figure(files, captured, capsys, tmp_path, extra, gt):
    """One refresh (the estimate does not grow): the same printed lines as
    the JAX verb (the exit on a stale estimate too) and the same figure,
    the rmse title included."""
    gt_flags = ["--gt", files["gt.txt"]] if gt else []
    argv = ["watch-run", files["est_a.txt"], *gt_flags, *extra]
    jax_out, out = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    said = _said(jax_main, [*argv, "--out", jax_out], capsys)
    (ref,) = captured
    args = tcli.build_parser().parse_args([*argv, "--out", out])
    fig = plots.watch(load_pose_file(files["est_a.txt"]),
                      load_pose_file(files["gt.txt"]) if gt else None, args.method)
    (ax,) = fig.axes
    _same_axes(ref.axes[0], ax)
    assert ax.title.startswith("pos rmse so far: ") == gt
    assert ax.lines[1].marker == "o" and not ax.lines[1].style
    ours = _said(tcli.main, [*argv, "--out", out], capsys)
    assert ours == said.replace(jax_out, out)
    assert ours.startswith("[watch-run] 190 poses -> ")
    assert ("stopped growing" in ours) == ("--stale-ticks" in extra)
    _colours_present(_png(out, fig), fig)


def test_watch_run_waits_for_a_file(tmp_path, capsys):
    """No estimate yet: nothing drawn, as the JAX verb."""
    argv = ["watch-run", str(tmp_path / "none.txt"), "--stale-ticks", "2", "--interval", "0",
            "--out", str(tmp_path / "w.png")]
    assert _said(tcli.main, argv, capsys) == _said(jax_main, argv, capsys)
    assert not (tmp_path / "w.png").exists()


@pytest.mark.parametrize("state", ["sim.npz", "sim_min.npz"])
def test_simulation_errors_match_the_jax_figure(files, captured, capsys, tmp_path, state):
    argv = ["error-simulation", files[state], files["sim_gt.txt"]]
    jax_out, out = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    said = _said(jax_main, [*argv, "--plot", jax_out], capsys)
    (ref,) = captured
    d = np.load(files[state])
    sim = ResultSimulation(d["times"], d["pose"], load_state_gt(files["sim_gt.txt"]),
                           est_v_body=d.get("v_body"), est_ba=d.get("ba"), est_bg=d.get("bg"),
                           est_cov_diag=d.get("cov_diag"), est_cov_core=d.get("cov_core"))
    fig = plots.simulation_errors(sim)
    rows = 5 if state == "sim.npz" else 2
    assert len(ref.axes) == len(fig.axes) == 3 * rows
    assert fig.size == (12, 2.2 * rows)
    for want, got in zip(ref.axes, fig.axes):
        _same_axes(want, got)
        assert len(got.lines) == (3 if state == "sim.npz" else 1)
    assert _said(tcli.main, [*argv, "--plot", out], capsys) == said.replace(jax_out, out)
    _colours_present(_png(out, fig), fig)


def test_a_lines_end_points_light_the_pixels_the_transform_gives():
    canvas = raster.Canvas(120, 90)
    tr = raster.Transform(raster.Box(10.0, 5.0, 110.0, 85.0), (-1.0, 3.0), (0.0, 2.0))
    xs, ys = np.array([-0.5, 1.0, 2.7]), np.array([0.3, 1.9, 0.1])
    px, py = tr(xs, ys)
    canvas.polyline(px, py, "C3", 1.0)
    red = np.array(raster.rgb_u8("C3"))
    for x, y in zip(px, py):
        assert (canvas.px[int(round(y)), int(round(x))] == red).all()
    _close(tr(np.array([-1.0, 3.0]), np.array([0.0, 2.0])), [[10.0, 110.0], [85.0, 5.0]])
    _close(tr.inverse(*tr(xs, ys)), [xs, ys])
    lit = (canvas.px == red).all(axis=2)
    assert lit.sum() < 3 * (np.hypot(np.diff(px), np.diff(py)).sum() + 3)  # a thin line
    assert not lit[:, :5].any()


def test_dashes_and_fills_and_arrows():
    canvas = raster.Canvas(100, 40)
    canvas.polyline([5.0, 95.0], [10.0, 10.0], "k", 2.0, dash=(6.0, 4.0))
    row = (canvas.px[10] == 0).all(axis=1)
    runs = np.diff(np.flatnonzero(np.diff(np.concatenate([[0], row.astype(int), [0]]))))[::2]
    # 90 px at a period of 10: 9 dashes of 6 px (+1 px of round cap on the
    # first), and the dash that starts at the last point
    assert len(runs) == 10 and all(6 <= r <= 7 for r in runs[:-1]) and runs[-1] <= 2
    canvas.polygon([10.0, 40.0, 40.0, 10.0], [20.0, 20.0, 30.0, 30.0], "C1", alpha=0.5)
    assert (canvas.px[25, 20] == raster.rgb_u8("C1", 0.5)).all()
    assert (canvas.px[25, 45] == 255).all()
    canvas.arrow((60.0, 30.0), (90.0, 30.0), "red", 1.0, 6.0)
    assert (canvas.px[30, 90] == (255, 0, 0)).all() and (canvas.px[31, 86] == (255, 0, 0)).all()


def test_log_and_equal_aspect_limits():
    lo, hi = raster.autoscale([np.array([1.0, 100.0, -5.0, 0.0])], log=True)
    _close([np.log10(lo), np.log10(hi)], [-0.1, 2.1])
    assert raster.autoscale([np.array([2.0, 4.0])]) == pytest.approx((1.9, 4.1))
    box = raster.Box(0.0, 0.0, 200.0, 100.0)
    xlim, ylim = raster.equal_aspect((0.0, 10.0), (0.0, 1.0), box)
    assert xlim == (0.0, 10.0) and ylim == pytest.approx((-2.0, 3.0))
    xlim, ylim = raster.equal_aspect((0.0, 1.0), (0.0, 10.0), box)
    assert ylim == (0.0, 10.0) and xlim == pytest.approx((-9.5, 10.5))
    tr = raster.Transform(box, xlim, ylim)
    (x0, x1), (y0, y1) = tr(np.array([0.0, 1.0]), np.array([0.0, 1.0]))
    assert x1 - x0 == pytest.approx(y0 - y1)  # one unit, as many pixels both ways
    tr = raster.Transform(box, (0.0, 1.0), (0.1, 1000.0), ylog=True)
    _close(tr(np.array([0.0, 0.0]), np.array([0.1, 1.0]))[1], [100.0, 75.0])
    _close(raster.log_ticks(0.1, 1000.0), [0.1, 1.0, 10.0, 100.0, 1000.0])
    assert raster.tick_labels(raster.nice_ticks(-1.05, 1.05)) == ["-1.0", "-0.5", "0.0", "0.5",
                                                                 "1.0"]


def test_rgb_png_round_trips_and_greyscale_bytes_stay(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (31, 47, 3)).astype(np.uint8)
    path = str(tmp_path / "c.png")
    write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path, rgb=True), img)
    Image.fromarray(img).save(tmp_path / "pil.png")  # PIL's own row filters
    np.testing.assert_array_equal(read_png(str(tmp_path / "pil.png"), rgb=True), img)
    Image.fromarray(img[..., 0]).save(tmp_path / "pil_grey.png")
    np.testing.assert_array_equal(read_png(str(tmp_path / "pil_grey.png"), rgb=True),
                                  np.repeat(img[..., :1], 3, axis=2))
    np.testing.assert_array_equal(read_png(path),
                                  np.asarray(Image.fromarray(img).convert("L")))
    grey = img[..., 0]
    raw = np.concatenate([np.zeros((31, 1), np.uint8), grey], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    want = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 47, 31, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    assert encode_png(grey) == want
    with pytest.raises(ValueError, match=r"\(H, W\) or \(H, W, 3\) uint8"):
        encode_png(img[..., :2])
    assert os.path.getsize(path) > 0

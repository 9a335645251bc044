"""The port's eval verbs against the JAX CLI's on the same files.

``error-singlerun`` (every alignment), ``timing-percentages`` and
``error-simulation`` must print exactly the JAX verbs' lines; the readers
behind them (``load_pose_file``, ``load_timing_file``, ``load_state_gt``,
``associate``) must return the JAX readers' arrays. The files are made
from a numpy seed: a smooth 10 s GT flight, an estimate with drift, noise,
a time offset and full pose covariances, a timing csv, a 17-column sim GT
and a ``run-vio --state-out`` style npz.
"""

import numpy as np
import pytest

from cuahn_vio.cli import main as jax_main
from cuahn_vio.eval.align import associate as jax_associate
from cuahn_vio.eval.simulation import load_state_gt as jax_load_state_gt
from cuahn_vio.eval.traj_io import load_pose_file as jax_load_pose_file
from cuahn_vio.eval.traj_io import load_timing_file as jax_load_timing_file
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.eval.align import associate
from cuahn_vio_torch.eval.simulation import StateGT, load_state_gt, save_state_gt
from cuahn_vio_torch.eval.traj_io import (
    load_pose_file,
    load_timing_file,
    save_pose_file,
    save_timing_file,
)


def _quat(rotvec: np.ndarray) -> np.ndarray:
    """(N, 3) rotation vectors -> (N, 4) unit quaternions [x y z w]."""
    angle = np.linalg.norm(rotvec, axis=1, keepdims=True)
    axis = rotvec / np.maximum(angle, 1e-12)
    return np.concatenate([axis * np.sin(angle / 2), np.cos(angle / 2)], axis=1)


def _spd(rng, n: int, dim: int, scale: float) -> np.ndarray:
    a = rng.normal(size=(n, dim, dim))
    return scale * (a @ a.transpose(0, 2, 1) / dim + 0.1 * np.eye(dim))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(11)
    t = np.arange(0.0, 10.0, 1 / 30)
    n = len(t)
    pos = np.stack([2 * np.sin(0.4 * t), 1.5 * np.cos(0.3 * t), 1.5 + 0.2 * np.sin(t)], 1)
    rot = np.stack([0.1 * np.sin(t), 0.1 * np.cos(0.7 * t), 0.5 * t], 1)
    gt = np.concatenate([pos, _quat(rot)], axis=1)
    drift = np.cumsum(rng.normal(0, 0.002, (n, 3)), axis=0)
    est = np.concatenate([pos + drift + rng.normal(0, 0.01, (n, 3)),
                          _quat(rot + rng.normal(0, 0.01, (n, 3)))], axis=1)
    est_t = t[5:-3] + 0.004  # a time offset inside the 20 ms association
    est = est[5:-3]
    m = len(est_t)
    paths = {k: str(d / k) for k in ("gt.txt", "est.txt", "est_nocov.txt", "t1.csv",
                                     "t2.csv", "state_gt.txt", "state.npz", "state_min.npz")}
    save_pose_file(paths["gt.txt"], t, gt)
    save_pose_file(paths["est.txt"], est_t, est, _spd(rng, m, 3, 1e-4), _spd(rng, m, 3, 1e-3))
    save_pose_file(paths["est_nocov.txt"], est_t, est)
    for name in ("t1.csv", "t2.csv"):
        save_timing_file(paths[name], est_t, np.abs(rng.normal(10.0, 5.0, (m, 5))))
    vel = np.gradient(pos, t, axis=0)
    save_state_gt(paths["state_gt.txt"], StateGT(
        times=t, pose=gt, vel=vel, bg=np.tile([0.003, -0.001, 0.002], (n, 1)),
        ba=np.tile([0.02, 0.01, -0.03], (n, 1))))
    cov = _spd(rng, m, 15, 1e-3)
    state = dict(times=est_t, pose=est, v_body=rng.normal(0, 1, (m, 3)),
                 ba=rng.normal(0.02, 0.01, (m, 3)), bg=rng.normal(0.0, 0.002, (m, 3)),
                 cov_diag=np.einsum("fii->fi", cov), cov_core=cov)
    np.savez(paths["state.npz"], **state)
    np.savez(paths["state_min.npz"], times=est_t, pose=est, cov_diag=state["cov_diag"])
    return paths


def _said(main, argv, capsys) -> str:
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("align", ["posyaw", "posyawsingle", "se3", "se3single", "sim3",
                                   "none"])
def test_error_singlerun_prints_the_jax_lines(files, capsys, align):
    argv = ["error-singlerun", align, files["gt.txt"], files["est.txt"]]
    ours = _said(tcli.main, argv, capsys)
    assert ours == _said(jax_main, argv, capsys)
    assert "pos: rmse" in ours and "NEES: ori mean" in ours


@pytest.mark.parametrize("extra", [["--segments", "0.5,1,2.5"], []],
                         ids=["segments", "no covariance"])
def test_error_singlerun_options_print_the_jax_lines(files, capsys, extra):
    est = files["est.txt"] if extra else files["est_nocov.txt"]
    argv = ["error-singlerun", "se3", files["gt.txt"], est, *extra]
    ours = _said(tcli.main, argv, capsys)
    assert ours == _said(jax_main, argv, capsys)
    assert ("skipped" in ours) == (not extra)


def test_timing_percentages_prints_the_jax_lines(files, capsys):
    argv = ["timing-percentages", files["t1.csv"], files["t2.csv"]]
    ours = _said(tcli.main, argv, capsys)
    assert ours == _said(jax_main, argv, capsys)
    assert ours.count(" fps") == 2


@pytest.mark.parametrize("state", ["state.npz", "state_min.npz"])
def test_error_simulation_prints_the_jax_lines(files, capsys, state):
    argv = ["error-simulation", files[state], files["state_gt.txt"]]
    ours = _said(tcli.main, argv, capsys)
    assert ours == _said(jax_main, argv, capsys)
    assert ("observable-subspace NEES" in ours) == (state == "state.npz")
    assert "full-state NEES" in ours


def test_error_simulation_refuses_plot(files, capsys, tmp_path):
    """``--plot``, once refused, now draws the figure with the port's raster
    writer (its series are held to the JAX figure's in
    ``tests/test_torch_plots.py``): the JAX verb's lines, then "wrote", and
    an RGB PNG of figsize x dpi (12 x 11 in at 130 dpi: five rows)."""
    from cuahn_vio_torch.utils.png import read_png

    out = str(tmp_path / "x.png")
    argv = ["error-simulation", files["state.npz"], files["state_gt.txt"]]
    ours = _said(tcli.main, [*argv, "--plot", out], capsys)
    assert ours == _said(jax_main, argv, capsys) + f"wrote {out}\n"
    with open(out, "rb") as f:
        assert f.read(26)[25] == 2  # colour type 2, RGB
    assert read_png(out).shape == (1430, 1560)


def test_readers_return_the_jax_arrays(files):
    for name in ("gt.txt", "est.txt", "est_nocov.txt"):
        ours, ref = load_pose_file(files[name]), jax_load_pose_file(files[name])
        for a, b in zip(ours, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    for a, b in zip(load_timing_file(files["t1.csv"]), jax_load_timing_file(files["t1.csv"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(load_state_gt(files["state_gt.txt"]),
                    jax_load_state_gt(files["state_gt.txt"])):
        np.testing.assert_array_equal(a, b)
    est, gt = load_pose_file(files["est.txt"]), load_pose_file(files["gt.txt"])
    args = (est.times, gt.times, est.poses, gt.poses, 0.0, 0.02, est.cov_ori, est.cov_pos)
    for a, b in zip(associate(*args), jax_associate(*args)):
        np.testing.assert_array_equal(a, b)

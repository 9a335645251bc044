"""The port's SE(3) B-spline (``cuahn_vio_torch.data.bspline``) against the
JAX package's (``cuahn_vio.data.bspline``), in float32 on the CPU.

Both evaluate the same pose map; the IMU is forward-mode autodiff of it
(``torch.func.jacfwd`` / ``jax.jacfwd``), twice for the acceleration.
Tolerances: poses 2e-6, body rates 5e-6 rad/s, specific force 5e-4 m/s^2
on ~10 m/s^2 and body velocities 2e-5 m/s, which the two libraries' float32
rounding of 4x4 products and of the second derivative leave (measured
5e-7, 7e-7, 5e-5 and 4e-6). At ``t_min`` and ``t_max - 1e-6`` the clamp of
``pose`` ties, where ``jnp.clip``'s derivative is 0.5: the port must give
the JAX spline's half rate there, not ``torch.clamp``'s full one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from cuahn_vio.data import bspline as jbs
from cuahn_vio.data.synthetic import AnalyticTrajectory as JAnalytic
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data import bspline as tbs
from cuahn_vio_torch.data.synthetic import make_sequence
from cuahn_vio_torch.utils.config import VioOptions

TOL = dict(pose=2e-6, w=5e-6, f=5e-4, v=2e-5)


def _write_pose_file(path: str, still_s: float = 0.6, seconds: float = 3.0):
    """The analytic flight (JAX closed forms) at 500 Hz after ``still_s``
    of hover, as make-synthetic writes a GT file: a pose txt whose spline
    has constant segments (theta -> 0) and moving ones."""
    traj = JAnalytic()
    t = np.arange(0.0, still_s + seconds, 0.002)
    tm = jnp.asarray(np.maximum(t - still_s, 0.0), jnp.float32)
    p = np.asarray(jax.vmap(traj.pos_w)(tm))
    q = np.asarray(jax.vmap(traj.quat_i2w)(tm))
    with open(path, "w") as f:
        f.write("# timestamp(s) tx ty tz qx qy qz qw\n")
        for ti, pi, qi in zip(t, p, q):
            f.write(f"{ti:.5f} " + " ".join(f"{x:.6f}" for x in (*pi, *qi[1:], qi[0])) + "\n")
    return path


@pytest.fixture(scope="module")
def splines(tmp_path_factory):
    path = _write_pose_file(str(tmp_path_factory.mktemp("spline") / "traj.txt"))
    return (path, jbs.SplineTrajectory.from_trajectory_file(path, dt=0.1, z_offset=0.4),
            tbs.SplineTrajectory.from_trajectory_file(path, dt=0.1, z_offset=0.4))


def _times(spline):
    f32 = np.float32
    edges = [spline.t_min, spline.t_max - 1e-6, f32(spline.t_min) + f32(1e-4), 0.0, 0.05,
             spline.t_max + 1.0, 0.3]  # at and beyond both clamps; 0.05-0.6: still (theta 0)
    return np.concatenate([edges, np.linspace(0.0, 3.7, 241)]).astype(np.float32)


def test_control_poses_and_twists_match_jax(splines):
    _, js, ts = splines
    np.testing.assert_allclose(ts.ctrl.numpy(), np.asarray(js.ctrl), atol=1e-6)
    np.testing.assert_allclose(ts.omega.numpy(), np.asarray(js.omega), atol=1e-6)
    assert (ts.t_min, ts.t_max) == (js.t_min, js.t_max)
    assert (np.abs(ts.omega.numpy()) < 1e-9).all(axis=1).any()  # constant segments


def test_pose_and_state_match_jax(splines):
    _, js, ts = splines
    t = _times(js)
    np.testing.assert_allclose(vmap(ts.pose)(torch.as_tensor(t)).numpy(),
                               np.asarray(jax.vmap(js.pose)(jnp.asarray(t))), atol=TOL["pose"])
    want = jax.vmap(js.state_gt)(jnp.asarray(t))
    got = vmap(ts.state_gt)(torch.as_tensor(t))
    for g, w, tol in zip(got, want, (TOL["pose"], TOL["pose"], TOL["v"])):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)


def test_imu_matches_jax_including_the_clamp_ties(splines):
    _, js, ts = splines
    t = _times(js)
    want_w, want_f = jax.jit(jax.vmap(lambda x: js.imu_true(x)))(jnp.asarray(t))
    got_w, got_f = vmap(lambda x: ts.imu_true(x))(torch.as_tensor(t))
    assert got_w.dtype == got_f.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=TOL["w"])
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=TOL["f"])
    # t_min and t_max - 1e-6 tie with the clamp: half the rate just inside
    # them (the JAX derivative of jnp.clip there is 0.5), and a quarter of
    # the acceleration
    inside = vmap(lambda x: ts.imu_true(x))(torch.as_tensor(
        np.array([np.float32(js.t_min) + np.float32(2e-6),
                  np.float32(js.t_max - 1e-6) - np.float32(4e-6)], np.float32)))
    for k in range(2):
        np.testing.assert_allclose(got_w[k].numpy(), 0.5 * inside[0][k].numpy(), atol=1e-4)
    g = torch.tensor([0.0, 0.0, -9.81])
    rot = vmap(ts.pose)(torch.as_tensor(t[:1]))[0, :3, :3]
    acc_tie = rot @ got_f[0] + g
    acc_in = vmap(ts.pose)(torch.as_tensor(t[2:3]))[0, :3, :3] @ inside[1][0] + g
    np.testing.assert_allclose(acc_tie.numpy(), 0.25 * acc_in.numpy(), atol=5e-3)
    # outside the span the pose is constant: no rate, gravity only
    np.testing.assert_allclose(got_w[5].numpy(), 0.0, atol=1e-7)


def test_so3_and_se3_maps_match_jax(rng):
    for scale in (1e-9, 1e-4, 0.3, 2.5):
        xi = (rng.normal(size=6) * scale).astype(np.float32)
        np.testing.assert_allclose(tbs.se3_exp(torch.as_tensor(xi)).numpy(),
                                   np.asarray(jbs.se3_exp(jnp.asarray(xi))), atol=2e-6)
        t4 = np.asarray(jbs.se3_exp(jnp.asarray(xi)))
        np.testing.assert_allclose(tbs.se3_log(torch.as_tensor(t4)).numpy(),
                                   np.asarray(jbs.se3_log(jnp.asarray(t4))), atol=2e-5)


def test_from_trajectory_file_refuses_short_files(tmp_path):
    path = tmp_path / "short.txt"
    path.write_text("# t x y z qx qy qz qw\n0 0 0 1 0 0 0 1\n0.1, 0, 0, 1, 0, 0, 0, 1\n")
    with pytest.raises(ValueError, match="fewer than 4 poses"):
        tbs.SplineTrajectory.from_trajectory_file(str(path))


def test_make_sequence_with_a_spline_matches_jax(splines):
    """The IMU stream and the GT of ``make_sequence`` over the spline: the
    port's against the JAX package's (same numpy noise), procedural ground
    (the frames come from two different random grounds, so they are not
    compared)."""
    from cuahn_vio.data.synthetic import make_sequence as jmake

    _, js, ts = splines
    t_imu_to_cam = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam)
    kw = dict(duration=2.0, t_still=0.5, seed=4, sigma_w=0.002, sigma_a=0.02, bias_g=0.003,
              bias_a=0.02, cam_hz=5.0)
    got = make_sequence(ts, t_imu_to_cam, device="cpu", **kw)
    want = jmake(js, t_imu_to_cam, **kw)
    for name in ("imu_t", "cam_t", "gt_times", "true_bg", "true_ba"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(got.imu_w, want.imu_w, atol=TOL["w"], rtol=0)
    np.testing.assert_allclose(got.imu_a, want.imu_a, atol=TOL["f"], rtol=0)
    np.testing.assert_allclose(got.gt_pose_w, want.gt_pose_w, atol=TOL["pose"], rtol=0)
    np.testing.assert_allclose(got.gt_vel_w, want.gt_vel_w, atol=TOL["v"], rtol=0)
    assert got.frames.shape == (len(got.cam_t), 224, 320)


def test_cli_make_synthetic_traj_file(splines, tmp_path):
    """``make-synthetic --traj-file`` flies the file: its GT follows the
    spline (the JAX verb's), and IMU and GT files match the JAX verb's."""
    from cuahn_vio import cli as jcli

    path, _, _ = splines
    flags = ["--traj-file", path, "--spline-dt", "0.1", "--traj-z-offset", "0.4",
             "--duration", "1.0", "--seed", "2", "--sigma-w", "0.002"]
    tcli.main(["make-synthetic", "--device", "cpu", "--out", str(tmp_path / "t.npz"), *flags])
    jcli.main(["make-synthetic", "--out", str(tmp_path / "j.npz"), *flags])
    out, ref = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    np.testing.assert_array_equal(out["cam_t"], ref["cam_t"])
    np.testing.assert_allclose(out["imu_w"], ref["imu_w"], atol=TOL["w"], rtol=0)
    np.testing.assert_allclose(out["imu_a"], ref["imu_a"], atol=TOL["f"], rtol=0)
    for suffix in ("_gt.txt", "_state_gt.txt"):
        a, b = np.loadtxt(tmp_path / f"t{suffix}"), np.loadtxt(tmp_path / f"j{suffix}")
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    gt = np.loadtxt(tmp_path / "t_gt.txt")
    assert abs(gt[0, 3] - (1.5 + 0.4)) < 1e-3  # the file's hover height + the offset

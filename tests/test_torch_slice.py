"""The port's slice end to end against cuahn_vio: synthetic data, config,
``run_offline`` with v10 weights, ATE and the ``run-vio`` CLI.

One short sequence from cuahn_vio's ``make_sequence`` (0.6 s of motion
after 2.5 s still, ~11 frames past initialization) through both
``run_offline``s at dropout_rate = 0, IEKF = 2, the bias block on and the
update gate lowered to 2 frames so that updates, the iterated prior and
the bias block all run. Tolerances: world positions 2e-5 m, quaternions
1e-6 and covariances 1e-6 absolute (measured ~1.5e-6 m / 1e-7 / 5e-8;
float32 towers and filter in another op order); network flows 1e-3 px.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.data.synthetic import AnalyticTrajectory as JaxTraj
from cuahn_vio.eval.traj_io import load_pose_file
from cuahn_vio.data.synthetic import make_sequence as jax_make_sequence
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.pipeline.runner import run_offline as jax_run_offline
from cuahn_vio.pipeline.vio import VioConfig as JaxVioConfig
from cuahn_vio.utils.config import VioOptions as JaxVioOptions
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
from cuahn_vio_torch.eval.align import ate_rmse
from cuahn_vio_torch.eval.traj_io import save_pose_file
from cuahn_vio_torch.models.uahn import build_uahn
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.pipeline.runner import run_offline
from cuahn_vio_torch.pipeline.vio import VioConfig
from cuahn_vio_torch.utils.checkpoint import load_params
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
POS_ATOL = 2e-5
Q_ATOL = 1e-6
COV_ATOL = 1e-6
FLOW_ATOL = 1e-3
SEQ_KW = dict(duration=0.6, seed=1, sigma_w=0.002, sigma_a=0.02, bias_g=0.003,
              bias_a=0.02, texture_seed=1)


def _seq_options(cls):
    """The config make-synthetic writes: calibrated, no cam-imu offset,
    hover height, gentle jerk threshold; plus the OU bias block."""
    opts = cls().apply_profile("calibrated")
    opts.calib_camimu_dt = 0.0
    opts.init_height = 1.5
    opts.init_imu_thresh = 0.2
    opts.meas_bias_sigma_px = 2.0
    return opts


@pytest.fixture(scope="module")
def sequence():
    opts = _seq_options(JaxVioOptions)
    return jax_make_sequence(JaxTraj(), np.asarray(opts.t_imu_to_cam), **SEQ_KW)


@pytest.fixture(scope="module")
def both_runs(sequence):
    from flax import serialization

    seq = sequence
    with open(WEIGHTS, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    jo = _seq_options(JaxVioOptions)
    ref = jax_run_offline(
        seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames,
        JaxUAHN(dropout_rate=0.0), params, jo.filter_params(),
        JaxVioConfig(max_iekf_iterations=2, update_gate_frames=2),
        jo.runner_options(),
    )
    to = _seq_options(VioOptions)
    model = build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)
    before = dict(tcuda.launch_counts)
    out = run_offline(
        seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames,
        model, to.filter_params("cpu"),
        VioConfig(max_iekf_iterations=2, update_gate_frames=2),
        to.runner_options(), device="cpu",
    )
    assert tcuda.launch_counts == before  # the CPU path launches no kernel
    return ref, out


def test_run_offline_matches_jax_v10(both_runs):
    ref, out = both_runs
    assert len(out.times) == len(ref.times) >= 8
    np.testing.assert_array_equal(out.times, ref.times)
    np.testing.assert_allclose(out.pose_w[:, :3], ref.pose_w[:, :3], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.pose_w[:, 3:], ref.pose_w[:, 3:], atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(out.cov_core, ref.cov_core, atol=COV_ATOL, rtol=0)
    np.testing.assert_allclose(out.net_mean, ref.net_mean, atol=FLOW_ATOL, rtol=0)
    # the updates really ran: past the gate the filter moved off propagation
    assert (out.net_chi2[3:] > 0).all() and np.isfinite(out.pose_w).all()


def test_run_offline_dead_reckoning_matches_jax(sequence):
    seq = sequence
    jo, to = _seq_options(JaxVioOptions), _seq_options(VioOptions)
    ref = jax_run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames,
                          None, None, jo.filter_params(), jo.vio_config(),
                          jo.runner_options())
    out = run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames,
                      None, to.filter_params("cpu"), to.vio_config(),
                      to.runner_options(), device="cpu")
    np.testing.assert_allclose(out.pose_w, ref.pose_w, atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.cov_core, ref.cov_core, atol=COV_ATOL, rtol=0)


def test_make_sequence_matches_jax_with_jax_texture_draws(sequence):
    """The port's generator with JAX's texture draws passed in: IMU and GT
    to float32 rounding, frames to one uint8 level on a few pixels."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(SEQ_KW["texture_seed"]), 3)
    draws = (
        np.asarray(jax.random.uniform(k1, (24, 2), minval=0.5, maxval=14.0)),
        np.asarray(jnp.sign(jax.random.normal(k3, (24, 2)))),
        np.asarray(jax.random.uniform(k2, (24,), minval=0.0, maxval=2 * jnp.pi)),
    )
    opts = _seq_options(VioOptions)
    out = make_sequence(AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam),
                        texture=draws, device="cpu", **SEQ_KW)
    ref = sequence
    for name in ("imu_t", "cam_t", "gt_times", "true_bg", "true_ba"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(out.imu_w, ref.imu_w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.imu_a, ref.imu_a, atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.gt_pose_w, ref.gt_pose_w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.gt_vel_w, ref.gt_vel_w, atol=1e-6, rtol=0)
    diff = np.abs(out.frames.astype(int) - ref.frames.astype(int))
    assert out.frames.shape == ref.frames.shape and out.frames.dtype == np.uint8
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_vio_options_match_jax(tmp_path):
    pytest.importorskip("yaml")
    for profile in ("launch", "calibrated"):
        a = VioOptions().apply_profile(profile)
        b = JaxVioOptions().apply_profile(profile)
        assert a.__dict__ == b.__dict__
        assert a.vio_config().__dict__ == b.vio_config().__dict__
        assert a.runner_options().__dict__ == b.runner_options().__dict__
    path = str(tmp_path / "cfg.yaml")
    _seq_options(JaxVioOptions).to_yaml(path)
    assert VioOptions.from_yaml(path).__dict__ == _seq_options(VioOptions).__dict__
    out = VioOptions.uzhfpv_outdoor45()
    np.testing.assert_allclose(out.t_imu_to_cam, JaxVioOptions.uzhfpv_outdoor45().t_imu_to_cam)


def test_ate_matches_jax_result_trajectory(both_runs, sequence, tmp_path):
    from cuahn_vio.eval.metrics import ResultTrajectory

    _, out = both_runs
    est, gt = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    save_pose_file(est, out.times, out.pose_w, out.cov_ori, out.cov_pos)
    save_pose_file(gt, sequence.gt_times, sequence.gt_pose_w)
    ori_ref, pos_ref = ResultTrajectory.from_files(est, gt, "se3").calculate_ate()
    e, g = load_pose_file(est), load_pose_file(gt)
    ori, pos = ate_rmse(e.times, e.poses, g.times, g.poses)
    np.testing.assert_allclose([ori, pos], [ori_ref.rmse, pos_ref.rmse], rtol=1e-9)


def test_cli_run_vio_on_cpu_writes_the_pose_file(sequence, tmp_path):
    seq = sequence
    npz = str(tmp_path / "seq.npz")
    np.savez(npz, imu_t=seq.imu_t, imu_w=seq.imu_w, imu_a=seq.imu_a,
             cam_t=seq.cam_t, frames=seq.frames)
    out = str(tmp_path / "est.txt")
    state = str(tmp_path / "state.npz")
    tcli.main([
        "run-vio", npz, "--no-network", "--device", "cpu", "--out", out,
        "--state-out", state, "--init-height", "1.5", "--calib-dt", "0",
        "--init-imu-thresh", "0.2",
    ])
    traj = load_pose_file(out)
    assert traj.poses.shape[1] == 7 and traj.cov_pos is not None
    opts = VioOptions().apply_profile("calibrated")
    opts.init_height, opts.calib_camimu_dt, opts.init_imu_thresh = 1.5, 0.0, 0.2
    res = run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames, None,
                      opts.filter_params("cpu"), opts.vio_config(),
                      opts.runner_options(), device="cpu")
    np.testing.assert_allclose(traj.poses, res.pose_w, atol=1e-6)
    assert set(np.load(state).files) >= {"pose", "cov_core", "net_chi2"}


@pytest.mark.parametrize("argv", [
    ["error-simulation", "x.npz", "gt.txt", "--plot", "x.png"],
], ids=["error-simulation --plot"])
def test_cli_refuses_flags_not_ported(argv, tmp_path, monkeypatch):
    """``--plot``, once refused, is ported: without its input files the
    verb fails reading them and writes nothing."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="x.npz"):
        tcli.main(argv)
    assert not list(tmp_path.iterdir())  # nothing written


def test_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["run-vio", str(tmp_path / "x.npz")])

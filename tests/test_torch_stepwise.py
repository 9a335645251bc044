"""The port's stepwise runner, stages and health checks against cuahn_vio.

- ``run_stepwise`` (staged) against the JAX ``run_stepwise`` with the v10
  weights at dropout_rate = 0, IEKF = 2, the bias block on and the update
  gate lowered to 2 frames (``tests/test_torch_slice.py``'s short sequence
  and options), and in dead reckoning;
- staged, fused and ``run_offline`` at one seed with dropout on: one
  trajectory (the runners draw their masks from the same keys, those of
  the JAX ``run_offline``; the JAX ``run_stepwise`` takes each frame
  pair's key one later, VERDICT.md:140-147);
- the divergence guard on ``tests/test_runner_features.py``'s NaN-IMU
  case: the JAX runner's ``n_recoveries`` and poses;
- ``health_flags`` against the JAX checks on good and bad states.

Tolerances are ``tests/test_torch_slice.py``'s (positions 2e-5 m,
quaternions 1e-6, covariances 1e-6, flows 1e-3 px) unless a test states
another.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.data.synthetic import AnalyticTrajectory as JaxTraj
from cuahn_vio.data.synthetic import make_sequence as jax_make_sequence
from cuahn_vio.filter import FilterState as JaxFilterState
from cuahn_vio.filter import make_params as jax_make_params
from cuahn_vio.filter.health import health_flags as jax_health_flags
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.pipeline.runner import RunnerOptions as JaxRunnerOptions
from cuahn_vio.pipeline.runner import run_stepwise as jax_run_stepwise
from cuahn_vio.pipeline.vio import VioConfig as JaxVioConfig
from cuahn_vio.utils.config import VioOptions as JaxVioOptions
from cuahn_vio_torch.filter.health import health_flags
from cuahn_vio_torch.filter.state import FilterState, make_params
from cuahn_vio_torch.models.uahn import build_uahn
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.pipeline.runner import RunnerOptions, run_offline, run_stepwise
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
# tests/test_runner_features.py: its extrinsic, runner options and flight
T_ITOC = np.array([[1.0, 0.0, 0.0, 0.02], [0.0, -1.0, 0.0, -0.01],
                   [0.0, 0.0, -1.0, 0.005], [0.0, 0.0, 0.0, 1.0]])
GUARD_OPTS = dict(calib_camimu_dt=0.0, init_imu_thresh=0.2, init_height=1.5)
# that 4 s flight's 75 frames of float32 dead reckoning drift further apart
# than the 0.6 s slice, with or without the guard (measured: 8.6e-6 m,
# 1.7e-6, and 2.0e-5 of the frame's largest covariance entry)
GUARD_Q_ATOL = 5e-6
GUARD_COV_FRAC = 1e-4


def _seq_options(cls):
    """``tests/test_torch_slice.py``'s options: the config make-synthetic
    writes, with the OU bias block on."""
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


def _args(seq):
    return seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames


def test_run_stepwise_matches_jax_v10(sequence):
    from flax import serialization

    with open(WEIGHTS, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    jo, to = _seq_options(JaxVioOptions), _seq_options(VioOptions)
    ref = jax_run_stepwise(
        *_args(sequence), JaxUAHN(dropout_rate=0.0), params, jo.filter_params(),
        JaxVioConfig(max_iekf_iterations=2, update_gate_frames=2), jo.runner_options(),
    )
    model = build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)
    before = dict(tcuda.launch_counts)
    out = run_stepwise(
        *_args(sequence), model, to.filter_params("cpu"),
        VioConfig(max_iekf_iterations=2, update_gate_frames=2), to.runner_options(),
        device="cpu",
    )
    assert tcuda.launch_counts == before  # the CPU path launches no kernel
    assert len(out.times) == len(ref.times) >= 8
    np.testing.assert_array_equal(out.times, ref.times)
    np.testing.assert_allclose(out.pose_w[:, :3], ref.pose_w[:, :3], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.pose_w[:, 3:], ref.pose_w[:, 3:], atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(out.cov_core, ref.cov_core, atol=COV_ATOL, rtol=0)
    np.testing.assert_allclose(out.net_mean, ref.net_mean, atol=FLOW_ATOL, rtol=0)
    assert out.n_recoveries == ref.n_recoveries == 0
    assert out.stage_ms.shape == ref.stage_ms.shape == (len(out.times), 5)
    assert (out.net_chi2[3:] > 0).all()  # the updates ran


def test_run_stepwise_dead_reckoning_matches_jax(sequence):
    jo, to = _seq_options(JaxVioOptions), _seq_options(VioOptions)
    ref = jax_run_stepwise(*_args(sequence), None, None, jo.filter_params(),
                           jo.vio_config(), jo.runner_options())
    out = run_stepwise(*_args(sequence), None, to.filter_params("cpu"), to.vio_config(),
                       to.runner_options(), device="cpu")
    np.testing.assert_allclose(out.pose_w, ref.pose_w, atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.cov_core, ref.cov_core, atol=COV_ATOL, rtol=0)
    assert out.n_recoveries == ref.n_recoveries == 0


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "fused"])
def test_stepwise_and_run_offline_share_one_trajectory(sequence, staged):
    """With MC dropout on (p = 0.05) and one seed, the stepwise runner
    draws run_offline's masks: the same trajectory, bit for bit, whatever
    the warm-up drew."""
    to = _seq_options(VioOptions)
    model = build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.05)
    cfg = VioConfig(max_iekf_iterations=2, update_gate_frames=2)
    args = (*_args(sequence), model, to.filter_params("cpu"), cfg, to.runner_options())
    ref = run_offline(*args, seed=5, device="cpu")
    out = run_stepwise(*args, seed=5, device="cpu", staged_timing=staged)
    other = run_offline(*args, seed=6, device="cpu")
    assert np.abs(other.pose_w - ref.pose_w).max() > 1e-6  # dropout is on
    for field in ("pose_w", "cov_core", "net_mean", "net_chi2", "v_body"):
        np.testing.assert_array_equal(getattr(out, field), getattr(ref, field), err_msg=field)
    ms = out.stage_ms
    assert ms.shape == (len(out.times), 5) and np.isfinite(ms).all() and (ms >= 0).all()
    assert (ms[:, 4] >= ms[:, 0]).all()
    if staged:
        assert (ms[:, 1] > 0).all() and (ms[:, 2] > 0).all() and (ms[:, 3] > 0).all()
        assert (ms[:, 1:4].sum(axis=1) <= ms[:, 4]).all()
    else:
        assert (ms[:, 1] == 0).all() and (ms[:, 3] == 0).all() and (ms[:, 2] > 0).all()


@pytest.fixture(scope="module")
def guard_sequence():
    return jax_make_sequence(JaxTraj(), T_ITOC, duration=4.0, cam_hz=20.0)


def _nan_imu(seq):
    """``tests/test_runner_features.py``'s corruption: three NaN gyro
    samples in the flight."""
    imu_w = seq.imu_w.copy()
    bad = np.searchsorted(seq.imu_t, 4.0)
    imu_w[bad:bad + 3] = np.nan
    return imu_w


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "fused"])
def test_divergence_guard_matches_jax(guard_sequence, staged):
    seq = guard_sequence
    imu_w = _nan_imu(seq)
    ref = jax_run_stepwise(seq.imu_t, imu_w, seq.imu_a, seq.cam_t, seq.frames, None, None,
                           jax_make_params(T_ITOC), JaxVioConfig(),
                           JaxRunnerOptions(**GUARD_OPTS), staged_timing=staged)
    out = run_stepwise(seq.imu_t, imu_w, seq.imu_a, seq.cam_t, seq.frames, None,
                       make_params(T_ITOC, device="cpu"), VioConfig(),
                       RunnerOptions(**GUARD_OPTS), device="cpu", staged_timing=staged)
    assert out.n_recoveries == ref.n_recoveries >= 1
    assert np.isfinite(out.pose_w).all()
    np.testing.assert_array_equal(out.times, ref.times)
    np.testing.assert_allclose(out.pose_w[:, :3], ref.pose_w[:, :3], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.pose_w[:, 3:], ref.pose_w[:, 3:], atol=GUARD_Q_ATOL,
                               rtol=0)
    scale = np.abs(ref.cov_core).max(axis=(1, 2))[:, None, None]
    assert (np.abs(out.cov_core - ref.cov_core) <= GUARD_COV_FRAC * scale).all()
    # the first rollback row is the rolled-back state, covariance inflated
    rolled = np.nonzero(np.all(out.pose_w[1:] == out.pose_w[:-1], axis=1))[0]
    first = int(rolled[0])
    assert (out.cov_diag[first + 1] > 5.0 * out.cov_diag[first]).any()


def test_no_guard_on_a_clean_run(guard_sequence):
    seq = guard_sequence
    out = run_stepwise(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames, None,
                       make_params(T_ITOC, device="cpu"), VioConfig(),
                       RunnerOptions(**GUARD_OPTS), device="cpu")
    assert out.n_recoveries == 0 and np.isfinite(out.pose_w).all()
    assert out.stage_ms.shape == (len(out.times), 5)


def _states():
    """(name, numpy fields) of good and bad states."""
    good = dict(p=np.array([0.0, 0.0, 1.5]), q=np.array([1.0, 0.0, 0.0, 0.0]),
                v=np.zeros(3), ba=np.zeros(3), bg=np.zeros(3), off=np.zeros((4, 3)),
                cov=np.eye(27) * 1e-4)
    rng = np.random.default_rng(0)
    tilted = dict(good, q=np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2]),
                  p=rng.normal(0, 1, 3) + [0, 0, 3.0], v=rng.normal(0, 2, 3))
    return [
        ("good", good),
        ("tilted", tilted),
        ("nan p", dict(good, p=good["p"] * np.nan)),
        ("inf offset", dict(good, off=np.full((4, 3), np.inf))),
        ("fast", dict(good, v=np.ones(3) * 100)),
        ("negative covariance", dict(good, cov=-good["cov"])),
        ("large trace", dict(good, cov=np.eye(27) * 1e3)),
        ("below the plane", dict(good, p=np.array([0.0, 0.0, -0.5]))),
    ]


@pytest.mark.parametrize("name,fields", _states(), ids=[n for n, _ in _states()])
def test_health_flags_match_jax(name, fields):
    ref = jax_health_flags(JaxFilterState(**{k: jnp.asarray(v, jnp.float32)
                                             for k, v in fields.items()}))
    out = health_flags(FilterState(**{k: torch.as_tensor(v, dtype=torch.float32)
                                      for k, v in fields.items()}))
    assert [bool(x) for x in out] == [bool(x) for x in ref]
    assert bool(out.ok) == (name in ("good", "tilted"))

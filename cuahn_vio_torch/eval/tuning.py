"""Filter-parameter sweep by measurement replay: a whole grid at once.

Counterpart of ``cuahn_vio.eval.tuning``. The expensive part of a run,
the network's inference per frame, is logged once by ``run-vio
--state-out`` (``net_mean`` / ``net_cov88`` per frame); the cheap part,
the 27-state filter, is replayed over that log for every point of a grid
of filter parameters in one batched run on the card: the grid's
FilterParams are stacked (``_stack_params``) and
``pipeline.vio.run_sequence_with_measurements`` maps the filter over them
with ``torch.func.vmap``, one Python loop over the frames with every grid
point in each launch.

Caveat (as the JAX module says): the logged measurements were made under
the original parameters, and the parameters feed back into the
measurements through the propagated prior handed to the network. The
sweep is a first-order search; confirm a winner with a real ``run-vio``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from cuahn_vio_torch.filter.initializer import initial_state
from cuahn_vio_torch.filter.propagate import propagate_window
from cuahn_vio_torch.filter.state import FOCAL, FilterParams, with_bias_block
from cuahn_vio_torch.pipeline.imu_window import build_imu_windows, select_imu_readings
from cuahn_vio_torch.pipeline.runner import RunnerOptions, _streaming_init
from cuahn_vio_torch.pipeline.vio import (
    FrameOutput,
    VioConfig,
    _params_dims,
    _state_dims,
    expand_state,
    run_sequence_with_measurements,
)


@dataclass(frozen=True)
class SweepConfig:
    """One point of the filter-parameter grid."""

    k_net_cov: float = 10.0
    chi2_gate: float = 1000.0
    q_scale: float = 1.0  # multiplies the whole 15x15 process noise Q
    q_pos_extra: float = 1.0e-4  # the Propagator.h:97 extra position noise
    # the correlated-error knobs (filter/state.py): OU measurement bias
    # (px / seconds), adaptive-R soft threshold, prior-echo fraction
    bias_sigma_px: float = 0.0
    bias_tau: float = 2.0
    chi2_soft: float = float("inf")
    echo_beta: float = 0.0


def _stack_params(base: FilterParams, grid: list) -> FilterParams:
    """One FilterParams per SweepConfig, stacked: every field gains a
    leading grid dim, its scalars 0-d float32 tensors on ``base``'s
    device."""
    dev, dtype = base.q_noise.device, base.q_noise.dtype

    def scalar(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype, device=dev)

    def one(cfg: SweepConfig) -> FilterParams:
        q = base.q_noise * cfg.q_scale
        q[12:15, 12:15] = torch.eye(3, dtype=dtype, device=dev) * cfg.q_pos_extra
        return base._replace(
            q_noise=q,
            k_net_cov=scalar(cfg.k_net_cov),
            chi2_gate=scalar(cfg.chi2_gate),
            bias_sigma=scalar(cfg.bias_sigma_px / FOCAL),
            bias_tau=scalar(cfg.bias_tau),
            chi2_soft=scalar(cfg.chi2_soft),
            echo_beta=scalar(cfg.echo_beta),
        )

    return FilterParams(*(torch.stack(xs) for xs in zip(*[one(c) for c in grid])))


def replay_measurements(imu_t, imu_w, imu_a, cam_t,
                        net_mean: np.ndarray,  # (F, 8) logged network flows, px
                        net_cov88: np.ndarray,  # (F, 8, 8) their covariances, px²
                        base_params: FilterParams, grid: list, opts: RunnerOptions,
                        vio_cfg: Optional[VioConfig] = None):
    """Replay the filter over logged measurements for every grid point, on
    ``base_params``' device.

    The log must come from a ``run-vio --state-out`` of the same sequence
    (one row per processed frame pair, zero matrices where no inference
    ran). Every grid point gets the bias block, so that all have one
    structure; with sigma_b = 0 it is inert.

    Returns (outs, times): ``outs`` a FrameOutput of numpy arrays with a
    leading grid axis, ``times`` the per-frame output timestamps.
    """
    vio_cfg = vio_cfg or VioConfig()
    dev = base_params.q_noise.device
    init, fi = _streaming_init(imu_t, imu_w, imu_a, cam_t, opts)
    if init is None:
        raise RuntimeError("initialization never fired (no jerk detected)")
    cam_used = cam_t[fi:]
    frame_times_imu = cam_used + opts.calib_camimu_dt

    win = build_imu_windows(
        imu_t, imu_w, imu_a, frame_times_imu[0], frame_times_imu[1:],
        max_steps=opts.max_imu_steps_per_frame,
    )
    n = win.w_mid.shape[0]
    if net_mean.shape[0] != n:
        raise ValueError(
            f"measurement log has {net_mean.shape[0]} rows, sequence has "
            f"{n} frame pairs — state npz from a different run?"
        )

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    state0 = initial_state(init, device=dev)
    t0s, w0s, a0s = select_imu_readings(imu_t, imu_w, imu_a, init.t0, frame_times_imu[0])
    w0 = put(0.5 * (w0s[:-1] + w0s[1:]))
    a0 = put(0.5 * (a0s[:-1] + a0s[1:]))
    dt0 = put(np.diff(t0s))

    def first(s0, fp: FilterParams):
        s0 = with_bias_block(s0, fp)
        return propagate_window(s0, fp, w0, a0, dt0) if t0s.shape[0] >= 2 else s0

    batched = _stack_params(base_params, grid)
    state0 = expand_state(state0, len(grid))
    s0 = vmap(first, in_dims=(_state_dims(state0), _params_dims(batched)[0]))(state0, batched)
    z_cov = put(net_cov88)
    # zero-cov rows are frames where no inference ran (gated / warm-up)
    z_valid = torch.einsum("fii->f", z_cov) > 0
    _, outs = run_sequence_with_measurements(
        s0, batched, vio_cfg, put(net_mean), z_cov, z_valid,
        put(win.w_mid), put(win.a_mid), put(win.dt), win.n_used,
    )
    times = cam_used[1:] + opts.calib_camimu_dt
    return FrameOutput(*(x.cpu().numpy() for x in outs)), np.asarray(times)


def score_sweep(outs, times: np.ndarray, gt_times: np.ndarray,
                gt_pose: np.ndarray,  # (N, 7) [x y z qx qy qz qw]
                state_gt=None,  # Optional StateGT for NEES
                grid: Optional[list] = None) -> list:
    """ATE (se3-aligned pos rmse) and pos NEES per grid point; the rows the
    JAX ``score_sweep`` writes (of a SweepConfig, only its first four
    knobs; ``grid_index`` names the point)."""
    from cuahn_vio_torch.eval.metrics import ResultTrajectory
    from cuahn_vio_torch.eval.simulation import ResultSimulation
    from cuahn_vio_torch.eval.traj_io import Trajectory

    results = []
    for g in range(outs.p_world.shape[0]):
        pose = np.concatenate([outs.p_world[g], outs.q[g][:, [1, 2, 3, 0]]], axis=1)
        row: dict = {"grid_index": g}
        if grid is not None:
            c = grid[g]
            row.update(k_net_cov=c.k_net_cov, chi2_gate=c.chi2_gate,
                       q_scale=c.q_scale, q_pos_extra=c.q_pos_extra)
        if not np.all(np.isfinite(pose)):
            row.update(ate_pos=float("inf"), nees_pos=float("inf"))
            results.append(row)
            continue
        try:
            traj = ResultTrajectory(Trajectory(times, pose, None, None),
                                    Trajectory(gt_times, gt_pose, None, None), "se3")
            ate_o, ate_p = traj.calculate_ate()
            row["ate_pos"] = float(ate_p.rmse)
            row["ate_ori"] = float(ate_o.rmse)
        except Exception as e:  # no overlap etc.
            row["ate_pos"] = float("inf")
            row["ate_err"] = str(e)
        if state_gt is not None:
            try:
                sim = ResultSimulation(
                    times, pose, state_gt,
                    est_v_body=outs.v_body[g], est_ba=outs.ba[g], est_bg=outs.bg[g],
                    est_cov_diag=np.einsum("fii->fi", outs.cov_core[g]),
                    est_cov_core=outs.cov_core[g],
                )
                neo, nep = sim.calculate_nees()
                row["nees_pos"] = float(nep.mean)
                row["nees_pos_med"] = float(nep.median)
                row["nees_ori"] = float(neo.mean)
            except Exception:
                row["nees_pos"] = float("inf")
        chi2 = outs.net_chi2[g]
        finite = np.isfinite(chi2) & (chi2 > 0)
        if finite.any():
            row["chi2_median"] = float(np.median(chi2[finite]))
            if grid is not None:
                row["n_gated"] = int((chi2[finite] >= grid[g].chi2_gate).sum())
        results.append(row)
    return results

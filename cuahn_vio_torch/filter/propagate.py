"""Robocentric IMU propagation: mean + analytic 27x27 covariance Jacobians.

Counterpart of ``cuahn_vio.filter.propagate`` (Propagator.cpp):

- ``predict_mean``: mean-only propagation over one IMU interval;
- ``compute_jacobians``: the analytic F (27x27) and Fw (27x15), the four
  corner chains computed together over a leading corner dim;
- ``propagate_step``: mean + P <- F P Fᵀ + Fw Q Fwᵀ (+ the OU bias block);
- ``propagate_window``: a Python loop over the frame's IMU intervals.

A dt = 0 step is an exact identity, as in the JAX package, so padded
windows give the same state; ``propagate_window`` skips the padding when
told how many intervals are real (``n_used``), which saves launches.

The functions take one state; ``torch.func.vmap`` runs them over a batch
of states (``pipeline/vio.py``). So F and Fw are made with ``new_zeros``
of a state tensor, which is batched under vmap, and filled in place.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from cuahn_vio_torch.filter.state import CORNER_XY1, FilterParams, FilterState
from cuahn_vio_torch.ops.quat import (
    jr_so3,
    quat_exp,
    quat_mul,
    quat_normalize,
    quat_to_rot,
    skew,
)


def _consts(ref: torch.Tensor):
    """(e_z, mu_w ground normal, corner bearings) on ``ref``'s device."""
    return _consts_on(ref.device, ref.dtype)


@functools.lru_cache(maxsize=None)
def _consts_on(device: torch.device, dtype: torch.dtype):
    # made once per device: a host-to-device copy of a fresh tensor would
    # synchronize the stream at every IMU step
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    muw = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=device)
    xy1 = torch.as_tensor(CORNER_XY1, dtype=dtype, device=device)
    return ez, muw, xy1


def _camera_terms(state: FilterState, params: FilterParams, w_hat, rot, muw):
    """Camera-frame angular rate, velocity, plane normal and height."""
    wc = params.c_rot_i @ w_hat
    vc = params.c_rot_i @ (state.v + skew(w_hat) @ params.i_t_i2c)
    muc = params.c_rot_i @ (rot.T @ muw)
    dc = (rot @ (state.p + params.i_t_i2c))[2]
    return wc, vc, muc, dc


def predict_mean(state: FilterState, params: FilterParams, w_m, a_m, dt) -> FilterState:
    """Mean-only propagation (predict_mean_discrete, Propagator.cpp:342-364).
    The covariance passes through unchanged."""
    ez, muw, xy1 = _consts(state.p)
    w_hat = w_m - state.bg
    a_hat = a_m - state.ba
    rot = quat_to_rot(state.q)
    wc, vc, muc, dc = _camera_terms(state, params, w_hat, rot, muw)
    pts = xy1 + state.off

    sk_w = skew(w_hat)
    new_q = quat_normalize(quat_mul(state.q, quat_exp(w_hat * dt)))
    new_v = state.v + dt * (-sk_w @ state.v + a_hat + rot.T @ params.gravity)
    new_p = state.p + dt * (-sk_w @ state.p + state.v)
    h_flow = skew(wc) + torch.outer(vc, muc) / dc
    flow = -((h_flow @ pts.T).T - pts * (pts @ h_flow.T @ ez)[:, None])
    new_off = state.off + dt * flow
    return state._replace(p=new_p, q=new_q, v=new_v, off=new_off)


def _corner_jacobians(pts, wc, vc, muc, dc, ez):
    """Per-corner flow Jacobians (Propagator.cpp:244-281), corners in the
    leading dim of ``pts`` (4, 3)."""
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    sk_wc = skew(wc)
    scalar = (ez @ vc) / dc
    mu_pt = pts @ muc  # (4,)
    ez_sk_pt = (pts @ sk_wc.T) @ ez  # ez · (sk_wc pt), (4,)
    j_df_pt = (
        sk_wc
        + torch.outer(vc, muc) / dc
        - ez_sk_pt[:, None, None] * eye
        - pts[:, :, None] * (ez @ sk_wc)[None, None, :]
        - scalar * (mu_pt[:, None, None] * eye + pts[:, :, None] * muc[None, None, :])
    )
    common = eye - pts[:, :, None] * ez[None, None, :]  # (4, 3, 3)
    common_vc = common @ vc  # (4, 3)
    j_df_dc = (1.0 / dc / dc) * mu_pt[:, None] * (-common_vc)  # (4, 3)
    j_df_vc = (1.0 / dc) * mu_pt[:, None, None] * common
    j_df_muc = (1.0 / dc) * (common_vc[:, :, None] * pts[:, None, :])
    j_df_wc = -common @ skew(pts)
    return j_df_pt, j_df_dc, j_df_vc, j_df_muc, j_df_wc


def compute_jacobians(state: FilterState, params: FilterParams, w_m, a_m, dt):
    """Analytic state transition F (27x27) and noise Jacobian Fw (27x15)
    (predict_and_compute, Propagator.cpp:224-325)."""
    ez, muw, xy1 = _consts(state.p)
    dtype, dev = state.p.dtype, state.p.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    w_hat = w_m - state.bg
    rot = quat_to_rot(state.q)
    wc, vc, muc, dc = _camera_terms(state, params, w_hat, rot, muw)
    pts = xy1 + state.off

    f = state.p.new_zeros((27, 27))
    sk_w = skew(w_hat)
    f[0:3, 0:3] = eye3 - dt * sk_w
    f[0:3, 6:9] = dt * eye3
    f[0:3, 12:15] = -dt * skew(state.p)
    f[3:6, 3:6] = quat_to_rot(quat_exp(w_hat * dt)).T
    f[3:6, 12:15] = -dt * jr_so3(w_hat * dt)
    f[6:9, 3:6] = dt * skew(rot.T @ params.gravity)
    f[6:9, 6:9] = eye3 - dt * sk_w
    f[6:9, 9:12] = -dt * eye3
    f[6:9, 12:15] = -dt * skew(state.v)
    f[9:12, 9:12] = eye3
    f[12:15, 12:15] = eye3

    j_df_pt, j_df_dc, j_df_vc, j_df_muc, j_df_wc = _corner_jacobians(
        pts, wc, vc, muc, dc, ez
    )
    # constant-extrinsic Jacobians (Propagator.h:191-196)
    j_vc_v = params.c_rot_i
    j_vc_bw = params.c_rot_i @ skew(params.i_t_i2c)
    j_wc_bw = -params.c_rot_i
    # shared chain terms (Propagator.cpp:284-287)
    j_dc_p = ez @ rot  # (3,)
    j_dc_q = ez @ (-rot @ skew(state.p + params.i_t_i2c))
    j_muc_q = params.c_rot_i @ skew(rot.T @ muw)

    # J_f_df = -dt I, so each block is -dt * (chain); rows 15+3k+i
    blk_p = -dt * (j_df_dc[:, :, None] * j_dc_p[None, None, :])
    blk_q = -dt * (j_df_dc[:, :, None] * j_dc_q[None, None, :] + j_df_muc @ j_muc_q)
    blk_v = -dt * (j_df_vc @ j_vc_v)
    blk_bg = -dt * (j_df_vc @ j_vc_bw + j_df_wc @ j_wc_bw)
    blk_pt = eye3 - dt * j_df_pt  # (4, 3, 3)
    f[15:27, 0:3] = blk_p.reshape(12, 3)
    f[15:27, 3:6] = blk_q.reshape(12, 3)
    f[15:27, 6:9] = blk_v.reshape(12, 3)
    f[15:27, 12:15] = blk_bg.reshape(12, 3)
    for k in range(4):  # block diagonal over the corners
        f[15 + 3 * k:18 + 3 * k, 15 + 3 * k:18 + 3 * k] = blk_pt[k]

    fw = state.p.new_zeros((27, 15))
    fw[0:3, 0:3] = -f[0:3, 12:15]
    fw[0:3, 12:15] = dt * eye3
    fw[3:6, 0:3] = -f[3:6, 12:15]
    fw[6:9, 0:3] = -f[6:9, 12:15]
    fw[6:9, 3:6] = dt * eye3
    fw[9:12, 6:9] = dt * eye3
    fw[12:15, 9:12] = dt * eye3
    fw[15:27, 0:3] = -f[15:27, 12:15]
    return f, fw


def propagate_step(state: FilterState, params: FilterParams, w_m, a_m, dt) -> FilterState:
    """One IMU interval: new mean + P <- F P Fᵀ + Fw Q Fwᵀ. dt == 0 is an
    exact identity."""
    new_mean = predict_mean(state, params, w_m, a_m, dt)
    f, fw = compute_jacobians(state, params, w_m, a_m, dt)
    new_cov = f @ state.cov @ f.T + fw @ params.q_noise @ fw.T
    new_mean = new_mean._replace(cov=new_cov)
    if state.bias is not None:
        # OU bias block: joint transition diag(F, rho I8), so
        # C <- rho F C, B <- rho^2 B + (1 - rho^2) s^2 I; dt = 0 -> rho = 1
        rho = torch.exp(-dt / params.bias_tau)
        eye8 = torch.eye(8, dtype=state.p.dtype, device=state.p.device)
        new_mean = new_mean._replace(
            bias=rho * state.bias,
            cov_xb=rho * (f @ state.cov_xb),
            cov_bb=(rho**2 * state.cov_bb
                    + (1.0 - rho**2) * params.bias_sigma * params.bias_sigma * eye8),
        )
    return new_mean


def propagate_window(state: FilterState, params: FilterParams, w_win, a_win,
                     dt_win, n_used: Optional[int] = None) -> FilterState:
    """Propagate over a frame's IMU window.

    Args:
        w_win, a_win: (T, 3) interval-midpoint gyro / accel.
        dt_win: (T,) interval lengths; dt == 0 entries are padding.
        n_used: number of real intervals at the front of the window, known
            on the host; the padding after them is skipped. None runs all T.
    """
    steps = dt_win.shape[0] if n_used is None else int(n_used)
    for k in range(steps):
        state = propagate_step(state, params, w_win[k], a_win[k], dt_win[k])
    return state

"""IMU preintegration (cpi parity) as pose-graph factors.

Counterpart of ``cuahn_vio.vision.preint`` (the reference's
ov_core/src/cpi/, OpenVINS continuous preintegration): the relative-motion
summary of an IMU interval, Delta R (a quaternion), Delta v and Delta p
with their bias Jacobians, so a smoother can use IMU factors between
keyframes without re-integrating raw samples each iteration. The
integration is a loop over the (masked, padded) sample window, the
filter's windowing: rows with dt == 0 change nothing. The five bias
Jacobians come from ``torch.func.jacfwd`` of the integrator, as the JAX
function's ``jax.jacfwd``.

Conventions match the filter (Hamilton wxyz, right-increment, FLU gravity).
``preintegrate`` takes one window (T, ...) or a batch (..., T, ...): a
batch is ``torch.func.vmap`` of the one-window function.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cuahn_vio_torch.ops.quat import quat_exp, quat_mul, quat_normalize, quat_to_rot


class PreintFactor(NamedTuple):
    dq: torch.Tensor  # (4,) Delta orientation, body_start -> body_end
    dv: torch.Tensor  # (3,) Delta velocity in the start body frame (gravity-free)
    dp: torch.Tensor  # (3,) Delta position in the start body frame (gravity-free)
    dt: torch.Tensor  # () total integration time
    j_q_bg: torch.Tensor  # (3, 3) d(theta)/d(bg)
    j_v_bg: torch.Tensor  # (3, 3)
    j_v_ba: torch.Tensor  # (3, 3)
    j_p_bg: torch.Tensor  # (3, 3)
    j_p_ba: torch.Tensor  # (3, 3)


def _integrate(w_win, a_win, dt_win, bg, ba):
    """Midpoint preintegration of one padded window (T, 3) / (T,); dt == 0
    rows are no-ops (the imu_window padding convention)."""
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=w_win.dtype, device=w_win.device)
    v = torch.zeros(3, dtype=w_win.dtype, device=w_win.device)
    p = torch.zeros(3, dtype=w_win.dtype, device=w_win.device)
    for k in range(w_win.shape[0]):
        dt = dt_win[k]
        w_hat = w_win[k] - bg
        a_hat = a_win[k] - ba
        acc = quat_to_rot(q) @ a_hat  # into the start frame
        p_new = p + v * dt + 0.5 * acc * dt * dt
        v_new = v + acc * dt
        q_new = quat_normalize(quat_mul(q, quat_exp(w_hat * dt)))
        keep = dt > 0
        q = torch.where(keep, q_new, q)
        v = torch.where(keep, v_new, v)
        p = torch.where(keep, p_new, p)
    return q, v, p


def _preintegrate_one(w_win, a_win, dt_win, bg, ba):
    q, v, p = _integrate(w_win, a_win, dt_win, bg, ba)

    def vp_of_biases(b):
        _, v_, p_ = _integrate(w_win, a_win, dt_win, b[:3], b[3:])
        return torch.cat([v_, p_])

    conj = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)

    def theta_of_bg(b):
        q_, _, _ = _integrate(w_win, a_win, dt_win, b, ba)
        # right-error angle of q_ relative to q
        return 2.0 * quat_mul(q * conj, q_)[1:4]

    j_vp = torch.func.jacfwd(vp_of_biases)(torch.cat([bg, ba]))
    j_q_bg = torch.func.jacfwd(theta_of_bg)(bg)
    return (q, v, p, torch.sum(dt_win), j_q_bg, j_vp[:3, :3], j_vp[:3, 3:], j_vp[3:, :3],
            j_vp[3:, 3:])


def preintegrate(w_win: torch.Tensor, a_win: torch.Tensor, dt_win: torch.Tensor,
                 bg: torch.Tensor, ba: torch.Tensor) -> PreintFactor:
    """Preintegrated IMU factors with autodiff bias Jacobians.

    Args:
        w_win: (..., T, 3) gyro samples (midpoint-averaged).
        a_win: (..., T, 3) accel samples.
        dt_win: (..., T) interval lengths, 0 = padding.
        bg, ba: (..., 3) gyro / accel bias linearization points.
    Returns:
        a PreintFactor whose fields carry the leading dims.
    """
    fn = _preintegrate_one
    for _ in range(dt_win.dim() - 1):
        fn = torch.func.vmap(fn)
    return PreintFactor(*fn(w_win, a_win, dt_win, bg, ba))


def predict_from_factor(f: PreintFactor, q_i2w: torch.Tensor, p_w: torch.Tensor,
                        v_w: torch.Tensor, gravity: torch.Tensor,
                        dbg: Optional[torch.Tensor] = None,
                        dba: Optional[torch.Tensor] = None):
    """Apply a preintegrated factor: the world-frame end state (q, p, v)
    from the start orientation body->world (4,), position (3,), velocity
    (3,) and gravity (3,), e.g. [0, 0, -9.81] (the measurement model of an
    IMU factor in the smoother). First-order bias correction by ``dbg`` /
    ``dba`` (bias deltas from the linearization point) through the stored
    Jacobians."""
    def mv(m, x):
        return (m @ x[..., None])[..., 0]

    dq, dv, dp = f.dq, f.dv, f.dp
    if dbg is not None:
        dq = quat_normalize(quat_mul(dq, quat_exp(mv(f.j_q_bg, dbg))))
        dv = dv + mv(f.j_v_bg, dbg)
        dp = dp + mv(f.j_p_bg, dbg)
    if dba is not None:
        dv = dv + mv(f.j_v_ba, dba)
        dp = dp + mv(f.j_p_ba, dba)
    r0 = quat_to_rot(q_i2w)
    dt = f.dt[..., None]
    q_end = quat_normalize(quat_mul(q_i2w, dq))
    v_end = v_w + gravity * dt + mv(r0, dv)
    p_end = p_w + v_w * dt + 0.5 * gravity * dt * dt + mv(r0, dp)
    return q_end, p_end, v_end

"""Cumulative SE(3) B-spline trajectory, differentiable.

Counterpart of ``cuahn_vio.data.bspline`` (the reference's BsplineSE3,
ov_core/src/sim/BsplineSE3.{h,cpp}): a cumulative cubic B-spline over
control poses, evaluated with torch ops in float32. Only the pose map is
written down; the IMU (angular rate, specific force) is
``torch.func.jacfwd`` of it, twice for the acceleration, on the interface
of ``data.synthetic.AnalyticTrajectory`` (``pos_w``, ``quat_i2w``,
``imu_true``, ``state_gt``), so ``make_sequence`` takes either trajectory
and ``vmap``s it over time.

``from_trajectory_file`` loads a '# t x y z qx qy qz qw' txt (Simulator.cpp
:50-76), resampled at a uniform knot spacing by nearest-time pick.

Cumulative cubic basis on [t_i, t_i+dt), u=(t-t_i)/dt, controls
T_{i-1},T_i,T_{i+1},T_{i+2} (BsplineSE3.cpp:95-118):
    T(u) = T_{i-1} exp(b1(u) O_i) exp(b2(u) O_{i+1}) exp(b3(u) O_{i+2})
    O_j  = log(T_{j-1}^-1 T_j)
    b1 = (5 + 3u - 3u^2 + u^3)/6, b2 = (1 + 3u + 3u^2 - 2u^3)/6, b3 = u^3/6

Derivatives follow the JAX functions' where they are not smooth: ``pose``
clamps t as ``jnp.clip`` does, whose derivative at either bound is 0.5
(``torch.clamp``'s is 1), so an IMU sample at exactly ``t_min`` or
``t_max - 1e-6`` gets the JAX spline's half rate and quarter acceleration;
``_rot_coeffs``' Taylor branches take a safe input where they are not
taken (double where), so no NaN reaches a tangent at theta = 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from cuahn_vio_torch.ops.quat import quat_to_rot, rot_to_quat, skew


def _clip(t, lo: float, hi: float):
    """``jnp.clip(t, lo, hi)``: max then min, each of whose derivatives is
    0.5 where its two arguments tie."""
    return torch.minimum(torch.maximum(t, torch.full_like(t, lo)), torch.full_like(t, hi))


def _dot3(w):
    return w[0] * w[0] + w[1] * w[1] + w[2] * w[2]


def _rot_coeffs(theta2):
    """(sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with Taylor branches under
    theta^2 < 1e-8, smooth (and twice differentiable) through theta = 0."""
    small = theta2 < 1e-8
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe * theta))
    return a, b, c


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, small-angle safe: (3,) -> (3, 3)."""
    a, b, _ = _rot_coeffs(_dot3(w))
    wx = skew(w)
    return _eye3(w) + a * wx + b * (wx @ wx)


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """(3, 3) -> (3,) rotation vector; the angle's cosine clipped to
    +-(1 - 1e-7), as the JAX function clips it."""
    tr = torch.clamp((rot[0, 0] + rot[1, 1] + rot[2, 2] - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(tr)
    vee = 0.5 * torch.stack(
        [rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]])
    s = torch.sin(theta)
    scale = torch.where(theta < 1e-6, torch.ones_like(theta),
                        theta / torch.clamp(s, min=1e-12))
    return scale * vee


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V such that the se3_exp translation is V @ rho."""
    _, b, c = _rot_coeffs(_dot3(w))
    wx = skew(w)
    return _eye3(w) + b * wx + c * (wx @ wx)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi = [rho(3), w(3)] -> (4, 4) (translation first, as the pose-graph
    module's [p, theta])."""
    rho, w = xi[:3], xi[3:]
    top = torch.cat([so3_exp(w), (_left_jacobian(w) @ rho)[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=0)


def se3_log(t4: torch.Tensor) -> torch.Tensor:
    w = so3_log(t4[:3, :3])
    vinv = torch.linalg.inv(_left_jacobian(w))
    return torch.cat([vinv @ t4[:3, 3], w])


class SplineTrajectory:
    """Differentiable cumulative cubic B-spline over uniform control poses,
    with the ``AnalyticTrajectory`` interface. ``t`` is a 0-dim float32
    tensor on any device; the spline's tensors follow it there."""

    def __init__(self, control_T: np.ndarray, dt: float, t0: float = 0.0):
        """control_T: (N, 4, 4) poses at t0 + i*dt (N >= 4)."""
        if control_T.shape[0] < 4:
            raise ValueError("need >= 4 control poses")
        self.ctrl = torch.as_tensor(np.asarray(control_T), dtype=torch.float32)
        self.dt = float(dt)
        self.t0 = float(t0)
        # relative twists O_j = log(T_{j-1}^-1 T_j), (N-1, 6)
        rel = torch.einsum("nij,njk->nik", torch.linalg.inv(self.ctrl[:-1]), self.ctrl[1:])
        self.omega = vmap(se3_log)(rel)
        self.t_min = self.t0 + self.dt  # first valid segment start
        # the last valid segment is i = N-3 (it uses omega[N-2], the final
        # twist): queries are valid on [t0+dt, t0+(N-2)dt)
        self.t_max = self.t0 + (control_T.shape[0] - 2) * self.dt
        self._on = {}

    def _tensors(self, device):
        if device not in self._on:
            self._on[device] = (self.ctrl.to(device), self.omega.to(device))
        return self._on[device]

    @classmethod
    def from_trajectory_file(cls, path: str, dt: float = 0.1, z_offset: float = 0.0):
        """Load a '# t x y z qx qy qz qw' txt, resampled at uniform ``dt`` by
        nearest-time pick, shifted up by ``z_offset`` (a mocap-frame
        trajectory over the synthetic z = 0 ground), its time axis
        zero-based."""
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                v = [float(x) for x in line.replace(",", " ").split()]
                if len(v) >= 8:
                    rows.append(v[:8])
        arr = np.asarray(rows)
        if arr.shape[0] < 4:
            raise ValueError(f"{path}: fewer than 4 poses")
        times = arr[:, 0]
        grid = np.arange(times[0], times[-1], dt)
        # nearest time: searchsorted gives the first at or after; keep the
        # previous sample where it is at least as close
        idx = np.clip(np.searchsorted(times, grid), 1, len(times) - 1)
        pick_prev = np.abs(times[idx - 1] - grid) <= np.abs(times[idx] - grid)
        idx = np.where(pick_prev, idx - 1, idx)
        q = arr[idx, 4:8]  # xyzw in the file
        qwxyz = torch.tensor(q[:, [3, 0, 1, 2]], dtype=torch.float32)
        ctrl = np.zeros((len(grid), 4, 4))
        ctrl[:, :3, :3] = quat_to_rot(qwxyz).numpy()
        ctrl[:, :3, 3] = arr[idx, 1:4] + [0.0, 0.0, z_offset]
        ctrl[:, 3, 3] = 1.0
        return cls(ctrl, dt, t0=0.0)

    def pose(self, t) -> torch.Tensor:
        """(4, 4) body->world pose at time t (clamped to the valid span)."""
        ctrl, omega = self._tensors(t.device)
        t = _clip(t, self.t_min, self.t_max - 1e-6)
        s = (t - self.t0) / self.dt
        i = torch.clamp(torch.floor(s).to(torch.int64), 1, ctrl.shape[0] - 3)
        u = s - i.to(s.dtype)
        u2, u3 = u * u, u * u * u
        b1 = (5.0 + 3.0 * u - 3.0 * u2 + u3) / 6.0
        b2 = (1.0 + 3.0 * u + 3.0 * u2 - 2.0 * u3) / 6.0
        b3 = u3 / 6.0
        rows = torch.stack([i - 1, i, i + 1]).reshape(3)
        base = torch.index_select(ctrl, 0, rows[:1])[0]
        om = torch.index_select(omega, 0, rows)
        return base @ se3_exp(b1 * om[0]) @ se3_exp(b2 * om[1]) @ se3_exp(b3 * om[2])

    # --- AnalyticTrajectory interface -----------------------------------
    def pos_w(self, t) -> torch.Tensor:
        return self.pose(t)[:3, 3]

    def quat_i2w(self, t) -> torch.Tensor:
        return rot_to_quat(self.pose(t)[:3, :3])

    def imu_true(self, t, gravity_mag: float = 9.81):
        """True (w_body, specific force) at t, by autodiff of the pose map."""
        rot = self.pose(t)[:3, :3]
        drot = jacfwd(lambda tt: self.pose(tt)[:3, :3])(t)
        wx = rot.T @ drot  # body angular velocity, skew form
        w_body = torch.stack([wx[2, 1], wx[0, 2], wx[1, 0]])
        acc_w = jacfwd(jacfwd(self.pos_w))(t)
        g_w = torch.tensor([0.0, 0.0, -gravity_mag], dtype=t.dtype, device=t.device)
        return w_body, rot.T @ (acc_w - g_w)

    def state_gt(self, t):
        """(rot^T p, the wxyz quaternion, rot^T v) at t, as the JAX spline."""
        t4 = self.pose(t)
        rot = t4[:3, :3]
        return rot.T @ t4[:3, 3], rot_to_quat(rot), rot.T @ jacfwd(self.pos_w)(t)

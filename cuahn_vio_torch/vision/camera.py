"""Per-point camera distortion models (radtan + equidistant), on tensors.

Counterpart of ``cuahn_vio.vision.camera``: pure functions over a
calibration tensor, on points of any leading shape, in float32; the
measurement Jacobians are ``torch.func.jacfwd`` of the forward model.

Calibration layout is the reference's 8-vector (CamBase.h set_value):
``[fx, fy, cx, cy, k1, k2, k3|p1, k4|p2]``: radtan uses (k1, k2, p1, p2)
plumb-bob, equidistant uses Kannala-Brandt (k1..k4).

The equidistant model branches at the optical axis (``r > 1e-8`` and
``theta_d > 1e-8``, as the JAX functions do). Here the branch that is not
taken sees a safe input (the double-where pattern), so the 0/0 of a point
on the axis reaches neither a value nor a tangent, forward or reverse.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

_UNDISTORT_ITERS = 20  # fixed-point iterations, as the JAX functions run
_AXIS = 1e-8  # radius under which a point is on the optical axis


def _split(calib: torch.Tensor):
    return [calib[i] for i in range(8)]


# ------------------------------------------------------------------ radtan
def distort_radtan(uv_norm: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    """Normalized camera coords (..., 2) -> raw distorted pixels (plumb-bob
    k1 k2 p1 p2, then the camera matrix)."""
    fx, fy, cx, cy, k1, k2, p1, p2 = _split(calib)
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def undistort_radtan(uv_dist: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    """Raw distorted pixels (..., 2) -> normalized camera coords:
    fixed-point inversion of the distortion polynomial."""
    fx, fy, cx, cy, k1, k2, p1, p2 = _split(calib)
    xd = (uv_dist[..., 0] - cx) / fx
    yd = (uv_dist[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


# ------------------------------------------------------------- equidistant
def _off_axis(sq: torch.Tensor):
    """(mask of points off the optical axis, sqrt of ``sq`` there and 1.0
    on the axis): the radius the off-axis branch may divide by."""
    off = torch.sqrt(sq) > _AXIS
    return off, torch.sqrt(torch.where(off, sq, torch.ones_like(sq)))


def distort_equidistant(uv_norm: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    """Normalized camera coords (..., 2) -> raw fisheye pixels
    (Kannala-Brandt theta-polynomial)."""
    fx, fy, cx, cy, k1, k2, k3, k4 = _split(calib)
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    off, r = _off_axis(x * x + y * y)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    # r -> 0: theta_d / r -> 1
    scale = torch.where(off, theta_d / r, torch.ones_like(r))
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def undistort_equidistant(uv_dist: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    """Raw fisheye pixels (..., 2) -> normalized camera coords: fixed-point
    solve of theta from theta_d, then rescale the ray."""
    fx, fy, cx, cy, k1, k2, k3, k4 = _split(calib)
    xd = (uv_dist[..., 0] - cx) / fx
    yd = (uv_dist[..., 1] - cy) / fy
    off, theta_d = _off_axis(xd * xd + yd * yd)
    theta = theta_d
    for _ in range(_UNDISTORT_ITERS):
        t2 = theta * theta
        theta = theta_d / (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(off, torch.tan(theta) / theta_d, torch.ones_like(theta_d))
    return torch.stack([xd * scale, yd * scale], dim=-1)


# ------------------------------------------------------------- dispatch
def distort(uv_norm, calib, fisheye: bool):
    return (distort_equidistant if fisheye else distort_radtan)(uv_norm, calib)


def undistort(uv_dist, calib, fisheye: bool):
    return (undistort_equidistant if fisheye else undistort_radtan)(uv_dist, calib)


def distort_jacobian(uv_norm: torch.Tensor, calib: torch.Tensor, fisheye: bool):
    """d(raw pixel)/d(normalized) and d(raw pixel)/d(calib), by
    ``torch.func.jacfwd`` of the forward model: (2, 2) and (2, 8) for one
    point, the JAX function's shapes for any other input."""
    fn = distort_equidistant if fisheye else distort_radtan
    return jacfwd(fn, argnums=0)(uv_norm, calib), jacfwd(fn, argnums=1)(uv_norm, calib)


def undistort_points(uv_dist: torch.Tensor, calib: torch.Tensor, fisheye: bool):
    """(N, 2) raw pixels -> (N, 2) normalized coords (each point on its own,
    as the JAX function's ``vmap``)."""
    return undistort(uv_dist, calib, fisheye)

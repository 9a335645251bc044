"""Exact corner flow between two camera poses over the ground plane.

Counterpart of ``cuahn_vio.data.oracle``, batched over leading dims: the
4-point optical flow that the UAHN estimates from images, computed from
the poses alone. The trainer's labels come from it.
"""

from __future__ import annotations

import functools

import torch

from cuahn_vio_torch.filter.state import CORNER_XY1, FOCAL
from cuahn_vio_torch.ops.quat import quat_to_rot


@functools.lru_cache(maxsize=None)
def _corner_xy1(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(CORNER_XY1, device=device)


def camera_pose(p_w, q_i2w, c_rot_i, i_t_i2c):
    """(R_CtoW (..., 3, 3), camera centre (..., 3)) of IMU poses p_w (...,
    3), q_i2w (..., 4) under the extrinsics c_rot_i (3, 3), i_t_i2c (3,)."""
    rot_i2w = quat_to_rot(q_i2w)
    return rot_i2w @ c_rot_i.T, p_w + (rot_i2w @ i_t_i2c[:, None])[..., 0]


def true_corner_flow(p_w1, q1, p_w2, q2, c_rot_i, i_t_i2c) -> torch.Tensor:
    """Exact corner flow (..., 8) in pixels from frame-1 corners to their
    ground-plane correspondences in frame 2.

    Corner k of frame 1 back-projects along the bearing CORNER_XY1[k] to
    the plane z = 0; its projection into camera 2 is the corresponding
    pixel, and the flow is that pixel minus the corner (State.h:110-113).
    """
    r1, c1 = camera_pose(p_w1, q1, c_rot_i, i_t_i2c)
    r2, c2 = camera_pose(p_w2, q2, c_rot_i, i_t_i2c)
    xy1 = _corner_xy1(p_w1.device)  # (4, 3)
    bear_w = xy1 @ r1.transpose(-1, -2)  # (..., 4, 3) corner rays in world
    lam = -c1[..., None, 2] / bear_w[..., 2]  # (..., 4): meet z = 0
    ground = c1[..., None, :] + lam[..., None] * bear_w
    x_c2 = (ground - c2[..., None, :]) @ r2  # (..., 4, 3) in camera 2
    xy2 = x_c2[..., :2] / x_c2[..., 2:3]
    return ((xy2 - xy1[:, :2]) * FOCAL).reshape(*xy2.shape[:-2], 8)

"""Homography-aware synthetic data: planar ground scenes + exact IMU.

Counterpart of ``cuahn_vio.data.synthetic`` with the procedural and the
photo-texture ground and exposure blur (sensor effects are not ported
yet, and are refused):

- ``AnalyticTrajectory``: closed-form p(t), q(t); body rates and specific
  force from ``torch.func.jacfwd`` of the closed forms (exact IMU);
- ``ground_texture``: a sum of random sinusoids; its frequencies, signs
  and phases are arrays, so a caller can pass in any draw;
- ``render_frame``: ray-casts every virtual-camera pixel (f = 159.5) onto
  the z = 0 ground plane and samples the procedural ground or a photo
  texture (``data/textures.sample_plane``, the B4 kernel on CUDA), at one
  pose or at many in one pass;
- ``render_frame_blurred``: the mean of the renders at the poses of an
  exposure window (motion blur);
- ``make_sequence``: IMU stream (optional noise/biases from a numpy seed)
  + uint8 camera frames + ground truth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from cuahn_vio_torch.data.textures import default_tex_params, sample_plane, texture_u8
from cuahn_vio_torch.ops.quat import quat_exp, quat_mul, quat_to_rot
from cuahn_vio_torch.ops.warp import virtual_cam_k


@dataclass(frozen=True)
class AnalyticTrajectory:
    """Smooth figure-flight over the ground plane, all closed-form.

    p_w(t) = [ax(1-cos wx t), ay(1-cos wy t), h0 + az(1-cos wz t)], starting
    from rest; attitude = small roll/pitch rocking + slow yaw drift.
    ``t`` is a 0-dim float32 tensor.
    """

    ax: float = 1.2
    ay: float = 0.9
    az: float = 0.25
    wx: float = 0.9
    wy: float = 0.7
    wz: float = 1.1
    h0: float = 1.5
    roll_amp: float = 0.12
    pitch_amp: float = 0.10
    yaw_rate: float = 0.15
    w_rock: float = 1.7

    def pos_w(self, t):
        return torch.stack(
            [
                self.ax * (1.0 - torch.cos(self.wx * t)),
                self.ay * (1.0 - torch.cos(self.wy * t)),
                self.h0 + self.az * (1.0 - torch.cos(self.wz * t)),
            ]
        )

    def quat_i2w(self, t):
        rv = torch.stack(
            [
                self.roll_amp * torch.sin(self.w_rock * t),
                self.pitch_amp * torch.sin(self.w_rock * 0.83 * t),
                self.yaw_rate * t,
            ]
        )
        return quat_exp(rv)

    def imu_true(self, t, gravity_mag: float = 9.81):
        """Exact body rates and specific force at time t:
        w_body = 2 vec(q* ⊗ q̇), f_body = R(t)ᵀ (p̈_w − g_w)."""
        q = self.quat_i2w(t)
        # forward-mode AD promotes python-scalar products to float64
        qdot = jacfwd(self.quat_i2w)(t).to(t.dtype)
        q_conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
        w_body = 2.0 * quat_mul(q_conj, qdot)[1:4]
        acc_w = jacfwd(jacfwd(self.pos_w))(t).to(t.dtype)
        g_w = torch.tensor([0.0, 0.0, -gravity_mag], dtype=t.dtype, device=t.device)
        f_body = quat_to_rot(q).T @ (acc_w - g_w)
        return w_body, f_body


def texture_draws(texture_seed: int = 0, n_waves: int = 24):
    """The port's own random ground: (freqs (n, 2), signs (n, 2), phases
    (n,)) from a numpy seed."""
    rng = np.random.default_rng(texture_seed)
    freqs = rng.uniform(0.5, 14.0, (n_waves, 2))
    signs = np.sign(rng.normal(size=(n_waves, 2)))
    phases = rng.uniform(0.0, 2 * math.pi, n_waves)
    return freqs.astype(np.float32), signs.astype(np.float32), phases.astype(np.float32)


def ground_texture(xy: torch.Tensor, freqs: torch.Tensor, signs: torch.Tensor,
                   phases: torch.Tensor) -> torch.Tensor:
    """Procedural grayscale texture in [0, 1] at world (x, y) points (..., 2)."""
    n = phases.shape[0]
    f = freqs * signs  # (n, 2)
    amps = 1.0 / torch.sqrt(
        torch.arange(1, n + 1, dtype=torch.float32, device=xy.device)
    )
    waves = torch.sin(xy @ f.T + phases)  # (..., n)
    return 0.5 + 0.5 * (waves @ (amps / amps.sum()))


def _mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 3, 3) @ (..., 3, n) as elementwise products and adds,
    so that each matrix of a stack is rounded as it is alone (a batched
    matmul may take another kernel, and another rounding, per batch size)."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def ground_points(p_w, q_i2w, c_rot_i, i_t_i2c, height: int = 224, width: int = 320):
    """Where each pixel's ray meets the ground plane z = 0: (H, W, 2) world
    (x, y), and the (H, W) ray parameter, > 0 where the ray hits the plane
    in front of the camera. Poses (K, 3) / (K, 4) give (K, H, W, 2) and
    (K, H, W) in one pass, each tap equal bit for bit to its pose alone."""
    dev = p_w.device
    _, k_inv = virtual_cam_k(height, width, device=dev)
    rot_i2w = quat_to_rot(q_i2w)
    rot_c2w = _mat3(rot_i2w, c_rot_i.T)
    cam_center = p_w + _mat3(rot_i2w, i_t_i2c[:, None])[..., 0]
    u = torch.arange(width, dtype=torch.float32, device=dev)
    v = torch.arange(height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    pix = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)  # (H, W, 3)
    d_cam = pix @ k_inv.T  # the same for every pose
    r = rot_c2w[..., None, None, :, :]  # (..., 1, 1, 3, 3)
    d_w = (d_cam[..., 0:1] * r[..., 0] + d_cam[..., 1:2] * r[..., 1]
           + d_cam[..., 2:3] * r[..., 2])  # (..., H, W, 3)
    c = cam_center[..., None, None, :]
    lam = -c[..., 2] / d_w[..., 2]
    return c[..., :2] + lam[..., None] * d_w[..., :2], lam


def render_frame(p_w, q_i2w, c_rot_i, i_t_i2c, waves=None,
                 height: int = 224, width: int = 320,
                 texture: Optional[torch.Tensor] = None,
                 tex_params: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The virtual camera's (H, W) float32 view of the textured ground, in
    [0, 1]; rays that miss the plane render 0. Poses (K, 3) / (K, 4) give
    the (K, H, W) views in one pass, with one texture lookup for all.

    The ground is the photo ``texture`` ((T, T) uint8 or float32 on the
    device, mapped by ``tex_params``, default ``default_tex_params()``)
    when given, else the procedural ground of ``waves`` = (freqs, signs,
    phases) tensors.
    """
    ground, lam = ground_points(p_w, q_i2w, c_rot_i, i_t_i2c, height, width)
    if texture is not None:
        if tex_params is None:
            tex_params = default_tex_params().to(p_w.device)
        tex = sample_plane(texture, ground, tex_params)
    else:
        tex = ground_texture(ground, *waves)
    return torch.where(lam > 0, tex, torch.zeros_like(tex))


def render_frame_blurred(p_taps, q_taps, c_rot_i, i_t_i2c, waves=None,
                         height: int = 224, width: int = 320,
                         texture: Optional[torch.Tensor] = None,
                         tex_params: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Motion-blurred frame: the float32 mean of ``render_frame`` at the K
    exposure-window poses ``p_taps`` (K, 3) / ``q_taps`` (K, 4), each tap a
    sharp render of the same rigid scene. All K taps are rendered in one
    pass (on a photo texture, one launch of the sampler over K x H x W
    points), each equal bit for bit to its ``render_frame``."""
    imgs = render_frame(p_taps, q_taps, c_rot_i, i_t_i2c, waves, height, width, texture,
                        tex_params)
    return imgs.sum(dim=0) / imgs.shape[0]


def exposure_taps(traj: AnalyticTrajectory, times, exposure_s: float, device):
    """(F, K, 3) positions and (F, K, 4) quaternions of each frame's render
    poses: K = 3 spread over the exposure window that ends at ``times``
    (F,) seconds into the motion, or K = 1 at ``times`` when ``exposure_s``
    is 0. Tap times are clamped to >= 0, so frames of the still phase stay
    still."""
    n_taps = 3 if exposure_s > 0.0 else 1
    tap_off = np.linspace(-exposure_s, 0.0, n_taps)
    tap_t = np.maximum(np.asarray(times, np.float64)[:, None] + tap_off[None, :], 0.0)
    p, q = vmap(lambda t: (traj.pos_w(t), traj.quat_i2w(t)))(
        torch.tensor(tap_t.reshape(-1), dtype=torch.float32, device=device)
    )
    return p.reshape(len(tap_t), n_taps, 3), q.reshape(len(tap_t), n_taps, 4)


class SyntheticSequence(NamedTuple):
    imu_t: np.ndarray  # (N,)
    imu_w: np.ndarray  # (N, 3) gyro measurements (noise + bias included)
    imu_a: np.ndarray  # (N, 3) accel measurements
    cam_t: np.ndarray  # (F,)
    frames: np.ndarray  # (F, H, W) uint8
    gt_times: np.ndarray  # (N,)
    gt_pose_w: np.ndarray  # (N, 7) [x y z qx qy qz qw] world frame
    gt_vel_w: np.ndarray  # (N, 3) world-frame velocity
    true_bg: np.ndarray
    true_ba: np.ndarray


def make_sequence(
    traj: AnalyticTrajectory,
    t_imu_to_cam,
    duration: float = 20.0,
    imu_hz: float = 500.0,
    cam_hz: float = 30.0,
    t_still: float = 2.5,
    seed: int = 0,
    sigma_w: float = 0.0,
    sigma_a: float = 0.0,
    bias_g: float = 0.0,
    bias_a: float = 0.0,
    texture_seed: int = 0,
    gravity_mag: float = 9.81,
    texture=None,
    tex_params=None,
    exposure_s: float = 0.0,
    effects=None,
    device="cuda",
) -> SyntheticSequence:
    """Synthetic flight: t_still seconds hovering at traj(0) (so the jerk
    initializer fires), then the analytic trajectory.

    The ground:
        texture: None draws a procedural ground from ``texture_seed`` with
            ``texture_draws``; a (freqs, signs, phases) tuple is such a
            draw; a (T, T) array is a photo texture at uint8 levels (a
            ``data/textures`` bank entry, float32 k/255 or uint8), held on
            ``device`` as uint8 once for the whole sequence and mapped onto
            the ground by ``tex_params`` (5,) (default
            ``default_tex_params()``).
        exposure_s: camera exposure time; > 0 renders each frame as
            ``render_frame_blurred`` over 3 poses spread across the exposure
            window that ends at the frame's time (physical motion blur).
        effects (the sensor-effect chain) is not ported yet and raises.
    Frames are rendered on ``device``, one texture lookup each (one launch
    of the sampler on a photo texture); everything returned is numpy.
    """
    if effects is not None:
        raise NotImplementedError("sensor effects are not ported yet")
    rng = np.random.default_rng(seed)
    t_imu_to_cam = np.asarray(t_imu_to_cam, np.float64)
    c_rot_i = torch.tensor(t_imu_to_cam[:3, :3], dtype=torch.float32, device=device)
    i_t_i2c = torch.tensor(
        -t_imu_to_cam[:3, :3].T @ t_imu_to_cam[:3, 3], dtype=torch.float32,
        device=device,
    )

    imu_t = np.arange(0.0, t_still + duration, 1.0 / imu_hz)
    shifted = np.maximum(imu_t - t_still, 0.0)
    t_dev = torch.tensor(shifted, dtype=torch.float32, device=device)
    w_true, a_true = vmap(lambda t: traj.imu_true(t, gravity_mag))(t_dev)
    w_true = w_true.cpu().numpy().astype(np.float64)
    a_true = a_true.cpu().numpy().astype(np.float64)
    # still phase: hover at the t=0 pose
    zero = torch.zeros((), dtype=torch.float32)
    r0 = quat_to_rot(traj.quat_i2w(zero)).numpy().astype(np.float64)
    still = imu_t < t_still
    w_true[still] = 0.0
    a_true[still] = r0.T @ np.array([0.0, 0.0, gravity_mag])

    bg = rng.normal(size=3) * bias_g
    ba = rng.normal(size=3) * bias_a
    imu_w = w_true + bg + rng.normal(size=w_true.shape) * sigma_w
    imu_a = a_true + ba + rng.normal(size=a_true.shape) * sigma_a

    cam_t = np.arange(t_still + 0.2, t_still + duration, 1.0 / cam_hz)
    waves = tex_dev = tp_dev = None
    if texture is None or isinstance(texture, tuple):
        draws = texture_draws(texture_seed) if texture is None else texture
        waves = [torch.tensor(np.asarray(x, np.float32), device=device) for x in draws]
    else:
        tex_dev = torch.as_tensor(texture_u8(texture), device=device)
        params = default_tex_params() if tex_params is None else tex_params
        tp_dev = torch.as_tensor(np.asarray(params, np.float32), device=device)
    p_taps, q_taps = exposure_taps(traj, cam_t - t_still, exposure_s, device)
    frames = np.zeros((len(cam_t), 224, 320), np.uint8)
    for i in range(len(cam_t)):
        img = render_frame_blurred(p_taps[i], q_taps[i], c_rot_i, i_t_i2c, waves,
                                   texture=tex_dev, tex_params=tp_dev)
        frames[i] = (img * 255.0).clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()

    # GT at IMU rate, world frame, file convention [x y z qx qy qz qw]
    p_all, q_all, v_all = vmap(
        lambda t: (traj.pos_w(t), traj.quat_i2w(t), jacfwd(traj.pos_w)(t).to(t.dtype))
    )(t_dev)
    p_all = p_all.cpu().numpy()
    q_all = q_all.cpu().numpy()
    v_all = v_all.cpu().numpy().astype(np.float64)
    v_all[still] = 0.0
    gt_pose = np.concatenate([p_all, q_all[:, [1, 2, 3, 0]]], axis=1)

    return SyntheticSequence(
        imu_t=imu_t, imu_w=imu_w, imu_a=imu_a, cam_t=cam_t, frames=frames,
        gt_times=imu_t, gt_pose_w=gt_pose, gt_vel_w=v_all,
        true_bg=bg, true_ba=ba,
    )

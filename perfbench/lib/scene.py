"""Synthetic flights over a planar ground, made by the benchmark itself.

A down-facing camera (the configuration's camera-IMU extrinsics and the
program's f = 159.5 px virtual pinhole at 224x320) over the z = 0 plane,
textured by a sum of random sinusoids (0.5-14 rad/m, as the program's
procedural ground), rendered on the device in batched torch ops: each
pixel's ray meets the plane, the texture is evaluated there, and the frame
is quantised to uint8. Poses and flows are float64 numpy on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_WAVES = 24
WAVE_FREQS = (0.5, 14.0)
FOV_DEG = 90.0


def intrinsics(h: int, w: int) -> np.ndarray:
    f = (w - 1) / 2.0 / math.tan(math.radians(FOV_DEG) / 2.0)
    return np.array([[f, 0.0, (w - 1) / 2.0], [0.0, f, (h - 1) / 2.0], [0.0, 0.0, 1.0]])


def extrinsics(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """(R_cam_from_imu, camera position in the IMU frame) of the config's
    ``t_imu_to_cam``."""
    t = np.asarray(cfg["t_imu_to_cam"], np.float64)
    return t[:3, :3], -t[:3, :3].T @ t[:3, 3]


def euler_to_rot(roll, pitch, yaw) -> np.ndarray:
    """(..., 3, 3) world-from-IMU rotations, R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr, cp, sp, cy, sy = (np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch),
                              np.cos(yaw), np.sin(yaw))
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        np.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


def camera_poses(r_wi: np.ndarray, p_wi: np.ndarray, cfg: dict):
    """(R_world_from_cam (N, 3, 3), camera centre (N, 3)) of IMU poses."""
    r_ci, t_ic = extrinsics(cfg)
    return r_wi @ r_ci.T, p_wi + r_wi @ t_ic


def ground_waves(rng: np.random.Generator, n: int = N_WAVES) -> tuple:
    freqs = rng.uniform(*WAVE_FREQS, size=(n, 2)) * rng.choice([-1.0, 1.0], size=(n, 2))
    phases = rng.uniform(0.0, 2.0 * math.pi, size=n)
    amps = 1.0 / np.sqrt(np.arange(1, n + 1))
    return freqs, phases, amps / amps.sum()


def render(r_wc: np.ndarray, c_w: np.ndarray, waves: tuple, h: int, w: int, device,
           chunk: int = 32) -> torch.Tensor:
    """(N, h, w) uint8 views of the ground from N camera poses; rays that
    miss the plane render 0."""
    k_inv = np.linalg.inv(intrinsics(h, w))
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    rays = torch.tensor(np.stack([uu, vv, np.ones_like(uu)], -1) @ k_inv.T,
                        dtype=torch.float32, device=device)  # (h, w, 3)
    freqs, phases, amps = (torch.tensor(x, dtype=torch.float32, device=device) for x in waves)
    out = torch.empty((len(c_w), h, w), dtype=torch.uint8, device=device)
    for s in range(0, len(c_w), chunk):
        r = torch.tensor(r_wc[s:s + chunk], dtype=torch.float32, device=device)
        c = torch.tensor(c_w[s:s + chunk], dtype=torch.float32, device=device)
        d = torch.einsum("nij,hwj->nhwi", r, rays)
        lam = -c[:, None, None, 2] / d[..., 2]
        xy = c[:, None, None, :2] + lam[..., None] * d[..., :2]
        tex = 0.5 + 0.5 * (torch.sin(xy @ freqs.T + phases) @ amps)
        tex = torch.where(lam > 0, tex, torch.zeros_like(tex))
        out[s:s + chunk] = (tex * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return out


def corner_flow(r_wc_i, c_i, r_wc_j, c_j, h: int, w: int) -> np.ndarray:
    """(N, 4, 2) pixels: where frame i's corners (UL, BL, BR, UR) land in
    frame j through the ground plane, less the corners."""
    k = intrinsics(h, w)
    px = np.array([[0.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0], [w - 1.0, 0.0]])
    rays = np.concatenate([px, np.ones((4, 1))], 1) @ np.linalg.inv(k).T  # (4, 3)
    d = np.einsum("nij,kj->nki", r_wc_i, rays)
    lam = -c_i[:, None, 2] / d[..., 2]
    g = c_i[:, None, :] + lam[..., None] * d  # (N, 4, 3) ground points
    x = np.einsum("nji,nkj->nki", r_wc_j, g - c_j[:, None, :])  # camera j frame
    uv = (x @ k.T)
    return uv[..., :2] / uv[..., 2:3] - px

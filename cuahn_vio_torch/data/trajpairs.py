"""Flight-realistic pose-pair bank for training, from UZH-FPV ground truth.

Counterpart of ``cuahn_vio.data.trajpairs``: consecutive-camera-frame world
pose pairs sampled from B-splines (``data/bspline``) of the UZH-FPV GT
trajectories (``*_with_gt.txt``), less the four sequences the benchmarks
replay, so evaluation trajectories stay held out. The trainer composes
each drawn pair with a random world yaw (``train.trainer.draw_pairs``).

The port looks for the files in ``data/uzh_fpv`` of the repository, where
they go once they are committed (the JAX package reads them from the
reference's checkout). It keeps no cache: the bank is built on the CPU
each time a trainer starts (the JAX package caches it in ``/tmp`` under a
name that does not depend on the directory, so two GT directories share
one bank there).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
from torch.func import vmap

GT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "uzh_fpv",
)

# benchmark replays: never trained on
EVAL_TRAJECTORIES = (
    "indoor_45_2", "indoor_45_4", "indoor_45_9", "indoor_forward_5",
)

Z_OFFSET = 1.7  # mocap frame -> ground plane at z=0 (same as the replays)
FRAME_DT = 1.0 / 30.0
MIN_HEIGHT = 0.4  # drop pairs that dip into / under the plane


def train_trajectory_files(gt_dir: str = GT_DIR) -> list[str]:
    """The GT trajectory files of ``gt_dir`` that training may use, sorted."""
    files = sorted(glob.glob(os.path.join(gt_dir, "*_with_gt.txt")))
    return [
        f for f in files
        if not any(os.path.basename(f).startswith(e) for e in EVAL_TRAJECTORIES)
    ]


def build_pose_pair_bank(
    gt_dir: str = GT_DIR,
    spline_dt: float = 0.1,
    z_offset: float = Z_OFFSET,
    frame_dt: float = FRAME_DT,
    stride: float = 1.0 / 30.0,
) -> dict:
    """{"p1", "q1", "p2", "q2"}: (N, 3) / (N, 4) float32 world poses (wxyz)
    of consecutive camera frames, every ``stride`` seconds along each
    training trajectory of ``gt_dir``; pairs under MIN_HEIGHT or not finite
    are dropped. Raises when ``gt_dir`` holds no training trajectory."""
    from cuahn_vio_torch.data.bspline import SplineTrajectory

    p1s, q1s, p2s, q2s = [], [], [], []
    for f in train_trajectory_files(gt_dir):
        traj = SplineTrajectory.from_trajectory_file(f, dt=spline_dt, z_offset=z_offset)
        ts = np.arange(traj.t_min, traj.t_max - frame_dt - 1e-3, stride)
        if len(ts) < 2:
            continue
        pose = vmap(lambda t: (traj.pos_w(t), traj.quat_i2w(t)))
        p1, q1 = (x.numpy() for x in pose(torch.tensor(ts, dtype=torch.float32)))
        p2, q2 = (x.numpy() for x in pose(torch.tensor(ts + frame_dt, dtype=torch.float32)))
        keep = (p1[:, 2] > MIN_HEIGHT) & (p2[:, 2] > MIN_HEIGHT)
        keep &= np.isfinite(p1).all(1) & np.isfinite(p2).all(1)
        p1s.append(p1[keep])
        q1s.append(q1[keep])
        p2s.append(p2[keep])
        q2s.append(q2[keep])
    if not p1s:
        raise ValueError(f"no training trajectory of >= 2 frames under {gt_dir}")
    return {k: np.concatenate(v).astype(np.float32)
            for k, v in (("p1", p1s), ("q1", q1s), ("p2", p2s), ("q2", q2s))}

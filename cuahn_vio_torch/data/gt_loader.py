"""UZH-FPV ground-truth loading (dataset_reader.h:61-113 format).

Counterpart of ``cuahn_vio.data.gt_loader``: the GT txt files ('#
timestamp(s) tx ty tz qx qy qz qw ...' rows at IMU rate) through the pose
loader, and the exact-timestamp state lookup of the reference's
RosVisualizer GT path.
"""

from __future__ import annotations

import numpy as np

from cuahn_vio_torch.eval.traj_io import Trajectory, load_pose_file


def load_gt_file(path: str) -> Trajectory:
    """Ground-truth trajectory: times + [x y z qx qy qz qw] (xyzw in the
    files; eval treats GT and estimate files alike, so conventions
    cancel)."""
    return load_pose_file(path)


def get_gt_state(traj: Trajectory, timestamp: float, tol: float = 0.005):
    """Exact-timestamp GT lookup (dataset_reader.h:113): (time, pose) of the
    sample nearest ``timestamp`` within ``tol`` seconds, or None."""
    idx = int(np.searchsorted(traj.times, timestamp))
    best, best_d = None, tol
    for i in (idx - 1, idx, idx + 1):
        if 0 <= i < len(traj.times):
            d = abs(traj.times[i] - timestamp)
            if d < best_d:
                best, best_d = i, d
    if best is None:
        return None
    return traj.times[best], traj.poses[best]

"""Trajectory error metrics: ATE / ATE-2D / RPE / NEES + Statistics.

A copy of ``cuahn_vio.eval.metrics`` (numpy only); ``error-singlerun``
prints them. Rebuilds ov_eval's calc stack in numpy:
- ``Statistics``        <- ov_eval/src/utils/Statistics.h:38-131
- ``ResultTrajectory``  <- ov_eval/src/calc/ResultTrajectory.{h,cpp}:
  association (20 ms tol), two-way alignment, calculate_ate (:69-96),
  calculate_ate_2d (:98-125), calculate_rpe (:127-228) with
  compute_comparison_indices_length (ResultTrajectory.h:167-196),
  calculate_nees (:230-270).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from cuahn_vio_torch.eval.align import (
    align_trajectory,
    apply_alignment,
    associate,
    jpl_quat_to_rot,
    log_so3,
)
from cuahn_vio_torch.eval.traj_io import Trajectory, load_pose_file


@dataclass
class Statistics:
    """Accumulator matching ov_eval::Statistics (Statistics.h:38-131)."""

    timestamps: List[float] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    values_bound: List[float] = field(default_factory=list)
    rmse: float = 0.0
    mean: float = 0.0
    median: float = 0.0
    std: float = 0.0
    max: float = 0.0
    min: float = 0.0

    def add(self, t: float, v: float, bound: Optional[float] = None):
        self.timestamps.append(t)
        self.values.append(v)
        if bound is not None:
            self.values_bound.append(bound)

    def calculate(self):
        v = np.asarray(self.values, dtype=np.float64)
        if v.size == 0:
            return self
        self.rmse = float(np.sqrt(np.mean(v**2)))
        self.mean = float(v.mean())
        self.median = float(np.median(v))
        # ov_eval uses sum((v-mean)^2)/size (population variance)
        self.std = float(np.sqrt(np.mean((v - self.mean) ** 2)))
        self.max = float(v.max())
        self.min = float(v.min())
        return self

    def __repr__(self):
        return (
            f"rmse={self.rmse:.5f} mean={self.mean:.5f} median={self.median:.5f}"
            f" std={self.std:.5f} min={self.min:.5f} max={self.max:.5f}"
        )


def _pose_to_T(pose: np.ndarray) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = jpl_quat_to_rot(pose[3:7]).T  # R_ItoG
    t[:3, 3] = pose[:3]
    return t


def _inv_se3(t: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = t[:3, :3].T
    out[:3, 3] = -t[:3, :3].T @ t[:3, 3]
    return out


class ResultTrajectory:
    """Load + associate + two-way align an estimate vs GT, then compute
    metrics (ResultTrajectory.cpp:28-68)."""

    def __init__(self, est: Trajectory, gt: Trajectory, align_method: str = "se3"):
        (
            self.times,
            self.est_poses,
            self.gt_poses,
            self.est_covori,
            self.est_covpos,
            self.gt_covori,
            self.gt_covpos,
        ) = associate(
            est.times, gt.times, est.poses, gt.poses,
            0.0, 0.02,
            est.cov_ori, est.cov_pos, gt.cov_ori, gt.cov_pos,
        )
        if self.est_poses.shape[0] < 3:
            raise ValueError("not enough common timestamps between trajectories")
        r_e2g, t_e2g, s_e2g = align_trajectory(
            self.est_poses, self.gt_poses, align_method
        )
        r_g2e, t_g2e, s_g2e = align_trajectory(
            self.gt_poses, self.est_poses, align_method
        )
        self.est_aligned = apply_alignment(self.est_poses, r_e2g, t_e2g, s_e2g)
        self.gt_aligned = apply_alignment(self.gt_poses, r_g2e, t_g2e, s_g2e)

    @classmethod
    def from_files(cls, path_est: str, path_gt: str, align_method: str = "se3"):
        return cls(load_pose_file(path_est), load_pose_file(path_gt), align_method)

    def trajectory_length(self) -> float:
        d = np.diff(self.gt_poses[:, :3], axis=0)
        return float(np.linalg.norm(d, axis=1).sum())

    def calculate_ate(self) -> Tuple[Statistics, Statistics]:
        """(ori_deg, pos_m) RMSE stats after alignment (ResultTrajectory.cpp:69)."""
        err_ori, err_pos = Statistics(), Statistics()
        for i in range(self.est_aligned.shape[0]):
            e_r = (
                jpl_quat_to_rot(self.est_aligned[i, 3:7]).T
                @ jpl_quat_to_rot(self.gt_poses[i, 3:7])
            )
            err_ori.add(self.times[i], 180.0 / np.pi * np.linalg.norm(log_so3(e_r)))
            err_pos.add(
                self.times[i],
                float(np.linalg.norm(self.gt_poses[i, :3] - self.est_aligned[i, :3])),
            )
        return err_ori.calculate(), err_pos.calculate()

    def calculate_ate_2d(self) -> Tuple[Statistics, Statistics]:
        """(yaw_deg, pos_xy_m) stats (ResultTrajectory.cpp:98-125)."""
        err_ori, err_pos = Statistics(), Statistics()
        for i in range(self.est_aligned.shape[0]):
            e_r = (
                jpl_quat_to_rot(self.est_aligned[i, 3:7]).T
                @ jpl_quat_to_rot(self.gt_poses[i, 3:7])
            )
            err_ori.add(self.times[i], 180.0 / np.pi * log_so3(e_r)[2])
            err_pos.add(
                self.times[i],
                float(
                    np.linalg.norm(self.gt_poses[i, :2] - self.est_aligned[i, :2])
                ),
            )
        return err_ori.calculate(), err_pos.calculate()

    def calculate_rpe(
        self, segment_lengths
    ) -> Dict[float, Tuple[Statistics, Statistics]]:
        """Relative pose error over distance-defined segments
        (ResultTrajectory.cpp:127-228)."""
        pos = self.gt_poses[:, :3]
        dists = np.concatenate(
            [[0.0], np.cumsum(np.linalg.norm(np.diff(pos, axis=0), axis=1))]
        )
        max_dist_diff = 0.5
        out = {}
        for distance in segment_lengths:
            err_ori, err_pos = Statistics(), Statistics()
            comparisons = self._comparison_indices(dists, distance, max_dist_diff)
            for i_start, i_end in enumerate(comparisons):
                if i_end == -1:
                    continue
                t_c1 = _pose_to_T(self.est_aligned[i_start])
                t_c2 = _pose_to_T(self.est_aligned[i_end])
                t_c1_c2 = _inv_se3(t_c1) @ t_c2
                t_m1 = _pose_to_T(self.gt_poses[i_start])
                t_m2 = _pose_to_T(self.gt_poses[i_end])
                t_m1_m2 = _inv_se3(t_m1) @ t_m2
                t_err_c2 = _inv_se3(t_m1_m2) @ t_c1_c2
                r_c2 = t_c2[:3, :3]
                r_err_w = r_c2 @ t_err_c2[:3, :3] @ r_c2.T
                p_err_w = r_c2 @ t_err_c2[:3, 3]
                err_pos.add(self.times[i_start], float(np.linalg.norm(p_err_w)))
                err_ori.add(
                    self.times[i_start],
                    180.0 / np.pi * float(np.linalg.norm(log_so3(r_err_w))),
                )
            out[distance] = (err_ori.calculate(), err_pos.calculate())
        return out

    @staticmethod
    def _comparison_indices(dists, distance, max_dist_diff):
        """compute_comparison_indices_length (ResultTrajectory.h:167-196),
        vectorized."""
        comparisons = []
        n = len(dists)
        for idx in range(n):
            err = np.abs(dists[idx:] - (dists[idx] + distance))
            best = int(np.argmin(err))
            comparisons.append(idx + best if err[best] < max_dist_diff else -1)
        return comparisons

    def calculate_nees(self) -> Tuple[Statistics, Statistics]:
        """Normalized estimation error squared (ResultTrajectory.cpp:230-270).
        Requires covariance columns in the estimate file."""
        if self.est_covori is None or self.est_covpos is None:
            raise ValueError("estimate trajectory has no covariances for NEES")
        nees_ori, nees_pos = Statistics(), Statistics()
        for i in range(self.est_poses.shape[0]):
            e_r = (
                jpl_quat_to_rot(self.gt_poses[i, 3:7])
                @ jpl_quat_to_rot(self.est_poses[i, 3:7]).T
            )
            err_ori = -log_so3(e_r)
            ori_nees = err_ori @ np.linalg.inv(self.est_covori[i]) @ err_ori
            err_pos = self.gt_aligned[i, :3] - self.est_poses[i, :3]
            pos_nees = err_pos @ np.linalg.inv(self.est_covpos[i]) @ err_pos
            if np.isfinite(ori_nees):
                nees_ori.add(self.times[i], float(ori_nees))
            if np.isfinite(pos_nees):
                nees_pos.add(self.times[i], float(pos_nees))
        return nees_ori.calculate(), nees_pos.calculate()

"""Filter health checks for the divergence guard.

Counterpart of ``cuahn_vio.filter.health``. The reference has no
divergence detection: its own shipped estimate ends in NaNs
(ov_data/uzh_fpv/stamped_traj_estimate.txt:1701, SURVEY.md §5.3). The
stepwise runner (``pipeline.runner.run_stepwise``) checks ``health_flags``
after every frame and rolls back to the last healthy state when ``ok`` is
false.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuahn_vio_torch.filter.state import FilterState
from cuahn_vio_torch.ops.quat import quat_to_rot


class HealthFlags(NamedTuple):
    finite: torch.Tensor  # () bool: all state entries finite
    cov_psd: torch.Tensor  # () bool: covariance diagonal non-negative
    cov_bounded: torch.Tensor  # () bool: trace below threshold
    speed_ok: torch.Tensor  # () bool: |v| below physical bound
    height_ok: torch.Tensor  # () bool: above the ground plane
    ok: torch.Tensor  # () bool: all of the above


def health_flags(state: FilterState, max_cov_trace: float = 1e4,
                 max_speed: float = 30.0, min_height: float = 0.01) -> HealthFlags:
    """Cheap invariant checks on one state, as device tensors."""
    leaves = (state.p, state.q, state.v, state.ba, state.bg, state.off, state.cov)
    finite = torch.stack([torch.isfinite(x).all() for x in leaves]).all()
    cov_psd = (torch.diagonal(state.cov) >= -1e-9).all()
    cov_bounded = torch.trace(state.cov) < max_cov_trace
    speed_ok = torch.linalg.norm(state.v) < max_speed
    # world height of the IMU; meaningful only when ``finite`` holds
    height_ok = (quat_to_rot(state.q) @ state.p)[2] > min_height
    ok = finite & cov_psd & cov_bounded & speed_ok & height_ok
    return HealthFlags(finite, cov_psd, cov_bounded, speed_ok, height_ok, ok)

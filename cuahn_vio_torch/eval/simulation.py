"""Simulator ground truth in the 17-column format.

Counterpart of ``cuahn_vio.eval.simulation``, in part: ``StateGT`` and
``save_state_gt``, which ``make-synthetic`` uses to write its
``_state_gt.txt`` (the reference's sim GT schema, dataset_reader.h:61:
t q(xyzw) p v bg ba). The NEES and error-series evaluation is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class StateGT(NamedTuple):
    times: np.ndarray  # (N,)
    pose: np.ndarray  # (N, 7) [x y z qx qy qz qw], world frame
    vel: np.ndarray  # (N, 3) world-frame velocity
    bg: np.ndarray  # (N, 3) true gyro bias
    ba: np.ndarray  # (N, 3) true accel bias


def save_state_gt(path: str, gt: StateGT) -> None:
    """Write the 17-column simulator GT format."""
    with open(path, "w") as f:
        f.write("# t qx qy qz qw px py pz vx vy vz bwx bwy bwz bax bay baz\n")
        for i in range(len(gt.times)):
            q = gt.pose[i, 3:7]
            p = gt.pose[i, 0:3]
            row = np.concatenate([[gt.times[i]], q, p, gt.vel[i], gt.bg[i], gt.ba[i]])
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")

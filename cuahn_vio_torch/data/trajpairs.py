"""Where the trainer's flight-realistic pose-pair bank would come from.

Counterpart of the file list of ``cuahn_vio.data.trajpairs``: the UZH-FPV
ground-truth trajectories (``*_with_gt.txt``) the bank is built from, less
the four sequences the benchmarks replay. The bank itself (B-spline poses
at the camera interval) needs ``data/bspline``, which the port does not
have yet; ``train.trainer.train`` uses random poses when no GT file is
found, as the JAX trainer does, and refuses to train when one is.

The port looks for the files in ``data/uzh_fpv`` of the repository, where
they go once they are committed (the JAX package reads them from the
reference's checkout).
"""

from __future__ import annotations

import glob
import os

GT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "uzh_fpv",
)

# benchmark replays: never trained on
EVAL_TRAJECTORIES = (
    "indoor_45_2", "indoor_45_4", "indoor_45_9", "indoor_forward_5",
)


def train_trajectory_files(gt_dir: str = GT_DIR) -> list[str]:
    """The GT trajectory files of ``gt_dir`` that training may use, sorted."""
    files = sorted(glob.glob(os.path.join(gt_dir, "*_with_gt.txt")))
    return [
        f for f in files
        if not any(os.path.basename(f).startswith(e) for e in EVAL_TRAJECTORIES)
    ]

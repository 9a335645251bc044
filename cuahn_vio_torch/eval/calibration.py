"""Reported-covariance calibration (``run-vio --cov-calib``).

A copy of ``cuahn_vio.eval.calibration`` (numpy only), in part: the
per-block inflation ``P' = D P D`` of the output covariance. The fits
(``calibrate-covariance``, ``calibrate-state-covariance``) are not ported
yet.
"""

from __future__ import annotations

import numpy as np

COV_BLOCKS = ("pos", "ori", "vel", "ba", "bg")


def inflation_diag(factors: dict, dtype=np.float32) -> np.ndarray:
    """(15,) sqrt-factor diagonal D for P' = D P D from per-block variance
    factors {pos, ori, vel, ba, bg} (missing -> 1). D P D scales each
    block's variance by its factor and cross blocks by the geometric mean,
    preserving positive-definiteness exactly."""
    d = np.ones(15, dtype)
    for i, name in enumerate(COV_BLOCKS):
        d[3 * i : 3 * i + 3] = np.sqrt(float(factors.get(name, 1.0)))
    return d


def apply_cov_inflation(cov_core: np.ndarray, factors: dict) -> np.ndarray:
    """Apply D P D to a (..., 15, 15) covariance stack."""
    d = inflation_diag(factors, cov_core.dtype)
    return cov_core * d[:, None] * d[None, :]

"""Batched evaluation: many sequences in lockstep on one device.

Counterpart of ``cuahn_vio.parallel.sharded_eval``, in part:
``batched_run_sequences`` with ``mesh=None``, the ``run-vio-batch`` path
on one card. B sequences, padded to a common frame count
(``pipeline.runner.prepare_batch``), run through the batched
``run_sequence``: the filter recurrence stays serial per sequence, and one
frame's host dispatch is shared by the B sequences. Sharding the batch
over a device mesh (``mesh``) and ``aggregate_rmse`` wait for the port's
parallel slice.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from cuahn_vio_torch.filter.state import FilterParams, FilterState
from cuahn_vio_torch.pipeline.vio import VioConfig, run_sequence


def batched_run_sequences(
    states0: FilterState,  # every tensor with a leading B
    model: Optional[Any],
    fparams: FilterParams,
    cfg: VioConfig,
    imgs_u8: torch.Tensor,  # (B, F+1, H, W)
    w_win: torch.Tensor,  # (B, F, T, 3)
    a_win: torch.Tensor,  # (B, F, T, 3)
    dt_win: torch.Tensor,  # (B, F, T)
    n_used,  # (B, F) host ints: real IMU intervals per sequence and frame
    generator: Optional[torch.Generator],
    mesh=None,
):
    """Run B sequences in lockstep on their device.

    Each frame propagates to the largest ``n_used`` of the batch (the dt = 0
    steps after a sequence's own count are exact identities). Returns
    (final states, FrameOutput) with leading axis B.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharding the batch over a device mesh is not ported yet; pass mesh=None"
        )
    n_max = np.asarray(n_used).max(axis=0)
    return run_sequence(states0, model, fparams, cfg, imgs_u8, w_win, a_win,
                        dt_win, n_max, generator)

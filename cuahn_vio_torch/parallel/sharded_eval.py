"""Batched evaluation: many sequences in lockstep, sharded over the mesh.

Counterpart of ``cuahn_vio.parallel.sharded_eval``: ``batched_run_sequences``
(the ``run-vio-batch`` path) and ``aggregate_rmse``. B sequences, padded to
a common frame count (``pipeline.runner.prepare_batch``), run through the
batched ``run_sequence``: the filter recurrence stays serial per sequence,
and one frame's host dispatch is shared by the sequences of a device. With
a mesh, each rank runs its contiguous shard of the B sequences
(``mesh.shard_batch``); a one-device mesh runs them all, as ``mesh=None``
does. ``aggregate_rmse`` sums squared errors over the rank's sequences,
then over the ranks (``all_reduce``), in place of the JAX ``psum``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from cuahn_vio_torch.filter.state import FilterParams, FilterState
from cuahn_vio_torch.parallel.mesh import Mesh, all_reduce_sum, shard_batch, shard_bounds
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
    mask_keys: Optional[torch.Tensor],  # (F, iters, B, 4, 2) or None
    mesh: Optional[Mesh] = None,
):
    """Run B sequences in lockstep on their device, or this rank's shard
    of them over ``mesh`` (its axis ``seq``; the model and parameters on
    the rank's device).

    Each frame propagates to the largest ``n_used`` of the (shard's) batch
    (the dt = 0 steps after a sequence's own count are exact identities).
    ``mask_keys`` holds every sequence's MC-dropout keys
    (``vio.sequence_mask_keys``); a rank takes its sequences' columns, so
    each sequence keeps its masks wherever it runs.
    Returns (final states, FrameOutput) with a leading axis of the
    sequences run here: all B without a mesh or on a one-device mesh.
    """
    n_used = np.asarray(n_used)
    if mesh is not None:
        lo, hi = shard_bounds(imgs_u8.shape[0], mesh)
        states0, imgs_u8, w_win, a_win, dt_win = shard_batch(
            (states0, imgs_u8, w_win, a_win, dt_win), mesh)
        n_used = n_used[lo:hi]
        if mask_keys is not None:
            mask_keys = mask_keys[:, :, lo:hi].to(mesh.local).contiguous()
    return run_sequence(states0, model, fparams, cfg, imgs_u8, w_win, a_win,
                        dt_win, n_used.max(axis=0), mask_keys)


def aggregate_rmse(err_by_seq: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """RMSE of per-frame errors over every rank's sequences: this rank's
    (B_local, F) errors squared and summed, then summed over the ranks
    with their element counts."""
    ss = all_reduce_sum(torch.sum(err_by_seq * err_by_seq).reshape(1), mesh)
    n = all_reduce_sum(torch.tensor([err_by_seq.numel()], dtype=ss.dtype,
                                    device=ss.device), mesh)
    return torch.sqrt(ss / n)[0]

"""The per-frame VIO step and the sequence loop.

Counterpart of ``cuahn_vio.pipeline.vio`` (VioManager::
do_feature_propagate_update, VioManager.cpp:200-315):

    1. propagate over the frame's IMU window;
    2. IEKF loop over max_iekf_iterations: the propagated 4-point-offset
       prior (x159.5 -> pixels) feeds the prior-mode network; intermediate
       iterations refine only the prior fed to the next inference (a
       mean-only update), the last one applies the real EKF update
       (offsets not updated), gated until frame_idx > update_gate_frames;
    3. reset the 4-point offsets and their covariance.

``run_sequence`` is a Python loop over frame pairs. All per-frame tensors
stay on the device; outputs are stacked once at the end. The three stages
carry ``record_function`` labels (vio.propagate, vio.network, vio.update)
that a ``torch.profiler`` trace groups by (``profile_slice.py``).

Batched (``run_sequence`` on (B, F+1, H, W) frames, the JAX package's
``jax.vmap`` of ``run_sequence``): B sequences in lockstep. The filter
stages run under ``torch.func.vmap`` over the leading B of the state and
the IMU windows; the model runs once per lockstep frame on all B image
pairs (the warps then launch once per site for the whole batch), with its
MC-dropout masks drawn per batch element from the one generator. The
update gate ``frame_idx > update_gate_frames`` is a host bool shared by
the batch, as in the JAX vmap. The single-sequence path calls the same
functions without vmap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import vmap
from torch.profiler import record_function

from cuahn_vio_torch.filter.propagate import propagate_window
from cuahn_vio_torch.filter.state import (
    FOCAL,
    FilterParams,
    FilterState,
    reset_4pt_offset,
)
from cuahn_vio_torch.filter.update import (
    hnet_update,
    innovation_stats,
    propagated_offset8,
)
from cuahn_vio_torch.ops.quat import quat_to_rot


@dataclass(frozen=True)
class VioConfig:
    """Static pipeline configuration (VioManagerOptions defaults of the
    UZH-FPV launch file)."""

    max_iekf_iterations: int = 1
    use_prior: bool = True
    update_gate_frames: int = 10
    blocks_to_run: int = 3


class FrameOutput(NamedTuple):
    p_world: torch.Tensor  # (3,) IMU position in world frame
    q: torch.Tensor  # (4,) wxyz IMU->world
    v_body: torch.Tensor  # (3,) velocity, IMU frame
    cov_core: torch.Tensor  # (15, 15) core error-state covariance
    net_mean: torch.Tensor  # (8,) last network flow (px)
    net_cov_tr: torch.Tensor  # () trace of the network covariance (px²)
    ba: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    net_chi2: torch.Tensor  # () innovation Mahalanobis distance (8 DoF)
    net_inno: torch.Tensor  # (8,) innovation, normalized camera units
    cov_meas: torch.Tensor  # (8, 8) H P Hᵀ of the propagated state
    net_cov88: torch.Tensor  # (8, 8) raw network covariance, px²


def _state_dims(state: FilterState) -> FilterState:
    """vmap dims of a state: its tensors are batched on dim 0; the bias
    fields stay None when the bias block is off."""
    return FilterState(*(None if x is None else 0 for x in state))


def _over_batch(fn: Callable, state: FilterState, *args, out_dims=0):
    """``fn(state, *args)`` for each element of a leading batch dim of the
    state's tensors and of ``args``; ``out_dims`` as for ``vmap`` (a
    returned state takes ``_state_dims``)."""
    in_dims = (_state_dims(state),) + (0,) * len(args)
    return vmap(fn, in_dims=in_dims, out_dims=out_dims)(state, *args)


def _single(fn: Callable, state: FilterState, *args, out_dims=0):
    return fn(state, *args)


def make_vio_step(model: Optional[Any], fparams: FilterParams, cfg: VioConfig,
                  batched: bool = False):
    """The per-frame step closure.

    Args:
        model: a ``models.uahn.UAHN`` on the filter's device, or None for
            filter-only dead reckoning.
        batched: the state, images and windows carry a leading batch dim B
            (B sequences in lockstep).
    Returns ``vio_step(state, frame_idx, img_prev_u8, img_curr_u8, w_win,
    a_win, dt_win, n_used, generator) -> (state, FrameOutput)``; ``n_used``
    is a host int, the largest of the batch when batched.
    """
    run = _over_batch if batched else _single

    def finish(state: FilterState, net_mean, net_cov88, net_chi2, net_inno, cov_meas):
        rot = quat_to_rot(state.q)
        out = FrameOutput(
            p_world=rot @ state.p,
            q=state.q,
            v_body=state.v,
            cov_core=state.cov[:15, :15],
            net_mean=net_mean,
            net_cov_tr=torch.trace(net_cov88),
            ba=state.ba,
            bg=state.bg,
            net_chi2=net_chi2,
            net_inno=net_inno,
            cov_meas=cov_meas,
            net_cov88=net_cov88.to(state.p.dtype),
        )
        return reset_4pt_offset(state), out

    def vio_step(state: FilterState, frame_idx: int, img_prev_u8, img_curr_u8,
                 w_win, a_win, dt_win, n_used, generator):
        sd = _state_dims(state)
        with record_function("vio.propagate"):
            state = run(
                lambda s, w, a, dt: propagate_window(s, fparams, w, a, dt, n_used),
                state, w_win, a_win, dt_win, out_dims=sd,
            )
        lead = state.p.shape[:-1]  # (B,) batched, () single
        net_mean = net_inno = state.p.new_zeros(lead + (8,))
        net_chi2 = state.p.new_zeros(lead)
        cov_meas = net_cov88 = state.p.new_zeros(lead + (8, 8))
        if model is not None:
            img1 = img_prev_u8 if batched else img_prev_u8[None]
            img2 = img_curr_u8 if batched else img_curr_u8[None]
            gate = frame_idx > cfg.update_gate_frames
            prior8 = run(propagated_offset8, state)
            for it in range(cfg.max_iekf_iterations):
                with record_function("vio.network"):
                    prior_px = (prior8 * FOCAL).reshape(-1, 4, 2)
                    flow8, cov88 = model(
                        img1, img2, prior_px if cfg.use_prior else None,
                        use_prior=cfg.use_prior, generator=generator,
                    )
                    if not batched:
                        flow8, cov88 = flow8[0], cov88[0]
                last = it == cfg.max_iekf_iterations - 1
                with record_function("vio.update"):
                    net_inno, _, net_chi2, _, cov_meas = run(
                        lambda s, m, c: innovation_stats(s, fparams, m, c),
                        state, flow8, cov88,
                    )
                    if last:
                        if gate:
                            state = run(
                                lambda s, m, c: hnet_update(
                                    s, fparams, m, c, update_offset=False
                                ),
                                state, flow8, cov88, out_dims=sd,
                            )
                    elif gate:
                        prior8 = run(
                            lambda s, m, c: propagated_offset8(hnet_update(
                                s, fparams, m, c, update_offset=True, cov_update=False,
                            )),
                            state, flow8, cov88,
                        )
                net_mean, net_cov88 = flow8, cov88
        return run(finish, state, net_mean, net_cov88, net_chi2, net_inno, cov_meas,
                   out_dims=(sd, 0))

    return vio_step


def run_sequence(init_state: FilterState, model: Optional[Any],
                 fparams: FilterParams, cfg: VioConfig,
                 imgs_u8: torch.Tensor, w_win: torch.Tensor,
                 a_win: torch.Tensor, dt_win: torch.Tensor, n_used,
                 generator: Optional[torch.Generator]):
    """Run the step over all frame pairs, of one sequence or of a batch of
    B sequences in lockstep.

    Args:
        imgs_u8: (F+1, H, W) uint8 frames on the filter's device, or
            (B, F+1, H, W) for a batch (then every state tensor has a
            leading B); the first frame only primes the image pair.
        w_win, a_win: ([B,] F, T, 3); dt_win: ([B,] F, T); n_used: (F,)
            host ints, for a batch the largest of the batch at each frame
            (dt = 0 steps after a sequence's own count are identities).
        generator: MC-dropout random source, drawn in frame order.
    Returns (final state, FrameOutput of ([B,] F, ...) stacked tensors).
    """
    batched = imgs_u8.dim() == 4
    step = make_vio_step(model, fparams, cfg, batched=batched)
    state = init_state
    outs = []
    for f in range(w_win.shape[-3]):
        # a batch's frame f is strided in (B, F+1, H, W); the kernels take
        # contiguous images
        state, out = step(
            state, f, imgs_u8[..., f, :, :].contiguous(),
            imgs_u8[..., f + 1, :, :].contiguous(),
            w_win[..., f, :, :], a_win[..., f, :, :], dt_win[..., f, :],
            int(n_used[f]), generator,
        )
        outs.append(out)
    frame_dim = 1 if batched else 0
    stacked = FrameOutput(*(torch.stack(field, frame_dim) for field in zip(*outs)))
    return state, stacked

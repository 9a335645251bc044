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

The step is composed of the stages of ``make_vio_stages`` (propagation,
network, update, finish), which the stepwise runner also times one by
one. ``run_sequence`` is a Python loop over frame pairs. All per-frame
tensors stay on the device; outputs are stacked once at the end. The
stages carry spans (``utils/spans``: vio.propagate, vio.network,
vio.update; the network's own ``vio.uahn.*`` inside vio.network) that a
``torch.profiler`` trace groups by (``profile_slice.py``).

Batched (``run_sequence`` on (B, F+1, H, W) frames, the JAX package's
``jax.vmap`` of ``run_sequence``): B sequences in lockstep. The filter
stages run under ``torch.func.vmap`` over the leading B of the state and
the IMU windows; the model runs once per lockstep frame on all B image
pairs (the warps then launch once per site for the whole batch), with
each sequence's MC-dropout masks drawn from that sequence's own keys. The
update gate ``frame_idx > update_gate_frames`` is a host bool shared by
the batch, as in the JAX vmap. The single-sequence path calls the same
functions without vmap.

MC-dropout keys: the JAX ``run_sequence`` splits its key into one key a
frame pair and folds the IEKF iteration into it (``rngs={"dropout":
fold_in(keys[f], it)}``). ``sequence_mask_keys`` makes the keys of every
mask of the run from those frame keys on the host, as one (F, iters, [B,]
4, 2) table that is copied to the device once; each network call takes a
view of it, and its four masks are one launch of the threefry kernel T1.

``run_sequence_with_measurements`` is the filter alone, driven by given
measurements in place of the network (the oracle tests, the
filter-parameter sweep of ``eval/tuning`` and the parallel self-test): a
leading batch may sit on the state, on stacked filter parameters (a grid)
or on the measurements, and the update of a frame whose measurement is
not valid is dropped by a device-side ``torch.where``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

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
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.spans import span


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


# the per-stage columns of a step, in the reference's timing CSV order
# (load and total are the runner's)
PROP, NET, UPDATE = 1, 2, 3


def _state_dims(state: FilterState) -> FilterState:
    """vmap dims of a state: its tensors are batched on dim 0; the bias
    fields stay None when the bias block is off."""
    return FilterState(*(None if x is None else 0 for x in state))


def expand_state(state: FilterState, n: int) -> FilterState:
    """The state repeated along a new leading batch dim of n."""
    return FilterState(*(None if x is None else x.expand((n,) + x.shape).contiguous()
                         for x in state))


def _over_batch(fn: Callable, state: FilterState, *args, out_dims=0):
    """``fn(state, *args)`` for each element of a leading batch dim of the
    state's tensors and of ``args``; ``out_dims`` as for ``vmap`` (a
    returned state takes ``_state_dims``)."""
    in_dims = (_state_dims(state),) + (0,) * len(args)
    return vmap(fn, in_dims=in_dims, out_dims=out_dims)(state, *args)


def _single(fn: Callable, state: FilterState, *args, out_dims=0):
    return fn(state, *args)


def _finish(state: FilterState, net_mean, net_cov88, net_chi2, net_inno, cov_meas):
    """(the state after the 4-point offset reset, the frame's FrameOutput)
    of one sequence."""
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


class VioStages(NamedTuple):
    """The step's stages (``make_vio_stages``); composed in order they are
    ``make_vio_step``."""

    prop_fn: Callable  # (state, w_win, a_win, dt_win, n_used) -> state
    net_fn: Callable  # (prior8, img_prev_u8, img_curr_u8, mask keys) -> (flow8, cov88)
    upd_fn: Callable  # (state, frame_idx, flow8, cov88) -> (state, (chi2, inno, cov_meas))
    finish_fn: Callable  # (state, net_mean, net_cov88, calib) -> (state, FrameOutput)
    refine_prior_fn: Callable  # (state, flow8, cov88) -> prior8
    prior_fn: Callable  # state -> prior8, the propagated 4-point offset


def make_vio_stages(model: Optional[Any], fparams: FilterParams, cfg: VioConfig,
                    batched: bool = False) -> VioStages:
    """The step split into stages, so that the stepwise runner can time
    each column of the reference's timing CSV (VioManager.cpp:98: load /
    propagation / inference / update / total). ``make_vio_step`` composes
    the same stages, so the two runners run one sequence of operations.

    Args as ``make_vio_step``. ``net_fn`` draws its MC-dropout masks
    from the mask keys it is given ((4, 2), or (B, 4, 2) batched: a view of
    ``sequence_mask_keys``' table at the frame and IEKF iteration, the keys
    of the JAX ``net_fn``'s ``fold_in(key, it)``).
    """
    run = _over_batch if batched else _single

    def prop_fn(state: FilterState, w_win, a_win, dt_win, n_used) -> FilterState:
        with span("vio.propagate"):
            return run(
                lambda s, w, a, dt: propagate_window(s, fparams, w, a, dt, n_used),
                state, w_win, a_win, dt_win, out_dims=_state_dims(state),
            )

    def prior_fn(state: FilterState) -> torch.Tensor:
        return run(propagated_offset8, state)

    def net_fn(prior8, img_prev_u8, img_curr_u8, keys):
        with span("vio.network"):
            img1 = img_prev_u8 if batched else img_prev_u8[None]
            img2 = img_curr_u8 if batched else img_curr_u8[None]
            if keys is not None and not batched:
                keys = keys[None]
            prior_px = (prior8 * FOCAL).reshape(-1, 4, 2)
            flow8, cov88 = model(
                img1, img2, prior_px if cfg.use_prior else None,
                use_prior=cfg.use_prior, dropout_keys=keys,
            )
            return (flow8, cov88) if batched else (flow8[0], cov88[0])

    def refine_prior_fn(state: FilterState, flow8, cov88) -> torch.Tensor:
        """Mean-only refinement of the offset prior for the next IEKF
        inference (never committed to the state)."""
        with span("vio.update"):
            return run(
                lambda s, m, c: propagated_offset8(hnet_update(
                    s, fparams, m, c, update_offset=True, cov_update=False,
                )),
                state, flow8, cov88,
            )

    def upd_fn(state: FilterState, frame_idx: int, flow8, cov88):
        """Innovation statistics, then the EKF update (offsets not updated,
        VioManager.cpp:261-263) once the frame is past the startup gate (a
        host bool, shared by a batch)."""
        with span("vio.update"):
            inno, _, chi2, _, cov_meas = run(
                lambda s, m, c: innovation_stats(s, fparams, m, c), state, flow8, cov88,
            )
            if frame_idx > cfg.update_gate_frames:
                state = run(
                    lambda s, m, c: hnet_update(s, fparams, m, c, update_offset=False),
                    state, flow8, cov88, out_dims=_state_dims(state),
                )
            return state, (chi2, inno, cov_meas)

    def finish_fn(state: FilterState, net_mean, net_cov88, calib):
        """The frame's outputs (world pose, RosVisualizer.cpp:171), then the
        4-point offset reset (VioManager.cpp:275)."""
        net_chi2, net_inno, cov_meas = calib
        return run(_finish, state, net_mean, net_cov88, net_chi2, net_inno, cov_meas,
                   out_dims=(_state_dims(state), 0))

    return VioStages(prop_fn, net_fn, upd_fn, finish_fn, refine_prior_fn, prior_fn)


def _no_network_outputs(state: FilterState):
    """(net_mean, net_cov88, (chi2, inno, cov_meas)) of a frame without a
    network measurement: zeros."""
    lead = state.p.shape[:-1]  # (B,) batched, () single
    vec8 = state.p.new_zeros(lead + (8,))
    mat8 = state.p.new_zeros(lead + (8, 8))
    return vec8, mat8, (state.p.new_zeros(lead), vec8, mat8)


def make_vio_step(model: Optional[Any], fparams: FilterParams, cfg: VioConfig,
                  batched: bool = False):
    """The per-frame step closure, composed of ``make_vio_stages``.

    Args:
        model: a ``models.uahn.UAHN`` on the filter's device, or None for
            filter-only dead reckoning.
        batched: the state, images and windows carry a leading batch dim B
            (B sequences in lockstep).
    Returns ``vio_step(state, frame_idx, img_prev_u8, img_curr_u8, w_win,
    a_win, dt_win, n_used, frame_keys, clock=None) -> (state,
    FrameOutput)``; ``n_used`` is a host int, the largest of the batch when
    batched; ``frame_keys`` is the frame's (iters, [B,] 4, 2) view of
    ``sequence_mask_keys``' table on the device (None without MC
    dropout). ``clock(column)``, when given, is called as each stage ends
    with the timing column it belongs to (``PROP``, ``NET``, ``UPDATE``).
    """
    stages = make_vio_stages(model, fparams, cfg, batched)

    def vio_step(state: FilterState, frame_idx: int, img_prev_u8, img_curr_u8,
                 w_win, a_win, dt_win, n_used, frame_keys, clock=None):
        tick = clock or (lambda column: None)
        state = stages.prop_fn(state, w_win, a_win, dt_win, n_used)
        tick(PROP)
        net_mean, net_cov88, calib = _no_network_outputs(state)
        if model is not None:
            prior8 = stages.prior_fn(state)
            for it in range(cfg.max_iekf_iterations):
                flow8, cov88 = stages.net_fn(prior8, img_prev_u8, img_curr_u8,
                                             None if frame_keys is None else frame_keys[it])
                tick(NET)
                if it == cfg.max_iekf_iterations - 1:
                    state, calib = stages.upd_fn(state, frame_idx, flow8, cov88)
                elif frame_idx > cfg.update_gate_frames:
                    # the ephemeral refinement honors the real update's gate
                    prior8 = stages.refine_prior_fn(state, flow8, cov88)
                tick(UPDATE)
                net_mean, net_cov88 = flow8, cov88
        state, out = stages.finish_fn(state, net_mean, net_cov88, calib)
        tick(UPDATE)
        return state, out

    return vio_step


def sequence_mask_keys(frame_keys, iters: int) -> np.ndarray:
    """(F, [B,] 2) uint32 frame keys -> the (F, iters, [B,] 4, 2) keys of
    every MC-dropout mask of a run: frame f's IEKF iteration it calls the
    network with ``fold_in(frame_keys[f], it)`` (the JAX ``vio_step``),
    whose four masks' keys are ``prng.mask_keys`` of it."""
    frame_keys = np.asarray(frame_keys, np.uint32)
    per_call = np.stack([prng.fold_in(frame_keys, it) for it in range(iters)], axis=1)
    return prng.mask_keys(per_call)


def run_sequence(init_state: FilterState, model: Optional[Any],
                 fparams: FilterParams, cfg: VioConfig,
                 imgs_u8: torch.Tensor, w_win: torch.Tensor,
                 a_win: torch.Tensor, dt_win: torch.Tensor, n_used,
                 mask_keys: Optional[torch.Tensor]):
    """Run the step over all frame pairs, of one sequence or of a batch of
    B sequences in lockstep.

    Args:
        imgs_u8: (F+1, H, W) uint8 frames on the filter's device, or
            (B, F+1, H, W) for a batch (then every state tensor has a
            leading B); the first frame only primes the image pair.
        w_win, a_win: ([B,] F, T, 3); dt_win: ([B,] F, T); n_used: (F,)
            host ints, for a batch the largest of the batch at each frame
            (dt = 0 steps after a sequence's own count are identities).
        mask_keys: (F, iters, [B,] 4, 2) int32 keys of every MC-dropout
            mask on the filter's device (``sequence_mask_keys`` through
            ``prng.keys_tensor``); None without MC dropout.
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
            int(n_used[f]), None if mask_keys is None else mask_keys[f],
        )
        outs.append(out)
    frame_dim = 1 if batched else 0
    stacked = FrameOutput(*(torch.stack(field, frame_dim) for field in zip(*outs)))
    return state, stacked


def _params_dims(fparams: FilterParams):
    """vmap dims of filter parameters: every field on dim 0 when stacked
    (``eval.tuning._stack_params``: ``q_noise`` is then (G, 15, 15)),
    None when shared."""
    batched = fparams.q_noise.dim() == 3
    return FilterParams(*((0 if batched else None) for _ in fparams)), batched


def run_sequence_with_measurements(init_state: FilterState, fparams: FilterParams,
                                   cfg: VioConfig, z_mean8: torch.Tensor,
                                   z_cov88: torch.Tensor, z_valid: torch.Tensor,
                                   w_win: torch.Tensor, a_win: torch.Tensor,
                                   dt_win: torch.Tensor, n_used=None):
    """The filter alone, driven by given measurements in place of the
    network (JAX ``run_sequence_with_measurements``): each frame
    propagates over its IMU window, takes the innovation statistics, the
    EKF update (offsets not updated) where ``z_valid`` and past the
    startup gate, the frame's outputs, then the 4-point offset reset.

    Args:
        z_mean8: (F, 8) measurement flows, pixels; z_cov88: (F, 8, 8)
            their covariances, px²; z_valid: (F,) bool, apply the update.
        w_win, a_win: (F, T, 3); dt_win: (F, T).
        n_used: (F,) host ints, the real IMU intervals of each frame (the
            rest is dt = 0 padding, skipped); None runs all T.

    Batched: a leading batch dim on the state's tensors, on every field of
    ``fparams`` (a stacked grid), on the measurements and windows, or on
    any of them; the step runs under ``torch.func.vmap`` over whichever
    are batched, and the outputs carry the batch. ``z_valid`` may differ
    per batch element, so the update is kept or dropped by a device-side
    ``torch.where``; only the startup gate ``frame_idx >
    cfg.update_gate_frames`` is a host bool, as in ``make_vio_stages``.

    Returns (final state, FrameOutput of ([B,] F, ...) stacked tensors).
    """
    p_dims, params_batched = _params_dims(fparams)
    data_batched = z_mean8.dim() == 3
    data_dims = 0 if data_batched else None

    def step(gate_open: bool, steps: Optional[int]):
        def one(state, fp, z, r, valid, w, a, dt):
            state = propagate_window(state, fp, w, a, dt, steps)
            inno, _, chi2, _, p_meas = innovation_stats(state, fp, z, r)
            if gate_open:
                upd = hnet_update(state, fp, z, r, update_offset=False)
                state = FilterState(*(
                    None if new is None else torch.where(valid, new, old)
                    for new, old in zip(upd, state)
                ))
            return _finish(state, z, r, chi2, inno, p_meas)
        return one

    state = init_state
    if state.p.dim() == 1 and (params_batched or data_batched):
        # the step writes into matrices made from the state (``new_zeros``),
        # which vmap batches only when the state is batched
        n = fparams.q_noise.shape[0] if params_batched else z_mean8.shape[0]
        state = expand_state(state, n)
    outs = []
    for f in range(z_mean8.shape[-2]):
        fn = step(f > cfg.update_gate_frames, None if n_used is None else int(n_used[f]))
        xs = (z_mean8[..., f, :], z_cov88[..., f, :, :], z_valid[..., f],
              w_win[..., f, :, :], a_win[..., f, :, :], dt_win[..., f, :])
        if state.p.dim() == 2:
            fn = vmap(fn, in_dims=(_state_dims(state), p_dims) + (data_dims,) * len(xs),
                      out_dims=(_state_dims(state), 0))
        state, out = fn(state, fparams, *xs)
        outs.append(out)
    frame_dim = 1 if state.p.dim() == 2 else 0
    stacked = FrameOutput(*(torch.stack(field, frame_dim) for field in zip(*outs)))
    return state, stacked

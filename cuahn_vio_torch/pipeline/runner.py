"""Host orchestration: streaming init -> windowing -> the frame loop.

Counterpart of ``cuahn_vio.pipeline.runner.run_offline``: the host replays
the IMU stream into the initializer (feed_measurement_imu semantics),
builds the per-frame IMU windows, and runs the step over every frame pair
on the device. ``run_offline_batch`` runs many sequences in lockstep
(``run-vio-batch``): ``prepare_batch`` pads them to a common frame count,
``parallel.sharded_eval.batched_run_sequences`` runs them and
``batch_results`` trims each back to its own frames. The per-frame stage
timer (``run_stepwise``) and the health rollback are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from cuahn_vio_torch.filter.initializer import initial_state, try_initialize
from cuahn_vio_torch.filter.propagate import propagate_window
from cuahn_vio_torch.filter.state import FilterParams, FilterState, with_bias_block
from cuahn_vio_torch.ops.homography import f32_parity_mode
from cuahn_vio_torch.pipeline.imu_window import build_imu_windows, select_imu_readings
from cuahn_vio_torch.pipeline.vio import FrameOutput, VioConfig, run_sequence


@dataclass
class RunnerOptions:
    """The launch-file knobs the runner uses (uzhfpv.launch:17-19,43,66-67)."""

    calib_camimu_dt: float = -0.0148489
    init_window_time: float = 1.0
    init_imu_thresh: float = 0.5
    init_height: float = 0.1
    gravity_mag: float = 9.81
    max_imu_steps_per_frame: int = 64


class RunResult(NamedTuple):
    times: np.ndarray  # (F,) output timestamps (IMU clock)
    pose_w: np.ndarray  # (F, 7) [x y z qx qy qz qw] (file convention)
    cov_ori: np.ndarray  # (F, 3, 3)
    cov_pos: np.ndarray  # (F, 3, 3)
    t0: float
    v_body: np.ndarray  # (F, 3) velocity, IMU frame
    ba: np.ndarray  # (F, 3)
    bg: np.ndarray  # (F, 3)
    cov_diag: np.ndarray  # (F, 15) core cov diagonal
    cov_core: np.ndarray  # (F, 15, 15)
    net_chi2: np.ndarray  # (F,)
    net_inno: np.ndarray  # (F, 8)
    cov_meas: np.ndarray  # (F, 8, 8)
    net_cov88: np.ndarray  # (F, 8, 8)
    net_mean: np.ndarray  # (F, 8)


def _streaming_init(imu_t, imu_w, imu_a, cam_t, opts: RunnerOptions):
    """At each camera time, try to initialize with the IMU seen so far.
    Returns (init result, index of the first processed camera frame)."""
    for fi, tc in enumerate(cam_t):
        t_imu_cut = tc + opts.calib_camimu_dt
        n = int(np.searchsorted(imu_t, t_imu_cut, side="right"))
        res = try_initialize(
            imu_t[:n], imu_w[:n], imu_a[:n],
            window_length=opts.init_window_time,
            imu_excite_threshold=opts.init_imu_thresh,
            init_height=opts.init_height,
            gravity_mag=opts.gravity_mag,
        )
        if res is not None:
            return res, fi
    return None, -1


def _outputs_to_result(out: FrameOutput, times, t0) -> RunResult:
    o = FrameOutput(*(x.detach().cpu().numpy() for x in out))
    pose = np.concatenate([o.p_world, o.q[:, [1, 2, 3, 0]]], axis=1)
    cov = o.cov_core
    return RunResult(
        times=np.asarray(times),
        pose_w=pose,
        cov_ori=cov[:, 3:6, 3:6],
        cov_pos=cov[:, 0:3, 0:3],
        t0=t0,
        v_body=o.v_body,
        ba=o.ba,
        bg=o.bg,
        cov_diag=np.einsum("fii->fi", cov).copy(),
        cov_core=cov,
        net_chi2=o.net_chi2,
        net_inno=o.net_inno,
        cov_meas=o.cov_meas,
        net_cov88=o.net_cov88,
        net_mean=o.net_mean,
    )


def prepare_sequence(imu_t, imu_w, imu_a, cam_t, frames_u8, opts: RunnerOptions,
                     fparams: FilterParams, device="cuda"):
    """Initialization + window building.

    Returns (init, state0, win, cam_used, frames_used): ``state0`` is on
    ``device``, propagated to the first processed frame's time; ``win``
    holds one padded window per following frame.
    """
    init, fi = _streaming_init(imu_t, imu_w, imu_a, cam_t, opts)
    if init is None:
        raise RuntimeError("initialization never fired (no jerk detected)")

    cam_used = cam_t[fi:]
    frames_used = frames_u8[fi:]
    frame_times_imu = cam_used + opts.calib_camimu_dt

    state0 = initial_state(init, device=device)
    if fparams.bias_sigma > 0.0:
        state0 = with_bias_block(state0, fparams)
    # window 0 (init t0 -> first frame) can span seconds: exact size
    t0s, w0s, a0s = select_imu_readings(
        imu_t, imu_w, imu_a, init.t0, frame_times_imu[0]
    )
    if t0s.shape[0] >= 2:
        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        state0 = propagate_window(
            state0, fparams,
            dev(0.5 * (w0s[:-1] + w0s[1:])),
            dev(0.5 * (a0s[:-1] + a0s[1:])),
            dev(np.diff(t0s)),
        )

    win = build_imu_windows(
        imu_t, imu_w, imu_a, frame_times_imu[0], frame_times_imu[1:],
        max_steps=opts.max_imu_steps_per_frame,
    )
    return init, state0, win, cam_used, frames_used


def resolve_device(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current CUDA device,
    which is where tensors made with device="cuda" live."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_devices(model, fparams: FilterParams, device) -> torch.device:
    device = resolve_device(device)
    if fparams.q_noise.device != device:
        raise ValueError(f"fparams on {fparams.q_noise.device}, run on {device}")
    if model is not None:
        dev_model = next(model.parameters()).device
        if dev_model != device:
            raise ValueError(f"model on {dev_model}, run on {device}")
    return device


def run_offline(imu_t, imu_w, imu_a, cam_t, frames_u8,
                model: Optional[Any], fparams: FilterParams, cfg: VioConfig,
                opts: RunnerOptions, seed: int = 0, device="cuda") -> RunResult:
    """Run a whole sequence; returns per-frame world poses from the second
    processed frame onward (steps are image pairs).

    ``model`` (a UAHN, or None for dead reckoning) and ``fparams`` must
    live on ``device``. MC-dropout masks come from a ``torch.Generator``
    on ``device`` seeded with ``seed``, drawn in frame order.
    """
    device = _check_devices(model, fparams, device)
    f32_parity_mode()
    init, state0, win, cam_used, frames_used = prepare_sequence(
        imu_t, imu_w, imu_a, cam_t, frames_u8, opts, fparams, device
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def dev(x):
        return torch.as_tensor(x, device=device)

    _, outs = run_sequence(
        state0, model, fparams, cfg,
        dev(np.ascontiguousarray(frames_used, np.uint8)),
        dev(win.w_mid), dev(win.a_mid), dev(win.dt), win.n_used, generator,
    )
    times_out = cam_used[1:] + opts.calib_camimu_dt
    return _outputs_to_result(outs, times_out, init.t0)


class BatchInputs(NamedTuple):
    """B sequences padded to F = the longest frame count, on the device."""

    states0: FilterState  # every tensor with a leading B
    imgs_u8: torch.Tensor  # (B, F+1, H, W) uint8
    w_win: torch.Tensor  # (B, F, T, 3)
    a_win: torch.Tensor  # (B, F, T, 3)
    dt_win: torch.Tensor  # (B, F, T); 0 = padding
    n_used: np.ndarray  # (B, F) real IMU intervals; 0 on padded frames
    n_frames: list  # each sequence's own frame count
    times: list  # each sequence's (n_frames,) output timestamps
    t0: list  # each sequence's initialization time


def prepare_batch(sequences, opts: RunnerOptions, fparams: FilterParams,
                  device="cuda") -> BatchInputs:
    """Initialize and window each of ``sequences`` ((imu_t, imu_w, imu_a,
    cam_t, frames_u8) tuples), pad them to a common frame count and stack
    them. Padded frames repeat the last frame and integrate zero-dt
    windows; ``batch_results`` trims them away."""
    preps = [prepare_sequence(*seq, opts, fparams, device) for seq in sequences]
    if not preps:
        raise ValueError("no sequences")
    n_frames = [win.dt.shape[0] for _, _, win, _, _ in preps]
    f_max = max(n_frames)
    if f_max == 0:
        raise ValueError("no sequence has a frame pair after initialization")
    imgs, ws, a_s, dts, ns = [], [], [], [], []
    for (_, _, win, _, frames_used), nf in zip(preps, n_frames):
        pad_f = f_max - nf
        imgs.append(np.concatenate([frames_used, np.repeat(frames_used[-1:], pad_f, 0)]))
        ws.append(np.pad(win.w_mid, ((0, pad_f), (0, 0), (0, 0))))
        a_s.append(np.pad(win.a_mid, ((0, pad_f), (0, 0), (0, 0))))
        dts.append(np.pad(win.dt, ((0, pad_f), (0, 0))))
        ns.append(np.pad(win.n_used, (0, pad_f)))
    states = [state0 for _, state0, _, _, _ in preps]
    states0 = FilterState(*(
        None if xs[0] is None else torch.stack(xs) for xs in zip(*states)
    ))

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(np.stack(x)), device=device)

    return BatchInputs(
        states0=states0,
        imgs_u8=dev([np.asarray(x, np.uint8) for x in imgs]),
        w_win=dev(ws), a_win=dev(a_s), dt_win=dev(dts),
        n_used=np.stack(ns),
        n_frames=n_frames,
        times=[cam_used[1:nf + 1] + opts.calib_camimu_dt
               for (_, _, _, cam_used, _), nf in zip(preps, n_frames)],
        t0=[init.t0 for init, _, _, _, _ in preps],
    )


def batch_results(outs: FrameOutput, batch: BatchInputs) -> list:
    """One RunResult per sequence, trimmed to its own frames."""
    return [
        _outputs_to_result(FrameOutput(*(x[i, :nf] for x in outs)), times, t0)
        for i, (nf, times, t0) in enumerate(zip(batch.n_frames, batch.times, batch.t0))
    ]


def run_offline_batch(sequences, model: Optional[Any], fparams: FilterParams,
                      cfg: VioConfig, opts: RunnerOptions, seed: int = 0,
                      device="cuda") -> list:
    """``run_offline`` for many sequences in lockstep on one device: one
    RunResult per sequence. The model runs once per lockstep frame on all
    B frame pairs; MC-dropout masks come from one generator seeded with
    ``seed``, drawn per frame for the whole batch."""
    from cuahn_vio_torch.parallel.sharded_eval import batched_run_sequences

    device = _check_devices(model, fparams, device)
    f32_parity_mode()
    batch = prepare_batch(sequences, opts, fparams, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    _, outs = batched_run_sequences(
        batch.states0, model, fparams, cfg, batch.imgs_u8, batch.w_win,
        batch.a_win, batch.dt_win, batch.n_used, generator,
    )
    return batch_results(outs, batch)

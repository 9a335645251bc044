"""Host orchestration: streaming init -> windowing -> the frame loop.

Counterpart of ``cuahn_vio.pipeline.runner.run_offline``: the host replays
the IMU stream into the initializer (feed_measurement_imu semantics),
builds the per-frame IMU windows, and runs the step over every frame pair
on the device. ``run_offline_batch`` runs many sequences in lockstep
(``run-vio-batch``): ``prepare_batch`` pads them to a common frame count,
``parallel.sharded_eval.batched_run_sequences`` runs them and
``batch_results`` trims each back to its own frames. ``run_stepwise`` runs
the frames one by one with the reference's per-stage timer (the timing
CSV of ``run-vio --timing-out``) and the divergence guard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import time

import numpy as np
import torch

from cuahn_vio_torch.filter.health import health_flags
from cuahn_vio_torch.filter.initializer import initial_state, try_initialize
from cuahn_vio_torch.filter.propagate import propagate_window
from cuahn_vio_torch.filter.state import FilterParams, FilterState, with_bias_block
from cuahn_vio_torch.ops.homography import f32_parity_mode
from cuahn_vio_torch.pipeline.imu_window import build_imu_windows, select_imu_readings
from cuahn_vio_torch.ops.quat import quat_to_rot
from cuahn_vio_torch.pipeline.vio import (
    NET,
    PROP,
    UPDATE,
    FrameOutput,
    VioConfig,
    make_vio_step,
    run_sequence,
    sequence_mask_keys,
)
from cuahn_vio_torch.utils import prng


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
    stage_ms: Optional[np.ndarray] = None  # (F, 5) timing rows (run_stepwise)
    n_recoveries: int = 0  # divergence-guard rollbacks (run_stepwise)


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


def _outputs_to_result(out: FrameOutput, times, t0, stage_ms=None) -> RunResult:
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
        stage_ms=stage_ms,
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


def _mask_table(model: Optional[Any], cfg: VioConfig, frame_keys: np.ndarray,
                device) -> Optional[torch.Tensor]:
    """The run's MC-dropout mask keys (``sequence_mask_keys`` of the (F,
    [B,] 2) frame keys) on ``device``, copied once; None when the run
    draws no mask (no network, or dropout rate 0)."""
    if model is None or getattr(model, "dropout_rate", 0.0) == 0.0:
        return None
    return prng.keys_tensor(sequence_mask_keys(frame_keys, cfg.max_iekf_iterations), device)


def batch_frame_keys(seed: int, n_sequences: int, frames: int) -> np.ndarray:
    """(frames, B, 2) frame keys of a batch (the JAX ``run-vio-batch``):
    ``split(PRNGKey(seed), B)``, one key a sequence, each split over the
    batch's padded frame count as ``run_offline`` splits its seed's key."""
    seq_keys = prng.split(prng.prng_key(seed), n_sequences)
    return prng.split(seq_keys, frames).transpose(1, 0, 2)


def run_offline(imu_t, imu_w, imu_a, cam_t, frames_u8,
                model: Optional[Any], fparams: FilterParams, cfg: VioConfig,
                opts: RunnerOptions, seed: int = 0, device="cuda") -> RunResult:
    """Run a whole sequence; returns per-frame world poses from the second
    processed frame onward (steps are image pairs).

    ``model`` (a UAHN, or None for dead reckoning) and ``fparams`` must
    live on ``device``. MC-dropout masks come from the JAX ``run_offline``'s
    keys: ``split(PRNGKey(seed), F)``, one a frame pair, the IEKF iteration
    folded in (``_mask_table``), so at one seed the masks are the JAX
    package's.
    """
    device = _check_devices(model, fparams, device)
    f32_parity_mode()
    init, state0, win, cam_used, frames_used = prepare_sequence(
        imu_t, imu_w, imu_a, cam_t, frames_u8, opts, fparams, device
    )

    def dev(x):
        return torch.as_tensor(x, device=device)

    _, outs = run_sequence(
        state0, model, fparams, cfg,
        dev(np.ascontiguousarray(frames_used, np.uint8)),
        dev(win.w_mid), dev(win.a_mid), dev(win.dt), win.n_used,
        _mask_table(model, cfg, prng.split(prng.prng_key(seed), win.dt.shape[0]), device),
    )
    times_out = cam_used[1:] + opts.calib_camimu_dt
    return _outputs_to_result(outs, times_out, init.t0)


class _StageClock:
    """Host wall time per step column, each stage closed by a device
    synchronize (``jax.block_until_ready`` in the JAX runner)."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
        self.ms = [0.0] * 5
        self.t = time.perf_counter()

    def start(self) -> None:
        self.ms = [0.0] * 5
        self.t = time.perf_counter()

    def __call__(self, column: int) -> None:
        self.sync()
        t = time.perf_counter()
        self.ms[column] += (t - self.t) * 1e3
        self.t = t


def _state_output(state: FilterState, failed: FrameOutput) -> FrameOutput:
    """The output of a rolled-back state: pose and covariance from the
    recovered state, the network diagnostics of the failed attempt (they
    describe what went wrong at this frame)."""
    return failed._replace(
        p_world=quat_to_rot(state.q) @ state.p, q=state.q, v_body=state.v,
        cov_core=state.cov[:15, :15], ba=state.ba, bg=state.bg,
    )


def _recovered(state: FilterState) -> FilterState:
    """The last healthy state with its covariance inflated, so that the
    next update trusts the measurement more than the state."""
    eye = torch.eye(state.cov.shape[-1], dtype=state.cov.dtype, device=state.cov.device)
    state = state._replace(cov=state.cov * 10.0 + eye * 1e-6)
    if state.cov_xb is not None:
        # decorrelating the bias keeps the inflated joint covariance PSD
        state = state._replace(cov_xb=torch.zeros_like(state.cov_xb))
    return state


def run_stepwise(imu_t, imu_w, imu_a, cam_t, frames_u8,
                 model: Optional[Any], fparams: FilterParams, cfg: VioConfig,
                 opts: RunnerOptions, seed: int = 0, device="cuda",
                 staged_timing: bool = True) -> RunResult:
    """``run_offline`` frame by frame with host stage timers and the
    divergence guard; ``stage_ms`` holds the reference's timing CSV columns
    (VioManager.cpp:98) per frame: [load, prop, net, update, total] ms.

    ``staged_timing`` (default): each stage of ``make_vio_stages`` is
    closed by a device synchronize, so every column is a measurement (the
    reference's inline stamps, VioManager.cpp:167-270); the offset prior
    counts to the network. Otherwise the step runs unbroken and its whole
    time goes to the network column, propagation and update reported as 0.

    MC-dropout masks come from ``run_offline``'s keys, so at one seed the
    two give one trajectory. (The JAX ``run_stepwise`` splits its key into
    one more key than its ``run_offline`` does, so its masks, and its
    poses, differ from its own ``run_offline``'s; this one equals the JAX
    ``run_offline``.) The warm-up step (frame 0's inputs, result
    discarded) draws frame 0's masks.

    Divergence guard: when ``health_flags`` fails after a frame, the state
    rolls back to the last healthy one with its covariance inflated
    (``cov * 10 + 1e-6 I``, the bias cross-covariance zeroed), the frame
    counter goes on from it, and the frame's output is the rolled-back
    state's pose with the failed attempt's network diagnostics;
    ``n_recoveries`` counts the rollbacks.
    """
    device = _check_devices(model, fparams, device)
    f32_parity_mode()
    init, state0, win, cam_used, frames_used = prepare_sequence(
        imu_t, imu_w, imu_a, cam_t, frames_u8, opts, fparams, device
    )
    step = make_vio_step(model, fparams, cfg)
    frames_dev = torch.as_tensor(np.ascontiguousarray(frames_used, np.uint8), device=device)
    mask_keys = _mask_table(model, cfg, prng.split(prng.prng_key(seed), win.dt.shape[0]),
                            device)
    clock = _StageClock(device)

    def keys(k: int):
        return None if mask_keys is None else mask_keys[k]

    def inputs(k: int):
        """Frame pair k -> k+1 and its IMU window on the device."""
        return (frames_dev[k], frames_dev[k + 1],
                *(torch.as_tensor(x[k], device=device) for x in (win.w_mid, win.a_mid, win.dt)),
                int(win.n_used[k]))

    # warm-up on frame 0's image (both frames) and the first window, so that
    # the first row times steady state
    *_, w, a, dt, n = inputs(0)
    step(state0, 0, frames_dev[0], frames_dev[0], w, a, dt, n, keys(0))
    clock.sync()

    state, frame_idx = state0, 0
    last_good, last_good_idx = state0, 0
    n_recoveries = 0
    outs, stage = [], []
    for k in range(len(cam_used) - 1):
        t_a = time.perf_counter()
        img_prev, img_curr, w, a, dt, n = inputs(k)
        clock.sync()
        t_b = time.perf_counter()
        clock.start()
        state, out = step(state, frame_idx, img_prev, img_curr, w, a, dt, n, keys(k),
                          clock if staged_timing else None)
        clock.sync()
        t_c = time.perf_counter()
        if bool(health_flags(state).ok):
            frame_idx += 1
            last_good, last_good_idx = state, frame_idx
        else:
            n_recoveries += 1
            state, frame_idx = _recovered(last_good), last_good_idx + 1
            out = _state_output(state, out)
        outs.append(out)
        load_ms, total_ms = (t_b - t_a) * 1e3, (t_c - t_a) * 1e3
        if staged_timing:
            stage.append([load_ms, clock.ms[PROP], clock.ms[NET], clock.ms[UPDATE], total_ms])
        else:
            stage.append([load_ms, 0.0, (t_c - t_b) * 1e3, 0.0, total_ms])

    stacked = FrameOutput(*(torch.stack(field) for field in zip(*outs)))
    times_out = cam_used[1:] + opts.calib_camimu_dt
    res = _outputs_to_result(stacked, times_out, init.t0, np.asarray(stage, np.float64))
    return res._replace(n_recoveries=n_recoveries)


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


def batch_results(outs: FrameOutput, batch: BatchInputs, first: int = 0) -> list:
    """One RunResult per sequence of ``outs``, trimmed to its own frames;
    ``outs`` holds the batch's sequences from index ``first`` on (a
    rank's shard)."""
    per_seq = list(zip(batch.n_frames, batch.times, batch.t0))[first:first + outs.p_world.shape[0]]
    return [
        _outputs_to_result(FrameOutput(*(x[i, :nf] for x in outs)), times, t0)
        for i, (nf, times, t0) in enumerate(per_seq)
    ]


def run_offline_batch(sequences, model: Optional[Any], fparams: FilterParams,
                      cfg: VioConfig, opts: RunnerOptions, seed: int = 0,
                      device="cuda", mesh=None) -> list:
    """``run_offline`` for many sequences in lockstep on one device: one
    RunResult per sequence. The model runs once per lockstep frame on all
    B frame pairs; MC-dropout masks come from the JAX ``run-vio-batch``'s
    keys (``batch_frame_keys``). With ``mesh``
    (``parallel.mesh``) the sequences are sharded over its ranks, and the
    results are this rank's sequences' (all of them on a one-device
    mesh)."""
    from cuahn_vio_torch.parallel.mesh import shard_bounds
    from cuahn_vio_torch.parallel.sharded_eval import batched_run_sequences

    device = _check_devices(model, fparams, device)
    f32_parity_mode()
    batch = prepare_batch(sequences, opts, fparams, device)
    frame_keys = batch_frame_keys(seed, len(batch.n_frames), batch.dt_win.shape[1])
    _, outs = batched_run_sequences(
        batch.states0, model, fparams, cfg, batch.imgs_u8, batch.w_win,
        batch.a_win, batch.dt_win, batch.n_used,
        _mask_table(model, cfg, frame_keys, "cpu" if mesh is not None else device), mesh=mesh,
    )
    first = 0 if mesh is None else shard_bounds(len(batch.n_frames), mesh)[0]
    return batch_results(outs, batch, first)

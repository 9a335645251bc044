"""Filter-in-the-loop (FIL) fine-tuning: optimize the network through the
deployed EKF recurrence itself.

Counterpart of ``cuahn_vio.train.fil``. Held-out single-pair corner error
and replay ATE decorrelate once the network is good: the filter is
sensitive to the error's temporal structure and to its covariance, not its
marginal size. So the loss is the pose drift of the actual filter over
short windows of flight: the deployed step (propagate -> prior-mode UAHN
-> EKF update -> reset, ``pipeline/vio.run_sequence``) runs with autograd
on, and gradients reach the network's block 4 and heads through both the
measurement mean (the Kalman gain's state correction) and the covariance
(the gain itself) at every frame. The part-1 homography is a constant to
backprop, as in the JAX model, so blocks 1-3 get no gradient.

Data: windows of W consecutive camera frames sampled from the UZH-FPV
training trajectories (``data/trajpairs``, the benchmark replays
excluded; ``data/bspline`` splines with exact IMU at the interval
midpoints), a bank built on the CPU once (``build_window_bank``). Each step
re-renders every window's imagery on the device (a random training-split
texture, motion blur, the photometric effects chain) and re-draws the IMU
noise and biases; the filter starts from ground truth perturbed
consistently with its initial covariance.

A window batch runs as B windows in lockstep (``run_sequence`` on (B, W+1,
H, W) frames: the filter under ``torch.func.vmap``, the network once per
frame on the B pairs), where the JAX module ``vmap``s the window loss.
The window loss is split in two: ``draw_windows`` (the draws of textures,
effects, IMU noise and initial states) and ``window_losses`` (the loss of
given draws and rendered frames), with ``render_windows`` between them.
Every draw is the JAX module's (``utils/prng``, the threefry kernel T1 on
a GPU, one launch a field for the batch): step i's ``key, kb, ks =
split(key, 3)`` from ``PRNGKey(seed)``, window b's key ``split(ks, B)[b]``
and its fields' ``split(window key, 10)`` (``draw_windows``; the tenth,
its filter run's MC-dropout key, ``window_mask_keys``); a pair step's
batch is the trainer's ``make_batch`` of kb.
The bank keeps no cache (the JAX module caches it in ``/tmp`` under a name
that leaves out the GT directory).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from cuahn_vio_torch.data.sensor_effects import (
    EffectsConfig,
    apply_photometric,
    draw_noise,
    draw_params,
)
from cuahn_vio_torch.data.synthetic import render_frame
from cuahn_vio_torch.data.textures import random_tex_params, texture_bank_u8, train_indices
from cuahn_vio_torch.data.trajpairs import GT_DIR
from cuahn_vio_torch.filter.state import FilterParams, FilterState
from cuahn_vio_torch.models.uahn import UAHN
from cuahn_vio_torch.ops.homography import f32_parity_mode
from cuahn_vio_torch.ops.quat import quat_conj, quat_exp, quat_log, quat_mul, quat_to_rot
from cuahn_vio_torch.pipeline.vio import VioConfig, run_sequence, sequence_mask_keys
from cuahn_vio_torch.train.trainer import (
    OptaxAdamW,
    TrainConfig,
    _clip,
    make_batch,
    make_train_step,
    step_mask_keys,
    warmup_cosine_decay,
)
from cuahn_vio_torch.utils import prng

PAIR_HEIGHT, PAIR_WIDTH = 224, 320  # the interleaved pair steps' render size


@dataclass(frozen=True)
class FilConfig:
    window: int = 6  # frames per window (W steps over W+1 images)
    batch_size: int = 4
    imu_substeps: int = 17  # IMU intervals per frame (~500 Hz at 30 fps)
    # IMU noise/bias draw per window per step (textured_replay.sh values)
    sigma_w: float = 0.002
    sigma_a: float = 0.02
    bias_g: float = 0.003
    bias_a: float = 0.02
    # initial-state perturbation sigmas == sqrt(initial covariance diag):
    # the filter starts consistent, in a plausible steady state
    init_pos_sigma: tuple = (0.05, 0.05, 0.03)
    init_tilt_sigma: float = 0.01  # rad, roll/pitch (yaw is gauge: exact)
    init_vel_sigma: float = 0.1
    init_ba_sigma: float = 0.03
    init_bg_sigma: float = 0.003
    # loss weights (later frames weighted linearly more: drift is what the
    # replay measures)
    w_pos: float = 1.0
    w_vel: float = 0.3
    w_tilt: float = 30.0  # rad^2 are tiny; bring tilt to a comparable scale
    # consistency (NEES) penalty on the filter's own velocity / tilt NEES
    # per frame, log-symmetric; 0 disables
    w_cons: float = 0.0
    # imagery
    exposure_s: float = 0.008
    blur_taps: int = 3
    tex_scale_range: tuple = (1.5, 10.0)
    img_hw: tuple = (224, 320)  # render size (tiny for tests)


class WindowBank(NamedTuple):
    """Precomputed noise-free window geometry (host numpy, built once)."""

    tap_p: np.ndarray  # (N, W+1, taps, 3) blur-tap world positions
    tap_q: np.ndarray  # (N, W+1, taps, 4) blur-tap quats (wxyz)
    w_true: np.ndarray  # (N, W, T, 3) true gyro at interval midpoints
    a_true: np.ndarray  # (N, W, T, 3) true specific force at midpoints
    dt: np.ndarray  # (N, W, T) interval lengths
    gt_p: np.ndarray  # (N, W+1, 3) world positions at frame times
    gt_q: np.ndarray  # (N, W+1, 4) quats at frame times (wxyz)
    gt_v: np.ndarray  # (N, W+1, 3) world velocities at frame times


def build_window_bank(n_windows: int = 1024, cfg: FilConfig = FilConfig(),
                      frame_dt: float = 1.0 / 30.0, seed: int = 0,
                      min_height: float = 0.6, gt_dir: str = GT_DIR) -> WindowBank:
    """Windows sampled uniformly over the training trajectories of
    ``gt_dir``, with the JAX module's numpy draws in its order: per
    trajectory, 3x as many window starts as it needs, then those whose
    frames all stay at least ``min_height`` above the ground, the first
    ``ceil(n_windows / trajectories)`` kept. Float32 spline evaluations on
    the CPU, one batched call per trajectory and quantity. Raises when
    ``gt_dir`` holds no training trajectory."""
    from cuahn_vio_torch.data.bspline import SplineTrajectory
    from cuahn_vio_torch.data.trajpairs import Z_OFFSET, train_trajectory_files

    files = train_trajectory_files(gt_dir)
    if not files:
        raise FileNotFoundError(
            f"no training trajectory under {gt_dir}: FIL windows are cut from "
            "*_with_gt.txt ground-truth files (the UZH-FPV GT, less the benchmark replays)")
    rng = np.random.default_rng(seed)
    trajs = [SplineTrajectory.from_trajectory_file(f, dt=0.1, z_offset=Z_OFFSET)
             for f in files]
    w1 = cfg.window
    span = w1 * frame_dt
    taps = np.linspace(-cfg.exposure_s, 0.0, cfg.blur_taps)
    t_sub = cfg.imu_substeps
    n_per = (n_windows + len(trajs) - 1) // len(trajs)
    parts = {k: [] for k in WindowBank._fields}
    f32 = lambda a: torch.tensor(np.asarray(a).reshape(-1), dtype=torch.float32)  # noqa: E731
    for tr in trajs:
        pq = vmap(lambda t, tr=tr: (tr.pos_w(t), tr.quat_i2w(t)))
        # oversample 3x, then reject low windows in one vectorized pass
        cand = rng.uniform(tr.t_min + 0.05, tr.t_max - span - 0.1, size=3 * n_per)
        ft = cand[:, None] + np.arange(w1 + 1)[None, :] * frame_dt  # (C, W+1)
        p_f = pq(f32(ft))[0].numpy().reshape(-1, w1 + 1, 3)
        keep = np.where(p_f[:, :, 2].min(axis=1) >= min_height)[0][:n_per]
        if keep.size == 0:
            continue
        ft = ft[keep]  # (K, W+1)
        k = ft.shape[0]
        p_t, q_t = pq(f32(ft[:, :, None] + taps[None, None, :]))
        parts["tap_p"].append(p_t.numpy().reshape(k, w1 + 1, cfg.blur_taps, 3))
        parts["tap_q"].append(q_t.numpy().reshape(k, w1 + 1, cfg.blur_taps, 4))
        edges = np.linspace(0.0, frame_dt, t_sub + 1)
        mids = ft[:, :-1, None] + 0.5 * (edges[:-1] + edges[1:])[None, None, :]  # (K, W, T)
        wt, at = vmap(tr.imu_true)(f32(mids))
        parts["w_true"].append(wt.numpy().reshape(k, w1, t_sub, 3))
        parts["a_true"].append(at.numpy().reshape(k, w1, t_sub, 3))
        parts["dt"].append(np.full((k, w1, t_sub), frame_dt / t_sub, np.float32))
        p_fr = pq(f32(ft))[0]
        _, q_gt, v_rc = vmap(tr.state_gt)(f32(ft))  # v_rc = Rᵀ v_w (robocentric)
        v_w = (quat_to_rot(q_gt) @ v_rc[:, :, None])[:, :, 0]
        parts["gt_p"].append(p_fr.numpy().reshape(k, w1 + 1, 3))
        parts["gt_q"].append(q_gt.numpy().reshape(k, w1 + 1, 4))
        parts["gt_v"].append(v_w.numpy().reshape(k, w1 + 1, 3))
    return WindowBank(**{k: np.concatenate(v).astype(np.float32)[:n_windows]
                         for k, v in parts.items()})


class WindowDraws(NamedTuple):
    """Everything random about a batch of B windows (``draw_windows``);
    the normals are standard, scaled by ``FilConfig`` in
    ``window_losses``."""

    tex_idx: torch.Tensor  # (B,) texture bank indices
    tex_params: torch.Tensor  # (B, 5)
    lens: torch.Tensor  # (B, 6) effects parameters, shared by a window's frames
    frame_noise: torch.Tensor  # (2, B, W+1, H, W) read and shot noise normals
    bias_g: torch.Tensor  # (B, 3) gyro bias normals
    bias_a: torch.Tensor  # (B, 3)
    noise_w: torch.Tensor  # (B, W, T, 3) gyro white-noise normals
    noise_a: torch.Tensor  # (B, W, T, 3)
    init_tilt: torch.Tensor  # (B, 2) initial roll/pitch error normals
    init_p: torch.Tensor  # (B, 3)
    init_v: torch.Tensor  # (B, 3)
    init_ba: torch.Tensor  # (B, 3)
    init_bg: torch.Tensor  # (B, 3)


def draw_windows(cfg: FilConfig, keys, tex_indices: torch.Tensor, device) -> WindowDraws:
    """The draws of B windows from their host keys ``keys`` (B, 2) (the JAX
    ``loss_fn``'s ``split(step key, B)``), on ``device``: each window's
    ``split(key, 10)`` as the JAX ``window_loss`` takes it, [0] the
    texture (``randint`` over ``tex_indices``), [1] its transform, [2] the
    lens (``draw_params``), [3] ``split(., W + 1)`` the frames' read and
    shot noise, [4] bias_g, [5] bias_a, [6] the gyro and [7] the
    accelerometer white noise, [8] ``split(., 5)`` the initial tilt, p, v,
    ba and bg errors ([9] is the masks', ``window_mask_keys``); one sampler
    call a field for the batch, the nine small normals in one."""
    ks = prng.split(keys, 10)
    hgt, wid = cfg.img_hw
    w, t = cfg.window, cfg.imu_substeps
    pick = prng.randint(ks[:, 0], (), 0, tex_indices.shape[0], device).long()
    ik = prng.split(ks[:, 8], 5)
    normals = prng.draw_fields(
        [(ks[:, 4], (3,)), (ks[:, 5], (3,)), (ks[:, 6], (w, t, 3)), (ks[:, 7], (w, t, 3)),
         (ik[:, 0], (2,))] + [(ik[:, i], (3,)) for i in range(1, 5)], prng.NORMAL, device)
    return WindowDraws(
        tex_indices[pick], random_tex_params(ks[:, 1], device, cfg.tex_scale_range),
        draw_params(EffectsConfig(), ks[:, 2], device),
        draw_noise(prng.split(ks[:, 3], w + 1), (hgt, wid), device), *normals,
    )


def render_windows(win: dict, draws: WindowDraws, cfg: FilConfig, c_rot_i, i_t_i2c,
                   tex_bank: torch.Tensor) -> torch.Tensor:
    """(B, W+1, H, W) uint8 frames of B windows: every frame the mean of its
    blur taps, all B windows' frames and taps in ONE launch of the flat
    sampler (B textures, (W+1) x taps x H x W points each), then the
    effects chain (one lens draw a window, per-frame noise), rounded to
    uint8 levels."""
    b, f, k = win["tap_p"].shape[:3]
    hgt, wid = cfg.img_hw
    taps = render_frame(win["tap_p"].reshape(b, f * k, 3), win["tap_q"].reshape(b, f * k, 4),
                        c_rot_i, i_t_i2c, None, hgt, wid, tex_bank[draws.tex_idx],
                        draws.tex_params)
    img = taps.reshape(b * f, k, hgt, wid).sum(dim=1) / k
    noise = draws.frame_noise.reshape(2, b * f, hgt, wid)
    img = apply_photometric(img, draws.lens.repeat_interleave(f, dim=0), 0.0, noise)
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).reshape(
        b, f, hgt, wid)


def _nees(e: torch.Tensor, p: torch.Tensor, eps: float) -> torch.Tensor:
    """e P^-1 e with P regularized by eps I, over leading dims."""
    eye = torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)
    return (e[..., None, :] @ torch.linalg.solve(p + eps * eye, e[..., None]))[..., 0, 0]


def window_losses(model_fn: Callable, fparams: FilterParams, cfg: FilConfig,
                  vio_cfg: VioConfig, win: dict, imgs_u8: torch.Tensor,
                  draws: WindowDraws, mask_keys: Optional[torch.Tensor] = None):
    """(B,) window losses of given draws and frames, differentiable into
    the network through the whole filter recurrence.

    Args:
        model_fn: the UAHN's grad-enabled call (``UAHN.flow_and_cov``).
        win: the batch's ``WindowBank`` rows as tensors on the device.
        imgs_u8: (B, W+1, H, W) uint8 frames (``render_windows``).
        mask_keys: (W, iters, B, 4, 2) MC-dropout mask keys of the
            windows' filter runs (``window_mask_keys``); None at rate 0.
    """
    dev = imgs_u8.device
    b = imgs_u8.shape[0]
    p_sig = torch.tensor(cfg.init_pos_sigma, dtype=torch.float32, device=dev)
    # IMU: a fresh bias + white noise draw
    w_m = win["w_true"] + (draws.bias_g * cfg.bias_g)[:, None, None] + draws.noise_w * cfg.sigma_w
    a_m = win["a_true"] + (draws.bias_a * cfg.bias_a)[:, None, None] + draws.noise_a * cfg.sigma_a
    # initial state: GT + a perturbation consistent with the initial covariance
    q0_gt, p0_w, v0_w = win["gt_q"][:, 0], win["gt_p"][:, 0], win["gt_v"][:, 0]
    dtheta = torch.cat([draws.init_tilt * cfg.init_tilt_sigma, p0_w.new_zeros(b, 1)], dim=1)
    q0 = quat_mul(q0_gt, quat_exp(dtheta))
    r0t = quat_to_rot(q0).transpose(-1, -2)
    p0 = (r0t @ p0_w[..., None])[..., 0] + draws.init_p * p_sig
    v0 = (r0t @ v0_w[..., None])[..., 0] + draws.init_v * cfg.init_vel_sigma
    diag = torch.cat([
        p_sig ** 2,
        torch.tensor([cfg.init_tilt_sigma ** 2, cfg.init_tilt_sigma ** 2, 1e-10], device=dev),
        torch.full((3,), cfg.init_vel_sigma ** 2, device=dev),
        torch.full((3,), cfg.init_ba_sigma ** 2, device=dev),
        torch.full((3,), cfg.init_bg_sigma ** 2, device=dev),
        torch.zeros(12, device=dev),
    ])
    state0 = FilterState(
        p=p0, q=q0, v=v0, ba=draws.init_ba * cfg.init_ba_sigma,
        bg=draws.init_bg * cfg.init_bg_sigma, off=p0.new_zeros(b, 4, 3),
        cov=torch.diag(diag).expand(b, 27, 27).contiguous(),
    )
    # the deployed recurrence, gradients on
    _, outs = run_sequence(state0, model_fn, fparams, vio_cfg, imgs_u8, w_m, a_m, win["dt"],
                           [cfg.imu_substeps] * cfg.window, mask_keys)

    # window loss against GT, later frames weighted more
    wgt = torch.arange(1, cfg.window + 1, dtype=torch.float32, device=dev)
    wgt = wgt / wgt.sum()
    e_pos = torch.sum((outs.p_world - win["gt_p"][:, 1:]) ** 2, dim=-1)  # (B, W)
    r_gt = quat_to_rot(win["gt_q"][:, 1:])
    v_gt_body = (r_gt.transpose(-1, -2) @ win["gt_v"][:, 1:, :, None])[..., 0]
    ev = outs.v_body - v_gt_body
    e_vel = torch.sum(ev ** 2, dim=-1)
    dq = quat_log(quat_mul(quat_conj(win["gt_q"][:, 1:]), outs.q))
    et = dq[..., :2]
    e_tilt = torch.sum(et ** 2, dim=-1)
    loss = torch.sum(wgt * (cfg.w_pos * e_pos + cfg.w_vel * e_vel + cfg.w_tilt * e_tilt), dim=-1)
    if cfg.w_cons > 0.0:
        # filter consistency: per-frame velocity (3-DoF) and tilt (2-DoF)
        # NEES of the filter's own covariance, log-symmetric, clipped so a
        # singular block cannot blow up the loss
        nees_v = _nees(ev, outs.cov_core[..., 6:9, 6:9], 1e-10)
        nees_t = _nees(et, outs.cov_core[..., 3:5, 3:5], 1e-12)
        l_cons = torch.sum(wgt * (torch.log(_clip(nees_v / 3.0, 1e-3, 1e6)) ** 2
                                  + torch.log(_clip(nees_t / 2.0, 1e-3, 1e6)) ** 2), dim=-1)
        loss = loss + cfg.w_cons * l_cons
    return loss


def mean_finite(losses: torch.Tensor) -> torch.Tensor:
    """The batch loss: the mean over the finite window losses (the JAX
    ``loss_fn``)."""
    fin = torch.isfinite(losses)
    return torch.sum(torch.where(fin, losses, torch.zeros_like(losses))) / torch.clamp(
        fin.sum(), min=1)


def window_mask_keys(step_key: np.ndarray, b: int, window: int, iters: int,
                     device) -> torch.Tensor:
    """(window, iters, b, 4, 2) MC-dropout mask keys of a FIL step's b
    windows on ``device``: window j's filter run takes the key
    ``split(split(step_key, b)[j], 10)[9]`` (the JAX ``window_loss``'s) and
    splits it over its frame pairs as ``run_sequence`` does."""
    run_keys = np.stack([prng.split(k, 10)[9] for k in prng.split(step_key, b)])
    frame_keys = np.stack([prng.split(k, window) for k in run_keys], axis=1)  # (W, b, 2)
    return prng.keys_tensor(sequence_mask_keys(frame_keys, iters), device)


def make_fil_loss(model: UAHN, fparams: FilterParams, cfg: FilConfig, vio_cfg: VioConfig,
                  c_rot_i, i_t_i2c, tex_bank: torch.Tensor, tex_indices: torch.Tensor):
    """loss_fn(win, step_key) -> scalar, the JAX ``loss_fn(params, win,
    step_key)``: the draws of the batch of windows ``win`` (``WindowBank``
    rows as device tensors) from ``split(step_key, B)`` (``draw_windows``),
    the render, then ``window_losses`` on the model's grad-enabled forward
    with the masks of ``window_mask_keys(step_key, ...)``, averaged over
    the finite windows."""

    def loss_fn(win: dict, step_key: np.ndarray) -> torch.Tensor:
        b = win["tap_p"].shape[0]
        draws = draw_windows(cfg, prng.split(step_key, b), tex_indices, tex_bank.device)
        imgs = render_windows(win, draws, cfg, c_rot_i, i_t_i2c, tex_bank)
        keys = window_mask_keys(step_key, b, cfg.window, vio_cfg.max_iekf_iterations,
                                imgs.device)
        return mean_finite(window_losses(model.flow_and_cov, fparams, cfg, vio_cfg, win,
                                         imgs, draws, keys))

    return loss_fn


def step_kinds(steps: int, pair_step_every: int, n_windows: int, batch: int, seed: int):
    """[(kind, window indices or the prior-mode coin)] of a run: the host
    stream of ``fil_finetune`` (one ``np.random.default_rng(seed)``, drawn
    in the JAX loop's order): every ``pair_step_every``-th step a pair step
    with its coin, the others a FIL step on ``batch`` distinct windows."""
    host_rng = np.random.default_rng(seed)
    kinds = []
    for i in range(steps):
        if pair_step_every and i % pair_step_every == pair_step_every - 1:
            kinds.append(("pair", bool(host_rng.random() < 0.5)))
        else:
            kinds.append(("fil", host_rng.choice(n_windows, batch, replace=False)))
    return kinds


def fil_finetune(model: UAHN, fparams: FilterParams, c_rot_i, i_t_i2c,
                 cfg: FilConfig = FilConfig(), steps: int = 2000, lr: float = 2e-5,
                 seed: int = 0, bank: Optional[WindowBank] = None, log_every: int = 20,
                 log_fn=print, checkpoint_path: Optional[str] = None, save_every: int = 200,
                 pair_step_every: int = 2, pair_cfg: Optional[TrainConfig] = None,
                 gt_dir: str = GT_DIR) -> UAHN:
    """Fine-tune ``model`` in place on its device with FIL window steps,
    interleaving a standard single-pair step (the trainer's, at
    ``pair_cfg``, 224x320) every ``pair_step_every`` steps as an anchor
    that keeps the covariance head's NLL calibration. One optimizer for
    both: the trainer's ``OptaxAdamW`` with optax's
    ``warmup_cosine_decay_schedule(0, lr, 100, max(steps, 101), lr / 10)``.
    Writes the weights to ``checkpoint_path`` every ``save_every`` steps.
    Returns the model."""
    from cuahn_vio_torch.utils.checkpoint import save_params

    f32_parity_mode()
    dev = model.corners.device
    c_rot_i, i_t_i2c = c_rot_i.to(dev), i_t_i2c.to(dev)
    if bank is None:
        log_fn("building FIL window bank...", flush=True)
        bank = build_window_bank(cfg=cfg, seed=seed, gt_dir=gt_dir)
    n_win = bank.tap_p.shape[0]
    log_fn(f"FIL bank: {n_win} windows of {cfg.window} frames", flush=True)

    tex_bank = texture_bank_u8(dev)
    tex_idx = torch.as_tensor(train_indices(tex_bank.shape[0]), dtype=torch.long, device=dev)
    bank_dev = {k: torch.as_tensor(v, device=dev) for k, v in bank._asdict().items()}
    loss_fn = make_fil_loss(model, fparams, cfg, VioConfig(update_gate_frames=-1), c_rot_i,
                            i_t_i2c, tex_bank, tex_idx)

    def schedule(count):
        return warmup_cosine_decay(count, 0.0, lr, 100, max(steps, 101), end_value=lr * 0.1)

    pair_cfg = pair_cfg or TrainConfig(batch_size=8)
    opt = OptaxAdamW(model.parameters(), schedule, pair_cfg.weight_decay, pair_cfg.grad_clip)
    pair_step = make_train_step(model, pair_cfg, opt)

    key = prng.prng_key(seed)  # the JAX loop's key chain
    for i, (tag, arg) in enumerate(step_kinds(steps, pair_step_every, n_win, cfg.batch_size,
                                              seed)):
        key, kb, ks = prng.split(key, 3)
        if tag == "pair":
            batch = make_batch(pair_cfg, kb, c_rot_i, i_t_i2c, PAIR_HEIGHT, PAIR_WIDTH,
                               tex_bank, tex_idx, None)
            loss, _ = pair_step(batch, arg, step_mask_keys(ks, pair_cfg.batch_size, None, dev))
        else:
            sel = torch.as_tensor(arg, device=dev)
            opt.zero_grad()
            loss = loss_fn({k: v[sel] for k, v in bank_dev.items()}, ks)
            loss.backward()
            opt.step()
            loss = loss.detach()
        if log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i:5d} [{tag}] loss {float(loss):.5f}", flush=True)
        if checkpoint_path and save_every and i and i % save_every == 0:
            save_params(checkpoint_path, model.state_dict())
    return model

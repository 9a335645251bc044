"""UAHN training: supervised cascade + heteroscedastic NLL, on one device
or data-parallel over the ranks of a ``torch.distributed`` job.

Counterpart of ``cuahn_vio.train.trainer`` (the reference ships no
training code; this trainer makes weights from scratch), with explicit
batch dims where the JAX trainer uses ``vmap``:

- Data: B random planar-scene frame pairs each step, drawn in one batch
  (``draw_pairs``: poses, textures, blur and effects parameters, the prior
  noise; a ``traj_pair_prob`` share of the pose pairs from the UZH-FPV
  pose-pair bank, ``data/trajpairs``, when its GT files are there) and
  then rendered by deterministic code (``render_pairs``): each
  frame of the pair is the mean of ``blur_taps`` renders across its
  exposure window, all B frames from B bank textures in ONE launch of the
  flat sampler (B4, shape 3), then the sensor-effect chain and rounding
  to uint8 levels. The exact corner-flow label comes from the poses
  (``data/oracle``).
- Part 1 (blocks 1-3): per-block Huber supervision of the cumulative
  corner flow (``UAHN.cascade_flows``), each block's incoming homography
  detached.
- Block 4: per-MC-member Huber loss on the warped-frame corner residual
  plus a clipped Gaussian NLL on the log-variance head; an optional
  prior-echo decorrelation penalty.
- Optimizer: ``OptaxAdamW``, what the JAX trainer's optax chain computes
  (warmup-cosine schedule, global-norm clip, AdamW, apply_if_finite).

Every draw is the JAX trainer's (``utils/prng``, the threefry kernel T1 on
a GPU): step i's key chain ``key, kb, ks = split(key, 3)`` from
``PRNGKey(seed)``; the batch's sample keys ``split(kb, B)`` and each
sample's ``split(k, 16)`` (``sample_pair``'s), every field from the key
and in the shape the JAX code uses for it, one sampler call (one T1
launch) a field for the whole batch, as ``jax_threefry_partitionable``
makes a draw under ``vmap`` over keys equal to the same draw key by key;
the held-out probe's batch from ``split(PRNGKey(probe_seed), 32)``; the
MC-dropout keys of sample b ``split(ks, B)[b]``, so each sample's masks
depend on its own key. The prior-mode coin is drawn on the host from
``np.random.default_rng(seed)``, as the JAX trainer's, so the two trainers
train the same sequence of modes on the same pairs from the same initial
weights (``models/uahn.init_uahn``).

Data parallelism (the JAX trainer's ``seq`` mesh): inside a job
(``parallel/mesh``) whose size W divides the batch, rank r trains rows
[r B/W, (r + 1) B/W) of the global batch and the W ranks compute what one
process computes on the whole batch. A rank draws, renders and runs only
its rows, from its rows' keys ``split(kb, B)[rB/W:(r + 1)B/W]`` (a
counter-based stream: the same draws as the whole batch's rows), with its
rows' own MC-dropout keys; the loss's denominators and the echo penalty's
moments are sums over the job (``parallel.mesh.differentiable_sum``), and
the flat gradient is summed by one ``all_reduce`` a step before the
optimizer's finite check and clip, so every rank applies the same update. Rank 0 alone logs,
probes and writes checkpoints. A batch that W does not divide trains
unsharded on every rank, as in the JAX trainer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cuahn_vio_torch.data.oracle import true_corner_flow
from cuahn_vio_torch.data.sensor_effects import (
    EffectsConfig,
    EffectsDraw,
    apply_effects_pair,
    draw_effects_pair,
    draw_noise,
    noise_keys,
)
from cuahn_vio_torch.data.synthetic import (
    random_texture_draws,
    render_frame,
    render_frame_blurred,
)
from cuahn_vio_torch.data.textures import (
    heldout_indices,
    random_tex_params,
    texture_bank_u8,
    train_indices,
)
from cuahn_vio_torch.models.uahn import UAHN
from cuahn_vio_torch.ops.homography import f32_parity_mode
from cuahn_vio_torch.ops.quat import quat_conj, quat_exp, quat_log, quat_mul
from cuahn_vio_torch.parallel.mesh import (
    Mesh,
    differentiable_sum,
    make_mesh,
    shard_bounds,
    world,
)
from cuahn_vio_torch.utils import prng

# the optax chain's constants (the JAX trainer's make_optimizer)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 10000  # apply_if_finite's
PROBE_SIZE = 32  # pairs of the held-out-texture probe's batch
PROBE_SEED = 20240817  # its batch's key, PRNGKey(PROBE_SEED); its masks' PRNGKey(PROBE_SEED + 1)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    lr: float = 2e-4
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    warmup_steps: int = 200
    huber_delta: float = 5.0  # px; caps outlier gradients early in training
    logvar_clip: float = 6.0
    nll_weight: float = 0.3
    prior_prob: float = 0.5  # fraction of steps trained in prior mode
    # simulated-EKF-prior noise: per-sample sigma drawn log-uniform in
    # [lo, hi] px (during fast flight the propagated prior is far worse
    # than a fixed 3 px, and the network must stay useful then)
    prior_noise_lo: float = 1.0
    prior_noise_px: float = 6.0  # upper end of the log-uniform range
    height_range: tuple = (0.8, 3.0)
    trans_sigma: float = 0.06  # inter-frame translation (m), ~v/fps
    rot_sigma: float = 0.025  # inter-frame rotation (rad)
    tilt_sigma: float = 0.12  # absolute roll/pitch (rad)
    # fraction of samples from the UZH-FPV pose-pair bank (data/trajpairs;
    # random poses while its GT files are absent)
    traj_pair_prob: float = 0.7
    use_textures: bool = True  # photo ground textures (data/textures.py)
    tex_scale_range: tuple = (1.5, 10.0)  # metres per texture period
    use_effects: bool = True  # vignette/exposure/noise chain
    exposure_frac_max: float = 0.5  # max exposure as fraction of frame dt
    blur_taps: int = 3  # pose taps per motion-blurred render
    max_flow_px: float = 120.0  # samples beyond this are masked from the loss
    # weight of the batch-level penalty on the regression slope of the
    # final-flow error against the fed-prior error in prior mode (the
    # cascade echoing prior error back makes the filter's white-noise
    # measurement model false); 0 disables
    echo_weight: float = 0.0
    # large-baseline curriculum (loop-closure revisit regime): fraction of
    # samples whose inter-frame translation is stretched by a factor drawn
    # from big_baseline_scale
    big_baseline_prob: float = 0.0
    big_baseline_scale: tuple = (2.0, 6.0)


class Batch(NamedTuple):
    img1: torch.Tensor  # (B, H, W) float32 at uint8 levels (k/255)
    img2: torch.Tensor  # (B, H, W)
    gt_flow: torch.Tensor  # (B, 8) pixels
    prior: torch.Tensor  # (B, 4, 2) noisy prior, pixels
    valid: torch.Tensor  # (B,) float32; 0 masks degenerate samples from the loss


class PairDraws(NamedTuple):
    """Everything random about B training pairs but the effects' noise."""

    p1: torch.Tensor  # (B, 3) world positions of frame 1
    q1: torch.Tensor  # (B, 4) its attitudes, wxyz
    p2: torch.Tensor  # (B, 3)
    q2: torch.Tensor  # (B, 4)
    dp: torch.Tensor  # (B, 3) p2 - p1: the blur taps follow the motion
    rv_d: torch.Tensor  # (B, 3) rotation vector of q1^-1 q2
    prior_sigma: torch.Tensor  # (B,) px at 320 wide
    prior_noise: torch.Tensor  # (B, 4, 2) standard normals
    tex_idx: Optional[torch.Tensor] = None  # (B,) bank indices (photo ground)
    tex_params: Optional[torch.Tensor] = None  # (B, 5)
    exposure_frac: Optional[torch.Tensor] = None  # (B,)
    effects: Optional[EffectsDraw] = None
    waves: Optional[tuple] = None  # procedural ground: (B, n, 2), (B, n, 2), (B, n)
    from_bank: Optional[torch.Tensor] = None  # (B,) bool: the pose pair is the bank's


def sample_keys(keys) -> np.ndarray:
    """(B, 16, 2): each sample key's ``split(k, 16)``, the keys of the JAX
    ``sample_pair``'s fields: 0 height, 1 tilt, 2 yaw, 3 dp, 4 rv_d, 5 the
    texture's randint or the procedural ground, 6 the prior's noise, 7 the
    texture transform, 8 the exposure, 9 the effects, 10 the prior's sigma,
    11 the bank coin, 12 the bank randint, 13 the bank yaw, 14 the
    big-baseline coin, 15 its stretch."""
    return prng.split(np.asarray(keys, np.uint32), 16)


def _bank_pairs(pair_bank, idx: torch.Tensor, yaw: torch.Tensor):
    """The pose pairs ``idx`` of ``pair_bank`` (p1, q1, p2, q2 on the
    device), each turned by its world ``yaw`` (the planar measurement model
    is yaw-invariant, and the texture transform randomizes planar
    position)."""
    bp1, bq1, bp2, bq2 = pair_bank
    zero = torch.zeros_like(yaw)
    q_yaw = quat_exp(torch.stack([zero, zero, yaw], dim=1))
    cy, sy = torch.cos(yaw), torch.sin(yaw)

    def turn(p):  # rz @ p, rz the yaw's rotation about z
        return torch.stack([cy * p[:, 0] - sy * p[:, 1], sy * p[:, 0] + cy * p[:, 1],
                            p[:, 2]], dim=1)

    return (turn(bp1[idx]), quat_mul(q_yaw, bq1[idx]), turn(bp2[idx]),
            quat_mul(q_yaw, bq2[idx]))


def draw_pairs(cfg: TrainConfig, keys, device,
               tex_indices: Optional[torch.Tensor] = None,
               pair_bank: Optional[tuple] = None) -> PairDraws:
    """The draws of the B training pairs of the host sample keys ``keys``
    (B, 2), on ``device``: the JAX ``sample_pair``'s of each key
    (``sample_keys``), one sampler call a field for the batch. Frame 1 at
    a random height, tilt and yaw over the plane, frame 2 moved by a random
    translation and rotation; with ``pair_bank`` (the flight-realistic
    pairs of ``data/trajpairs`` on the device), a ``cfg.traj_pair_prob``
    share of the pairs taken from it instead, each at a random world yaw
    (the random pose is drawn all the same, as in the JAX code), and every
    pair's blur motion taken from its two poses (dp = p2 - p1, rv_d =
    log(q1^-1 q2)); a ``big_baseline_prob`` share of the translations
    stretched; with ``tex_indices`` (the bank indices of the texture split)
    a texture, its transform, the exposure and the effects parameters per
    pair, else a procedural ground per pair; and the prior's noise."""
    ks = sample_keys(keys)

    def uniform(i: int, lo: float, hi: float) -> torch.Tensor:
        return prng.draw_field(ks[:, i], (), prng.UNIFORM, device, lo, hi)

    height = uniform(0, *cfg.height_range)
    tilt, dp, rv_d, prior_noise = prng.draw_fields(
        [(ks[:, 1], (2,)), (ks[:, 3], (3,)), (ks[:, 4], (3,)), (ks[:, 6], (4, 2))],
        prng.NORMAL, device)
    yaw = uniform(2, -math.pi, math.pi)
    q1 = quat_exp(torch.cat([tilt * cfg.tilt_sigma, yaw[:, None]], dim=1))
    dp, rv_d = dp * cfg.trans_sigma, rv_d * cfg.rot_sigma
    q2 = quat_mul(q1, quat_exp(rv_d))
    p1 = torch.cat([torch.zeros_like(dp[:, :2]), height[:, None]], dim=1)
    from_bank = None
    if pair_bank is not None and cfg.traj_pair_prob > 0.0:
        idx = prng.randint(ks[:, 12], (), 0, pair_bank[0].shape[0], device).long()
        bank = _bank_pairs(pair_bank, idx, uniform(13, 0.0, 2 * math.pi))
        from_bank = prng.draw_field(ks[:, 11], (), prng.BERNOULLI, device,
                                    cfg.traj_pair_prob).bool()
        pick = from_bank[:, None]
        p1, q1, p2, q2 = (torch.where(pick, x, y) for x, y in zip(bank, (p1, q1, p1 + dp, q2)))
        dp = p2 - p1  # the blur taps follow the actual inter-frame motion
        rv_d = quat_log(quat_mul(quat_conj(q1), q2))
    if cfg.big_baseline_prob > 0.0:
        big = prng.draw_field(ks[:, 14], (), prng.BERNOULLI, device, cfg.big_baseline_prob)
        stretch = uniform(15, *cfg.big_baseline_scale)
        dp = dp * torch.where(big.bool(), stretch, torch.ones_like(stretch))[:, None]
    extra = {}
    if tex_indices is not None:
        pick = prng.randint(ks[:, 5], (), 0, tex_indices.shape[0], device).long()
        extra = dict(
            tex_idx=tex_indices[pick],
            tex_params=random_tex_params(ks[:, 7], device, cfg.tex_scale_range),
            exposure_frac=uniform(8, 0.0, cfg.exposure_frac_max),
            effects=(draw_effects_pair(EffectsConfig(), ks[:, 9], device)
                     if cfg.use_effects else None),
        )
    else:
        extra["waves"] = random_texture_draws(ks[:, 5], device)
    log_lo, log_hi = math.log(cfg.prior_noise_lo), math.log(cfg.prior_noise_px)
    return PairDraws(
        p1=p1, q1=q1, p2=p1 + dp, q2=q2, dp=dp, rv_d=rv_d,
        prior_sigma=torch.exp(uniform(10, log_lo, log_hi)), prior_noise=prior_noise,
        from_bank=from_bank, **extra,
    )


def render_pairs(draws: PairDraws, cfg: TrainConfig, c_rot_i, i_t_i2c,
                 height: int = 224, width: int = 320,
                 bank: Optional[torch.Tensor] = None,
                 noise: Optional[tuple] = None) -> Batch:
    """The batch of ``draws``, deterministically.

    On the photo ground (``draws.tex_idx`` into ``bank``, (N, T, T) uint8
    on the device): each frame the mean of ``cfg.blur_taps`` renders over
    its exposure window (poses along the inter-frame motion), the B first
    frames in one launch of the flat sampler and the B second frames in
    another, then the effects chain of ``draws.effects`` with ``noise`` =
    (noise1, noise2) of ``sensor_effects.draw_noise``. On the procedural
    ground, one sharp render per sample. Frames are rounded to uint8
    levels (the deployed pipeline feeds /255-normalized uint8 frames); the
    corner-flow label is scaled by (width - 1) / 319 for a narrower model.
    """
    if draws.tex_idx is not None:
        k = cfg.blur_taps
        betas = torch.linspace(-1.0, 0.0, k, device=draws.p1.device)[None] * (
            draws.exposure_frac[:, None])  # (B, K)

        def taps(p, q):
            ps = p[:, None] + betas[..., None] * draws.dp[:, None]
            qs = quat_mul(q[:, None], quat_exp(betas[..., None] * draws.rv_d[:, None]))
            return ps, qs

        textures = bank[draws.tex_idx]
        img1, img2 = (
            render_frame_blurred(*taps(p, q), c_rot_i, i_t_i2c, None, height, width,
                                 textures, draws.tex_params)
            for p, q in ((draws.p1, draws.q1), (draws.p2, draws.q2))
        )
        if draws.effects is not None:
            img1, img2 = apply_effects_pair(img1, img2, draws.effects, *noise)
    else:
        img1, img2 = (
            torch.stack([render_frame(p[i], q[i], c_rot_i, i_t_i2c,
                                      [w[i] for w in draws.waves], height, width)
                         for i in range(p.shape[0])])
            for p, q in ((draws.p1, draws.q1), (draws.p2, draws.q2))
        )
    img1 = torch.round(torch.clamp(img1, 0.0, 1.0) * 255.0) / 255.0
    img2 = torch.round(torch.clamp(img2, 0.0, 1.0) * 255.0) / 255.0
    gt_flow = true_corner_flow(draws.p1, draws.q1, draws.p2, draws.q2, c_rot_i, i_t_i2c)
    gt_flow = gt_flow * (width - 1) / 319.0  # scaled when a narrower model is trained
    prior = gt_flow.reshape(-1, 4, 2) + draws.prior_noise * (
        draws.prior_sigma * (width - 1) / 319.0)[:, None, None]
    # geometrically degenerate draws (corners flung far off-image) blow up
    # the cascade loss: masked
    valid = torch.all(torch.abs(gt_flow) < cfg.max_flow_px, dim=1).to(torch.float32)
    return Batch(img1=img1, img2=img2, gt_flow=gt_flow, prior=prior, valid=valid)


def make_batch(cfg: TrainConfig, key, c_rot_i, i_t_i2c, height: int = 224, width: int = 320,
               bank: Optional[torch.Tensor] = None,
               tex_indices: Optional[torch.Tensor] = None,
               pair_bank: Optional[tuple] = None, mesh: Optional[Mesh] = None) -> Batch:
    """The JAX ``make_batch(key, ...)``: ``cfg.batch_size`` fresh training
    pairs from the sample keys ``split(key, B)`` (``key`` a host (2,)
    uint32 key), on the photo textures ``tex_indices`` of ``bank`` (both
    None: the procedural ground), a share of their poses from
    ``pair_bank``, on ``c_rot_i``'s device: ``draw_pairs``, the effects'
    noise (each frame's read and shot normals, one launch for the batch's
    2 x 2 x B frames), then ``render_pairs``. With ``mesh``, only this
    rank's rows (``shard_bounds``) are drawn and rendered."""
    device = c_rot_i.device
    keys = prng.split(key, cfg.batch_size)
    if mesh is not None:
        lo, hi = shard_bounds(cfg.batch_size, mesh)
        keys = keys[lo:hi]
    draws = draw_pairs(cfg, keys, device, tex_indices, pair_bank)
    noise = None
    if draws.effects is not None:
        drawn = draw_noise(noise_keys(sample_keys(keys)[:, 9]), (height, width), device)
        noise = (drawn[:, 0], drawn[:, 1])
    return render_pairs(draws, cfg, c_rot_i, i_t_i2c, height, width, bank, noise)


def _warped_frame_gt(h_part1, gt_flow, corners):
    """Ground-truth corner residual in the warped-img2 frame, block 4's
    regression target: H^-1 (corners + gt_flow) - corners, (B, 4, 2)."""
    dst = corners + gt_flow.reshape(-1, 4, 2)
    uv1 = torch.cat([dst, torch.ones_like(dst[..., :1])], dim=-1)
    m = uv1 @ torch.linalg.inv(h_part1).transpose(-1, -2)
    return m[..., :2] / m[..., 2:3] - corners


def _clip(x, lo, hi):
    """``jnp.clip``: max then min, whose backward passes a NaN cotangent on
    (``torch.clamp``'s would zero it), so a non-finite sample poisons the
    same gradient entries as in the JAX trainer."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _huber(err, delta):
    a = torch.abs(err)
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def make_loss_fn(model: UAHN, cfg: TrainConfig, mesh: Optional[Mesh] = None) -> Callable:
    """loss_fn(batch, use_prior, dropout_keys) -> (total loss, (3,) batch
    means of the cascade, member-mean and NLL losses), differentiable in
    the model's parameters; ``dropout_keys`` (B, 4, 2) are the rows' mask
    keys (``step_mask_keys``; None at dropout rate 0).

    With ``mesh`` (data-parallel), ``batch`` is this rank's rows of the
    global batch and the loss is this rank's share of the global one: the
    weight sums and the echo moments are summed over the job
    (``mesh.differentiable_sum``, whose backward sums the cotangents of
    the W ranks' copies), each rank's echo term counts 1 / W of the penalty
    every rank computes, and the (3,) means are this rank's rows' weighted
    sums over the global weight. The ranks' losses, aux and gradients then
    sum to one process's on the whole batch."""
    corners = model.corners
    if mesh is None:
        n_ranks = 1

        def gsum(x):
            return x
    else:
        gsum, n_ranks = differentiable_sum, mesh.size

    def loss_fn(batch: Batch, use_prior: bool, dropout_keys: Optional[torch.Tensor]):
        img1, img2, gt = batch.img1, batch.img2, batch.gt_flow
        flows, h1 = model.cascade_flows(img1, img2, batch.prior if use_prior else None,
                                        use_prior)
        l_cascade = _huber(flows - gt[:, None], cfg.huber_delta).mean(dim=(1, 2))

        h1 = h1.detach()
        means, logvars = model.last_block_members(img1, img2, h1, dropout_keys)
        logvars = _clip(logvars, -cfg.logvar_clip, cfg.logvar_clip)
        err = means - _warped_frame_gt(h1, gt, corners)[:, None]  # (B, 16, 4, 2)
        l_mean = _huber(err, cfg.huber_delta).mean(dim=(1, 2, 3))
        # NLL on the clipped residual, so one outlier cannot blow up the
        # variance head
        clip = 3 * cfg.huber_delta
        err2 = torch.square(_clip(err, -clip, clip))
        l_nll = (0.5 * (logvars + err2 / torch.exp(logvars))).mean(dim=(1, 2, 3))
        losses = l_cascade + l_mean + cfg.nll_weight * l_nll

        # a degenerate sample (singular DLT, off-image corner flow) must not
        # poison the batch: invalid-geometry and non-finite samples weigh 0
        w = batch.valid * torch.isfinite(losses).to(torch.float32)
        losses = torch.where(w > 0, losses, torch.zeros_like(losses)) * w
        denom = torch.clamp(gsum(torch.sum(w)), min=1.0)
        total = torch.sum(losses) / denom

        if use_prior and cfg.echo_weight > 0.0:
            # echo decorrelation: squared batch regression slope of the
            # output errors (the cascade's final flow, and the full output
            # through the member mean) on the fed prior's error
            err_casc = flows[:, -1] - gt
            uv1 = torch.cat([corners + means.mean(dim=1), torch.ones_like(corners[:, :1])
                             .expand(means.shape[0], 4, 1)], dim=-1)
            m_full = uv1 @ h1.transpose(-1, -2)
            err_full = (m_full[..., :2] / m_full[..., 2:3] - corners).reshape(-1, 8) - gt
            err_prior = batch.prior.reshape(-1, 8) - gt
            wf = (w * torch.all(torch.isfinite(err_full), dim=1)
                  * torch.all(torch.isfinite(err_casc), dim=1))[:, None]

            def slope2(e):
                e = torch.where(wf > 0, e, torch.zeros_like(e))
                p = torch.where(wf > 0, err_prior, torch.zeros_like(err_prior))
                n = torch.clamp(gsum(torch.sum(wf)), min=1.0)
                e = e - gsum(torch.sum(e, dim=0)) / n
                p = p - gsum(torch.sum(p, dim=0)) / n
                cov = gsum(torch.sum(e * p * wf, dim=0))
                var = gsum(torch.sum(p * p * wf, dim=0)) + 1e-3
                return torch.mean((cov / var) ** 2)

            echo = cfg.echo_weight * (slope2(err_casc) + slope2(err_full))
            total = total + echo / n_ranks

        aux = torch.stack([
            torch.sum(torch.where(w > 0, x, torch.zeros_like(x)) * w) / denom
            for x in (l_cascade, l_mean, l_nll)
        ])
        return total, aux

    return loss_fn


def warmup_cosine_decay(count: torch.Tensor, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> torch.Tensor:
    """optax's ``warmup_cosine_decay_schedule`` at integer ``count``, in
    float32: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = torch.clamp(count, 0, warmup_steps).to(torch.float32)
    frac = 1 - warm / max(warmup_steps, 1)
    linear = (init_value - peak_value) * frac + peak_value
    span = decay_steps - warmup_steps
    t = torch.clamp((count - warmup_steps).to(torch.float32), max=float(span))
    cosine = 0.5 * (1 + torch.cos(math.pi * t / span))
    decayed = peak_value * ((1 - alpha) * cosine + alpha)
    return torch.where(count < warmup_steps, linear, decayed)


class OptaxAdamW:
    """What the JAX trainer's optax chain computes, on one flat buffer:

        apply_if_finite(chain(zero_nonfinite, clip_by_global_norm(clip),
                              adamw(schedule, weight_decay)),
                        MAX_CONSECUTIVE_ERRORS)

    - a step whose gradients hold a NaN or inf changes nothing (parameters,
      moments and step count stay) and counts a skip (``notfinite_count``:
      consecutive, reset by a finite step; ``total_notfinite``), unless
      more than ``MAX_CONSECUTIVE_ERRORS`` came in a row: then it applies
      with the non-finite entries zeroed;
    - the gradients are scaled by clip / ||g|| when their global norm
      ||g|| (over all parameters) is not below ``clip`` (optax's formula:
      no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
    - Adam (ADAM_B1, ADAM_B2, ADAM_EPS) with bias correction, plus the decoupled decay
      ``weight_decay * p``, all times -lr, lr = ``schedule(count)``, count
      the updates applied so far (the first update uses schedule(0)).

    Every decision stays on the device (no host synchronize per step).
    The parameters become views of one flat buffer; a parameter without a
    gradient has a zero gradient, as in JAX. ``grad_reduce``, where given,
    reduces the flat gradient in place before anything reads it (the
    data-parallel trainer's one ``all_reduce`` a step), so every rank sees
    the same gradient and takes the same decisions.
    """

    def __init__(self, params, schedule: Callable, weight_decay: float, grad_clip: float,
                 grad_reduce: Optional[Callable] = None):
        self.params = list(params)
        self.schedule = schedule
        self.grad_reduce = grad_reduce
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        offset = 0
        for p in self.params:
            p.data = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        self.flat = flat
        self.mu = torch.zeros_like(flat)
        self.nu = torch.zeros_like(flat)
        zero = torch.zeros((), dtype=torch.int32, device=flat.device)
        self._b1 = torch.full((), ADAM_B1, device=flat.device)  # bias corrections' bases
        self._b2 = torch.full((), ADAM_B2, device=flat.device)
        self.count = zero.clone()
        self.notfinite_count = zero.clone()
        self.total_notfinite = zero.clone()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad``."""
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        if self.grad_reduce is not None:
            self.grad_reduce(g)
        finite_entries = torch.isfinite(g)
        finite = torch.all(finite_entries)
        self.notfinite_count = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                           self.notfinite_count + 1)
        self.total_notfinite = torch.where(finite, self.total_notfinite,
                                           self.total_notfinite + 1)
        apply = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)

        g = torch.where(finite_entries, g, torch.zeros_like(g))
        g_norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(g_norm < self.grad_clip, g, g / g_norm * self.grad_clip)
        count_inc = self.count + 1
        mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu
        mu_hat = mu / (1 - torch.pow(self._b1, count_inc))
        nu_hat = nu / (1 - torch.pow(self._b2, count_inc))
        update = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) + self.weight_decay * self.flat
        update = -self.schedule(self.count) * update
        self.flat.copy_(torch.where(apply, self.flat + update, self.flat))
        self.mu = torch.where(apply, mu, self.mu)
        self.nu = torch.where(apply, nu, self.nu)
        self.count = torch.where(apply, count_inc, self.count)


def make_optimizer(model: UAHN, cfg: TrainConfig, steps: int,
                   grad_reduce: Optional[Callable] = None) -> OptaxAdamW:
    """The JAX trainer's optimizer for a run of ``steps``: warmup from 0 to
    ``cfg.lr`` over ``cfg.warmup_steps``, cosine to 5 % of it;
    ``grad_reduce`` as ``OptaxAdamW``'s."""
    decay_steps = max(steps, cfg.warmup_steps + 1)

    def schedule(count):
        return warmup_cosine_decay(count, 0.0, cfg.lr, cfg.warmup_steps, decay_steps,
                                   end_value=cfg.lr * 0.05)

    return OptaxAdamW(model.parameters(), schedule, cfg.weight_decay, cfg.grad_clip,
                      grad_reduce)


def make_train_step(model: UAHN, cfg: TrainConfig, opt: OptaxAdamW,
                    mesh: Optional[Mesh] = None) -> Callable:
    """train_step(batch, use_prior, dropout_keys) -> (loss, aux): one gradient
    step of ``opt`` on the model's parameters, in place; with ``mesh``,
    this rank's share of the loss and aux (``make_loss_fn``), and ``opt``
    must sum the gradient over the job."""
    loss_fn = make_loss_fn(model, cfg, mesh)

    def train_step(batch: Batch, use_prior: bool, dropout_keys: Optional[torch.Tensor]):
        opt.zero_grad()
        loss, aux = loss_fn(batch, use_prior, dropout_keys)
        loss.backward()
        opt.step()
        return loss.detach(), aux.detach()

    return train_step


def make_probe_metric(model: UAHN, c_rot_i, i_t_i2c, cfg: TrainConfig, height: int,
                      width: int, probe_size: int, probe_seed: int = PROBE_SEED) -> Callable:
    """The held-out-texture probe: one frozen batch of ``probe_size`` pairs
    on the held-out textures (never trained on), the JAX probe's
    ``split(PRNGKey(probe_seed), probe_size)`` samples without the pose-pair
    bank (``make_batch`` of the key ``PRNGKey(probe_seed)``), and a
    function model -> (prior-mode, no-prior) mean corner-flow error in px
    over the valid samples, every sample's MC-dropout masks those of the
    JAX probe's one key ``PRNGKey(probe_seed + 1)``, in both modes on every
    call (the statistic ``eval-flow`` reports)."""
    dev = model.corners.device
    bank = texture_bank_u8(dev)
    held = torch.as_tensor(heldout_indices(bank.shape[0]), dtype=torch.long, device=dev)
    batch = make_batch(replace(cfg, batch_size=probe_size), prng.prng_key(probe_seed),
                       c_rot_i, i_t_i2c, height, width, bank, held)
    w = batch.valid.repeat_interleave(4)
    drop = prng.keys_tensor(np.repeat(prng.mask_keys(prng.prng_key(probe_seed + 1))[None],
                                      probe_size, axis=0), dev)

    def metric(model: UAHN):
        errs = []
        for use_prior in (True, False):
            pred, _ = model(batch.img1, batch.img2, batch.prior if use_prior else None,
                            use_prior, dropout_keys=drop)
            e = torch.linalg.vector_norm((pred - batch.gt_flow).reshape(-1, 4, 2), dim=-1)
            errs.append(torch.sum(e.reshape(-1) * w) / torch.clamp(w.sum(), min=1.0))
        return errs[0], errs[1]

    return metric


def step_mask_keys(step_key: np.ndarray, batch_size: int, mesh: Optional[Mesh],
                   device) -> torch.Tensor:
    """The (b, 4, 2) MC-dropout mask keys of this rank's rows of a step
    whose samples' keys are ``split(step_key, batch_size)`` (the JAX
    ``loss_fn``'s), on ``device``: all rows without a mesh."""
    keys = prng.split(step_key, batch_size)
    if mesh is not None:
        lo, hi = shard_bounds(batch_size, mesh)
        keys = keys[lo:hi]
    return prng.keys_tensor(prng.mask_keys(keys), device)


def train(model: UAHN, c_rot_i, i_t_i2c, cfg: TrainConfig = TrainConfig(),
          steps: int = 1000, seed: int = 0, log_every: int = 50, height: int = 224,
          width: int = 320, log_fn=print, checkpoint_path: Optional[str] = None,
          save_every: int = 500, probe_every: int = 1000,
          gt_dir: Optional[str] = None) -> UAHN:
    """Train ``model`` in place on its device for ``steps`` steps; returns it.

    With ``cfg.traj_pair_prob`` > 0 and UZH-FPV GT files under ``gt_dir``
    (default ``data.trajpairs.GT_DIR``), that share of the pose pairs comes
    from their pose-pair bank (``build_pose_pair_bank``); without such
    files, every pair is random, as in the JAX trainer.

    Logs the loss every ``log_every`` steps and at the last; writes the
    weights to ``checkpoint_path`` every ``save_every`` steps (Flax
    msgpack, ``utils/checkpoint.save_params``). Every ``probe_every``
    steps and at the last, logs the held-out-texture probe
    (``make_probe_metric``, with photo textures only) and writes the best
    weights by its prior-mode error to ``<checkpoint_path>.best``.

    Inside a ``torch.distributed`` job of W ranks (``parallel/mesh``), each
    with its model on its own device and the same initial weights, trains
    data-parallel when W divides ``cfg.batch_size`` (see the module
    docstring; logged as "data-parallel over W ranks (seq mesh)"), else
    unsharded on every rank; either way every rank ends with the same
    weights, and rank 0 alone logs, probes and writes.
    """
    import torch.distributed as dist

    from cuahn_vio_torch.data.trajpairs import (
        GT_DIR,
        build_pose_pair_bank,
        train_trajectory_files,
    )
    from cuahn_vio_torch.utils.checkpoint import save_params

    f32_parity_mode()  # homography algebra needs full float32, not TF32
    dev = model.corners.device
    c_rot_i, i_t_i2c = c_rot_i.to(dev), i_t_i2c.to(dev)
    n_ranks, rank = world()
    if rank:
        def log_fn(*args, **kwargs):
            return None
    mesh = None
    if dist.is_available() and dist.is_initialized():
        if cfg.batch_size % n_ranks == 0:
            mesh = make_mesh(dev)
            log_fn(f"data-parallel over {n_ranks} ranks (seq mesh)", flush=True)
        else:
            log_fn(f"batch {cfg.batch_size} does not split over {n_ranks} ranks: training "
                   "unsharded, the whole batch on every rank", flush=True)
    opt = make_optimizer(model, cfg, steps, None if mesh is None else dist.all_reduce)
    step_fn = make_train_step(model, cfg, opt, mesh)

    bank = tex_idx = None
    if cfg.use_textures:
        bank = texture_bank_u8(dev)
        tex_idx = torch.as_tensor(train_indices(bank.shape[0]), dtype=torch.long, device=dev)
        log_fn(f"texture bank: {bank.shape[0]} textures, {tex_idx.shape[0]} in training "
               "split", flush=True)

    pair_bank = None
    if cfg.traj_pair_prob > 0.0:
        gt_dir = GT_DIR if gt_dir is None else gt_dir
        if train_trajectory_files(gt_dir):
            pairs = build_pose_pair_bank(gt_dir)
            pair_bank = tuple(torch.as_tensor(pairs[k], device=dev)
                              for k in ("p1", "q1", "p2", "q2"))
            log_fn(f"trajectory pose-pair bank: {pairs['p1'].shape[0]} pairs "
                   f"({cfg.traj_pair_prob:.0%} of samples)", flush=True)
        else:
            log_fn(f"trajectory pair bank unavailable (no *_with_gt.txt under {gt_dir}); "
                   "random poses", flush=True)

    probe_fn = None
    best_probe = float("inf")
    if probe_every and cfg.use_textures and rank == 0:
        probe_fn = make_probe_metric(model, c_rot_i, i_t_i2c, cfg, height, width,
                                     probe_size=PROBE_SIZE)

    # the prior-mode coin: the JAX trainer's host stream, flip for flip
    host_rng = np.random.default_rng(seed)
    key = prng.prng_key(seed)  # the JAX trainer's key chain
    for i in range(steps):
        key, kb, ks = prng.split(key, 3)
        batch = make_batch(cfg, kb, c_rot_i, i_t_i2c, height, width, bank, tex_idx, pair_bank,
                           mesh)
        use_prior = bool(host_rng.random() < cfg.prior_prob)
        loss, aux = step_fn(batch, use_prior, step_mask_keys(ks, cfg.batch_size, mesh, dev))
        if log_every and (i % log_every == 0 or i == steps - 1):
            if mesh is not None:  # the ranks' shares sum to the batch's loss and means
                shares = torch.cat([loss[None], aux])
                dist.all_reduce(shares)
                loss, aux = shares[0], shares[1:]
            l_c, l_m, l_n = aux.tolist()
            log_fn(f"step {i:5d} loss {loss.item():.4f} cascade {l_c:.4f} mean {l_m:.4f} "
                   f"nll {l_n:.4f} prior={use_prior} skipped={int(opt.notfinite_count)}",
                   flush=True)
        if probe_fn is not None and ((i and i % probe_every == 0) or i == steps - 1):
            e_prior, e_noprior = (float(e) for e in probe_fn(model))
            log_fn(f"step {i:5d} PROBE heldout-tex corner err px: prior {e_prior:.3f} "
                   f"noprior {e_noprior:.3f} (best {min(best_probe, e_prior):.3f})",
                   flush=True)
            if checkpoint_path and e_prior < best_probe:
                best_probe = e_prior
                save_params(checkpoint_path + ".best", model.state_dict())
        if checkpoint_path and save_every and i and i % save_every == 0 and rank == 0:
            save_params(checkpoint_path, model.state_dict())
    return model


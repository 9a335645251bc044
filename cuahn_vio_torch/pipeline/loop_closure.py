"""Network-based loop closure: UAHN relative-position factors between
distant keyframes.

Counterpart of ``cuahn_vio.pipeline.loop_closure``. Any two keyframes
whose ground footprints overlap can be constrained by one more homography
inference over the planar scene:

1. candidate pairs: temporally distant, spatially near (estimated poses);
2. the prior-mode UAHN runs on the (frame_i, frame_j) pair with the prior
   4-point offset computed from the current pose estimates
   (``flow_between``), the filter's prior pathway across a long baseline;
3. the 4 corner rays of frame i meet the z = 0 ground plane at G_k;
4. the measured corners + flow in frame j give bearings u_k; with the
   attitude R_j taken from the estimate, u_k x R_j^T (G_k - c_j) = 0 is
   linear in the camera-j position c_j: a 12 x 3 least squares
   (``position_from_flow``);
5. the factor is the relative position (frame-i IMU coordinates) for the
   pose-graph smoother, with the relative attitude of the estimates.

The port runs the network over all pairs that pass the geometric gate in
batches of at most ``LOOP_BATCH`` pairs (the JAX module runs one pair at a
time), on the uint8 frames as ``run-vio`` feeds it, so its warps launch
once per site and batch. MC-dropout masks come from the JAX module's keys:
candidate pair n calls the network with ``fold_in(PRNGKey(seed), n)``, and
a batch's masks are one launch of the threefry kernel T1. The least
squares is ``torch.linalg.lstsq``: on CUDA it solves by QR (``gels``)
only, which rounds otherwise than the JAX package's SVD-based solve.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from cuahn_vio_torch.data.oracle import camera_pose, true_corner_flow
from cuahn_vio_torch.filter.state import CORNER_XY1, FOCAL
from cuahn_vio_torch.ops.quat import quat_to_rot, skew
from cuahn_vio_torch.parallel.pose_graph import relative_pose
from cuahn_vio_torch.utils import prng

LOOP_BATCH = 64  # pairs a network call at most


class LoopFactors(NamedTuple):
    pairs: np.ndarray  # (L, 2) keyframe indices (i, j)
    dp_meas: np.ndarray  # (L, 3) measured p_j - p_i in IMU frame i
    dq_meas: np.ndarray  # (L, 4) relative attitude from the estimates
    sigma_p: np.ndarray  # (L,) per-factor position sigma (m) from the
    # network covariance: height * mean corner sigma / focal
    inferred: int = 0  # candidates inside the geometric gate: the network ran on them


def find_loop_candidates(
    times: np.ndarray,
    p_world: np.ndarray,
    min_dt: float = 3.0,
    max_dist: float = 1.0,
    stride: int = 5,
    max_pairs: int = 32,
) -> np.ndarray:
    """Temporally distant, spatially near keyframe pairs (L, 2): for every
    ``stride``-th keyframe i, its NEAREST partner j (on the same stride, at
    least ``min_dt`` later) if within ``max_dist``; at most ``max_pairs``.
    Factor quality goes as the revisit baseline (corner flow ~ baseline /
    height * focal), so the nearest revisit, not the first, is taken."""
    pairs = []
    n = len(times)
    for i in range(0, n, stride):
        js = np.arange(i + 1, n, stride)
        js = js[times[js] - times[i] >= min_dt]
        if js.size == 0:
            continue
        d = np.linalg.norm(p_world[js] - p_world[i], axis=1)
        k = int(np.argmin(d))
        if d[k] < max_dist:
            pairs.append((i, int(js[k])))
        if len(pairs) >= max_pairs:
            break
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def flow_between(p_wi, q_i, p_wj, q_j, c_rot_i, i_t_i2c) -> torch.Tensor:
    """Predicted 4-point offset (..., 4, 2) in pixels between estimated
    poses: the long-baseline prior, the oracle's measurement geometry."""
    flow = true_corner_flow(p_wi, q_i, p_wj, q_j, c_rot_i, i_t_i2c)
    return flow.reshape(*flow.shape[:-1], 4, 2)


def position_from_flow(flow_px, p_wi, q_i, q_j, c_rot_i, i_t_i2c) -> torch.Tensor:
    """World IMU position (..., 3) of keyframe j from the measured corner
    flow (..., 4, 2) i -> j in pixels, keyframe i's estimated pose and
    keyframe j's estimated attitude (known-attitude planar PnP, steps 3-4
    of the module docstring), batched over leading dims."""
    xy1 = torch.as_tensor(CORNER_XY1, device=flow_px.device)
    r1, c1 = camera_pose(p_wi, q_i, c_rot_i, i_t_i2c)
    bear_w = xy1 @ r1.transpose(-1, -2)  # (..., 4, 3)
    lam = -c1[..., None, 2] / bear_w[..., 2]
    ground = c1[..., None, :] + lam[..., None] * bear_w  # (..., 4, 3) world points

    # measured bearings in camera j
    xy_j = xy1[:, :2] + flow_px / FOCAL
    u = torch.cat([xy_j, torch.ones_like(xy_j[..., :1])], dim=-1)  # (..., 4, 3)
    rot_i2w_j = quat_to_rot(q_j)
    r2 = rot_i2w_j @ c_rot_i.T  # camera j -> world
    # u_k x R2^T (G_k - c2) = 0  ->  [u_k]x R2^T c2 = [u_k]x R2^T G_k
    a_rows = skew(u) @ r2.transpose(-1, -2)[..., None, :, :]  # (..., 4, 3, 3)
    b_rows = (a_rows @ ground[..., None])[..., 0]  # (..., 4, 3)
    a = a_rows.reshape(*a_rows.shape[:-3], 12, 3)
    b = b_rows.reshape(*b_rows.shape[:-2], 12, 1)
    c2 = torch.linalg.lstsq(a, b).solution[..., 0]  # world camera-j position
    return c2 - (rot_i2w_j @ i_t_i2c[:, None])[..., 0]  # back to the IMU position


def generate_loop_factors(
    frames,  # (F, H, W) uint8 undistorted frames (numpy or a tensor)
    times: np.ndarray,  # (F,)
    p_world: np.ndarray,  # (F, 3) estimated IMU world positions
    q_wxyz: np.ndarray,  # (F, 4) estimated attitudes
    c_rot_i,
    i_t_i2c,
    model: Any,
    pairs: Optional[np.ndarray] = None,
    seed: int = 0,
    max_sigma_px: float = 4.0,
    max_prior_px: float = 50.0,
) -> LoopFactors:
    """Run the prior-mode UAHN (``model``, a ``models.uahn.UAHN`` on the
    device to compute on) across each candidate pair and solve the planar
    PnP for a relative-position factor.

    Gates, in the JAX module's order: (a) geometric, before inference: a
    pair whose predicted corner flow is non-finite or beyond
    ``max_prior_px`` (outside the network's training regime) is skipped;
    (b) confidence, after it: a pair whose mean corner sigma
    sqrt(tr(cov) / 8) is non-finite or above ``max_sigma_px`` is dropped.
    Each survivor carries its position sigma |c1_z| * sigma_px / FOCAL
    (floored at 1e-3 m), so the smoother weights it by its information.
    """
    dev = model.corners.device
    if pairs is None:
        pairs = find_loop_candidates(times, p_world)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    c_rot_i, i_t_i2c = f32(c_rot_i), f32(i_t_i2c)
    idx_i = torch.as_tensor(pairs[:, 0], device=dev)
    idx_j = torch.as_tensor(pairs[:, 1], device=dev)
    p_w, q_w = f32(p_world), f32(q_wxyz)
    p_i, q_i, p_j, q_j = p_w[idx_i], q_w[idx_i], p_w[idx_j], q_w[idx_j]
    prior = flow_between(p_i, q_i, p_j, q_j, c_rot_i, i_t_i2c)  # (L, 4, 2)
    inside = (torch.isfinite(prior).all(dim=(1, 2))
              & (prior.abs().amax(dim=(1, 2)) <= max_prior_px))
    run = torch.nonzero(inside)[:, 0]  # the network's pairs, in pair order

    frames = torch.as_tensor(frames, device=dev)
    # candidate pair n's call key, fold_in(PRNGKey(seed), n), for the pairs
    # that run; copied to the device once
    call_keys = prng.fold_in(prng.prng_key(seed), run.cpu().numpy())
    mask_keys = prng.keys_tensor(prng.mask_keys(call_keys), dev)
    flows, covs = [], []
    for s in range(0, run.numel(), LOOP_BATCH):
        k = run[s:s + LOOP_BATCH]
        flow8, cov88 = model(frames[idx_i[k]], frames[idx_j[k]], prior[k], use_prior=True,
                             dropout_keys=mask_keys[s:s + LOOP_BATCH])
        flows.append(flow8)
        covs.append(cov88)
    if not flows:
        return LoopFactors(np.zeros((0, 2), np.int64), np.zeros((0, 3), np.float32),
                           np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
    flow8, cov88 = torch.cat(flows), torch.cat(covs)
    tr = torch.diagonal(cov88, dim1=-2, dim2=-1).sum(-1)
    sigma_px = torch.sqrt(torch.clamp(tr / 8.0, min=0.0))
    keep = torch.isfinite(sigma_px) & (sigma_px <= max_sigma_px)
    kept = run[keep]
    sel = lambda x: x[kept]  # noqa: E731
    p_j_meas = position_from_flow(flow8[keep].reshape(-1, 4, 2), sel(p_i), sel(q_i),
                                  sel(q_j), c_rot_i, i_t_i2c)
    # position sigma: bearing noise scaled by the scene depth (~ height)
    _, c1 = camera_pose(sel(p_i), sel(q_i), c_rot_i, i_t_i2c)
    sigma_m = torch.clamp(c1[:, 2].abs() * sigma_px[keep] / FOCAL, min=1e-3)
    dp, dq = relative_pose(sel(p_i), sel(q_i), p_j_meas, sel(q_j))
    return LoopFactors(
        pairs=pairs[kept.cpu().numpy()].reshape(-1, 2),
        dp_meas=dp.cpu().numpy().astype(np.float32).reshape(-1, 3),
        dq_meas=dq.cpu().numpy().astype(np.float32).reshape(-1, 4),
        sigma_p=sigma_m.cpu().numpy().astype(np.float32).reshape(-1),
        inferred=int(run.numel()),
    )

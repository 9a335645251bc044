"""Pyramidal Lucas-Kanade tracking of N features as one batch.

Counterpart of ``cuahn_vio.vision.klt`` (the reference's TrackKLT,
ov_core/src/track/TrackKLT.cpp, which wraps cv::calcOpticalFlowPyrLK): all
N features advance together. Their (N, P, P) patches (P = 2 half + 1) are
sampled bilinearly, the 2x2 normal equations of every feature are solved
in closed form at once, and each pyramid level runs a fixed number of
iterations (a masked update, no early exit), coarse to fine over
average-pool halvings (the Bouguet scheme).

``_bilinear`` keeps the JAX arithmetic: four taps weighted (1-du)(1-dv),
du(1-dv), (1-du)dv and du dv, summed in that order, off-image taps 0. The
integer tap of a coordinate is its floor clamped to [-2, W + 1] (NaN to
-2) before the cast: the cast of a huge, infinite or NaN float differs
between XLA, torch's CPU and CUDA, while the clamped taps are off the
image exactly when the unclamped ones are, and an in-image coordinate
keeps its taps. A diverging track (NaN or huge coordinates) therefore
gives the JAX tracker's ``valid``.

``track_sequence`` is the loop of the ``track-features`` verb.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cuahn_vio_torch.utils.spans import span
from cuahn_vio_torch.vision.detect import grid_detect

DET_MIN = 1e-8  # a level's 2x2 normal equations are conditioned above this determinant
MAX_RESIDUAL = 0.08  # default bound on a track's mean |photometric residual|


def _tap_index(c: torch.Tensor, size: int) -> torch.Tensor:
    """The floor ``c`` of a coordinate as an int64 tap, clamped to [-2,
    size + 1] (NaN to -2): off the image exactly when the unclamped one
    is, and a well-defined cast for every float."""
    return torch.clamp(torch.nan_to_num(c, nan=-2.0), -2.0, size + 1.0).to(torch.int64)


def _bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (H, W) at float coords (u, v) of any one shape;
    zero pad."""
    h, w = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0 = _tap_index(u0, w)
    v0 = _tap_index(v0, h)
    flat = img.reshape(-1)

    def tap(vv, uu):
        ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        val = flat[vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)]
        return torch.where(ok, val, torch.zeros_like(val))

    return (
        tap(v0, u0) * (1 - du) * (1 - dv)
        + tap(v0, u0 + 1) * du * (1 - dv)
        + tap(v0 + 1, u0) * (1 - du) * dv
        + tap(v0 + 1, u0 + 1) * du * dv
    )


def build_pyramid(img: torch.Tensor, levels: int = 3) -> list[torch.Tensor]:
    """``levels`` average-pool halvings of (H, W), finest first
    (cv::buildOpticalFlowPyramid analog). H and W must be divisible by
    2**(levels-1)."""
    pyr = [img]
    for _ in range(levels - 1):
        x = pyr[-1]
        h, w = x.shape
        pyr.append(x.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3)))
    return pyr


def _patch_grid(half: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(dv, du) offsets of a (P, P) patch, P = 2 half + 1 ('ij' order)."""
    r = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    dv_g, du_g = torch.meshgrid(r, r, indexing="ij")
    return dv_g, du_g


def _track_level(img1, img2, pts1, guess, half: int, iters: int):
    """One pyramid level of LK for all N features: (refined offsets (N, 2),
    conditioning flags (N,), determinants (N,)).

    pts1: (N, 2) feature coords in THIS level's pixels.
    guess: (N, 2) initial flow at this level.
    """
    dv_g, du_g = _patch_grid(half, img1.device)
    pu = pts1[:, 0, None, None]
    pv = pts1[:, 1, None, None]
    u_t = pu + du_g  # (N, P, P)
    v_t = pv + dv_g
    # the template and its central differences in one gather (template
    # frame: the Bouguet inverse-compositional choice, constant per level)
    s = _bilinear(img1, torch.stack([u_t, u_t + 1, u_t - 1, u_t, u_t]),
                  torch.stack([v_t, v_t, v_t, v_t + 1, v_t - 1]))
    t = s[0]
    gx = 0.5 * (s[1] - s[2])
    gy = 0.5 * (s[3] - s[4])
    a11 = torch.sum(gx * gx, dim=(1, 2))
    a12 = torch.sum(gx * gy, dim=(1, 2))
    a22 = torch.sum(gy * gy, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    ok = det > DET_MIN
    den = torch.where(ok, det, torch.ones_like(det))
    d = guess
    for _ in range(iters):
        cur = _bilinear(img2, (pu + d[:, 0, None, None]) + du_g,
                        (pv + d[:, 1, None, None]) + dv_g)
        e = cur - t
        b1 = torch.sum(e * gx, dim=(1, 2))
        b2 = torch.sum(e * gy, dim=(1, 2))
        step_u = (a22 * b1 - a12 * b2) / den
        step_v = (-a12 * b1 + a11 * b2) / den
        step = torch.stack([step_u, step_v], dim=1)
        d = d - torch.where(ok[:, None], step, torch.zeros_like(step))
    return d, ok, det


def track_pyramidal(img1: torch.Tensor, img2: torch.Tensor, pts1: torch.Tensor,
                    levels: int = 3, half: int = 7, iters: int = 10,
                    max_residual: float = MAX_RESIDUAL, with_stats: bool = False):
    """Track pts1 (N, 2) from img1 to img2 ((H, W) float32), coarse to fine.

    Returns:
        pts2: (N, 2) tracked coordinates.
        valid: (N,) bool: well-conditioned at every level (det > DET_MIN),
            in bounds by ``half`` and photometrically consistent (mean
            |residual| < ``max_residual``): the cv status array analog.
        stats (with ``with_stats``): {"det": (levels, N) determinants,
            coarsest first, "residual": (N,) mean |residual|}.
    """
    p1 = build_pyramid(img1, levels)
    p2 = build_pyramid(img2, levels)
    n = pts1.shape[0]
    # Bouguet coarse-to-fine: the flow guess lives in the CURRENT level's
    # pixel units; moving one level finer doubles it
    guess = torch.zeros((n, 2), dtype=torch.float32, device=img1.device)
    ok_all = torch.ones((n,), dtype=torch.bool, device=img1.device)
    flow, dets = guess, []
    for lv in range(levels - 1, -1, -1):
        s = float(2 ** lv)
        flow, ok, det = _track_level(p1[lv], p2[lv], pts1 / s, guess, half, iters)
        ok_all = ok_all & ok
        dets.append(det)
        guess = flow * 2.0
    pts2 = pts1 + flow  # level 0 px == full-res px
    h, w = img1.shape
    inb = ((pts2[:, 0] >= half) & (pts2[:, 0] < w - half)
           & (pts2[:, 1] >= half) & (pts2[:, 1] < h - half))
    # photometric consistency at full resolution
    dv_g, du_g = _patch_grid(half, img1.device)
    t = _bilinear(img1, pts1[:, 0, None, None] + du_g, pts1[:, 1, None, None] + dv_g)
    c = _bilinear(img2, pts2[:, 0, None, None] + du_g, pts2[:, 1, None, None] + dv_g)
    res = torch.mean(torch.abs(t - c), dim=(1, 2))
    valid = ok_all & inb & (res < max_residual)
    if with_stats:
        return pts2, valid, {"det": torch.stack(dets), "residual": res}
    return pts2, valid


def track_sequence(frames: torch.Tensor, n: int, grid_y: int = 8, grid_x: int = 10):
    """The ``track-features`` loop over the first ``n`` of (F, H, W) uint8
    ``frames`` on their device: grid-detect on frame 0, KLT from frame to
    frame, and the dead slots refilled from that frame's grid detection
    with new track ids. One host read a frame (the slots' flags).

    Returns (pts (n, G, 2) float32, valid (n, G) bool, ids (n, G) int64
    numpy arrays, ms a frame of the loop over frames 1 .. n-1).
    """
    def as_float(f: int) -> torch.Tensor:
        return frames[f].to(torch.float32) / 255.0

    pts, valid, _ = grid_detect(as_float(0), grid_y=grid_y, grid_x=grid_x)
    g = pts.shape[0]
    track_id = np.arange(g)
    next_id = g
    all_pts, all_valid, all_ids = [pts.cpu().numpy()], [valid.cpu().numpy()], [track_id.copy()]
    t0 = time.perf_counter()
    img2 = as_float(0)
    for f in range(1, n):
        img1, img2 = img2, as_float(f)
        with span("track.klt"):
            pts2, ok = track_pyramidal(img1, img2, pts)
        with span("track.detect"):
            fresh_pts, fresh_valid, _ = grid_detect(img2, grid_y=grid_y, grid_x=grid_x)
        # re-detect: refill dead slots from this frame's grid detection
        ok = ok & valid
        dead = ~ok & fresh_valid
        pts = torch.where(dead[:, None], fresh_pts, pts2)
        valid = ok | dead
        # the frame's one host read: the slots and their flags
        host = torch.cat([pts.reshape(-1), ok.to(pts.dtype), dead.to(pts.dtype)]).cpu().numpy()
        dead_np = host[3 * g:] != 0
        track_id = track_id.copy()
        track_id[dead_np] = next_id + np.arange(int(dead_np.sum()))
        next_id += int(dead_np.sum())
        all_pts.append(host[: 2 * g].reshape(g, 2))
        all_valid.append((host[2 * g: 3 * g] != 0) | dead_np)
        all_ids.append(track_id)
    ms = (time.perf_counter() - t0) * 1e3 / max(n - 1, 1)
    return np.stack(all_pts), np.stack(all_valid), np.stack(all_ids), ms

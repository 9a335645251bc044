#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cuahn_vio_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:

1. build the sampling kernels (``cuahn_vio_torch/ops/cuda/warp.cu``: the
   warp B1/B2, the row-band warp B3 and the flat sampler B4) with nvcc for
   sm_90a, and print each kernel's registers, shared memory and spill bytes
   (``-Xptxas -v``);
2. hold each kernel to its plain PyTorch version on the card, uint8 and
   float32, bit for bit (max abs error 0.0, NaN exactly where the plain
   version has NaN): the warp at 224x320 with B in {1, 4, 8, 65}, at the
   ragged 224x317, 7x5 and 6x3 (B = 8) and on 50,000 6x3 images (widths
   that are not a multiple of a thread's pixels, narrower than one
   thread's 8 pixels) with near-identity, off-image, z <= 0, NaN, z = 0
   (+-inf and NaN coordinates) and rolled homographies; the row-band warp on the same cases and on rolls whose
   tiles' bands lie just under and just over its shared band (8.8 deg for
   uint8, 1.8 deg for float32), against the warp kernel and the plain
   version; the flat sampler (``sample_parity_inputs``) at its three
   shapes (a rendered frame's 71,680 coordinates on a 512x512 texture, a
   blurred frame's 3 x 71,680 at ``--exposure-ms 8``, and 16 bank
   textures at a blurred frame's coordinates each, the JAX trainer's
   batch), at ragged N, at 4-byte-misaligned coordinates, on a texture
   whose rows are not whole 4-byte words, and at in-range, edge,
   off-image, +-inf and NaN ones;
3. time each kernel, its plain version and ``torch.nn.functional.
   grid_sample`` on the same points (the library yardstick; the port never
   calls it) beside its byte bound: device time from CUDA-graph replays
   (the median of three, taken in turns; the numbers kept), the kernel's
   ratio to grid_sample, and eager call-to-call time. The warp at B = 1, 4 and 64 (uint8 and float32), the
   row-band warp at B = 4, 8 and 64 (uint8), the flat sampler at its
   three shapes on uint8 textures, beside the launch floor (a one-element
   ``add_`` in the same CUDA graph);
4. the single-stream slice: a synthetic 2.5 s still + 6 s flight from the
   port's ``make_sequence``, run through ``run_offline`` with the shipped
   v10 weights and 16-member MC dropout (p = 0.05, seeded generator); the
   warp launch count must be 3 x steps x IEKF iterations, every pose finite
   and the ATE under the bar below;
5. textured data: three photo-texture sequences (``TEX_SEQS``) rendered
   with ``make_sequence`` on the card, and one motion-blurred one
   (``BLUR_SEQ``, ``exposure_s = EXPOSURE_S``: each frame the mean of 3
   renders); the flat sampler must launch once per rendered frame, and
   each blurred frame must equal, bit for bit, the uint8 of the mean of
   its three taps rendered one by one on the card (and differ from its
   sharp render);
6. the batched path: ``run_offline_batch`` over the slice's sequence and
   the three textured ones (B = 4, lockstep, padded to the longest) with
   ``BATCH_SAMPLER = "full"``; the warp kernel must launch 3 x F x IEKF
   times (once per warp site and lockstep frame, not per sequence), every
   pose finite and each sequence's ATE under its bar (``BATCH_ATE_BARS_M``);
7. the first ``ROWSKIP_FRAMES`` lockstep frames again with
   ``BATCH_SAMPLER = "rowskip"`` and the same generator seed: the row-band
   kernel must launch 3 x frames x IEKF times, the warp kernel never, and
   the poses must agree with the "full" run's within ``ROWSKIP_POS_TOL_M``.

Then one JSON line of kernels, the card's name and power limit, and the
result line. Exits non-zero (and prints no result) without a CUDA device,
without the port's sources beside it, or when any phase fails. Uses only
the port: no JAX and nothing of ``cuahn_vio``.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "weights", "uahn_fil_v10.msgpack")
WALL_LIMIT_S = 1000  # hard stop well inside the 1200 s budget

H, W = 224, 320
# parity shapes beside 224x320, (B, H, W): a ragged width, tiny images,
# and a batch large enough for 8 pixels a thread on images 3 pixels wide
RAGGED_SHAPES = ((8, 224, 317), (8, 7, 5), (8, 6, 3), (50000, 6, 3))
# rolls (deg) whose row-band tiles straddle the shared band's size
BAND_EDGE_ROLL_DEG = {1: 8.8, 4: 1.8}  # by image element bytes; any pixels per thread
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
WARP_FLOPS_PER_PIXEL = 38  # 15 coords, 2 div, 4 clip, 17 bilinear
SAMPLE_FLOPS_PER_POINT = 21  # 4 clip, 17 bilinear

# The slice's sequence: 2.5 s still, 6 s of motion, the noise of the
# verify recipe's make-synthetic drive, fixed seeds.
SEQ = dict(duration=6.0, t_still=2.5, seed=7, texture_seed=7,
           sigma_w=0.002, sigma_a=0.02, bias_g=0.003, bias_a=0.02)
# ATE bar. Reference: ``python3 smoke_reference.py OUT_DIR`` runs the same
# sequence (SEQ through the port's make_sequence on the CPU) through the
# JAX package's ``run-vio`` with the v10 weights and scores it with its
# ``error-singlerun se3``, on the CPU: ATE pos rmse 0.03315 m at seed 0
# (seeds 1 and 2: 0.03263, 0.03242 m; the port on the CPU, seeds 0-2:
# 0.03235, 0.03239, 0.03296 m). The margin, ~7x that seed-to-seed spread,
# covers MC-dropout draws (the port's generator cannot reproduce JAX's
# keys) and frames rendered on the card.
REF_ATE_M = 0.03315
ATE_MARGIN_M = 0.005
ATE_BAR_M = REF_ATE_M + ATE_MARGIN_M

# The batched phase's photo-texture sequences: entries of the texture
# bank's procedural part (``data/textures._procedural_extras(512)``, the
# whole bank where no image package is installed) at uint8 levels, one
# texture period per TEX_SCALE_M metres, SEQ's noise and still phase.
# Durations differ so that the batch pads.
TEX_SEQS = (
    dict(texture=0, duration=6.0, seed=11),  # fractal noise
    dict(texture=5, duration=5.0, seed=12),  # fractal noise
    dict(texture=11, duration=4.0, seed=13),  # paving stones
)
TEX_SIZE = 512
TEX_SCALE_M = 4.0
# make-synthetic --exposure-ms 8: the blurred render's exposure, which
# gives the flat sampler its 3-tap shape (phases 2, 3 and 5)
EXPOSURE_S = 0.008
BLUR_SEQ = dict(texture=0, duration=1.0, seed=14)
# the JAX trainer's batch (trainer.py batch_size): textures per launch of
# the flat sampler at shape 3
BATCH_TEXTURES = 16
# ATE bars of the batched phase, one per sequence (SEQ, then TEX_SEQS).
# Reference: ``python3 smoke_reference.py OUT_DIR --part batch`` makes the
# same four sequences with the port's make_sequence on the CPU and runs them
# through the JAX package's ``run-vio-batch`` with the v10 weights, scored
# with its ``error-singlerun se3``, on the CPU (JAX_REF_BATCH_ATE_M, the
# mean over MC-dropout seeds 0-2). Each bar is that ATE + 0.005 m, or + 5x
# the JAX package's seed-to-seed spread where that spread is above
# 0.001 m. Measured: JAX seeds 0/1/2 0.03283/0.03278/0.03215,
# 0.04416/0.04465/0.04416, 0.01794/0.01804/0.01791, 0.00654/0.00601/0.00596 m
# (spreads 0.00068, 0.00049, 0.00013, 0.00058 m: the 0.005 m margin holds).
# The port's run-vio-batch on the CPU, seeds 0/1/2: 0.03244/0.03205/0.03249,
# 0.04355/0.04401/0.04415, 0.01785/0.01819/0.01775, 0.00609/0.00597/0.00613 m.
JAX_REF_BATCH_ATE_M = (0.03259, 0.04432, 0.01796, 0.00617)
BATCH_ATE_BARS_M = tuple(round(a + ATE_MARGIN_M, 5) for a in JAX_REF_BATCH_ATE_M)
ROWSKIP_FRAMES = 40
ROWSKIP_POS_TOL_M = 1e-5  # rowskip vs full run, world positions


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {extra}".rstrip(), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rolled(deg: float, hgt: int = H, wid: int = W):
    """Pixel homography of a camera roll by ``deg`` about the image centre."""
    import math

    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    cx, cy = (wid - 1) / 2.0, (hgt - 1) / 2.0
    return [[c, -s, cx - c * cx + s * cy], [s, c, cy - s * cx - c * cy], [0.0, 0.0, 1.0]]


def parity_cases(torch, rng, b: int, dtype, hgt: int = H, wid: int = W):
    """(imgs, homographies) at B = b: random near-identity homographies,
    then (when b >= 4) off-image, z <= 0 and NaN ones, (when b >= 6) an
    extreme (90 deg) and a 20 deg roll, and (when b >= 7) z = 0 everywhere
    (+-inf coordinates, NaN at u = v = 0)."""
    import numpy as np

    if dtype == torch.uint8:
        imgs = rng.integers(0, 256, (b, hgt, wid)).astype(np.uint8)
    else:
        imgs = rng.random((b, hgt, wid)).astype(np.float32)
    hs = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    hs[:, :2, :2] += rng.normal(0, 0.03, (b, 2, 2)).astype(np.float32)
    hs[:, :2, 2] += rng.normal(0, 8.0, (b, 2)).astype(np.float32)
    hs[:, 2, :2] += rng.normal(0, 2e-4, (b, 2)).astype(np.float32)
    if b >= 4:
        hs[1] = [[1, 0, 5000], [0, 1, 5000], [0, 0, 1]]  # everything off-image
        hs[2] = [[1, 0, 0], [0, 1, 0], [0.01, 0, -1.6]]  # z <= 0 left of u=160
        hs[3, 0, 0] = np.nan  # NaN everywhere
    if b >= 6:
        hs[4] = rolled(90.0, hgt, wid)  # every output row sweeps a full image column
        hs[5] = rolled(20.0, hgt, wid)
    if b >= 7:
        hs[6] = [[1, 0, 0], [0, 1, 0], [0, 0, 0]]  # x/0, y/0: +-inf, and 0/0
    return imgs, hs


def tile_bands(torch, hs, hgt: int, wid: int, itemsize: int):
    """(B, tiles) bytes of the row band that each tile of the row-band
    kernel copies for homographies ``hs`` (0: no in-image tap): the rows of
    the in-image taps of its pixels, the tiles being runs of as many
    threads' pixels as a block has (``warp.cu``; the card's build says how
    many)."""
    from cuahn_vio_torch.ops.cuda.warp import pixels_per_thread, threads_per_block
    from cuahn_vio_torch.ops.warp import COORD_CLIP, _row_dot

    b, dev = hs.shape[0], hs.device
    u = torch.arange(wid, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(hgt, dtype=torch.float32, device=dev)[None, :, None]
    h = hs[:, :, :, None, None]
    x, y, z = (_row_dot(h[:, i], u, v) for i in range(3))
    su, sv = x / z, y / z
    nan = torch.isnan(su) | torch.isnan(sv)
    xi = torch.floor(su.clamp(-COORD_CLIP, COORD_CLIP)).nan_to_num(0.0).long()
    yi = torch.floor(sv.clamp(-COORD_CLIP, COORD_CLIP)).nan_to_num(0.0).long()
    lo, hi = yi.clamp(min=0), (yi + 1).clamp(max=hgt - 1)
    ok = ~nan & (xi + 1 >= 0) & (xi < wid) & (lo <= hi)
    ppt, threads = pixels_per_thread(b, hgt, wid), threads_per_block()
    groups = (wid + ppt - 1) // ppt
    r = torch.arange(hgt, device=dev)[:, None]
    c = torch.arange(wid, device=dev)[None, :]
    tile = ((r * groups + c // ppt) // threads).expand(b, hgt, wid)
    n_tiles = int(tile.max()) + 1
    idx = (torch.arange(b, device=dev)[:, None, None] * n_tiles + tile).reshape(-1)
    rmin = torch.full((b * n_tiles,), hgt, device=dev).scatter_reduce(
        0, idx, torch.where(ok, lo, hgt).reshape(-1), "amin")
    rmax = torch.full((b * n_tiles,), -1, device=dev).scatter_reduce(
        0, idx, torch.where(ok, hi, -1).reshape(-1), "amax")
    rows = torch.where(rmax >= rmin, rmax - rmin + 1, 0)
    return (rows * wid * itemsize).reshape(b, n_tiles)


def nan_checked_err(torch, out, ref, what: str) -> float:
    """Max abs error over ref's non-NaN entries; NaN must be exactly where
    ref has NaN."""
    nan_ref = torch.isnan(ref)
    if not torch.equal(torch.isnan(out), nan_ref):
        raise AssertionError(f"NaN pattern differs: {what}")
    diff = (out - ref).abs()[~nan_ref]
    return diff.max().item() if diff.numel() else 0.0


def warp_parity_inputs(torch, rng, dtype, dev):
    """(label, imgs, hs) of the warps' parity phase: 224x320 at B = 1, 4,
    8 and 65 (1, 2, 4 and 8 pixels a thread on the H100), and the
    RAGGED_SHAPES (parity_cases)."""
    for b, hgt, wid in [(b, H, W) for b in (1, 4, 8, 65)] + list(RAGGED_SHAPES):
        imgs, hs = parity_cases(torch, rng, b, dtype, hgt, wid)
        yield (f"{str(dtype):13s} B={b} {hgt}x{wid}", torch.as_tensor(imgs, device=dev),
               torch.as_tensor(hs, device=dev))


def check_kernel(torch, dev):
    """Phase 2, B1/B2: the warp kernel against its plain version, bit for
    bit. Returns the max abs error (0.0)."""
    import numpy as np

    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda, pixels_per_thread
    from cuahn_vio_torch.ops.warp import homography_warp_plain

    rng = np.random.default_rng(0)
    for dtype in (torch.uint8, torch.float32):
        for label, imgs, hs in warp_parity_inputs(torch, rng, dtype, dev):
            out = homography_warp_cuda(imgs, hs)
            ref = homography_warp_plain(imgs, hs)
            torch.cuda.synchronize()
            err = nan_checked_err(torch, out, ref, f"warp {label}")
            nan_ref = torch.isnan(ref)
            if imgs.shape[0] >= 7 and not (
                nan_ref[3].all() and (ref[1] == 0).all() and (out[1] == 0).all()
                and nan_ref[6].any() and not nan_ref[6].all()
            ):
                raise AssertionError("special homographies lost their meaning")
            print(f"  warp parity {label} ({pixels_per_thread(*imgs.shape)} pixels a "
                  f"thread): max abs err {err:.3e}, NaN pixels {int(nan_ref.sum())}",
                  flush=True)
            if err != 0.0:
                raise AssertionError(f"warp kernel vs plain {err:.3e}: not bit-identical")
    return 0.0


def check_rowskip(torch, dev):
    """Phase 2, B3: the row-band warp against the warp kernel and the plain
    version, which it must equal bit for bit, on the warp's cases and on
    rolls whose tiles' bands lie just under and just over the shared band
    (one image row either side). Returns the max abs error (0.0)."""
    import numpy as np

    from cuahn_vio_torch.ops.cuda.warp import (
        band_bytes,
        homography_warp_cuda,
        homography_warp_rowskip_cuda,
    )
    from cuahn_vio_torch.ops.warp import homography_warp_plain

    rng = np.random.default_rng(2)
    limit = band_bytes()
    for dtype in (torch.uint8, torch.float32):
        cases = list(warp_parity_inputs(torch, rng, dtype, dev))
        item = torch.tensor([], dtype=dtype).element_size()
        deg = BAND_EDGE_ROLL_DEG[item]
        imgs, hs = parity_cases(torch, rng, 2, dtype)
        hs[:] = rolled(deg)
        hs[1] = rolled(-deg)
        hs = torch.as_tensor(hs, device=dev)
        bands = tile_bands(torch, hs, H, W, item)
        under = int(((bands <= limit) & (bands > limit - W * item)).sum())
        over = int(((bands > limit) & (bands <= limit + W * item)).sum())
        if not (under and over):
            raise AssertionError(f"{deg} deg roll: no tile band just under ({under}) and "
                                 f"just over ({over}) {limit} B")
        cases.append((f"{str(dtype):13s} B=2 {H}x{W} +-{deg} deg roll, tile bands "
                      f"{under} just under / {over} just over {limit} B",
                      torch.as_tensor(imgs, device=dev), hs))
        for label, imgs, hs in cases:
            out = homography_warp_rowskip_cuda(imgs, hs)
            full = homography_warp_cuda(imgs, hs)
            ref = homography_warp_plain(imgs, hs)
            torch.cuda.synchronize()
            err_full = nan_checked_err(torch, out, full, f"rowskip vs warp {label}")
            err_plain = nan_checked_err(torch, out, ref, f"rowskip vs plain {label}")
            print(f"  rowskip parity {label}: max abs err vs warp kernel "
                  f"{err_full:.3e}, vs plain {err_plain:.3e}", flush=True)
            if not (err_full == 0.0 and err_plain == 0.0):
                raise AssertionError("the row-band warp is not bit-identical")
    return 0.0


def sample_cases(torch, rng, dtype, dev):
    """A 512x512 texture and flat coordinates: in-range, edges, off-image,
    +-inf and NaN."""
    import numpy as np

    t = TEX_SIZE
    if dtype == torch.uint8:
        tex = rng.integers(0, 256, (t, t)).astype(np.uint8)
    else:
        tex = rng.random((t, t)).astype(np.float32)
    inside = rng.uniform(0.0, t - 1.0, (2, 4096))
    edge = np.array([0.0, t - 1.0, t - 1.5, -0.5, t - 0.5, -1.0, float(t), -0.999, t - 0.001])
    special = np.array([-600.0, 600.0, 1e5, -1e5, np.inf, -np.inf, np.nan, 3.0])
    su = np.concatenate([inside[0], np.repeat(edge, len(edge)), np.repeat(special, len(special))])
    sv = np.concatenate([inside[1], np.tile(edge, len(edge)), np.tile(special, len(special))])
    return (torch.as_tensor(tex, device=dev),
            torch.as_tensor(su.astype(np.float32), device=dev),
            torch.as_tensor(sv.astype(np.float32), device=dev))


def camera(torch, dev):
    """(c_rot_i, i_t_i2c) of the smoke's sequences (the UZH-FPV indoor 45
    extrinsics) on ``dev``."""
    import numpy as np

    from cuahn_vio_torch.utils.config import VioOptions

    t_imu_to_cam = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64)
    return (torch.tensor(t_imu_to_cam[:3, :3], dtype=torch.float32, device=dev),
            torch.tensor(-t_imu_to_cam[:3, :3].T @ t_imu_to_cam[:3, 3], dtype=torch.float32,
                         device=dev))


def frame_sample_coords(torch, dev, exposure_s: float = 0.0):
    """The (P,) coordinates at which ``sample_plane`` has the flat sampler
    read the texture for one rendered frame: the first TEX_SEQS flight 2 s
    into its motion, mirror-tiled onto a 512x512 texture at TEX_SCALE_M.
    Sharp (``exposure_s`` 0): P = 224 x 320, shape 1; blurred over
    ``exposure_s`` (``render_frame_blurred``, its 3 taps in one call): P =
    3 x 224 x 320, shape 2."""
    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, exposure_taps, ground_points
    from cuahn_vio_torch.data.textures import default_tex_params, plane_coords

    p, q = exposure_taps(AnalyticTrajectory(), [2.0], exposure_s, dev)
    if exposure_s == 0.0:
        p, q = p[:, 0], q[:, 0]  # render_frame's single pose
    ground, _ = ground_points(p[0], q[0], *camera(torch, dev), H, W)
    su, sv = plane_coords(TEX_SIZE, ground, default_tex_params(TEX_SCALE_M).to(dev))
    return su.reshape(-1).contiguous(), sv.reshape(-1).contiguous()


def batch_sample_inputs(torch, dev, dtype):
    """Shape 3, the JAX trainer's batch (``trainer.make_batch``, ``vmap`` of
    ``sample_pair`` over 16 samples): BATCH_TEXTURES bank textures
    (``_procedural_extras(512)`` in turn, at uint8 levels; float32 k/255
    for ``dtype`` float32), each at the coordinates of one blurred frame
    (EXPOSURE_S, 3 taps) at a random time of the analytic flight, under
    random tex params across the trainer's range (scale 1.5-10 m
    log-uniform, rotation 0-2 pi, offset 0-2), from a numpy seed. Returns
    (textures (B, 512, 512), su, sv (B, 3 x 224 x 320))."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, exposure_taps, ground_points
    from cuahn_vio_torch.data.textures import (
        _procedural_extras,
        plane_coords,
        quantize_u8,
        texture_u8,
    )

    b = BATCH_TEXTURES
    rng = np.random.default_rng(6)
    extras = _procedural_extras(TEX_SIZE)
    bank = [quantize_u8(extras[i % len(extras)]) for i in range(b)]
    tex = np.stack([texture_u8(t) for t in bank] if dtype == torch.uint8 else bank)
    p, q = exposure_taps(AnalyticTrajectory(), rng.uniform(0.5, 6.0, b), EXPOSURE_S, dev)
    th = rng.uniform(0.0, 2 * np.pi, b)
    params = np.stack([np.exp(rng.uniform(np.log(1.5), np.log(10.0), b)), np.cos(th),
                       np.sin(th), *rng.uniform(0.0, 2.0, (2, b))], axis=1)
    ground, _ = ground_points(p, q, *camera(torch, dev), H, W)  # (B, 3, H, W, 2)
    su, sv = plane_coords(TEX_SIZE, ground,
                          torch.tensor(params, dtype=torch.float32, device=dev))
    return (torch.as_tensor(tex, device=dev), su.reshape(b, -1).contiguous(),
            sv.reshape(b, -1).contiguous())


def misaligned(torch, x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary (as ``su[1:]`` of a fresh tensor does)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def sample_parity_inputs(torch, rng, dtype, dev):
    """(label, images, su, sv) of the flat sampler's parity phase: shapes 1,
    2 and 3 (a frame's, a blurred frame's and the trainer batch's
    coordinates), the batch's first 2 and 4 textures, ragged N (N mod 8 !=
    0), 4-byte-misaligned coordinates, all of shape 3's points on one
    texture (8 points a thread in one row), and the special coordinates
    (in-range, edges, off-image, +-inf, NaN) on one texture, on a texture
    509 wide (rows not whole 4-byte words: one load a uint8 tap) and on
    3."""
    tex, su, sv = sample_cases(torch, rng, dtype, dev)
    frame = frame_sample_coords(torch, dev)
    blurred = frame_sample_coords(torch, dev, EXPOSURE_S)
    texs, bsu, bsv = batch_sample_inputs(torch, dev, dtype)
    cut = bsu.shape[1] - 5
    yield "shape 1 (frame)", tex, *frame
    yield "shape 2 (blurred frame)", tex, *blurred
    yield "shape 3 (trainer batch)", texs, bsu, bsv
    for b in (2, 4):
        yield f"batch of {b}", texs[:b], bsu[:b], bsv[:b]
    yield "shape 1 ragged", tex, frame[0][:-3], frame[1][:-3]
    yield "shape 3 ragged", texs, bsu[:, :cut].contiguous(), bsv[:, :cut].contiguous()
    yield "shape 3 on one texture, ragged", texs[0], bsu.reshape(-1)[:-5], bsv.reshape(-1)[:-5]
    yield "shape 2 at su[1:], sv[1:]", tex, blurred[0][1:], blurred[1][1:]
    yield "shape 3 misaligned", texs, misaligned(torch, bsu), misaligned(torch, bsv)
    yield "special", tex, su, sv
    yield "special on a 509-wide texture", tex[:509, :509].contiguous(), su, sv
    yield "special on 3 textures", texs[:3], *(torch.stack([x, x.flip(0), x.roll(7)]) for x in (su, sv))


def check_sample(torch, dev):
    """Phase 2, B4: the flat sampler against its plain version, bit for bit,
    on ``sample_parity_inputs``, uint8 and float32. Returns (max abs error
    at the three shapes, over all)."""
    import numpy as np

    from cuahn_vio_torch.ops.cuda.warp import bilinear_sample_cuda, pixels_per_thread
    from cuahn_vio_torch.ops.warp import bilinear_sample_flat

    rng = np.random.default_rng(3)
    worst = {"shapes": 0.0, "other": 0.0}
    for dtype in (torch.uint8, torch.float32):
        for label, tex, csu, csv in sample_parity_inputs(torch, rng, dtype, dev):
            out = bilinear_sample_cuda(tex, csu, csv)
            ref = bilinear_sample_flat(tex, csu, csv)
            torch.cuda.synchronize()
            err = nan_checked_err(torch, out, ref, f"flat sampler {dtype} {label}")
            b = tex.shape[0] if tex.dim() == 3 else 1
            print(f"  sampler parity {str(dtype):13s} {label} B={b} N={csu.shape[-1]} "
                  f"({pixels_per_thread(b, 1, csu.shape[-1])} points a thread, su at "
                  f"{csu.data_ptr() % 16} mod 16 B): max abs err {err:.3e}, NaN points "
                  f"{int(torch.isnan(ref).sum())}", flush=True)
            if err != 0.0:
                raise AssertionError(f"sampler vs plain {err:.3e}: not bit-identical")
            key = "shapes" if label.split(" (")[0] in ("shape 1", "shape 2", "shape 3") else "other"
            worst[key] = max(worst[key], err)
    return worst["shapes"], max(worst.values())


def time_ms(torch, fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` eager calls back to back (CUDA
    events): at small sizes this is the host's launch rate."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(torch, fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in a
    CUDA graph and replayed, so no host launch cost is between kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def warp_bound_ms(b: int, pixel_bytes: int) -> float:
    """Least time for one warp of B images: each input byte read once
    (images + homographies), each output float written once, against the
    float32 work of the coordinates and the bilinear blend."""
    bytes_moved = b * (H * W * pixel_bytes + 9 * 4) + b * H * W * 4
    flops = b * H * W * WARP_FLOPS_PER_PIXEL
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def timed(torch, fns: dict, bound_ms: float, iters: int, rounds: int = 3):
    """(device times from CUDA-graph replays + bound_ms, eager times) of
    ``fns`` {key: fn}; each device time is the median of ``rounds``
    measurements, taken in turns over ``fns``."""
    import statistics

    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            runs[k].append(time_graph_ms(torch, fn))
    row = {k: statistics.median(v) for k, v in runs.items()}
    row["bound_ms"] = bound_ms
    eager = {k: time_ms(torch, fn, iters) for k, fn in fns.items()}
    return row, eager


def library_grid(torch, hs):
    """grid_sample's (B, H, W, 2) normalized (align_corners=True) grid of
    the points at which the warp samples under ``hs`` (the library
    yardstick's input)."""
    dev = hs.device
    u = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    v = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    h = hs[:, :, :, None, None]
    z = h[:, 2, 0] * u + h[:, 2, 1] * v + h[:, 2, 2]
    su = (h[:, 0, 0] * u + h[:, 0, 1] * v + h[:, 0, 2]) / z
    sv = (h[:, 1, 0] * u + h[:, 1, 1] * v + h[:, 1, 2]) / z
    return torch.stack([2 * su / (W - 1) - 1, 2 * sv / (H - 1) - 1], dim=-1)


def time_kernel(torch, dev):
    """Phase 3, warps: warp kernel / row-band kernel / plain / grid_sample
    times for uint8 frames (the main path's input) and float32 images.
    Returns {(kernel, dtype name, B): {ms, plain_ms, library_ms, bound_ms}}."""
    import numpy as np
    import torch.nn.functional as F

    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda, homography_warp_rowskip_cuda
    from cuahn_vio_torch.ops.warp import homography_warp_plain

    rng = np.random.default_rng(1)
    rows = {}
    cases = (("warp", torch.uint8, 1, 500), ("warp", torch.uint8, 4, 200),
             ("warp", torch.uint8, 64, 50), ("warp", torch.float32, 1, 500),
             ("warp", torch.float32, 4, 200), ("warp", torch.float32, 64, 50),
             ("rowskip", torch.uint8, 4, 200), ("rowskip", torch.uint8, 8, 200),
             ("rowskip", torch.uint8, 64, 50))
    for kernel, dtype, b, iters in cases:
        name = "uint8" if dtype == torch.uint8 else "float32"
        imgs, hs = parity_cases(torch, rng, b, dtype)
        hs[:] = hs[0]  # finite, near identity for every image
        imgs = torch.as_tensor(imgs, device=dev)
        hs = torch.as_tensor(hs, device=dev)
        # grid_sample's input: the same images as float, and the same
        # sample points as a normalized grid
        img_f = (imgs.float() / 255.0 if name == "uint8" else imgs)[:, None]
        grid = library_grid(torch, hs)

        def library():
            return F.grid_sample(img_f, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)

        lib_err = (library()[:, 0] - homography_warp_plain(imgs, hs)).abs().max().item()
        launch = homography_warp_cuda if kernel == "warp" else homography_warp_rowskip_cuda
        row, eager = timed(torch, dict(
            ms=lambda: launch(imgs, hs),
            plain_ms=lambda: homography_warp_plain(imgs, hs),
            library_ms=library,
        ), warp_bound_ms(b, imgs.element_size()), iters)
        rows[(kernel, name, b)] = row
        print(f"  {kernel} {name} B={b} device time (CUDA graph): kernel {row['ms']:.5f} ms"
              f" | plain {row['plain_ms']:.5f} ms | grid_sample "
              f"{row['library_ms']:.5f} ms (|diff| {lib_err:.2e}) | kernel / grid_sample "
              f"{row['ms'] / row['library_ms']:.3f} | byte bound {row['bound_ms']:.5f} ms",
              flush=True)
        print(f"  {kernel} {name} B={b} eager call to call: kernel {eager['ms']:.5f} ms | "
              f"plain {eager['plain_ms']:.5f} ms | grid_sample "
              f"{eager['library_ms']:.5f} ms", flush=True)
    return rows


def sample_bound_ms(torch, tex, su, sv) -> tuple[float, int]:
    """(least ms, distinct texels read) of one flat-sampler call: 8 B of
    coordinates and 4 B of output a point, and each texel that an in-image
    tap of this call reads, once, against the float32 work."""
    t = tex.shape[-1]
    b = tex.shape[0] if tex.dim() == 3 else 1
    x0, y0 = torch.floor(su).long(), torch.floor(sv).long()
    base = (torch.arange(b, device=su.device) * (t * t)).reshape(b, *[1] * (su.dim() - 1))
    taps = torch.cat([(base + (y0 + dy) * t + (x0 + dx)).reshape(-1)
                      for dy in (0, 1) for dx in (0, 1)])
    inside = torch.cat([((y0 + dy >= 0) & (y0 + dy < t) & (x0 + dx >= 0) & (x0 + dx < t))
                        .reshape(-1) for dy in (0, 1) for dx in (0, 1)])
    texels = int(torch.unique(taps[inside]).numel())
    n = su.numel()
    bytes_moved = 3 * n * 4 + texels * tex.element_size()
    return max(bytes_moved / HBM_BYTES_PER_S,
               n * SAMPLE_FLOPS_PER_POINT / F32_FLOPS_PER_S) * 1e3, texels


def time_sample(torch, dev):
    """Phase 3, B4: the flat sampler on uint8 textures at its three shapes:
    1, one rendered frame's 71,680 coordinates on a 512x512 texture; 2, a
    blurred frame's 3 x 71,680 (EXPOSURE_S); 3, the trainer batch's
    BATCH_TEXTURES textures at 3 x 71,680 each. Beside it, in the same
    turns: its plain version, batched grid_sample on the same points, and
    the launch floor (a one-element ``add_`` in the same CUDA graph).
    Returns {shape: {ms, plain_ms, library_ms, floor_ms, bound_ms, points,
    texels}}."""
    import numpy as np
    import torch.nn.functional as F

    from cuahn_vio_torch.ops.cuda.warp import bilinear_sample_cuda, pixels_per_thread
    from cuahn_vio_torch.ops.warp import bilinear_sample_flat

    t = TEX_SIZE
    rng = np.random.default_rng(4)
    tex = torch.as_tensor(rng.integers(0, 256, (t, t)).astype(np.uint8), device=dev)
    texs, bsu, bsv = batch_sample_inputs(torch, dev, torch.uint8)
    shapes = {1: (tex, *frame_sample_coords(torch, dev)),
              2: (tex, *frame_sample_coords(torch, dev, EXPOSURE_S)),
              3: (texs, bsu, bsv)}
    one = torch.zeros(1, device=dev)
    rows = {}
    for shape, (img, su, sv) in shapes.items():
        imgs, su2, sv2 = (img if img.dim() == 3 else img[None],
                          su.reshape(-1, su.shape[-1]), sv.reshape(-1, sv.shape[-1]))
        b, n = su2.shape
        bound, texels = sample_bound_ms(torch, img, su, sv)
        tex_f = (imgs.float() / 255.0)[:, None]
        grid = torch.stack([2 * su2 / (t - 1) - 1, 2 * sv2 / (t - 1) - 1], dim=-1)[:, None]

        def library():
            return F.grid_sample(tex_f, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        lib_err = (library().reshape(b, n) - bilinear_sample_flat(imgs, su2, sv2)).abs().max()
        row, eager = timed(torch, dict(
            ms=lambda: bilinear_sample_cuda(img, su, sv),
            plain_ms=lambda: bilinear_sample_flat(img, su, sv),
            library_ms=library,
            floor_ms=lambda: one.add_(1.0),
        ), bound, 500 if shape < 3 else 50)
        row.update(points=b * n, texels=texels)
        rows[shape] = row
        print(f"  sampler shape {shape} uint8 B={b} N={n} ({pixels_per_thread(b, 1, n)} points "
              f"a thread, {texels} texels) device time (CUDA graph): kernel {row['ms']:.5f} ms"
              f" | plain {row['plain_ms']:.5f} ms | grid_sample {row['library_ms']:.5f} ms "
              f"(|diff| {lib_err.item():.2e}) | kernel / grid_sample "
              f"{row['ms'] / row['library_ms']:.3f} | byte bound {row['bound_ms']:.5f} ms | "
              f"kernel / bound {row['ms'] / row['bound_ms']:.2f} | launch floor "
              f"{row['floor_ms']:.5f} ms", flush=True)
        print(f"  sampler shape {shape} eager call to call: kernel {eager['ms']:.5f} ms | "
              f"plain {eager['plain_ms']:.5f} ms | grid_sample {eager['library_ms']:.5f} ms",
              flush=True)
    return rows


def slice_setup(torch, dev):
    """The slice's sequence, options (the config make-synthetic writes for
    it) and v10 model on ``dev``, warmed up outside any count."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params
    from cuahn_vio_torch.utils.config import VioOptions

    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    seq = make_sequence(AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam),
                        device=dev, **SEQ)
    opts.calib_camimu_dt = 0.0
    opts.init_height = float(seq.gt_pose_w[0, 2])
    opts.init_imu_thresh = 0.2
    model = build_uahn(load_params(WEIGHTS), device=dev,
                       dropout_rate=opts.mc_dropout, blocks_to_run=opts.blocks_to_run)
    # warm-up: first cuDNN/cuBLAS calls and the generator
    warm = torch.as_tensor(seq.frames[:1], device=dev)
    model(warm, warm, torch.zeros((1, 4, 2), device=dev), use_prior=True,
          generator=torch.Generator(device=dev))
    return seq, opts, model


def textured_sequences(dev):
    """The batched phase's three photo-texture sequences (TEX_SEQS) from
    the port's make_sequence on ``dev``."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.data.textures import (
        _procedural_extras,
        default_tex_params,
        quantize_u8,
    )
    from cuahn_vio_torch.utils.config import VioOptions

    extras = _procedural_extras(TEX_SIZE)
    t_imu_to_cam = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam)
    noise = {k: SEQ[k] for k in ("t_still", "sigma_w", "sigma_a", "bias_g", "bias_a")}
    return [
        make_sequence(AnalyticTrajectory(), t_imu_to_cam, duration=spec["duration"],
                      seed=spec["seed"], texture=quantize_u8(extras[spec["texture"]]),
                      tex_params=default_tex_params(TEX_SCALE_M), device=dev, **noise)
        for spec in TEX_SEQS
    ]


def run_slice(torch, dev):
    """Phase 4: the single-stream main path. Returns (launches, steps,
    iekf, ms/frame, ATE pos m, ATE ori deg, (seq, opts, model))."""
    import numpy as np

    from cuahn_vio_torch.eval.align import ate_rmse
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.pipeline.runner import run_offline

    seq, opts, model = slice_setup(torch, dev)
    cfg = opts.vio_config()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames,
                      model, opts.filter_params(dev), cfg, opts.runner_options(),
                      seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    steps = len(res.times)
    if not np.isfinite(res.pose_w).all():
        raise AssertionError("non-finite pose in the slice")
    ori, pos = ate_rmse(res.times, res.pose_w, seq.gt_times, seq.gt_pose_w)
    return (launches, steps, cfg.max_iekf_iterations, seconds * 1e3 / steps, pos, ori,
            (seq, opts, model))


def make_textured(torch, dev):
    """Phase 5: the three photo-texture sequences on the card. Returns
    (sequences, sampler launches, frames rendered)."""
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    seqs = textured_sequences(dev)
    torch.cuda.synchronize()
    return seqs, dict(launch_counts), sum(len(s.cam_t) for s in seqs)


def make_blurred(torch, dev):
    """Phase 5, blurred: one short photo-texture sequence (BLUR_SEQ) made
    with ``exposure_s = EXPOSURE_S`` on the card; then each of its frames
    against the uint8 of the mean of its three taps rendered one by one
    (``render_frame`` at the same poses) on the card. Returns (frames,
    sampler launches in make_sequence, frames that differ from that mean,
    frames that differ from the sharp render at the last tap)."""
    import numpy as np

    from cuahn_vio_torch.data.synthetic import (
        AnalyticTrajectory,
        exposure_taps,
        make_sequence,
        render_frame,
    )
    from cuahn_vio_torch.data.textures import (
        _procedural_extras,
        default_tex_params,
        quantize_u8,
        texture_u8,
    )
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.utils.config import VioOptions

    texture = quantize_u8(_procedural_extras(TEX_SIZE)[BLUR_SEQ["texture"]])
    traj, t_still = AnalyticTrajectory(), SEQ["t_still"]
    reset_launch_counts()
    torch.cuda.synchronize()
    seq = make_sequence(traj, np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam),
                        duration=BLUR_SEQ["duration"], seed=BLUR_SEQ["seed"], t_still=t_still,
                        texture=texture, tex_params=default_tex_params(TEX_SCALE_M),
                        exposure_s=EXPOSURE_S, device=dev)
    torch.cuda.synchronize()
    launches = launch_counts["bilinear_sample"]
    tex = torch.as_tensor(texture_u8(texture), device=dev)
    params = default_tex_params(TEX_SCALE_M).to(dev)
    p, q = exposure_taps(traj, seq.cam_t - t_still, EXPOSURE_S, dev)
    unequal = unblurred = 0
    for i, frame in enumerate(seq.frames):
        taps = [render_frame(p[i, k], q[i, k], *camera(torch, dev), texture=tex,
                             tex_params=params) for k in range(p.shape[1])]
        mean = torch.stack(taps).sum(dim=0) / len(taps)
        want = (mean * 255.0).clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
        sharp = (taps[-1] * 255.0).clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
        unequal += not np.array_equal(frame, want)
        unblurred += np.array_equal(frame, sharp)
    return len(seq.frames), launches, unequal, unblurred


def run_batched(torch, dev, seqs, opts, model):
    """Phase 6: run_offline_batch over ``seqs`` in lockstep with the "full"
    batched sampler. Returns (results, launches, seconds)."""
    import numpy as np

    from cuahn_vio_torch.ops import warp
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.pipeline.runner import run_offline_batch

    warp.BATCH_SAMPLER = "full"
    sequences = [(s.imu_t, s.imu_w, s.imu_a, s.cam_t, s.frames) for s in seqs]
    fparams = opts.filter_params(dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_offline_batch(sequences, model, fparams, opts.vio_config(),
                                opts.runner_options(), seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    for res in results:
        if not np.isfinite(res.pose_w).all():
            raise AssertionError("non-finite pose in the batched run")
    return results, launches, seconds


def run_rowskip(torch, dev, seqs, opts, model, frames: int):
    """Phase 7: the first ``frames`` lockstep frames of the batched run with
    the row-band sampler and the same generator seed. Returns (results,
    launches)."""
    from cuahn_vio_torch.ops import warp
    from cuahn_vio_torch.ops.cuda import launch_counts, reset_launch_counts
    from cuahn_vio_torch.parallel.sharded_eval import batched_run_sequences
    from cuahn_vio_torch.pipeline.runner import batch_results, prepare_batch

    sequences = [(s.imu_t, s.imu_w, s.imu_a, s.cam_t, s.frames) for s in seqs]
    fparams = opts.filter_params(dev)
    batch = prepare_batch(sequences, opts.runner_options(), fparams, dev)
    cut = batch._replace(
        imgs_u8=batch.imgs_u8[:, :frames + 1], w_win=batch.w_win[:, :frames],
        a_win=batch.a_win[:, :frames], dt_win=batch.dt_win[:, :frames],
        n_used=batch.n_used[:, :frames],
        n_frames=[min(nf, frames) for nf in batch.n_frames],
        times=[t[:frames] for t in batch.times],
    )
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    warp.BATCH_SAMPLER = "rowskip"
    try:
        reset_launch_counts()
        _, outs = batched_run_sequences(
            cut.states0, model, fparams, opts.vio_config(), cut.imgs_u8, cut.w_win,
            cut.a_win, cut.dt_win, cut.n_used, generator,
        )
        torch.cuda.synchronize()
        launches = dict(launch_counts)
    finally:
        warp.BATCH_SAMPLER = "full"
    return batch_results(outs, cut), launches


def kernel_entry(name, source_line, launches, err, row, ptxas, bound_by="bytes"):
    """One entry of the kernels line; ``ptxas`` is the kernel's
    ``build.ptxas_report`` entry (registers and spill bytes)."""
    return dict(
        name=name, route="cuda", source="cuahn_vio_torch/ops/cuda/warp.cu",
        replaces=f"cuahn_vio/ops/pallas/warp_kernel.py:{source_line}",
        launches=launches, max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=bound_by, library_ms=row["library_ms"],
        registers=ptxas["registers"], spill_stores=ptxas["spill_stores"],
        spill_loads=ptxas["spill_loads"],
    )


def sample_entry(sharp_launches, blur_launches, err, rows, ptxas, points_per_thread):
    """B4's entry of the kernels line: its launches at shapes 1 (sharp
    frames) and 2 (blurred frames) in phase 5, the times of shape 1 in the
    common fields, and each shape's times and bound under ``shapes``."""
    def compiled(shape):  # the instantiation a launch at ``shape`` runs (whole-word rows)
        b = BATCH_TEXTURES if shape == 3 else 1
        p = points_per_thread(b, 1, rows[shape]["points"] // b)
        return ptxas[f"flat_kernel<h,{p},1>"]

    entry = kernel_entry("bilinear_sample (make-synthetic texture, sharp and --exposure-ms)",
                         174, sharp_launches + blur_launches, err, rows[1], compiled(1))
    entry["launches_by_shape"] = {"1": sharp_launches, "2": blur_launches}
    entry["shapes"] = {
        str(shape): dict(points=row["points"], texels=row["texels"], ms=row["ms"],
                         plain_ms=row["plain_ms"], library_ms=row["library_ms"],
                         bound_ms=row["bound_ms"], launch_floor_ms=row["floor_ms"],
                         registers=compiled(shape)["registers"])
        for shape, row in rows.items()
    }
    return entry


def main() -> int:
    t_all = time.perf_counter()
    faulthandler.dump_traceback_later(WALL_LIMIT_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from cuahn_vio_torch.ops.cuda import warp as warp_cuda
        from cuahn_vio_torch.ops.homography import f32_parity_mode
    except ImportError as exc:
        print(f"chip_smoke: the port's sources are not beside this script: {exc}",
              file=sys.stderr)
        return 2
    if not os.path.exists(WEIGHTS):
        print(f"chip_smoke: weights missing: {WEIGHTS}", file=sys.stderr)
        return 2
    if not all(BATCH_ATE_BARS_M):
        print("chip_smoke: BATCH_ATE_BARS_M not set (smoke_reference.py)", file=sys.stderr)
        return 2
    import numpy as np

    from cuahn_vio_torch.eval.align import ate_rmse

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    f32_parity_mode()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build_s = warp_cuda.build_kernel()
    ptxas = warp_cuda.ptxas_report()
    for kern, info in sorted(ptxas.items()):
        print(f"  {kern}: {info['registers']} registers, {info['smem_bytes']} B shared, "
              f"{info['stack_bytes']} B stack, spill stores {info['spill_stores']} B, "
              f"spill loads {info['spill_loads']} B", flush=True)
    phase("build", t0, library=os.path.relpath(warp_cuda.SOURCE, REPO),
          nvcc_s=f"{build_s:.3f}", threads_per_block=warp_cuda.threads_per_block(),
          band_bytes=warp_cuda.band_bytes())

    t0 = time.perf_counter()
    warp_err = check_kernel(torch, dev)
    rowskip_err = check_rowskip(torch, dev)
    sample_err, sample_worst = check_sample(torch, dev)
    phase("parity", t0, warp_max_abs_err=f"{warp_err:.3e}",
          rowskip_max_abs_err=f"{rowskip_err:.3e}",
          sampler_shapes_max_abs_err=f"{sample_err:.3e}",
          sampler_max_abs_err=f"{sample_worst:.3e}")

    t0 = time.perf_counter()
    times = time_kernel(torch, dev)
    sample_time = time_sample(torch, dev)
    gpu = gpu_name_and_power()
    phase("timing", t0, gpu=f"'{gpu}'")

    t0 = time.perf_counter()
    launches, steps, iekf, ms_frame, ate_pos, ate_ori, (seq, opts, model) = run_slice(torch, dev)
    warp_launches = launches[warp_cuda.KERNEL]
    phase("slice", t0, frames=steps, ms_per_frame=f"{ms_frame:.3f}",
          warp_launches=warp_launches, ate_pos_m=f"{ate_pos:.5f}",
          ate_ori_deg=f"{ate_ori:.4f}", ate_bar_m=f"{ATE_BAR_M:.5f}")
    if warp_launches != 3 * steps * iekf:
        raise AssertionError(
            f"warp launched {warp_launches}x, expected 3 x {steps} x {iekf}"
        )
    if not ate_pos <= ATE_BAR_M:
        raise AssertionError(f"ATE {ate_pos:.5f} m above the bar {ATE_BAR_M:.5f} m")

    t0 = time.perf_counter()
    tex_seqs, tex_launches, rendered = make_textured(torch, dev)
    sample_launches = tex_launches[warp_cuda.SAMPLE_KERNEL]
    phase("textured", t0, sequences=len(tex_seqs), frames=rendered,
          sampler_launches=sample_launches)
    if sample_launches != rendered:
        raise AssertionError(f"sampler launched {sample_launches}x for {rendered} frames")
    t0 = time.perf_counter()
    blur_frames, blur_launches, unequal, unblurred = make_blurred(torch, dev)
    phase("blurred", t0, exposure_ms=EXPOSURE_S * 1e3, frames=blur_frames,
          sampler_launches=blur_launches, frames_unequal_to_tap_mean=unequal,
          frames_equal_to_sharp=unblurred)
    if blur_launches != blur_frames:
        raise AssertionError(f"sampler launched {blur_launches}x for {blur_frames} blurred frames")
    if unequal or unblurred:
        raise AssertionError(f"{unequal} blurred frames differ from the mean of their taps, "
                             f"{unblurred} equal their sharp render")

    t0 = time.perf_counter()
    batch_seqs = [seq] + tex_seqs
    results, b_launches, b_seconds = run_batched(torch, dev, batch_seqs, opts, model)
    n_frames = [len(r.times) for r in results]
    f_max = max(n_frames)
    batch_warp_launches = b_launches[warp_cuda.KERNEL]
    ates = [ate_rmse(r.times, r.pose_w, s.gt_times, s.gt_pose_w)[1]
            for r, s in zip(results, batch_seqs)]
    phase("batched", t0, sequences=len(results), frames=n_frames, lockstep_frames=f_max,
          ms_per_lockstep_frame=f"{b_seconds * 1e3 / f_max:.3f}",
          sequence_frames_per_s=f"{sum(n_frames) / b_seconds:.2f}",
          warp_launches=batch_warp_launches,
          ate_pos_m="[" + ", ".join(f"{a:.5f}" for a in ates) + "]",
          ate_bars_m="[" + ", ".join(f"{b:.5f}" for b in BATCH_ATE_BARS_M) + "]")
    if batch_warp_launches != 3 * f_max * iekf:
        raise AssertionError(f"batched warp launched {batch_warp_launches}x, "
                             f"expected 3 x {f_max} x {iekf}")
    if b_launches[warp_cuda.ROWSKIP_KERNEL] != 0:
        raise AssertionError("the row-band warp ran under BATCH_SAMPLER='full'")
    for i, (a, bar) in enumerate(zip(ates, BATCH_ATE_BARS_M)):
        if not a <= bar:
            raise AssertionError(f"batched sequence {i}: ATE {a:.5f} m above the bar {bar:.5f} m")

    t0 = time.perf_counter()
    skip_results, s_launches = run_rowskip(torch, dev, batch_seqs, opts, model, ROWSKIP_FRAMES)
    rowskip_launches = s_launches[warp_cuda.ROWSKIP_KERNEL]
    pos_diff = max(float(np.abs(r.pose_w[:, :3] - f.pose_w[:len(r.times), :3]).max())
                   for r, f in zip(skip_results, results))
    phase("rowskip", t0, lockstep_frames=ROWSKIP_FRAMES, rowskip_launches=rowskip_launches,
          warp_launches=s_launches[warp_cuda.KERNEL], max_pos_diff_m=f"{pos_diff:.3e}",
          tol_m=f"{ROWSKIP_POS_TOL_M:.0e}")
    if rowskip_launches != 3 * ROWSKIP_FRAMES * iekf or s_launches[warp_cuda.KERNEL] != 0:
        raise AssertionError(f"rowskip run: {s_launches}, expected "
                             f"3 x {ROWSKIP_FRAMES} x {iekf} row-band launches only")
    if not pos_diff <= ROWSKIP_POS_TOL_M:
        raise AssertionError(f"rowskip poses {pos_diff:.3e} m from the full run's")

    nb = len(batch_seqs)

    def compiled(kernel: str, b: int) -> dict:  # the instantiation a B-image launch runs
        return ptxas[f"{kernel}<h,{warp_cuda.pixels_per_thread(b, H, W)}>"]

    kernels = [
        kernel_entry("homography_warp (B=1, single-stream run-vio)", 154, warp_launches,
                     warp_err, times[("warp", "uint8", 1)], compiled("warp_kernel", 1)),
        kernel_entry(f"homography_warp (B={nb}, run-vio-batch)", 468, batch_warp_launches,
                     warp_err, times[("warp", "uint8", nb)], compiled("warp_kernel", nb)),
        kernel_entry(f"homography_warp_rowskip (B={nb}, run-vio-batch)", 403,
                     rowskip_launches, rowskip_err, times[("rowskip", "uint8", nb)],
                     compiled("rowskip_kernel", nb)),
        sample_entry(sample_launches, blur_launches, sample_err, sample_time, ptxas,
                     warp_cuda.pixels_per_thread),
    ]
    print(f"total {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Bilinear remap of uint8 frames through a float32 map (the undistortion).

Counterpart of ``remap_u8`` / ``remap_u8_batch`` of the JAX package's
host runtime (``cuahn_vio/runtime/undistort.cpp:92-139``):

- ``remap_u8``: the entry point. A CUDA tensor goes to the hand-written
  kernel C1 (``ops/cuda/remap.cu``), one launch for the whole batch; a
  CPU tensor goes to ``remap_u8_plain``.
- ``remap_u8_plain``: the plain PyTorch version, on any device.
- ``tile_boxes``: the raw box that each output tile of C1 reads, and
  whether the tile streams it through shared memory (the kernel's rule).

What both compute, for each of N frames and each output pixel i:
``x0 = floor(map_x[i])``, ``wx = map_x[i] - x0`` in float32 (the same for
y); the taps (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) added in that
order as ``acc = fma(wy_k * wx_k, src, acc)``, a tap outside the image
left out; ``acc + 0.5`` clamped to [0, 255] and truncated to uint8.

This is the C++ arithmetic as the JAX package builds it: ``g++ -O3
-march=native -std=c++17`` contracts ``acc += w * src`` into a fused
multiply-add wherever the host has one (GCC turns contraction off in ISO
mode for C, not for C++). Built without contraction, the C++ differs
from this on ~2 pixels a million (a blend on a rounding edge). So the
three agree bit for bit where the C++ is defined. Where it is not (a NaN
or an out-of-int coordinate), both versions here give 0: a NaN coordinate
samples nothing, and a coordinate is clipped to +-COORD_CLIP first,
beyond which every tap of any image that the kernel takes is off the
image.
"""

from __future__ import annotations

import math

import torch

COORD_CLIP = 1e6
MAX_SIDE = 1 << 16  # raw frames up to 65536 pixels a side
# C1's layout (ops/cuda/remap.cu, whose remap_layout gives the same):
# output tiles of TILE (rows, columns); a tile's raw box, its columns
# widened to whole CHUNK-byte copies, streams through shared stages of
# STAGE_BYTES when it fits one
TILE = (16, 32)
STAGE_BYTES = 6144
CHUNK = 16


def check_remap_args(frames: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> None:
    """Shapes and dtypes that both versions take."""
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"frames must be (N, H, W) uint8, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    if max(frames.shape[1:]) > MAX_SIDE:
        raise ValueError(f"frames of {tuple(frames.shape[1:])} exceed {MAX_SIDE} a side")
    if map_x.dim() != 2 or map_x.shape != map_y.shape:
        raise ValueError(f"map_x, map_y must be (H, W) each, got {tuple(map_x.shape)}, "
                         f"{tuple(map_y.shape)}")
    if map_x.dtype != torch.float32 or map_y.dtype != torch.float32:
        raise TypeError(f"maps must be float32, got {map_x.dtype}, {map_y.dtype}")


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` of float32 tensors, rounded once: the product is
    exact in float64, the float64 sum is rounded to odd (its error by
    TwoSum), and one rounding of a round-to-odd float64 to float32 is the
    correctly rounded result (Boldo and Melquiond, 2008)."""
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    t = s - p
    err = (p - (s - t)) + (c64 - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def remap_u8_plain(frames: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """(N, H_raw, W_raw) uint8 frames sampled at (H, W) float32 map
    coordinates -> (N, H, W) uint8 (the C++ remap's arithmetic)."""
    check_remap_args(frames, map_x, map_y)
    n, src_h, src_w = frames.shape
    nan = torch.isnan(map_x) | torch.isnan(map_y)
    sx = torch.clamp(torch.where(nan, torch.zeros_like(map_x), map_x), -COORD_CLIP, COORD_CLIP)
    sy = torch.clamp(torch.where(nan, torch.zeros_like(map_y), map_y), -COORD_CLIP, COORD_CLIP)
    fx0, fy0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - fx0, sy - fy0
    x0, y0 = fx0.to(torch.int64), fy0.to(torch.int64)
    flat = frames.reshape(n, src_h * src_w)
    acc = torch.zeros((n, *map_x.shape), dtype=torch.float32, device=frames.device)
    for dy, wyk in ((0, 1.0 - wy), (1, wy)):
        for dx, wxk in ((0, 1.0 - wx), (1, wx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < src_w) & (yi >= 0) & (yi < src_h) & ~nan
            idx = (yi.clamp(0, src_h - 1) * src_w + xi.clamp(0, src_w - 1)).reshape(-1)
            src = flat[:, idx].reshape(acc.shape).to(torch.float32)
            acc = torch.where(inside, fma_f32((wyk * wxk).expand_as(src), src, acc), acc)
    return torch.clamp(acc + 0.5, 0.0, 255.0).to(torch.uint8)


def tile_boxes(map_x: torch.Tensor, map_y: torch.Tensor, src_h: int, src_w: int,
               tile: tuple = TILE) -> dict:
    """The raw box that each ``tile`` (rows, columns) of the (H, W) maps
    reads from an (src_h, src_w) frame, as the C1 kernel finds it: the
    least and greatest raw row and column of the tile's in-image taps (a
    NaN coordinate has none; coordinates clipped to +-COORD_CLIP), the
    columns widened to whole CHUNK-byte chunks. Returns (tiles down, tiles
    across) int64 tensors ``row0``, ``row1`` (rows [row0, row1), empty
    when equal), ``col0``, ``col1`` (columns [col0, col1)), ``bytes`` (the
    box's stage bytes, rows x columns) and the bool ``shared``: the tile
    streams its box through shared memory (bytes <= STAGE_BYTES), else it
    reads its taps from global memory."""
    th, tw = tile
    h, w = map_x.shape
    nan = torch.isnan(map_x) | torch.isnan(map_y)
    sx = torch.clamp(torch.where(nan, torch.zeros_like(map_x), map_x), -COORD_CLIP, COORD_CLIP)
    sy = torch.clamp(torch.where(nan, torch.zeros_like(map_y), map_y), -COORD_CLIP, COORD_CLIP)
    x0, y0 = torch.floor(sx).to(torch.int64), torch.floor(sy).to(torch.int64)
    clo, chi = x0.clamp(min=0), (x0 + 1).clamp(max=src_w - 1)
    rlo, rhi = y0.clamp(min=0), (y0 + 1).clamp(max=src_h - 1)
    taps = ~nan & (clo <= chi) & (rlo <= rhi)  # the pixel has an in-image tap
    ty, tx = -(-h // th), -(-w // tw)
    big = torch.iinfo(torch.int64).max

    def reduce(v, fill, op):
        grid = torch.full((ty * th, tx * tw), fill, dtype=torch.int64, device=v.device)
        grid[:h, :w] = torch.where(taps, v, torch.full_like(v, fill))
        return op(grid.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(ty, tx, th * tw), -1)

    r0, r1 = reduce(rlo, big, torch.amin), reduce(rhi, -1, torch.amax) + 1
    c0, c1 = reduce(clo, big, torch.amin), reduce(chi, -1, torch.amax)
    empty = r1 <= r0
    r0, r1 = torch.where(empty, 0, r0), torch.where(empty, 0, r1)
    c0 = torch.where(empty, 0, c0 // CHUNK * CHUNK)
    c1 = torch.where(empty, 0, c1 // CHUNK * CHUNK + CHUNK)
    nbytes = (r1 - r0) * (c1 - c0)
    return dict(row0=r0, row1=r1, col0=c0, col1=c1, bytes=nbytes, shared=nbytes <= STAGE_BYTES)


def remap_u8(frames: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Remap (N, H_raw, W_raw) uint8 frames through the (H, W) float32 map
    -> (N, H, W) uint8. CUDA tensors launch the C1 kernel once (or raise);
    CPU tensors take the plain version."""
    if frames.is_cuda:
        from cuahn_vio_torch.ops.cuda.remap import remap_u8_cuda

        return remap_u8_cuda(frames, map_x, map_y)
    return remap_u8_plain(frames, map_x, map_y)

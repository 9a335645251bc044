"""Raw camera frames -> the 224x320 virtual camera: the undistortion map and
the remap.

Counterpart of ``cuahn_vio.runtime`` (the ctypes surface of
``cuahn_vio/runtime/undistort.cpp``). The port needs no host library:

- ``build_undist_map`` computes ``build_undist_map_radtan`` and
  ``build_undist_map_fisheye`` (``undistort.cpp:42-88``) on the host in
  float64 torch ops, op for op, rounds to float32 as the C++
  ``static_cast<float>`` does, and moves the map to its device once. The
  fisheye angle is the one exception: ``atan`` is the C library's
  (``math.atan``), which the C++ calls too, since torch's vectorized
  float64 ``atan`` differs from it by an ulp now and then, and such an ulp
  can move a map entry's float32 rounding and then a remapped pixel by a
  level;
- ``undistort_frames`` remaps a batch of raw uint8 frames through the map
  (``ops.remap.remap_u8``: one launch of the C1 kernel on CUDA).

The virtual camera is the fixed pinhole of FoV 90 deg in width:
f = (W - 1) / 2, c = ((W - 1) / 2, (H - 1) / 2).
"""

from __future__ import annotations

import math

import torch

from cuahn_vio_torch.ops.remap import remap_u8

OUT_W, OUT_H = 320, 224  # the virtual camera's size


def build_undist_map(intrinsics, distortion, fisheye: bool, out_w: int = OUT_W,
                     out_h: int = OUT_H, device="cuda"):
    """(map_x, map_y), (out_h, out_w) float32 on ``device``: the raw-image
    coordinates that each virtual-camera pixel samples. ``intrinsics`` =
    (fx, fy, cx, cy), ``distortion`` = (k1, k2, p1, p2) radtan or (k1..k4)
    equidistant."""
    k = [float(v) for v in torch.as_tensor(intrinsics, dtype=torch.float64).reshape(-1)]
    d = [float(v) for v in torch.as_tensor(distortion, dtype=torch.float64).reshape(-1)]
    if len(k) != 4 or len(d) != 4:
        raise ValueError(f"intrinsics and distortion take 4 values each, got {len(k)}, {len(d)}")
    fx, fy, cx, cy = k
    f = (out_w - 1.0) / 2.0  # tan(45 deg) = 1
    vcx, vcy = (out_w - 1.0) / 2.0, (out_h - 1.0) / 2.0
    u = torch.arange(out_w, dtype=torch.float64)[None, :]
    v = torch.arange(out_h, dtype=torch.float64)[:, None]
    x = ((u - vcx) / f).expand(out_h, out_w)
    y = ((v - vcy) / f).expand(out_h, out_w)
    if fisheye:
        k1, k2, k3, k4 = d
        r = torch.sqrt(x * x + y * y)
        th = torch.tensor([math.atan(v) for v in r.reshape(-1).tolist()],
                          dtype=torch.float64).reshape(r.shape)
        th2 = th * th
        th_d = th * (1.0 + k1 * th2 + k2 * th2 * th2 + k3 * th2 * th2 * th2
                     + k4 * th2 * th2 * th2 * th2)
        scale = torch.where(r > 1e-12, th_d / r, torch.ones_like(r))
        map_x = fx * (x * scale) + cx
        map_y = fy * (y * scale) + cy
    else:
        k1, k2, p1, p2 = d
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        map_x = fx * xd + cx
        map_y = fy * yd + cy
    return map_x.float().to(device).contiguous(), map_y.float().to(device).contiguous()


def undistort_frames(frames: torch.Tensor, map_x: torch.Tensor,
                     map_y: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 raw frames -> (N, out_h, out_w) uint8 virtual-camera
    frames, bilinear through the map (``remap_u8``), on the frames'
    device."""
    return remap_u8(frames, map_x, map_y)

"""EuRoC-ASL dataset ingestion -> preprocessed sequence arrays, and back.

Counterpart of ``cuahn_vio.data.euroc``. A EuRoC-ASL directory (the layout
UZH-FPV and EuRoC ship in) is decoded on the host, undistorted into the
224x320 f = 159.5 virtual camera and saved as the dense ``.npz`` that
``run-vio`` reads:

    <root>/mav0/imu0/data.csv                  t[ns], wx, wy, wz, ax, ay, az
    <root>/mav0/cam0/data.csv                  t[ns], filename
    <root>/mav0/cam0/data/<filename>           grayscale png

- ``load_euroc_sequence``: PNGs decoded by the port's own codec
  (``utils/png``), the undistortion map built by ``runtime.undistort``
  and every frame remapped in one call of ``ops.remap.remap_u8`` (one
  launch of the C1 kernel on the card);
- ``write_euroc_dir``: the inverse, the same csv bytes as the JAX package
  and PNGs with the same pixels (the port's writer: filter None);
- ``distort_frames_to_raw``: virtual-camera renders re-projected out to a
  raw distorted camera (the input of the full ingestion chain on synthetic
  imagery), in float32 torch on ``device``.
"""

from __future__ import annotations

import csv
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from cuahn_vio_torch.ops.warp import virtual_cam_k
from cuahn_vio_torch.runtime.undistort import build_undist_map, undistort_frames
from cuahn_vio_torch.utils.png import read_pngs, write_png
from cuahn_vio_torch.vision.camera import undistort_points


class RawSequence(NamedTuple):
    imu_t: np.ndarray  # (N,) seconds
    imu_w: np.ndarray  # (N, 3)
    imu_a: np.ndarray  # (N, 3)
    cam_t: np.ndarray  # (F,) seconds
    frames: np.ndarray  # (F, 224, 320) uint8, undistorted virtual camera


def _read_imu_csv(path: str):
    ts, ws, accs = [], [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            vals = [float(x) for x in row[:7]]
            ts.append(vals[0] * 1e-9)
            ws.append(vals[1:4])
            accs.append(vals[4:7])
    return np.asarray(ts), np.asarray(ws), np.asarray(accs)


def _read_cam_csv(path: str):
    ts, names = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(float(row[0]) * 1e-9)
            names.append(row[1].strip())
    return np.asarray(ts), names


def load_euroc_sequence(
    root: str,
    intrinsics,
    distortion,
    fisheye: bool,
    imu_dir: str = "mav0/imu0",
    cam_dir: str = "mav0/cam0",
    max_frames: Optional[int] = None,
    device="cuda",
) -> RawSequence:
    """Decode + undistort a EuRoC-layout sequence; the remap runs on
    ``device``.

    ``intrinsics`` = (fx, fy, cx, cy), ``distortion`` = 4 radtan/equidistant
    coefficients (the per-dataset values of the config).
    """
    imu_t, imu_w, imu_a = _read_imu_csv(os.path.join(root, imu_dir, "data.csv"))
    cam_t, names = _read_cam_csv(os.path.join(root, cam_dir, "data.csv"))
    if max_frames:
        cam_t, names = cam_t[:max_frames], names[:max_frames]
    raw = np.stack(read_pngs([os.path.join(root, cam_dir, "data", n) for n in names]))
    map_x, map_y = build_undist_map(intrinsics, distortion, fisheye, device=device)
    frames = undistort_frames(torch.as_tensor(raw, device=device), map_x, map_y)
    return RawSequence(imu_t, imu_w, imu_a, cam_t, frames.cpu().numpy())


def save_sequence_npz(path: str, seq: RawSequence) -> None:
    np.savez_compressed(
        path,
        imu_t=seq.imu_t, imu_w=seq.imu_w, imu_a=seq.imu_a,
        cam_t=seq.cam_t, frames=seq.frames,
    )


def write_euroc_dir(root, frames, imu_t, imu_w, imu_a, cam_t) -> None:
    """Write a minimal EuRoC-ASL directory (mav0/imu0 + mav0/cam0): the
    inverse of ``load_euroc_sequence``."""
    imu_dir = os.path.join(root, "mav0", "imu0")
    cam_dir = os.path.join(root, "mav0", "cam0", "data")
    os.makedirs(imu_dir, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(len(imu_t)):
            f.write(
                f"{int(imu_t[i] * 1e9)},"
                + ",".join(f"{v:.9f}" for v in [*imu_w[i], *imu_a[i]])
                + "\n"
            )
    with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i in range(len(cam_t)):
            name = f"{int(cam_t[i] * 1e9)}.png"
            f.write(f"{int(cam_t[i] * 1e9)},{name}\n")
            write_png(os.path.join(cam_dir, name), np.asarray(frames[i], np.uint8))


def distort_frames_to_raw(
    frames: np.ndarray,
    intrinsics,
    distortion,
    fisheye: bool,
    raw_w: int = 640,
    raw_h: int = 480,
    device="cuda",
) -> np.ndarray:
    """Re-project (F, H, W) uint8 virtual-camera (f = 159.5 pinhole)
    frames out to a RAW distorted camera -> (F, raw_h, raw_w) uint8: for
    every raw pixel, undistort to a normalized ray (``vision.camera``'s
    fixed-point inverse) and sample the virtual image there bilinearly,
    taps off the image 0. The inverse of the ingest remap, so interior
    content round-trips through ``convert-euroc``. In float32 torch on
    ``device``, the taps and weights in the JAX function's order (which
    computes the weights in float64 numpy: the two may differ by a level
    where a pixel's blend lies on a rounding edge)."""
    f, h, w = frames.shape
    vs, us = torch.meshgrid(torch.arange(raw_h, device=device),
                            torch.arange(raw_w, device=device), indexing="ij")
    uv = torch.stack([us.reshape(-1), vs.reshape(-1)], dim=1).to(torch.float32)
    calib = torch.tensor([*intrinsics, *distortion], dtype=torch.float32, device=device)
    norm = undistort_points(uv, calib, fisheye)
    k, _ = virtual_cam_k(h, w, device=device)
    x = norm[:, 0] * k[0, 0] + k[0, 2]
    y = norm[:, 1] * k[1, 1] + k[1, 2]
    fx0, fy0 = torch.floor(x), torch.floor(y)
    x0, y0 = fx0.to(torch.int64), fy0.to(torch.int64)
    fx, fy = x - fx0, y - fy0
    imgs = torch.as_tensor(frames, device=device).to(torch.float32)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = imgs[:, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return vals * inside[None]

    out = (
        tap(y0, x0) * ((1 - fx) * (1 - fy))[None]
        + tap(y0, x0 + 1) * (fx * (1 - fy))[None]
        + tap(y0 + 1, x0) * ((1 - fx) * fy)[None]
        + tap(y0 + 1, x0 + 1) * (fx * fy)[None]
    )
    return out.clamp(0, 255).to(torch.uint8).reshape(f, raw_h, raw_w).cpu().numpy()

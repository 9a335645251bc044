"""Homography image warping and bilinear sampling.

Counterpart of ``cuahn_vio.ops.warp`` and of the Pallas kernels of
``cuahn_vio/ops/pallas/warp_kernel.py``:

- ``virtual_cam_k``: the f = (W-1)/2 / tan(FoV/2) = 159.5 px virtual camera;
- ``pixel_grid_uv1``: the homogeneous pixel grid;
- ``homography_warp``: the warp entry point. A CUDA tensor goes to a
  hand-written kernel (``ops/cuda/warp.cu``): the warp kernel (B1/B2), or,
  for a batch (B > 1) while ``BATCH_SAMPLER == "rowskip"``, the row-band
  kernel (B3). A CPU tensor goes to ``homography_warp_plain``, the plain
  PyTorch version of both: B3 computes B2's function bit for bit, so the
  two kernels share one plain version.
- ``bilinear_sample``: an image (or a batch of images, each at its own
  points) sampled at flat coordinates, the texture sampler's entry point:
  the flat-coordinate kernel (B4) on CUDA, ``bilinear_sample_flat`` on the
  CPU.

Semantics are those of the Pallas kernels: for each output pixel (u, v),
``[x, y, z] = H [u, v, 1]`` in float32 (rounded like the reference's
float32 matmul: ``fma(h1, v, h0*u) + h2``), ``su = x/z``, ``sv = y/z``; the
sampler clips both coordinates to ±1e4 (so an infinite coordinate samples
nothing and gives 0), then samples bilinearly with zeros padding
(``grid_sample`` bilinear / zeros / ``align_corners=True`` in pixel
coordinates). A NaN coordinate gives a NaN output, which the filter's
finiteness gate then rejects (the JAX gather ``bilinear_sample`` returns 0
there instead).

A uint8 image is sampled on its raw values and the result multiplied by
1/255, the form the main path uses for its uint8 camera frames and the
texture sampler for its uint8 bank.
"""

from __future__ import annotations

import math

import torch

D2R = math.pi / 180.0
COORD_CLIP = 1e4

# the batched (B > 1) warp kernel on CUDA: "full" (B2, the default, as in
# the JAX package) or "rowskip" (B3, the same function through a per-tile
# shared-memory row band). Single frames always take the warp kernel.
BATCH_SAMPLER = "full"


def virtual_cam_k(img_height: int, img_width: int, fov_deg: float = 90.0,
                  device=None):
    """(K, K_inv) of the fixed virtual pinhole camera, (3, 3) float32.
    For 224x320 @ 90°: f = 159.5, c = (159.5, 111.5)."""
    fx = (img_width - 1) / 2.0 / math.tan(fov_deg * D2R / 2.0)
    fy = fx
    cx = (img_width - 1) / 2.0
    cy = (img_height - 1) / 2.0
    k = torch.tensor(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )
    k_inv = torch.tensor(
        [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )
    return k, k_inv


def pixel_grid_uv1(img_height: int, img_width: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Homogeneous pixel grid (3, H*W): rows u (column index), v (row), 1."""
    u = torch.arange(img_width, dtype=dtype, device=device)
    v = torch.arange(img_height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W) each
    return torch.stack([uu, vv, torch.ones_like(uu)], dim=0).reshape(
        3, img_height * img_width
    )


def check_warp_args(imgs: torch.Tensor, h_uv: torch.Tensor) -> None:
    """Shapes and dtypes that both versions of the warp take."""
    if imgs.dim() != 3:
        raise ValueError(f"imgs must be (B, H, W), got {tuple(imgs.shape)}")
    if h_uv.shape != (imgs.shape[0], 3, 3):
        raise ValueError(
            f"h_uv must be (B, 3, 3) with B={imgs.shape[0]}, got {tuple(h_uv.shape)}"
        )
    if imgs.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"imgs must be uint8 or float32, got {imgs.dtype}")
    if h_uv.dtype != torch.float32:
        raise TypeError(f"h_uv must be float32, got {h_uv.dtype}")


def check_sample_args(img: torch.Tensor, su: torch.Tensor, sv: torch.Tensor) -> None:
    """Shapes and dtypes that both versions of the flat sampler take: an
    (H, W) image with (N,) coordinates, or (B, H, W) images with (B, N)."""
    if img.dim() not in (2, 3):
        raise ValueError(f"img must be (H, W) or (B, H, W), got {tuple(img.shape)}")
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"img must be uint8 or float32, got {img.dtype}")
    want = "(N,)" if img.dim() == 2 else f"(B, N) with B={img.shape[0]}"
    if (su.dim() != img.dim() - 1 or su.shape != sv.shape
            or (img.dim() == 3 and su.shape[0] != img.shape[0])):
        raise ValueError(f"su, sv must be {want} each for img {tuple(img.shape)}, got "
                         f"{tuple(su.shape)}, {tuple(sv.shape)}")
    if su.dtype != torch.float32 or sv.dtype != torch.float32:
        raise TypeError(f"su, sv must be float32, got {su.dtype}, {sv.dtype}")


def _row_dot(h_row: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h0*u + h1*v + h2 in float32, rounded as fma(h1, v, h0*u) + h2: the
    rounding of the reference's float32 ``H @ grid`` matmul, which the
    kernel reproduces with the same fused multiply-add. (The fma is taken
    in float64, where the product is exact, and rounded once to float32.)"""
    hu = h_row[:, 0] * u
    fma = (h_row[:, 1].double() * v.double() + hu.double()).float()
    return fma + h_row[:, 2]


def _sample_plain(imgs: torch.Tensor, su: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8|float32 images sampled at (B, ...) float32 pixel
    coordinates -> float32 of su's shape (the kernels' tap arithmetic)."""
    b, hgt, wid = imgs.shape
    su = torch.clamp(su, -COORD_CLIP, COORD_CLIP)  # NaN stays NaN
    sv = torch.clamp(sv, -COORD_CLIP, COORD_CLIP)
    is_nan = torch.isnan(su) | torch.isnan(sv)
    su = torch.where(is_nan, torch.zeros_like(su), su)
    sv = torch.where(is_nan, torch.zeros_like(sv), sv)

    x0 = torch.floor(su)
    y0 = torch.floor(sv)
    wx = su - x0
    wy = sv - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = imgs.reshape(b, hgt * wid).to(torch.float32)

    def tap(yi, xi, wgt):
        inb = (xi >= 0) & (xi < wid) & (yi >= 0) & (yi < hgt)
        idx = (yi.clamp(0, hgt - 1) * wid + xi.clamp(0, wid - 1)).reshape(b, -1)
        val = torch.gather(flat, 1, idx).reshape(yi.shape)
        return torch.where(inb, wgt * val, torch.zeros_like(val))

    out = (
        tap(y0i, x0i, (1.0 - wx) * (1.0 - wy))
        + tap(y0i, x0i + 1, wx * (1.0 - wy))
        + tap(y0i + 1, x0i, (1.0 - wx) * wy)
        + tap(y0i + 1, x0i + 1, wx * wy)
    )
    if imgs.dtype == torch.uint8:
        out = out * (1.0 / 255.0)
    return torch.where(is_nan, torch.full_like(out, float("nan")), out)


def homography_warp_plain(imgs: torch.Tensor, h_uv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the warp kernels (B1/B2 and B3), on any
    device.

    Args:
        imgs: (B, H, W) uint8 (sampled as value/255) or float32.
        h_uv: (B, 3, 3) float32 pixel-frame homographies.
    Returns:
        (B, H, W) float32.
    """
    check_warp_args(imgs, h_uv)
    _, hgt, wid = imgs.shape
    dev = imgs.device
    u = torch.arange(wid, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(hgt, dtype=torch.float32, device=dev)[None, :, None]
    h = h_uv[:, :, :, None, None]  # (B, 3, 3, 1, 1)
    x, y, z = (_row_dot(h[:, i], u, v) for i in range(3))
    return _sample_plain(imgs, x / z, y / z)


def bilinear_sample_flat(img: torch.Tensor, su: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the flat-coordinate kernel (B4): an (H, W)
    uint8|float32 image at (N,) float32 pixel coordinates -> (N,) float32,
    or (B, H, W) images, each at its own row of (B, N) coordinates -> (B,
    N), with ``_sample_flat``'s semantics (clip to ±1e4, taps off the image
    weigh 0, a NaN coordinate gives NaN)."""
    check_sample_args(img, su, sv)
    if img.dim() == 2:
        return _sample_plain(img[None], su[None], sv[None])[0]
    return _sample_plain(img, su, sv)


def bilinear_sample(img: torch.Tensor, su: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) ``img`` at flat (N,) pixel coordinates -> (N,) float32,
    or (B, H, W) images at (B, N) coordinates -> (B, N). CUDA tensors
    launch the flat-coordinate kernel (or raise); CPU tensors take the
    plain version."""
    if img.is_cuda:
        from cuahn_vio_torch.ops.cuda.warp import bilinear_sample_cuda

        return bilinear_sample_cuda(img, su, sv)
    return bilinear_sample_flat(img, su, sv)


def homography_warp(imgs: torch.Tensor, h_uv: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W) images by (B, 3, 3) homographies -> (B, H, W) float32.

    Output pixel (u, v) samples the image at H [u, v, 1], dehomogenized.
    CUDA tensors launch a hand-written kernel, chosen by ``BATCH_SAMPLER``
    for a batch (or raise); CPU tensors take the plain version.
    """
    if BATCH_SAMPLER not in ("full", "rowskip"):
        raise ValueError(f"BATCH_SAMPLER must be 'full' or 'rowskip', got {BATCH_SAMPLER!r}")
    if imgs.is_cuda:
        from cuahn_vio_torch.ops.cuda import warp as cuda_warp

        if BATCH_SAMPLER == "rowskip" and imgs.shape[0] > 1:
            return cuda_warp.homography_warp_rowskip_cuda(imgs, h_uv)
        return cuda_warp.homography_warp_cuda(imgs, h_uv)
    return homography_warp_plain(imgs, h_uv)

"""Grid-bucketed corner detection.

Counterpart of ``cuahn_vio.vision.detect`` (the reference's Grider_FAST,
ov_core/src/track/Grider_FAST.h): a dense Shi-Tomasi score (the smaller
eigenvalue of the box-filtered structure tensor) from four convolutions,
then the strongest pixel of each grid cell by one reshape and ``argmax``,
with a fixed output shape (one candidate a cell and a validity mask).

The convolutions are ``F.conv2d`` with symmetric zero padding (``k // 2``
a side: XLA's SAME padding for odd kernels). On the card they run in
float32 only after ``ops.homography.f32_parity_mode`` (cuDNN's default
TF32 moves the scores by ~1e-3 relative). Both libraries' ``argmax``
return the first maximum of a cell on exact ties; on near-ties the
convolutions' own rounding (XLA against cuDNN or oneDNN) can pick another
pixel of the cell whose score is within float rounding of the maximum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv2_same(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """2-D 'same' correlation of (B, H, W) with an odd (kh, kw) kernel."""
    kh, kw = kern.shape
    return F.conv2d(img[:, None], kern[None, None], padding=(kh // 2, kw // 2))[:, 0]


def shi_tomasi_score(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Dense Shi-Tomasi corner response: lambda_min of the structure tensor.

    Args:
        img: (H, W) or (B, H, W) float32 in [0, 1].
        window: box window accumulating the structure tensor.
    Returns:
        float32 score of img's shape (>= 0, larger = cornerier).
    """
    batched = img.dim() == 3
    x = img if batched else img[None]
    sobel_x = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                           dtype=x.dtype, device=x.device) / 8.0
    ix = _conv2_same(x, sobel_x)
    iy = _conv2_same(x, sobel_x.T.contiguous())
    box = torch.ones((window, window), dtype=x.dtype, device=x.device) / float(window * window)
    sxx = _conv2_same(ix * ix, box)
    syy = _conv2_same(iy * iy, box)
    sxy = _conv2_same(ix * iy, box)
    # lambda_min = (sxx+syy)/2 - sqrt(((sxx-syy)/2)^2 + sxy^2)
    half_tr = 0.5 * (sxx + syy)
    disc = torch.sqrt(torch.square(0.5 * (sxx - syy)) + torch.square(sxy) + 1e-20)
    score = torch.clamp(half_tr - disc, min=0.0)
    return score if batched else score[0]


def grid_detect(img: torch.Tensor, grid_y: int = 8, grid_x: int = 10,
                min_score: float = 1e-6, border: int = 8):
    """Strongest corner per grid cell (Grider_FAST semantics, fixed shape).

    Args:
        img: (H, W) float32 in [0, 1], or (B, H, W) for B images at once.
            H % grid_y == 0, W % grid_x == 0.
        min_score: validity threshold on the Shi-Tomasi response.
        border: margin (px) inside which corners are invalidated (KLT
            patches must fit).
    Returns:
        pts: (G, 2) float32 (u, v) pixel coordinates, G = grid_y * grid_x
            ((B, G, 2) for a batch).
        valid: (G,) bool.
        score: (G,) float32.
    """
    batched = img.dim() == 3
    x = img if batched else img[None]
    b, h, w = x.shape
    ch, cw = h // grid_y, w // grid_x
    score = shi_tomasi_score(x)
    cells = score.reshape(b, grid_y, ch, grid_x, cw).permute(0, 1, 3, 2, 4)
    flat = cells.reshape(b, grid_y * grid_x, ch * cw)
    idx = torch.argmax(flat, dim=2)
    best = torch.gather(flat, 2, idx[..., None])[..., 0]
    cy = idx // cw
    cx = idx % cw
    g = torch.arange(grid_y * grid_x, device=x.device)
    u = ((g % grid_x) * cw + cx).to(torch.float32)
    v = ((g // grid_x) * ch + cy).to(torch.float32)
    valid = ((best >= min_score) & (u >= border) & (u < w - border)
             & (v >= border) & (v < h - border))
    pts = torch.stack([u, v], dim=-1)
    return (pts, valid, best) if batched else (pts[0], valid[0], best[0])

"""Plain reference of the UAHN's inference, in plain PyTorch.

A frozen copy of the mathematics of ``cuahn_vio_torch/models/uahn.py``
(the reference's ``model_to_trace.py:64-193``), with the pieces it calls
written out here: the homography warp's float32 arithmetic
(``ops/warp.homography_warp_plain``: ``fma(h1, v, h0*u) + h2``, the
quotient, the clip to +-1e4, bilinear taps with zero padding), the
Hartley-normalised 4-point DLT and the covariance transfer
(``ops/homography``), the towers, and the 16-member MC-dropout heads with
the masks that ``jax.random.bernoulli`` draws from the call's keys
(``lib/threefry``). No kernel of the program is called, and the weights
come from the benchmark's own reader of the raw file.

Precision: float32 with TF32 off, unless the caller turns TF32 on (the
benchmark's control).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.lib import threefry

PLANES = (8, 16, 32, 64, 128, 256, 256)
MC = 16
LEAK = 0.1
LOGVAR_CLAMP = 11.5
COORD_CLIP = 1e4
# (out channels, kernel, stride) of each tower; pooling 8 / 4 / 2 / 1
TOWERS = {
    "block1": [(PLANES[4], 7, 2), (PLANES[4], 5, 2), (PLANES[5], 3, 2)],
    "block2": [(PLANES[3], 7, 2), (PLANES[4], 5, 2), (PLANES[5], 3, 2), (PLANES[6], 3, 2)],
    "block3": [(PLANES[1], 7, 1), (PLANES[2], 5, 2), (PLANES[3], 3, 2), (PLANES[4], 3, 2),
               (PLANES[5], 3, 2), (PLANES[6], 3, 2)],
    "block4": [(PLANES[0], 7, 1), (PLANES[1], 5, 2), (PLANES[2], 3, 2), (PLANES[3], 3, 2),
               (PLANES[4], 3, 2), (PLANES[5], 3, 2), (PLANES[6], 3, 2)],
}


def weights_from_tree(tree: dict, device) -> dict:
    """Flax's parameter tree -> {path: float32 tensor on ``device``}, conv
    kernels HWIO -> OIHW and dense kernels kept (in, out)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[f"{prefix}{k}"] = torch.tensor(np.ascontiguousarray(a), device=device)

    walk(tree, "")
    return out


def corners(h: int, w: int, device) -> torch.Tensor:
    return torch.tensor([[0.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0], [w - 1.0, 0.0]],
                        dtype=torch.float32, device=device)


def dlt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Homography (B, 3, 3), H src ~ dst, from Hartley-normalised points."""
    def norm(p):
        c = p.mean(dim=-2)
        d = torch.linalg.vector_norm(p - c[:, None], dim=-1).mean(dim=-1)
        s = (2.0 ** 0.5) / torch.clamp(d, min=1e-6)
        o, z = torch.ones_like(s), torch.zeros_like(s)
        t = torch.stack([s, z, -s * c[:, 0], z, s, -s * c[:, 1], z, z, o], -1).reshape(-1, 3, 3)
        ti = torch.stack([1 / s, z, c[:, 0], z, 1 / s, c[:, 1], z, z, o], -1).reshape(-1, 3, 3)
        return (p - c[:, None]) * s[:, None, None], t, ti

    sn, ts, _ = norm(src)
    dn, _, tdi = norm(dst)
    b = sn.shape[0]
    rows = []
    for k in range(4):
        x, y = sn[:, k, 0], sn[:, k, 1]
        u, v = dn[:, k, 0], dn[:, k, 1]
        o, z = torch.ones_like(x), torch.zeros_like(x)
        rows.append(torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1))
        rows.append(torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1))
    # rows per point: its u-row, then its v-row
    a = torch.stack(rows, dim=1)
    rhs = dn.reshape(b, 8, 1)
    h8 = torch.linalg.solve_ex(a, rhs)[0][..., 0]
    hn = torch.cat([h8, torch.ones_like(h8[:, :1])], -1).reshape(b, 3, 3)
    h = tdi @ hn @ ts
    return h / h[:, 2:3, 2:3]


def as_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 / 255; float32 frames as they are."""
    return img.float() / 255.0 if img.dtype == torch.uint8 else img


def warp(img_u8: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 (sampled / 255) or float32 frames sampled at
    H [u, v, 1] -> float32."""
    b, hh, ww = img_u8.shape
    dev = img_u8.device
    u = torch.arange(ww, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(hh, dtype=torch.float32, device=dev)[None, :, None]
    hm = h[:, :, :, None, None]

    def row(i):
        hu = hm[:, i, 0] * u
        return (hm[:, i, 1].double() * v.double() + hu.double()).float() + hm[:, i, 2]

    x, y, z = row(0), row(1), row(2)
    su = torch.clamp(x / z, -COORD_CLIP, COORD_CLIP)
    sv = torch.clamp(y / z, -COORD_CLIP, COORD_CLIP)
    nan = torch.isnan(su) | torch.isnan(sv)
    su = torch.where(nan, torch.zeros_like(su), su)
    sv = torch.where(nan, torch.zeros_like(sv), sv)
    x0, y0 = torch.floor(su), torch.floor(sv)
    wx, wy = su - x0, sv - y0
    x0, y0 = x0.long(), y0.long()
    flat = img_u8.reshape(b, -1).float()

    def tap(yi, xi, wt):
        inside = (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
        idx = (yi.clamp(0, hh - 1) * ww + xi.clamp(0, ww - 1)).reshape(b, -1)
        val = torch.gather(flat, 1, idx).reshape(yi.shape)
        return torch.where(inside, wt * val, torch.zeros_like(val))

    out = (tap(y0, x0, (1 - wx) * (1 - wy)) + tap(y0, x0 + 1, wx * (1 - wy))
           + tap(y0 + 1, x0, (1 - wx) * wy) + tap(y0 + 1, x0 + 1, wx * wy))
    if img_u8.dtype == torch.uint8:
        out = out * (1.0 / 255.0)
    return torch.where(nan, torch.full_like(out, float("nan")), out)


class PlainUAHN:
    """The prior-mode UAHN (blocks 2-4 with ``blocks_to_run`` 3) on frames
    of (B, H, W) uint8, with weights from ``weights_from_tree``."""

    def __init__(self, weights: dict, rate: float, h: int, w: int, device):
        self.w, self.rate = weights, rate
        self.c = corners(h, w, device)

    def tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i, (_, k, s) in enumerate(TOWERS[name]):
            x = F.conv2d(x, self.w[f"{name}/conv{i}/kernel"], self.w[f"{name}/conv{i}/bias"],
                         s, (k - 1) // 2)
            x = F.leaky_relu(x, LEAK)
        return torch.flatten(x, 1)

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w[f"{name}/kernel"] + self.w[f"{name}/bias"]

    def refine(self, block, fc, img1, img2, h_uv, pool):
        """One cascade block; ``h_uv`` None (block 1) warps nothing and
        composes nothing; an incoming homography is a constant."""
        img2_in = as_float(img2) if h_uv is None else warp(img2, h_uv.detach())
        pair = torch.stack([as_float(img1), img2_in], dim=1)
        off = self.dense(fc, self.tower(block, F.avg_pool2d(pair, pool, pool)))
        cs = self.c.expand(off.shape[0], 4, 2)
        h_blk = dlt(cs, cs + off.reshape(-1, 4, 2))
        return h_blk if h_uv is None else h_uv.detach() @ h_blk

    def masks(self, keys: np.ndarray, n_fc: int, device):
        """The four (B, 16, width) keep-masks of the mask keys (B, 4, 2)
        (``threefry.mask_keys`` of the call's keys)."""
        widths = (n_fc, 256, n_fc, 256)
        out = []
        for s, wdt in enumerate(widths):
            k = torch.as_tensor(keys[:, s].astype(np.int64), device=device)
            out.append(threefry.bernoulli_rows(k, MC * wdt, 1.0 - self.rate)
                       .reshape(-1, MC, wdt))
        return out

    def head(self, name, feat, m0, m1):
        x = feat[:, None, :].expand(-1, MC, -1)
        x = torch.where(m0, x / (1.0 - self.rate), torch.zeros_like(x))
        x = F.leaky_relu(self.dense(f"{name}/fc0", x), LEAK)
        x = torch.where(m1, x / (1.0 - self.rate), torch.zeros_like(x))
        return self.dense(f"{name}/fc1", x)

    @torch.no_grad()
    def __call__(self, img1, img2, prior, mask_keys):
        """(flow8 (B, 8), cov88 (B, 8, 8)) of the prior-mode network on
        (B, H, W) uint8 frames, the (B, 4, 2) prior in pixels and the
        (B, 4, 2) uint32 keys of the call's masks."""
        b = img1.shape[0]
        cs = self.c.expand(b, 4, 2)
        h_uv = dlt(cs, cs + prior)
        h_uv = self.refine("block2", "fc_block2", img1, img2, h_uv, 4)
        h_uv = self.refine("block3", "fc_block3", img1, img2, h_uv, 2)
        feat = self.tower("block4", torch.stack([as_float(img1), warp(img2, h_uv)], 1))
        m = self.masks(np.asarray(mask_keys), feat.shape[1], img1.device)
        means = self.head("head_mean", feat, m[0], m[1]).reshape(b, MC, 4, 2)
        logv = (self.head("head_logvar", feat, m[2], m[3]) * 1e-3).reshape(b, MC, 4, 2)
        logv = torch.clamp(logv, -LOGVAR_CLAMP, LOGVAR_CLAMP)
        mean = means.mean(dim=1)
        var = torch.square(means - mean[:, None]).mean(dim=1) + torch.exp(logv).mean(dim=1)
        pts = self.c + mean
        # push each corner's variance through the part-1 homography
        uv1 = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
        mapped = uv1 @ h_uv.transpose(-1, -2)
        scale = mapped[..., 2:3]
        hs = h_uv[:, None] / scale[..., None]
        var3 = torch.cat([var, torch.zeros_like(var[..., :1])], -1)
        cov = ((hs * var3[..., None, :]) @ hs.transpose(-1, -2))[..., :2, :2]
        flow8 = (mapped[..., :2] / scale - self.c).reshape(b, 8)
        cov88 = torch.zeros(b, 8, 8, dtype=cov.dtype, device=cov.device)
        for i in range(4):
            cov88[:, 2 * i:2 * i + 2, 2 * i:2 * i + 2] = cov[:, i]
        return flow8, cov88

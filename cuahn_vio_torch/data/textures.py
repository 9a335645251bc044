"""Photo ground-texture bank for the synthetic renderer.

Counterpart of ``cuahn_vio.data.textures`` (the port keeps its own copy of
the numpy code that builds the bank; it imports nothing of the JAX package):

- ``build_texture_bank``: host-side and deterministic. It loads every
  curated image asset of the installed packages (matplotlib sample data,
  pygame example and doc photos, labmaze wall/floor textures), grayscales,
  square-crops, resizes to ``TEXTURE_SIZE``² and contrast-normalizes them,
  then appends 12 procedural textures (``_procedural_extras``) and
  quantizes everything to uint8 levels (k/255). Where none of those
  packages is installed, the bank is the 12 procedural textures alone, and
  PIL is then never imported.
- ``get_texture_bank``: the bank cached per process and in the temporary
  directory, under a file name of the port's own.
- the train/held-out split: every ``HELDOUT_EVERY``-th texture (by bank
  index) is held out for evaluation.
- ``sample_plane``: mirror-tiled bilinear lookup of world (x, y) metres
  through a similarity transform, on one texture or on a batch of
  textures each with its own points and transform (the JAX trainer's
  ``vmap``). The mirror tiling is torch arithmetic; the lookup is
  ``ops.warp.bilinear_sample``, one launch of the flat-coordinate kernel
  (B4) on CUDA. A uint8 texture is sampled on its raw levels and the blend
  scaled by 1/255, which is the JAX package's ``exact_u8`` Pallas call.

``random_tex_params`` (the trainer's random draw) waits for the trainer.
"""

from __future__ import annotations

import glob
import os
import sysconfig
import tempfile

import numpy as np
import torch

from cuahn_vio_torch.ops.warp import bilinear_sample

TEXTURE_SIZE = 512
HELDOUT_EVERY = 7  # bank[i] with i % 7 == 3 is held out from training

_SP = sysconfig.get_paths()["purelib"]

# Curated on-disk image assets (all shipped with installed packages; real
# photographs and hand-authored game textures, not procedural).
_ASSET_GLOBS = [
    f"{_SP}/matplotlib/mpl-data/sample_data/grace_hopper.jpg",
    f"{_SP}/pygame/docs/generated/_images/camera_*.jpg",
    f"{_SP}/pygame/docs/generated/_images/intro_*.jpg",
    f"{_SP}/pygame/examples/data/arraydemo.bmp",
    f"{_SP}/pygame/examples/data/liquid.bmp",
    f"{_SP}/pygame/examples/data/fist.png",
    f"{_SP}/pygame/examples/data/midikeys.png",
    f"{_SP}/labmaze/assets/style_*/wall_*.png",
    f"{_SP}/labmaze/assets/style_*/floor_*.png",
    f"{_SP}/labmaze/assets/style_*/ceiling_*.png",
    f"{_SP}/labmaze/assets/style_*/4tile_*.png",
    f"{_SP}/labmaze/assets/sky_*/ft.png",
    f"{_SP}/labmaze/assets/sky_*/bk.png",
]

# Minimum texture detail for the photometric task to be observable: mean
# |∇I| and std below these make a sample unalignable at every scale.
_MIN_GRAD = 0.0015
_MIN_STD = 0.015


def _candidate_paths() -> list[str]:
    paths: list[str] = []
    for pat in _ASSET_GLOBS:
        paths.extend(sorted(glob.glob(pat)))
    # de-dup, preserve order
    seen, out = set(), []
    for p in paths:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def _load_square_gray(path: str, size: int) -> np.ndarray | None:
    from PIL import Image

    try:
        with Image.open(path) as im:
            im = im.convert("L")
            w, h = im.size
            if min(w, h) < 64:
                return None
            # resize short side to `size`, center-crop square
            s = size / min(w, h)
            im = im.resize(
                (max(size, round(w * s)), max(size, round(h * s))),
                Image.LANCZOS,
            )
            w, h = im.size
            left, top = (w - size) // 2, (h - size) // 2
            im = im.crop((left, top, left + size, top + size))
            return np.asarray(im, np.float32) / 255.0
    except Exception:
        return None


def _contrast_normalize(img: np.ndarray) -> np.ndarray:
    lo, hi = np.percentile(img, [2.0, 98.0])
    if hi - lo < 1e-3:
        return img
    return np.clip(0.05 + 0.90 * (img - lo) / (hi - lo), 0.0, 1.0)


def _fractal_noise(rng: np.random.Generator, size: int, octaves: int = 5) -> np.ndarray:
    """Multi-octave value noise: bilinear-upsampled random grids."""
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        n = 4 << o  # 4, 8, 16, ...
        grid = rng.standard_normal((n, n)).astype(np.float32)
        # periodic bilinear upsample to size x size
        idx = np.arange(size, dtype=np.float32) * n / size
        i0 = np.floor(idx).astype(int) % n
        i1 = (i0 + 1) % n
        f = (idx - np.floor(idx)).astype(np.float32)
        rows = grid[i0][:, i1] * f[None, :] + grid[i0][:, i0] * (1 - f[None, :])
        rows1 = grid[i1][:, i1] * f[None, :] + grid[i1][:, i0] * (1 - f[None, :])
        up = rows * (1 - f[:, None]) + rows1 * f[:, None]
        out += amp * up
        total += amp
        amp *= 0.55
    out /= total
    return _contrast_normalize(out)


def _procedural_extras(size: int) -> list[np.ndarray]:
    """12 deterministic procedural textures: 8 fractal noises, 2
    checkerboards, stripes, paving stones."""
    rng = np.random.default_rng(1234)
    tex = [_fractal_noise(rng, size) for _ in range(8)]
    # checkerboard + noise (calibration-pattern-like ground)
    yy, xx = np.mgrid[0:size, 0:size]
    for cells in (8, 24):
        cb = (((xx * cells // size) + (yy * cells // size)) % 2).astype(np.float32)
        cb = 0.15 + 0.7 * cb + 0.08 * rng.standard_normal((size, size)).astype(np.float32)
        tex.append(np.clip(cb, 0, 1))
    # radial + stripe interference (parquet-like)
    stripes = 0.5 + 0.25 * np.sin(xx * 40.0 / size) + 0.25 * np.sin(yy * 9.0 / size + np.sin(xx * 6.0 / size))
    tex.append(_contrast_normalize(stripes.astype(np.float32)))
    # voronoi-ish cell pattern (paving stones)
    pts = rng.uniform(0, size, (60, 2)).astype(np.float32)
    d = np.sqrt(
        (xx[..., None] - pts[None, None, :, 0]) ** 2
        + (yy[..., None] - pts[None, None, :, 1]) ** 2
    )
    d.sort(axis=-1)
    cells = np.clip((d[..., 1] - d[..., 0]) / 12.0, 0, 1)  # edge darkening
    tex.append(_contrast_normalize(cells.astype(np.float32)))
    return tex


def quantize_u8(textures: np.ndarray) -> np.ndarray:
    """Textures in [0, 1] -> float32 at uint8 levels (k/255), as the bank
    stores them."""
    return np.round(np.asarray(textures, np.float32) * 255.0) / np.float32(255.0)


_BANK_CACHE: np.ndarray | None = None


def build_texture_bank(size: int = TEXTURE_SIZE) -> np.ndarray:
    """(N, size, size) float32 bank in [0, 1] at uint8 levels;
    deterministic given the installed packages."""
    imgs: list[np.ndarray] = []
    for p in _candidate_paths():
        img = _load_square_gray(p, size)
        if img is None:
            continue
        gx = np.abs(np.diff(img, axis=1)).mean()
        gy = np.abs(np.diff(img, axis=0)).mean()
        if img.std() < _MIN_STD or (gx + gy) < _MIN_GRAD:
            continue
        imgs.append(_contrast_normalize(img))
    imgs.extend(_procedural_extras(size))
    return quantize_u8(np.stack(imgs))


def get_texture_bank(size: int = TEXTURE_SIZE) -> np.ndarray:
    """The bank, cached per process and as an npz in the temporary
    directory (decoding the photos takes a few seconds)."""
    global _BANK_CACHE
    if _BANK_CACHE is not None and _BANK_CACHE.shape[1] == size:
        return _BANK_CACHE
    cache = os.path.join(tempfile.gettempdir(), f"cuahn_vio_torch_texture_bank_{size}.npz")
    if os.path.exists(cache):
        try:
            _BANK_CACHE = np.load(cache)["bank"]
            return _BANK_CACHE
        except (OSError, ValueError, KeyError):
            pass  # unreadable cache: rebuild it
    _BANK_CACHE = build_texture_bank(size)
    try:
        tmp = f"{cache}.{os.getpid()}.tmp.npz"
        np.savez_compressed(tmp, bank=_BANK_CACHE)
        os.replace(tmp, cache)
    except OSError:
        pass  # a read-only temporary directory only costs the rebuild
    return _BANK_CACHE


def heldout_mask(n: int) -> np.ndarray:
    """(n,) bool: True for evaluation-only textures the trainer never sees."""
    return (np.arange(n) % HELDOUT_EVERY) == 3


def train_indices(n: int) -> np.ndarray:
    return np.nonzero(~heldout_mask(n))[0].astype(np.int32)


def heldout_indices(n: int) -> np.ndarray:
    return np.nonzero(heldout_mask(n))[0].astype(np.int32)


def default_tex_params(scale_m: float = 4.0) -> torch.Tensor:
    """(5,) float32 [scale_m, cos, sin, off_u, off_v]: one texture period
    spans ``scale_m`` metres, unrotated, no offset."""
    return torch.tensor([scale_m, 1.0, 0.0, 0.0, 0.0], dtype=torch.float32)


def texture_u8(texture) -> np.ndarray:
    """A bank texture (float32 at uint8 levels, or uint8) as (T, T) uint8.
    Raises if a float texture is not at uint8 levels: the sampler reads
    raw levels and scales by 1/255, which is exact only for those."""
    tex = np.asarray(texture)
    if tex.ndim != 2 or tex.shape[0] != tex.shape[1]:
        raise ValueError(f"texture must be (T, T), got {tex.shape}")
    if tex.dtype == np.uint8:
        return tex
    levels = np.round(tex.astype(np.float32) * 255.0)
    if not np.array_equal(levels / np.float32(255.0), tex.astype(np.float32)):
        raise ValueError("texture is not at uint8 levels (k/255); quantize it first")
    return levels.astype(np.uint8)


def sample_plane(texture: torch.Tensor, xy: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Mirror-tiled bilinear texture lookup at world points.

    Args:
        texture: (B, T, T) uint8 (levels k, sampled as k/255) or float32,
            on the device of ``xy``; or one (T, T) texture.
        xy: (B, ..., 2) float32 world-plane coordinates in metres, row b on
            texture b; (..., 2) for one texture.
        params: (B, 5) float32 [scale_m, cos, sin, off_u, off_v], row b
            for texture b: one texture period spans ``scale_m`` metres,
            rotated and offset; (5,) for one texture.
    Returns:
        (B, ...) float32 sampled intensities ((...) for one texture), from
        one launch of the flat sampler: the JAX trainer's ``vmap`` of
        ``sample_plane`` written out as a batch dim.
    """
    x, y = plane_coords(texture.shape[-1], xy, params)
    rows = (texture.shape[0], -1) if texture.dim() == 3 else (-1,)
    out = bilinear_sample(texture, x.reshape(rows).contiguous(), y.reshape(rows).contiguous())
    return out.reshape(x.shape)


def plane_coords(t: int, xy: torch.Tensor, params: torch.Tensor):
    """The pixel coordinates (x, y) of a (t, t) texture, mirror-tiled, at
    which ``sample_plane`` samples world points ``xy`` (..., 2) under
    ``params`` (5,), or (B, ..., 2) under (B, 5), each of xy's shape
    without its last dim."""
    # each parameter as (B, 1, ..., 1), or a scalar, against xy[..., 0]
    shape = (5, *params.shape[:-1], *[1] * (xy.dim() - params.dim()))
    scale, c, s, ou, ov = params.movedim(-1, 0).reshape(shape).unbind()
    u = (c * xy[..., 0] - s * xy[..., 1]) / scale + ou
    v = (s * xy[..., 0] + c * xy[..., 1]) / scale + ov
    # mirror tiling: continuous triangular wave with period 2 -> [0, 1]
    u = 1.0 - torch.abs(1.0 - torch.remainder(u, 2.0))
    v = 1.0 - torch.abs(1.0 - torch.remainder(v, 2.0))
    return u * (t - 1), v * (t - 1)

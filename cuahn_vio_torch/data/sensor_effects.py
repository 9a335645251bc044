"""Camera sensor effects: the degradations real camera frames carry that
a clean ray-cast render does not.

Counterpart of ``cuahn_vio.data.sensor_effects``, on (B, H, W) frames with
per-sample parameters. The photometric chain:

    vignette -> exposure gain/gamma -> defocus blur -> shot+read noise
    -> black-level offset -> clip

The random draws are apart from the arithmetic: ``draw_params``,
``draw_effects_pair`` and ``draw_noise`` are the JAX package's draws of B
keys (``utils/prng``; one T1 launch a field on a GPU), as
``make-synthetic`` and the trainers draw them. ``apply_photometric`` and
``apply_effects_pair`` are deterministic, so the same drawn values give
the JAX package's frames to float32 rounding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cuahn_vio_torch.utils import prng


@dataclass(frozen=True)
class EffectsConfig:
    """Maximum severities; each sample draws uniformly within these."""

    vignette_max: float = 0.35  # relative corner falloff
    gain_lo: float = 0.6  # exposure gain range (multiplicative)
    gain_hi: float = 1.4
    gain_drift: float = 0.06  # frame-to-frame auto-exposure drift (sigma)
    gamma_lo: float = 0.75
    gamma_hi: float = 1.30
    offset_sigma: float = 0.02  # black-level offset
    read_noise_max: float = 0.02  # additive Gaussian sigma, [0,1] units
    shot_noise_max: float = 0.04  # sqrt(I)-scaled noise coefficient
    defocus_sigma_max: float = 1.2  # px, Gaussian defocus
    clean_prob: float = 0.2  # fraction of samples left fully clean


def vignette_field(height: int, width: int, device=None) -> torch.Tensor:
    """(H, W) float32 normalized squared radius from the image centre (1
    at the farthest corner); times a strength, the falloff."""
    v = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    u = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    cu, cv = (width - 1) / 2.0, (height - 1) / 2.0
    r2 = ((u - cu) / cu) ** 2 + ((v - cv) / cv) ** 2
    return r2 / r2.max()


def _gauss_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap Gaussian of (B, H, W) frames, sigma (B,) per frame
    (sigma < 0.01: identity), edge-replicate padding; the taps summed in
    the JAX package's order, horizontal then vertical."""
    x = torch.arange(-2, 3, dtype=torch.float32, device=img.device)
    s = sigma[:, None]
    w = torch.exp(-0.5 * (x / torch.clamp(s, min=1e-3)) ** 2)
    delta = (x == 0).to(torch.float32)
    w = torch.where(s < 1e-2, delta, w / w.sum(dim=1, keepdim=True))
    w = w[:, :, None, None]  # (B, 5, 1, 1)
    hgt, wid = img.shape[1:]
    p = F.pad(img[:, None], (2, 2, 0, 0), mode="replicate")[:, 0]
    out = w[:, 0] * p[:, :, 0:wid]
    for k in range(1, 5):
        out = out + w[:, k] * p[:, :, k:k + wid]
    p = F.pad(out[:, None], (0, 0, 2, 2), mode="replicate")[:, 0]
    out = w[:, 0] * p[:, 0:hgt]
    for k in range(1, 5):
        out = out + w[:, k] * p[:, k:k + hgt]
    return out


def draw_params(cfg: EffectsConfig, keys, device) -> torch.Tensor:
    """(B, 6) [vignette, gain, gamma, offset, read_sigma, shot_coef], the
    JAX ``draw_params(key, cfg)`` of each of B host keys (B, 2), on
    ``device``: ks = split(key, 7); vignette, gain, gamma, read and shot
    uniform in their ranges (ks[0], ks[1], ks[2], ks[4], ks[5]), the offset
    ``normal(ks[3]) * offset_sigma``, and the neutral row (no vignette,
    gain 1, gamma 1, no offset, no noise) where ``bernoulli(ks[6],
    clean_prob)``."""
    ks = prng.split(keys, 7)

    def uniform(i: int, lo: float, hi: float) -> torch.Tensor:
        return prng.draw_field(ks[:, i], (), prng.UNIFORM, device, lo, hi)

    drawn = torch.stack([
        uniform(0, 0.0, cfg.vignette_max),
        uniform(1, cfg.gain_lo, cfg.gain_hi),
        uniform(2, cfg.gamma_lo, cfg.gamma_hi),
        prng.draw_field(ks[:, 3], (), prng.NORMAL, device) * cfg.offset_sigma,
        uniform(4, 0.0, cfg.read_noise_max),
        uniform(5, 0.0, cfg.shot_noise_max),
    ], dim=1)
    clean = prng.draw_field(ks[:, 6], (), prng.BERNOULLI, device, cfg.clean_prob).bool()
    neutral = torch.tensor([0.0, 1.0, 1.0, 0.0, 0.0, 0.0], device=drawn.device)
    return torch.where(clean[:, None], neutral, drawn)


def draw_noise(keys, hw: tuple, device) -> torch.Tensor:
    """(2, ..., H, W) standard normals of the host noise keys (..., 2): the
    read (0) and the shot (1) noise of frames of size ``hw``, the normals
    of ``split(key, 2)`` (the JAX ``apply_photometric``'s), all in one
    launch."""
    ks = np.moveaxis(prng.split(keys, 2), -2, 0)
    return prng.draw_field(ks, tuple(hw), prng.NORMAL, device)


def apply_photometric(img: torch.Tensor, params: torch.Tensor, defocus_sigma,
                      noise: torch.Tensor) -> torch.Tensor:
    """The photometric chain on (B, H, W) float frames in [0, 1].

    Args:
        params: (B, 6) rows of ``draw_params``.
        defocus_sigma: (B,) defocus blur in pixels, or one float for all.
        noise: (2, B, H, W) standard normals (``draw_noise``): the read and
            the shot noise, scaled here by each row's read_sigma and
            shot_coef * sqrt(intensity).
    """
    vig, gain, gamma, off, read, shot = (params[:, i, None, None] for i in range(6))
    img = img * (1.0 - vig * vignette_field(*img.shape[1:], device=img.device))
    img = gain * torch.pow(torch.clamp(img, 1e-4, 1.0), gamma) + off
    sigma = torch.as_tensor(defocus_sigma, dtype=torch.float32, device=img.device)
    img = _gauss_blur(img, sigma.expand(img.shape[0]))
    img = img + (read * noise[0] + shot * torch.sqrt(torch.clamp(img, 0.0, 1.0)) * noise[1])
    return torch.clamp(img, 0.0, 1.0)


class EffectsDraw(NamedTuple):
    """The parameters of a batch of frame pairs (``draw_effects_pair``)."""

    params1: torch.Tensor  # (B, 6) first frame
    params2: torch.Tensor  # (B, 6) second frame: the gain drifted
    sigma: torch.Tensor  # (B,) defocus, px, shared by the pair


def draw_effects_pair(cfg: EffectsConfig, keys, device) -> EffectsDraw:
    """The parameters of B frame pairs, the JAX ``apply_effects_pair``'s
    draws of each of B host keys (B, 2), on ``device``: kp, kd, kg, kn1,
    kn2, _ = split(key, 6); the lens and exposure ``draw_params(kp)``,
    shared by a pair (one camera, consecutive frames), the defocus
    uniform(kd) in [0, defocus_sigma_max), the second frame's gain drifted
    by 1 + normal(kg) gain_drift (auto exposure); clean samples keep their
    neutral gain and skip defocus. The frames' noise keys kn1 and kn2 are
    ``noise_keys``'."""
    ks = prng.split(keys, 6)
    params = draw_params(cfg, ks[:, 0], device)
    neutral = params[:, 1] == 1.0
    sigma = prng.draw_field(ks[:, 1], (), prng.UNIFORM, device, 0.0,
                            cfg.defocus_sigma_max) * (~neutral)
    drift = 1.0 + prng.draw_field(ks[:, 2], (), prng.NORMAL, device) * cfg.gain_drift
    params2 = params.clone()
    params2[:, 1] = params[:, 1] * torch.where(neutral, torch.ones_like(drift), drift)
    return EffectsDraw(params, params2, sigma)


def noise_keys(keys) -> np.ndarray:
    """(2, B, 2): the noise keys kn1, kn2 of the two frames of each pair of
    ``draw_effects_pair``'s keys (B, 2)."""
    return np.moveaxis(prng.split(keys, 6)[:, 3:5], 1, 0)


def apply_effects_pair(img1: torch.Tensor, img2: torch.Tensor, draw: EffectsDraw,
                       noise1: torch.Tensor, noise2: torch.Tensor):
    """Degrade B training pairs (B, H, W) with ``draw``; the noise of each
    frame is its own (``draw_noise`` of ``noise_keys``). Returns (out1,
    out2)."""
    return (apply_photometric(img1, draw.params1, draw.sigma, noise1),
            apply_photometric(img2, draw.params2, draw.sigma, noise2))

"""The network's measurement quality with no filter in the loop
(``eval-flow``).

Counterpart of the JAX CLI's ``eval-flow`` body (``cuahn_vio/cli.py``
``cmd_eval_flow``): the UAHN runs on every consecutive frame pair of a
rendered sequence, and its 4-point flow is compared with the oracle flow
of the simulator's GT poses (``data.oracle.true_corner_flow``, the
quantity the network is trained to estimate), with the predicted sigmas'
calibration as z-scores. It separates "the network measures badly" from
"the filter uses measurements badly".

The frames go to the device once as uint8; each batch of ``batch`` pairs
is made float32 / 255 there, as the JAX verb feeds them, so a batch
launches the float32 warp. Randomness is the JAX verb's, from ``rng =
PRNGKey(seed)`` (``utils/prng``): pair i calls the network with
``fold_in(rng, i)``, and with ``prior = "noisy"`` the batch starting at
pair s adds 2 px times ``normal(fold_in(rng, 10_000 + s), (b, 4, 2))`` to
its prior. The masks and the noise are drawn by the threefry kernel T1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuahn_vio_torch.data.oracle import true_corner_flow
from cuahn_vio_torch.utils import prng

PRIOR_NOISE_PX = 2.0  # --prior noisy: the oracle flow + normals of this sigma


class FlowEval(NamedTuple):
    pred: np.ndarray  # (n, 8) predicted 4-point flow, px
    true: np.ndarray  # (n, 8) oracle flow, px
    cov: np.ndarray  # (n, 8, 8) predicted covariance, px^2
    times: np.ndarray  # (n,) camera time of each pair's first frame


def nearest_gt_rows(gt_times: np.ndarray, cam_t: np.ndarray) -> np.ndarray:
    """Index of the GT row nearest to each camera time (the earlier one on
    a tie)."""
    idx = np.clip(np.searchsorted(gt_times, cam_t), 0, len(gt_times) - 1)
    lo = np.clip(idx - 1, 0, len(gt_times) - 1)
    return np.where(np.abs(gt_times[lo] - cam_t) < np.abs(gt_times[idx] - cam_t), lo, idx)


def eval_flow(frames: np.ndarray, cam_t: np.ndarray, gt_times: np.ndarray,
              gt_pose: np.ndarray, c_rot_i: torch.Tensor, i_t_i2c: torch.Tensor, model,
              prior: str = "gt", batch: int = 16, limit: int = 0, seed: int = 0) -> FlowEval:
    """Run ``model`` on the consecutive pairs of (F, H, W) uint8 ``frames``
    (at most ``limit`` pairs when > 0), in batches of ``batch``, on the
    model's device, beside the oracle flow of the GT poses nearest each
    camera time (``gt_pose`` (N, 7) [xyz qx qy qz qw]).

    ``prior``: "none" runs all four blocks; "gt" feeds the oracle flow as
    the prior; "noisy" the oracle flow plus PRIOR_NOISE_PX normals.
    """
    if prior not in ("none", "gt", "noisy"):
        raise ValueError(f"prior must be none, gt or noisy, got {prior!r}")
    dev = model.corners.device
    pose = gt_pose[nearest_gt_rows(gt_times, cam_t)]  # (F, 7)
    p_w = torch.as_tensor(pose[:, :3], dtype=torch.float32, device=dev)
    q_wxyz = torch.as_tensor(pose[:, [6, 3, 4, 5]], dtype=torch.float32, device=dev)
    flow_true = true_corner_flow(p_w[:-1], q_wxyz[:-1], p_w[1:], q_wxyz[1:], c_rot_i,
                                 i_t_i2c)  # (F-1, 8)
    n = len(frames) - 1
    if limit:
        n = min(n, limit)
    imgs = torch.as_tensor(np.ascontiguousarray(frames[: n + 1]), device=dev)  # uint8, once
    rng = prng.prng_key(seed)
    # pair i's call key fold_in(rng, i), every pair's masks' keys on the device once
    mask_keys = prng.keys_tensor(prng.mask_keys(prng.fold_in(rng, np.arange(n))), dev)
    use_prior = prior != "none"
    preds, covs = [], []
    for s in range(0, n, batch):
        e = min(s + batch, n)
        prior_px = flow_true[s:e].reshape(-1, 4, 2)
        if prior == "noisy":
            noise_key = prng.keys_tensor(prng.fold_in(rng, 10_000 + s)[None], dev)
            prior_px = prior_px + PRIOR_NOISE_PX * prng.normal(noise_key, prior_px.shape)[0]
        img = imgs[s: e + 1].to(torch.float32) / 255.0
        flow8, cov88 = model(img[:-1], img[1:], prior_px if use_prior else None,
                             use_prior=use_prior, dropout_keys=mask_keys[s:e])
        preds.append(flow8)
        covs.append(cov88)
    return FlowEval(pred=torch.cat(preds).cpu().numpy(), true=flow_true[:n].cpu().numpy(),
                    cov=torch.cat(covs).cpu().numpy(), times=np.asarray(cam_t[:n]))


def flow_report(ev: FlowEval, prior: str, flow_cap: float = 80.0) -> list[str]:
    """The JAX verb's printed lines, in its formats: the oracle flow's
    size, the per-corner error, the predicted sigmas, the z-scores, the
    split at ``flow_cap`` px of true flow, and the worst frames."""
    pred, true, cov = ev.pred, ev.true, ev.cov
    n = len(pred)
    err = pred - true  # px
    enorm = np.linalg.norm(err.reshape(n, 4, 2), axis=2)  # per-corner px
    sig = np.sqrt(np.maximum(np.einsum("fii->fi", cov), 1e-12))
    # z-scores: per-component error / predicted sigma (calibrated ~ N(0,1))
    z = err / sig
    flow_mag = np.linalg.norm(true.reshape(n, 4, 2), axis=2)
    lines = [
        f"frames: {n}, prior={prior}",
        f"true |flow|   px: median {np.median(flow_mag):.2f}, "
        f"p95 {np.percentile(flow_mag, 95):.2f}, max {flow_mag.max():.2f}",
        f"corner error  px: rmse {np.sqrt((enorm ** 2).mean()):.3f}, "
        f"median {np.median(enorm):.3f}, p95 {np.percentile(enorm, 95):.3f}, "
        f"max {enorm.max():.2f}",
        f"pred sigma    px: median {np.median(sig):.3f}, "
        f"p95 {np.percentile(sig, 95):.3f}",
        f"z-score (err/sigma): median |z| {np.median(np.abs(z)):.2f} "
        f"(calibrated ~0.67), p95 |z| {np.percentile(np.abs(z), 95):.2f} "
        f"(~1.96), rms z {np.sqrt((z ** 2).mean()):.2f} (~1.0)",
    ]
    # regime split: frames whose true flow stays in the measurement's
    # useful range vs degenerate high-tilt frames
    good = flow_mag.max(axis=1) <= flow_cap
    if good.any() and not good.all():
        eg, zg = enorm[good], z[good]
        lines.append(
            f"regime |flow|<= {flow_cap:g} px: {int(good.sum())}/{n} "
            f"frames | err px rmse {np.sqrt((eg ** 2).mean()):.3f}, "
            f"median {np.median(eg):.3f}, p95 {np.percentile(eg, 95):.3f} "
            f"| rms z {np.sqrt((zg ** 2).mean()):.2f}"
        )
    worst = np.argsort(enorm.max(axis=1))[-5:][::-1]
    lines.append("worst frames: " + ", ".join(f"{i} ({enorm[i].max():.1f} px)" for i in worst))
    return lines

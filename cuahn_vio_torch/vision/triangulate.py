"""N-view point triangulation of F features at once (FeatureInitializer
parity).

Counterpart of ``cuahn_vio.vision.triangulate`` (the reference's
ov_core/src/feat/FeatureInitializer.{h,cpp}), with a leading feature dim
(the JAX function is written for one feature and vmapped by its callers):
a linear least-squares triangulation with a singular-value condition
check, then a fixed number of Gauss-Newton steps on the inverse-depth
parameters (alpha, beta, rho) = (x/z, y/z, 1/z) in the anchor frame, the
Jacobian by ``torch.func.jacfwd`` under ``vmap``, as the JAX function's
``jax.jacfwd``.
"""

from __future__ import annotations

import torch


def _residuals(x, bearings, rot_c2a, p_cia, w):
    """2M reprojection residuals of one feature at (alpha, beta, rho) = x:
    the feature in view i is R_a2ci (pf_a - p_cia), pf_a = [alpha, beta,
    1] / rho; each view's normalized-plane error, weighted by its mask."""
    pf_a = torch.stack([x[0], x[1], torch.ones_like(x[0])]) / x[2]
    pf_ci = torch.einsum("mji,mj->mi", rot_c2a, pf_a[None] - p_cia)  # Rᵀ(...)
    floor = torch.tensor(1e-6, dtype=x.dtype, device=x.device)
    uv = pf_ci[:, :2] / torch.maximum(pf_ci[:, 2:3], floor)
    meas = bearings[:, :2] / torch.maximum(bearings[:, 2:3], floor)
    return ((uv - meas) * w[:, None]).reshape(-1)


def triangulate_nview(bearings: torch.Tensor, rot_c2a: torch.Tensor, p_cia: torch.Tensor,
                      valid: torch.Tensor, gn_iters: int = 5):
    """Triangulate F features, each from M (masked) observations.

    The anchor frame is observation 0's camera frame (FeatureInitializer
    convention).

    Args:
        bearings: (F, M, 3) unit-norm bearing in each camera frame.
        rot_c2a: (F, M, 3, 3) rotation camera_i -> anchor.
        p_cia: (F, M, 3) camera_i position in the anchor frame.
        valid: (F, M) bool observation mask.
    Returns:
        p_fa: (F, 3) feature positions in the anchor frame.
        ok: (F,) bool: conditioning (singular-value ratio < 1e4), 1e-3 <
            rho < 1e3, at least 2 valid views, and finite.
    """
    w = valid.to(bearings.dtype)
    eye = torch.eye(3, dtype=bearings.dtype, device=bearings.device)
    # linear stage: each view constrains p to the line p_cia + s * (R b):
    # (I - d dᵀ) (p - p_cia) = 0 with d = rot_c2a @ bearing
    d = torch.einsum("fmij,fmj->fmi", rot_c2a, bearings)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    proj = eye - d[..., :, None] * d[..., None, :]  # (F, M, 3, 3)
    a_mat = torch.sum(proj * w[..., None, None], dim=1)
    b_vec = torch.einsum("fmij,fmj->fi", proj * w[..., None, None], p_cia)
    # condition check as in FeatureInitializer (singular value ratio)
    svals = torch.linalg.svdvals(a_mat)
    cond_ok = (svals[:, 0] / torch.clamp(svals[:, 2], min=1e-12)) < 1e4
    p_lin = torch.linalg.solve_ex(a_mat + 1e-9 * eye, b_vec)[0]

    # Gauss-Newton on (alpha, beta, rho) in the anchor frame
    # (FeatureInitializer.cpp single-depth refinement, all views weighted)
    z0 = torch.clamp(p_lin[:, 2], min=1e-3)
    x = torch.stack([p_lin[:, 0] / z0, p_lin[:, 1] / z0, 1.0 / z0], dim=1)
    res = torch.func.vmap(_residuals)
    jac = torch.func.vmap(torch.func.jacfwd(_residuals))
    for _ in range(gn_iters):
        r = res(x, bearings, rot_c2a, p_cia, w)  # (F, 2M)
        j = jac(x, bearings, rot_c2a, p_cia, w)  # (F, 2M, 3)
        jt = j.transpose(-1, -2)
        h = jt @ j + 1e-8 * eye
        x = x - torch.linalg.solve_ex(h, (jt @ r[..., None])[..., 0])[0]
    p_fa = torch.stack([x[:, 0], x[:, 1], torch.ones_like(x[:, 0])], dim=1) / x[:, 2:3]
    depth_ok = (x[:, 2] > 1e-3) & (x[:, 2] < 1e3)
    n_obs_ok = torch.sum(w, dim=1) >= 2
    return p_fa, cond_ok & depth_ok & n_obs_ok & torch.isfinite(p_fa).all(dim=1)

"""Keyframe pose-graph smoothing: Gauss-Newton over SE(3), batched over
the factors.

Counterpart of ``cuahn_vio.parallel.pose_graph``: keyframe poses are
re-optimized against relative-pose factors (the odometry chain from the
filter, plus loop factors between non-consecutive keyframes), with the
first keyframe anchored (gauge). Each factor's 6x6 Jacobians come from
``torch.func.jacfwd`` of its residual on right-multiplicative tangent
perturbations, ``vmap``-ed over the M factors, as the JAX module takes
``jax.jacfwd`` under ``jax.vmap``. One Gauss-Newton step solves the dense
6N x 6N normal system (``torch.linalg.solve``; the JAX module leaves it to
``jnp.linalg.solve``).

The normal equations are summed by ``index_put_(accumulate=True)``, as the
JAX module's scatter-add: on CUDA that op sorts the contributions by their
place and sums each place's one after another, with no atomics, so two
runs on the card give the same poses bit for bit (``chip_smoke.py`` phase
13 repeats it at the loop-closure demo's graph). ``index_add_`` adds with
float32 atomics instead, in an order that CUDA does not fix.

Pose convention as the filter's output: q Hamilton wxyz (body -> world),
p the world-frame position.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from cuahn_vio_torch.ops.quat import quat_exp, quat_mul, quat_normalize, quat_to_rot

GAUGE_WEIGHT = 1e8  # prior information on keyframe 0's six tangent directions


class PoseGraph(NamedTuple):
    """N keyframes + M relative factors (i -> j), tensors on one device."""

    p: torch.Tensor  # (N, 3) world positions
    q: torch.Tensor  # (N, 4) wxyz body->world
    idx_i: torch.Tensor  # (M,) factor source keyframe
    idx_j: torch.Tensor  # (M,) factor target keyframe
    dp_meas: torch.Tensor  # (M, 3) measured p_j - p_i in frame i
    dq_meas: torch.Tensor  # (M, 4) measured q_i^-1 ⊗ q_j
    sqrt_info: torch.Tensor  # (M, 6, 6) sqrt information of [dp; dtheta]


def _quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def relative_pose(p_i, q_i, p_j, q_j):
    """(dp in frame i, dq = q_i^-1 ⊗ q_j), batched over leading dims."""
    dp = (quat_to_rot(q_i).transpose(-1, -2) @ (p_j - p_i)[..., None])[..., 0]
    dq = quat_normalize(quat_mul(_quat_conj(q_i), q_j))
    return dp, dq


def factor_residual(p_i, q_i, p_j, q_j, dp_meas, dq_meas):
    """(..., 6) residual [translation; 2 vec(dq_err)] of relative factors."""
    dp, dq = relative_pose(p_i, q_i, p_j, q_j)
    dq_err = quat_mul(_quat_conj(dq_meas), dq)
    dtheta = 2.0 * dq_err[..., 1:4] * torch.sign(dq_err[..., :1])
    return torch.cat([dp - dp_meas, dtheta], dim=-1)


def _perturb(p, q, xi):
    """The chart: world translation + body rotation, p' = p + xi[:3],
    q' = q ⊗ exp(xi[3:])."""
    return p + xi[..., :3], quat_normalize(quat_mul(q, quat_exp(xi[..., 3:])))


def _perturbed_residual(xi_i, xi_j, p_i, q_i, p_j, q_j, dp_meas, dq_meas):
    r = factor_residual(*_perturb(p_i, q_i, xi_i), *_perturb(p_j, q_j, xi_j),
                        dp_meas, dq_meas)
    return r, r


def _factor_jacobians(p_i, q_i, p_j, q_j, dp_meas, dq_meas):
    """(r (M, 6), J_i (M, 6, 6), J_j (M, 6, 6)): residuals and their
    Jacobians by forward-mode autodiff at the zero perturbation."""
    zero = p_i.new_zeros(p_i.shape[:-1] + (6,))
    jac = jacfwd(_perturbed_residual, argnums=(0, 1), has_aux=True)
    (j_i, j_j), r = vmap(jac)(zero, zero, p_i, q_i, p_j, q_j, dp_meas, dq_meas)
    return r, j_i, j_j


def _normal_equations(idx_i, idx_j, jiw, jjw, rw, dim: int):
    """H = JᵀJ and g = Jᵀr from the whitened per-factor blocks, each
    block added into its place by ``index_put_(accumulate=True)``."""
    off = torch.arange(6, device=rw.device)
    at_i, at_j = idx_i[:, None] * 6 + off, idx_j[:, None] * 6 + off  # (M, 6)
    rows = torch.cat([at_i, at_i, at_j, at_j])[:, :, None].expand(-1, 6, 6)
    cols = torch.cat([at_i, at_j, at_i, at_j])[:, None, :].expand(-1, 6, 6)
    blocks = torch.cat([jiw.transpose(1, 2) @ jiw, jiw.transpose(1, 2) @ jjw,
                        jjw.transpose(1, 2) @ jiw, jjw.transpose(1, 2) @ jjw])
    h = rw.new_zeros((dim, dim)).index_put_((rows, cols), blocks, accumulate=True)
    g_rows = torch.cat([(jiw.transpose(1, 2) @ rw[..., None])[..., 0],
                        (jjw.transpose(1, 2) @ rw[..., None])[..., 0]])
    g = rw.new_zeros(dim).index_put_((torch.cat([at_i, at_j]),), g_rows, accumulate=True)
    return h, g


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-6,
             huber_delta: float = 0.0):
    """Gauss-Newton (lightly damped) over all keyframes; the first pose is
    gauged by a ``GAUGE_WEIGHT`` prior.

    ``huber_delta`` > 0 enables IRLS robust weighting on the whitened
    per-factor residual norm (units of sigma) with a redescending Cauchy
    kernel, w = 1 / (1 + (||r|| / delta)^2) on the squared residual, so a
    confident outlier loop factor is driven to ~zero weight; chain factors,
    with sub-sigma residuals, keep w ~ 1.

    Returns (p_opt (N, 3), q_opt (N, 4), costs (iters,)): ``costs[k]`` is
    the whitened (and weighted) squared residual at the start of iteration
    k. Dense normal equations: fine to ~2,000 keyframes.
    """
    n = graph.p.shape[0]
    dim = 6 * n
    gauge = torch.eye(6, dtype=graph.p.dtype, device=graph.p.device) * GAUGE_WEIGHT
    p, q = graph.p, graph.q
    costs = []
    for _ in range(iters):
        r, j_i, j_j = _factor_jacobians(p[graph.idx_i], q[graph.idx_i], p[graph.idx_j],
                                        q[graph.idx_j], graph.dp_meas, graph.dq_meas)
        rw = (graph.sqrt_info @ r[..., None])[..., 0]  # (M, 6)
        jiw = graph.sqrt_info @ j_i
        jjw = graph.sqrt_info @ j_j
        if huber_delta > 0.0:
            rn = torch.linalg.vector_norm(rw, dim=1)  # (M,) sigma units
            w = torch.sqrt(1.0 / (1.0 + (rn / huber_delta) ** 2))
            rw = rw * w[:, None]
            jiw = jiw * w[:, None, None]
            jjw = jjw * w[:, None, None]
        h, g = _normal_equations(graph.idx_i, graph.idx_j, jiw, jjw, rw, dim)
        h[:6, :6] += gauge  # anchor keyframe 0
        h.diagonal().add_(damping)
        delta = torch.linalg.solve(h, -g).reshape(n, 6)
        p, q = _perturb(p, q, delta)
        costs.append(torch.sum(rw * rw))
    return p, q, torch.stack(costs) if costs else graph.p.new_zeros(0)


def _sqrt_info(sigma_dp: torch.Tensor, sigma_dth: torch.Tensor) -> torch.Tensor:
    """(L, 6, 6) diagonal sqrt information of per-factor sigmas (L,)."""
    diag = torch.cat([(1.0 / sigma_dp)[:, None].expand(-1, 3),
                      (1.0 / sigma_dth)[:, None].expand(-1, 3)], dim=1)
    return torch.diag_embed(diag)


def chain_graph_from_trajectory(
    p: torch.Tensor, q: torch.Tensor, sigma_dp: float, sigma_dth: float,
    extra_pairs=None, extra_dp=None, extra_dq=None,
    extra_sigma_dp=None, extra_sigma_dth=None,
) -> PoseGraph:
    """A chain pose graph of an odometry trajectory (consecutive keyframes,
    measurements their own relative poses, sigmas ``sigma_dp`` /
    ``sigma_dth``), with optional extra (loop) factors ``extra_pairs``
    [(a, b), ...] measuring ``extra_dp`` (L, 3) / ``extra_dq`` (L, 4).
    The loop sigmas default to the chain's; each is a scalar or (L,)
    per-factor sigmas (loop factors carry their own confidence)."""
    n = p.shape[0]
    dev, dtype = p.device, p.dtype
    idx_i = torch.arange(n - 1, device=dev)
    idx_j = idx_i + 1
    dp, dq = relative_pose(p[:-1], q[:-1], p[1:], q[1:])
    full = lambda v, m: torch.full((m,), float(v), dtype=dtype, device=dev)  # noqa: E731
    sqrt_info = _sqrt_info(full(sigma_dp, n - 1), full(sigma_dth, n - 1))
    if extra_pairs is not None:
        ends = torch.as_tensor(np.asarray(extra_pairs, np.int64).reshape(-1, 2), device=dev)
        idx_i = torch.cat([idx_i, ends[:, 0]])
        idx_j = torch.cat([idx_j, ends[:, 1]])
        dp = torch.cat([dp, torch.as_tensor(extra_dp, dtype=dtype, device=dev)])
        dq = torch.cat([dq, torch.as_tensor(extra_dq, dtype=dtype, device=dev)])
        m = ends.shape[0]

        def sigmas(extra, default):
            if extra is None:
                return full(default, m)
            return torch.as_tensor(extra, dtype=dtype, device=dev).expand(m)

        sqrt_info = torch.cat([sqrt_info, _sqrt_info(sigmas(extra_sigma_dp, sigma_dp),
                                                     sigmas(extra_sigma_dth, sigma_dth))])
    return PoseGraph(p=p, q=q, idx_i=idx_i, idx_j=idx_j, dp_meas=dp, dq_meas=dq,
                     sqrt_info=sqrt_info)

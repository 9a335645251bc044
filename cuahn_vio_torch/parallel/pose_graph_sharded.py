"""Block-partitioned pose-graph Gauss-Newton with a Schur-complement
reduced solve over the mesh.

Counterpart of ``cuahn_vio.parallel.pose_graph_sharded``. Keyframes are
split into B contiguous blocks. Endpoints of block-crossing factors (and
keyframe 0, the gauge anchor) are promoted to SEPARATORS, held by every
rank; the rest are block INTERIORS, each owned by one block. Every factor
then touches one block's interior plus separators, so a Gauss-Newton
iteration is:

    per block:   assemble H_ii, H_is, H_ss and g_i, g_s of its factors;
                 eliminate the interiors: S_loc = H_ss - H_isᵀ H_ii⁻¹ H_is
    collective:  S = Σ S_loc, b = Σ b_loc, over the rank's blocks and then
                 over the ranks (``all_reduce``): one (6S)² matrix an
                 iteration, whatever N
    everywhere:  solve S Δx_s = b, back-substitute the interiors
                 Δx_i = H_ii⁻¹ (g_i - H_is Δx_s), apply the perturbations

The B blocks are split evenly over the mesh's ranks, and a rank holds its
blocks along a leading axis: one card runs a 4-block solve alone. The
block count is the partition's, not the job's.

Assembly: the JAX module places each factor's blocks by one-hot matmuls,
which suit the TPU's matrix unit. Here each block's normal equations are
summed by ``index_put_(accumulate=True)`` into one (6(K+S))² matrix per
block, interiors first, all blocks in one call (``pose_graph.optimize``'s
op): on CUDA it sorts the contributions by place and sums each place's in
order, with no atomics, so repeats give identical bytes on the card.

Gives the solution of ``pose_graph.optimize`` on the full dense system
(the same factors, damping and keyframe-0 anchor).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cuahn_vio_torch.parallel.mesh import Mesh, all_gather_batch, all_reduce_sum, shard_bounds
from cuahn_vio_torch.parallel.pose_graph import (
    GAUGE_WEIGHT,
    PoseGraph,
    _factor_jacobians,
    _perturb,
)


class ShardedPoseGraph(NamedTuple):
    """Host-partitioned graph: leading axis B on the per-block tensors,
    which lie on the graph's device."""

    # separators (held by every rank)
    sep_idx: np.ndarray  # (S,) global keyframe ids
    p_sep: torch.Tensor  # (S, 3)
    q_sep: torch.Tensor  # (S, 4)
    # per-block interiors, padded to K
    int_idx: np.ndarray  # (B, K) global ids, -1 = padding
    p_int: torch.Tensor  # (B, K, 3)
    q_int: torch.Tensor  # (B, K, 4)
    # per-block factors, padded to M
    is_sep_i: torch.Tensor  # (B, M) bool: endpoint i is a separator
    pos_i: torch.Tensor  # (B, M) index into sep (if is_sep) else interior
    is_sep_j: torch.Tensor  # (B, M)
    pos_j: torch.Tensor  # (B, M)
    dp_meas: torch.Tensor  # (B, M, 3)
    dq_meas: torch.Tensor  # (B, M, 4)
    sqrt_info: torch.Tensor  # (B, M, 6, 6) zeroed on padding factors


def partition_graph(graph: PoseGraph, n_blocks: int) -> ShardedPoseGraph:
    """Host partitioning (numpy), as the JAX module's: contiguous blocks,
    cross-block factor endpoints and keyframe 0 promoted to separators; a
    factor belongs to the block of an interior endpoint (else endpoint
    i's)."""
    n = int(graph.p.shape[0])
    idx_i = graph.idx_i.cpu().numpy()
    idx_j = graph.idx_j.cpu().numpy()
    block_of = np.minimum(np.arange(n) * n_blocks // n, n_blocks - 1)

    sep = {0}
    for a, b in zip(idx_i, idx_j):
        if block_of[a] != block_of[b]:
            sep.add(int(a))
            sep.add(int(b))
    sep_idx = np.array(sorted(sep), np.int64)
    sep_pos = {g: s for s, g in enumerate(sep_idx)}
    is_sep = np.zeros(n, bool)
    is_sep[sep_idx] = True

    int_lists = [[] for _ in range(n_blocks)]
    int_pos = {}
    for g in range(n):
        if not is_sep[g]:
            b = block_of[g]
            int_pos[g] = len(int_lists[b])
            int_lists[b].append(g)
    k_max = max(1, max(len(lst) for lst in int_lists))

    f_lists = [[] for _ in range(n_blocks)]
    for m, (a, b) in enumerate(zip(idx_i, idx_j)):
        if not is_sep[a]:
            blk = block_of[a]
        elif not is_sep[b]:
            blk = block_of[b]
        else:
            blk = block_of[a]
        f_lists[blk].append(m)
    m_max = max(1, max(len(lst) for lst in f_lists))

    int_idx = np.array([lst + [-1] * (k_max - len(lst)) for lst in int_lists], np.int64)

    g_dp = graph.dp_meas.cpu().numpy()
    g_dq = graph.dq_meas.cpu().numpy()
    g_w = graph.sqrt_info.cpu().numpy()
    shp = (n_blocks, m_max)
    isi = np.zeros(shp, bool)
    pi = np.zeros(shp, np.int64)
    isj = np.zeros(shp, bool)
    pj = np.zeros(shp, np.int64)
    dp = np.zeros((*shp, 3), np.float32)
    dq = np.zeros((*shp, 4), np.float32)
    dq[..., 0] = 1.0
    w = np.zeros((*shp, 6, 6), np.float32)
    for blk, ms in enumerate(f_lists):
        for s, m in enumerate(ms):
            a, b = int(idx_i[m]), int(idx_j[m])
            isi[blk, s] = is_sep[a]
            pi[blk, s] = sep_pos[a] if is_sep[a] else int_pos[a]
            isj[blk, s] = is_sep[b]
            pj[blk, s] = sep_pos[b] if is_sep[b] else int_pos[b]
            dp[blk, s] = g_dp[m]
            dq[blk, s] = g_dq[m]
            w[blk, s] = g_w[m]

    p = graph.p.cpu().numpy().astype(np.float32)
    q = graph.q.cpu().numpy().astype(np.float32)
    p_int = np.zeros((n_blocks, k_max, 3), np.float32)
    q_int = np.zeros((n_blocks, k_max, 4), np.float32)
    q_int[..., 0] = 1.0
    for blk, lst in enumerate(int_lists):
        for s, g in enumerate(lst):
            p_int[blk, s] = p[g]
            q_int[blk, s] = q[g]

    def dev(x):
        return torch.as_tensor(x, device=graph.p.device)

    return ShardedPoseGraph(
        sep_idx=sep_idx, p_sep=dev(p[sep_idx]), q_sep=dev(q[sep_idx]),
        int_idx=int_idx, p_int=dev(p_int), q_int=dev(q_int),
        is_sep_i=dev(isi), pos_i=dev(pi), is_sep_j=dev(isj), pos_j=dev(pj),
        dp_meas=dev(dp), dq_meas=dev(dq), sqrt_info=dev(w),
    )


def _block_normal_equations(place_i, place_j, jiw, jjw, rw, dim: int):
    """Per-block H = JᵀJ (nb, dim, dim) and g = -Jᵀr (nb, dim) of the
    whitened factor blocks (nb, M, 6, 6) / (nb, M, 6), each factor's 6x6
    blocks added at its endpoints' places (nb, M) by
    ``index_put_(accumulate=True)``."""
    nb, m = place_i.shape
    off = torch.arange(6, device=rw.device)
    blk = torch.arange(nb, device=rw.device)[:, None, None].expand(nb, m, 6)
    at_i, at_j = place_i[..., None] * 6 + off, place_j[..., None] * 6 + off  # (nb, M, 6)
    blocks4 = torch.cat([blk] * 4, dim=1)[..., None].expand(-1, -1, 6, 6)
    rows = torch.cat([at_i, at_i, at_j, at_j], dim=1)[..., None].expand(-1, -1, 6, 6)
    cols = torch.cat([at_i, at_j, at_i, at_j], dim=1)[..., None, :].expand(-1, -1, 6, 6)
    jit, jjt = jiw.transpose(-1, -2), jjw.transpose(-1, -2)
    vals = torch.cat([jit @ jiw, jit @ jjw, jjt @ jiw, jjt @ jjw], dim=1)
    h = rw.new_zeros((nb, dim, dim)).index_put_((blocks4, rows, cols), vals, accumulate=True)
    g_vals = -torch.cat([(jit @ rw[..., None])[..., 0], (jjt @ rw[..., None])[..., 0]], dim=1)
    g = rw.new_zeros((nb, dim)).index_put_(
        (torch.cat([blk, blk], dim=1), torch.cat([at_i, at_j], dim=1)), g_vals, accumulate=True)
    return h, g


def _gn_iteration(mesh: Optional[Mesh], n_blocks: int, damping: float,
                  p_int, q_int, p_sep, q_sep, fac):
    """One Gauss-Newton step over this rank's nb blocks (leading axis):
    their Schur systems summed, then summed over the ranks."""
    is_i, pos_i, is_j, pos_j, dpm, dqm, w = fac
    nb, k = p_int.shape[:2]
    s = p_sep.shape[0]
    dim_i, dim_s = 6 * k, 6 * s
    blk = torch.arange(nb, device=p_int.device)[:, None]

    def endpoint(is_sep, pos):
        sep_pos = torch.where(is_sep, pos, 0)
        int_pos = torch.where(is_sep, 0, pos)
        pe = torch.where(is_sep[..., None], p_sep[sep_pos], p_int[blk, int_pos])
        qe = torch.where(is_sep[..., None], q_sep[sep_pos], q_int[blk, int_pos])
        return pe, qe

    pe_i, qe_i = endpoint(is_i, pos_i)
    pe_j, qe_j = endpoint(is_j, pos_j)
    m = pos_i.shape[1]
    flat = lambda x: x.reshape((nb * m,) + x.shape[2:])  # noqa: E731
    r, j_i, j_j = _factor_jacobians(flat(pe_i), flat(qe_i), flat(pe_j), flat(qe_j),
                                    flat(dpm), flat(dqm))
    r, j_i, j_j = (x.reshape((nb, m) + x.shape[1:]) for x in (r, j_i, j_j))
    rw = (w @ r[..., None])[..., 0]
    jiw, jjw = w @ j_i, w @ j_j

    # interiors at places 0..K-1, separators at K..K+S-1 (padding factors
    # have w = 0: their blocks are zeros wherever they land)
    h, g = _block_normal_equations(torch.where(is_i, k + pos_i, pos_i),
                                   torch.where(is_j, k + pos_j, pos_j),
                                   jiw, jjw, rw, dim_i + dim_s)
    h_ii, h_is, h_ss = h[:, :dim_i, :dim_i], h[:, :dim_i, dim_i:], h[:, dim_i:, dim_i:]
    g_i, g_s = g[:, :dim_i], g[:, dim_i:]
    cost_loc = torch.sum(rw * rw)

    # damping makes padded interior slots (no factors) invertible too;
    # the separators' damping and the keyframe-0 anchor are split 1/B so
    # the sums over all blocks give the dense system's
    eye_i = torch.eye(dim_i, dtype=h.dtype, device=h.device)
    h_ii = h_ii + eye_i * damping
    anchor = torch.eye(dim_s, dtype=h.dtype, device=h.device) * (damping / n_blocks)
    anchor[:6, :6] += torch.eye(6, dtype=h.dtype, device=h.device) * (GAUGE_WEIGHT / n_blocks)
    h_ss = h_ss + anchor  # separator 0 IS keyframe 0 (always promoted, sorted)

    sol = torch.linalg.solve(h_ii, torch.cat([h_is, g_i[..., None]], dim=2))
    hii_inv_his, hii_inv_gi = sol[..., :dim_s], sol[..., dim_s]
    his_t = h_is.transpose(1, 2)
    s_loc = h_ss - his_t @ hii_inv_his
    b_loc = g_s - (his_t @ hii_inv_gi[..., None])[..., 0]

    # the only traffic: the (6S)² Schur system and the cost
    s_glob = s_loc.sum(dim=0)
    b_glob = b_loc.sum(dim=0)
    if mesh is not None:
        packed = all_reduce_sum(torch.cat([s_glob.reshape(-1), b_glob, cost_loc.reshape(1)]),
                                mesh)
        s_glob, b_glob = packed[:dim_s * dim_s].reshape(dim_s, dim_s), packed[dim_s * dim_s:-1]
        cost = packed[-1]
    else:
        cost = cost_loc
    dx_s = torch.linalg.solve(s_glob, b_glob)
    dx_i = hii_inv_gi - (hii_inv_his @ dx_s[:, None])[..., 0]

    p_sep2, q_sep2 = _perturb(p_sep, q_sep, dx_s.reshape(s, 6))
    p_int2, q_int2 = _perturb(p_int, q_int, dx_i.reshape(nb, k, 6))
    return p_int2, q_int2, p_sep2, q_sep2, cost


def optimize_sharded(sg: ShardedPoseGraph, mesh: Optional[Mesh] = None, iters: int = 10,
                     damping: float = 1e-6):
    """Gauss-Newton over the blocks; with a mesh, this rank's contiguous
    share of the B blocks, the Schur systems summed over the ranks.

    Returns (p_int, q_int, p_sep, q_sep, costs): the interiors of the
    rank's blocks (all B without a mesh or on a one-device mesh), the
    separators and ``costs[k]``, the whitened squared residual at the
    start of iteration k over every block. ``reassemble`` puts them back in
    keyframe order.
    """
    n_blocks = sg.p_int.shape[0]
    lo, hi = (0, n_blocks) if mesh is None else shard_bounds(n_blocks, mesh)
    fac = tuple(x[lo:hi] for x in (sg.is_sep_i, sg.pos_i, sg.is_sep_j, sg.pos_j,
                                   sg.dp_meas, sg.dq_meas, sg.sqrt_info))
    p_int, q_int, p_sep, q_sep = sg.p_int[lo:hi], sg.q_int[lo:hi], sg.p_sep, sg.q_sep
    costs = []
    for _ in range(iters):
        p_int, q_int, p_sep, q_sep, cost = _gn_iteration(
            mesh, n_blocks, damping, p_int, q_int, p_sep, q_sep, fac)
        costs.append(cost)
    return p_int, q_int, p_sep, q_sep, (torch.stack(costs) if costs else p_sep.new_zeros(0))


def reassemble(sg: ShardedPoseGraph, p_int, q_int, p_sep, q_sep,
               mesh: Optional[Mesh] = None):
    """Block and separator results back in global keyframe order (numpy
    (N, 3), (N, 4)); with a mesh the ranks' blocks are gathered first."""
    if mesh is not None:
        p_int, q_int = all_gather_batch(p_int, mesh), all_gather_batch(q_int, mesh)
    n = int(sg.sep_idx.max()) + 1
    valid = sg.int_idx[sg.int_idx >= 0]
    if valid.size:
        n = max(n, int(valid.max()) + 1)
    p = np.zeros((n, 3), np.float32)
    q = np.zeros((n, 4), np.float32)
    p[sg.sep_idx] = p_sep.cpu().numpy()
    q[sg.sep_idx] = q_sep.cpu().numpy()
    keep = sg.int_idx >= 0
    p[sg.int_idx[keep]] = p_int.cpu().numpy()[keep]
    q[sg.int_idx[keep]] = q_int.cpu().numpy()[keep]
    return p, q

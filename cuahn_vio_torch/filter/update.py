"""EKF measurement update with the network's 4-point offset + covariance.

Counterpart of ``cuahn_vio.filter.update`` (UpdaterHNet.cpp:28-61): H
selects the (x, y) components of the four corner-offset states,
K = P Hᵀ (H P Hᵀ + K_net Σ_net / 159.5²)⁻¹, innovation = mean/159.5 −
propagated offset, quaternion right-update.

Every measurement passes a finiteness check and the chi-square (8 DoF)
gate; a rejected one leaves the state as propagated. The accept decision
is a ``torch.where`` on the device, never a host branch, so the update
does not synchronize with the card.
"""

from __future__ import annotations

import functools

import torch

from cuahn_vio_torch.filter.state import FOCAL, FOCAL2, FilterParams, FilterState
from cuahn_vio_torch.ops.quat import quat_exp, quat_mul, quat_normalize

# columns of the 27-state selected by the 8 measurement rows
MEAS_IDX = (15, 16, 18, 19, 21, 22, 24, 25)


def _meas_idx(ref: torch.Tensor) -> torch.Tensor:
    return _meas_idx_on(ref.device)


@functools.lru_cache(maxsize=None)
def _meas_idx_on(device: torch.device) -> torch.Tensor:
    # made once per device: copying a fresh index tensor to the card would
    # synchronize the stream at every update
    return torch.tensor(MEAS_IDX, dtype=torch.long, device=device)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹ b without the singularity check (and host sync) of ``solve``."""
    return torch.linalg.solve_ex(a, b)[0]


def propagated_offset8(state: FilterState) -> torch.Tensor:
    """The propagated 4-point offset prior, (8,), normalized camera units."""
    return state.off[:, :2].reshape(8)


def innovation_stats(state: FilterState, params: FilterParams,
                     net_mean8: torch.Tensor, net_cov88: torch.Tensor):
    """Innovation, its covariance and Mahalanobis distance.

    Non-finite measurements are replaced by harmless values so the algebra
    stays finite; ``meas_finite`` flags them for rejection.

    Returns (inno (8,), s_mat (8, 8), chi2 (), meas_finite () bool,
    p_meas (8, 8): S minus the white-noise part).
    """
    dtype = state.p.dtype
    idx = _meas_idx(state.p)
    meas_finite = torch.isfinite(net_mean8).all() & torch.isfinite(net_cov88).all()
    net_mean8 = torch.where(meas_finite, net_mean8, torch.zeros_like(net_mean8))
    eye8 = torch.eye(8, dtype=net_cov88.dtype, device=net_cov88.device)
    net_cov88 = torch.where(meas_finite, net_cov88, eye8)

    # effective Jacobian e H (prior-echo model); each knob meets a tensor
    # before another knob, so a float and a 0-d tensor give the same bits
    e = 1.0 - params.echo_beta
    p_meas = e * (e * state.cov[idx][:, idx])
    pred = propagated_offset8(state)
    if state.bias is not None:
        hc = e * state.cov_xb[idx]
        p_meas = p_meas + hc + hc.T + state.cov_bb
        pred = pred + state.bias
    s_mat = p_meas + params.k_net_cov * net_cov88.to(dtype) / FOCAL2
    inno = net_mean8.to(dtype) / FOCAL - pred
    chi2 = inno @ _solve(s_mat, inno[:, None])[:, 0]
    return inno, s_mat, chi2, meas_finite, p_meas


def hnet_update(state: FilterState, params: FilterParams,
                net_mean8: torch.Tensor, net_cov88: torch.Tensor,
                update_offset: bool, cov_update: bool = True) -> FilterState:
    """One EKF update (UpdaterHNet::update).

    Args:
        net_mean8: (8,) network 4-point flow, pixels.
        net_cov88: (8, 8) network covariance, pixels².
        update_offset: if False only the 15 core states are corrected.
        cov_update: if False only the mean is corrected (the intermediate
            IEKF step).
    """
    dtype = state.p.dtype
    idx = _meas_idx(state.p)
    inno, s_mat, chi2, meas_finite, _ = innovation_stats(
        state, params, net_mean8, net_cov88
    )
    accept = meas_finite & (chi2 < params.chi2_gate)

    # adaptive covariance matching: inflate the network part of S by
    # chi2/chi2_soft when the innovation is far outside its covariance
    # (chi2_soft = inf, float or 0-d tensor: chi2 / inf = 0, so lam = 1)
    r_net = params.k_net_cov * net_cov88.to(dtype) / FOCAL2
    lam = torch.clamp(chi2 / params.chi2_soft, min=1.0)
    s_mat = s_mat + (lam - 1.0) * r_net

    e = 1.0 - params.echo_beta
    u_x = e * state.cov[:, idx]  # P (eH)ᵀ (27, 8)
    if state.bias is not None:
        u_x = u_x + state.cov_xb
        u_b = e * state.cov_xb[idx].T + state.cov_bb
    k_gain = _solve(s_mat.T, u_x.T).T  # (27, 8) = Ux S⁻¹

    new_cov = state.cov - k_gain @ u_x.T if cov_update else state.cov

    d = k_gain @ inno  # (27,)
    if not update_offset:
        d = torch.cat([d[:15], torch.zeros_like(d[15:])])

    updated = FilterState(
        p=state.p + d[0:3],
        q=quat_normalize(quat_mul(state.q, quat_exp(d[3:6]))),
        v=state.v + d[6:9],
        ba=state.ba + d[9:12],
        bg=state.bg + d[12:15],
        off=state.off + d[15:27].reshape(4, 3),
        cov=new_cov,
        bias=state.bias,
        cov_xb=state.cov_xb,
        cov_bb=state.cov_bb,
    )
    if state.bias is not None:
        # the bias mean/cov always take the full joint update
        k_b = _solve(s_mat.T, u_b.T).T  # (8, 8) = Ub S⁻¹
        updated = updated._replace(bias=state.bias + k_b @ inno)
        if cov_update:
            updated = updated._replace(
                cov_xb=state.cov_xb - k_gain @ u_b.T,
                cov_bb=state.cov_bb - k_b @ u_b.T,
            )
    # last-resort guard: an accepted update must leave the state finite
    leaves = [updated.cov, updated.p, updated.q, updated.v, updated.ba, updated.bg]
    if updated.bias is not None:
        leaves += [updated.bias, updated.cov_xb, updated.cov_bb]
    upd_finite = torch.stack([torch.isfinite(x).all() for x in leaves]).all()
    accept = accept & upd_finite
    return FilterState(*(
        None if new is None else torch.where(accept, new, old)
        for new, old in zip(updated, state)
    ))

"""Filter state and static parameters.

Counterpart of ``cuahn_vio.filter.state``. The 27-state error-state layout:
  p 0:3 | q 3:6 | v 6:9 | ba 9:12 | bg 12:15 | 4x corner offsets 15:27
with corners ordered UL, BL, BR, UR. Robocentric convention: q is the
Hamilton body(IMU)->world quaternion (wxyz), p the world-origin -> IMU
vector in the current IMU frame, v the velocity in the IMU frame.

The optional 8-D Ornstein-Uhlenbeck measurement-bias block (``bias``,
``cov_xb``, ``cov_bb``) keeps ``cov`` the exact 27x27 marginal; when the
three fields are None every filter function reduces to the plain model.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# normalized corner bearing vectors: (±1, ±111.5/159.5, 1)
CORNER_XY1 = np.array(
    [
        [-1.0, -0.69906, 1.0],  # upper-left
        [-1.0, 0.69906, 1.0],  # bottom-left
        [1.0, 0.69906, 1.0],  # bottom-right
        [1.0, -0.69906, 1.0],  # upper-right
    ],
    dtype=np.float32,
)

FOCAL = 159.5  # pixel <-> normalized-camera scaling
FOCAL2 = 25440.25  # 159.5^2

STATE_DIM = 27
CORE_DIM = 15


class FilterState(NamedTuple):
    """The 27-state estimate as tensors on one device."""

    p: torch.Tensor  # (3,)  world-origin -> IMU, in IMU frame
    q: torch.Tensor  # (4,)  Hamilton wxyz, IMU -> world
    v: torch.Tensor  # (3,)  velocity in IMU frame
    ba: torch.Tensor  # (3,) accelerometer bias
    bg: torch.Tensor  # (3,) gyroscope bias
    off: torch.Tensor  # (4, 3) corner-offset states (z nominally 0)
    cov: torch.Tensor  # (27, 27) error-state covariance (exact marginal)
    bias: Optional[torch.Tensor] = None  # (8,) measurement bias, normalized
    cov_xb: Optional[torch.Tensor] = None  # (27, 8) state-bias cross-cov
    cov_bb: Optional[torch.Tensor] = None  # (8, 8) bias covariance


class FilterParams(NamedTuple):
    """Static filter parameters. Matrices are tensors on the filter's
    device. The six scalar knobs are Python floats (``make_params``) or
    0-d tensors on that device; the grid sweep (``eval.tuning``) stacks
    whole FilterParams, every field with a leading grid dim, and maps the
    filter over them with ``torch.func.vmap``."""

    c_rot_i: torch.Tensor  # (3, 3) rotation IMU -> camera
    i_t_i2c: torch.Tensor  # (3,)   IMU -> camera offset, in IMU frame
    gravity: torch.Tensor  # (3,)   [0, 0, -g] world FLU
    q_noise: torch.Tensor  # (15, 15) process noise
    k_net_cov: float  # measurement-covariance temperature
    chi2_gate: float = 1000.0  # 8-DoF Mahalanobis catastrophe gate
    bias_sigma: float = 0.0  # OU bias stationary std, normalized units
    bias_tau: float = 1.0  # OU correlation time, s
    chi2_soft: float = float("inf")  # adaptive R inflation threshold
    echo_beta: float = 0.0  # prior-echo fraction of the prior-mode net


def make_params(
    t_imu_to_cam,
    gravity_mag: float = 9.81,
    sigma_w: float = 0.00559017,
    sigma_a: float = 0.01118034,
    sigma_wb: float = 8.94427e-4,
    sigma_ab: float = 0.04472136,
    k_net_cov: float = 10.0,
    chi2_gate: float = 1000.0,
    q_scale: float = 1.0,
    extra_pos_noise: float = 1.0e-4,
    bias_sigma_px: float = 0.0,
    bias_tau: float = 1.0,
    chi2_soft: float = float("inf"),
    echo_beta: float = 0.0,
    dtype=torch.float32,
    device="cuda",
) -> FilterParams:
    """FilterParams from the 4x4 T_ItoC extrinsic and noise densities
    (UZH-FPV launch defaults; Q layout per Propagator.h:93-97)."""
    t = torch.as_tensor(np.asarray(t_imu_to_cam), dtype=dtype, device=device)
    c_rot_i = t[:3, :3]
    i_t_i2c = -c_rot_i.T @ t[:3, 3]
    eye3 = torch.eye(3, dtype=dtype, device=device)
    q = torch.zeros((15, 15), dtype=dtype, device=device)
    q[0:3, 0:3] = eye3 * (q_scale * sigma_w**2)
    q[3:6, 3:6] = eye3 * (q_scale * sigma_a**2)
    q[6:9, 6:9] = eye3 * (q_scale * sigma_ab**2)
    q[9:12, 9:12] = eye3 * (q_scale * sigma_wb**2)
    q[12:15, 12:15] = eye3 * extra_pos_noise

    def knob(v: float) -> float:
        # the nearest value of ``dtype``, as the JAX package's arrays hold
        # it: then a 0-d tensor of the knob gives the filter the same bits
        return torch.tensor(float(v), dtype=dtype).item()

    return FilterParams(
        c_rot_i=c_rot_i.contiguous(),
        i_t_i2c=i_t_i2c,
        gravity=torch.tensor([0.0, 0.0, -gravity_mag], dtype=dtype, device=device),
        q_noise=q,
        k_net_cov=knob(k_net_cov),
        chi2_gate=knob(chi2_gate),
        bias_sigma=knob(float(bias_sigma_px) / FOCAL),
        bias_tau=knob(bias_tau),
        chi2_soft=knob(chi2_soft),
        echo_beta=knob(echo_beta),
    )


def with_bias_block(state: FilterState, params: FilterParams) -> FilterState:
    """Attach an inert-at-zero measurement-bias block: b = 0, cross-cov 0,
    bias cov at its stationary value sigma_b^2 I."""
    p = state.p
    return state._replace(
        bias=p.new_zeros(8),
        cov_xb=p.new_zeros((27, 8)),
        cov_bb=torch.eye(8, dtype=p.dtype, device=p.device) * params.bias_sigma
        * params.bias_sigma,
    )


def reset_4pt_offset(state: FilterState) -> FilterState:
    """Zero the corner offsets and every covariance entry outside the
    top-left 15x15 core block (State.cpp:101-111). With the bias block the
    offset rows of the cross-covariance are zeroed too."""
    new_cov = torch.zeros_like(state.cov)
    new_cov[:CORE_DIM, :CORE_DIM] = state.cov[:CORE_DIM, :CORE_DIM]
    state = state._replace(off=torch.zeros_like(state.off), cov=new_cov)
    if state.cov_xb is not None:
        cov_xb = state.cov_xb.clone()
        cov_xb[CORE_DIM:, :] = 0.0
        state = state._replace(cov_xb=cov_xb)
    return state

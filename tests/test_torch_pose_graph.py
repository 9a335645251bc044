"""The port's pose-graph smoother (``cuahn_vio_torch.parallel.pose_graph``)
against ``cuahn_vio.parallel.pose_graph`` on the CPU, on the cases of
``tests/test_pose_graph.py``.

Tolerances:
- ``relative_pose`` and ``factor_residual``: 1e-6 absolute (measured
  <= 2.4e-7);
- the factor Jacobians against ``jax.jacfwd``: 1e-5 absolute;
- ``optimize``: poses within 1e-4 m (quaternions 1e-4), every iteration's
  cost within 1e-3 relative (measured ~5e-7 m and ~3e-6 relative: the
  normal equations are summed in another order than XLA's scatter-add),
  or 1e-6 absolute once a chain has converged (the cost is then float32
  noise, ~5e-9 in both packages, a whitened squared residual far under a
  thousandth of a sigma);
- ``chain_graph_from_trajectory``: graphs equal within 1e-6;
- two runs of the port: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.ops.quat import quat_exp as jquat_exp
from cuahn_vio.ops.quat import quat_mul as jquat_mul
from cuahn_vio.ops.quat import quat_normalize as jquat_normalize
from cuahn_vio.ops.quat import quat_to_rot as jquat_to_rot
from cuahn_vio.parallel import pose_graph as jpg
from cuahn_vio_torch.parallel import pose_graph as tpg

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

ALGEBRA_TOL = 1e-6
JAC_TOL = 1e-5
POSE_TOL = 1e-4
COST_RTOL = 1e-3
COST_ATOL = 1e-6  # converged: float32 noise


def circle_traj(n=40, radius=3.0):
    th = np.linspace(0, 1.5 * np.pi, n)
    p = np.stack([radius * np.cos(th), radius * np.sin(th), 1.5 + 0.1 * np.sin(3 * th)], 1)
    q = np.stack([np.asarray(jquat_exp(jnp.array([0.05, 0.0, t]))) for t in th])
    return p.astype(np.float32), q.astype(np.float32)


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def _graphs(p, q, **kw):
    """The same chain graph (+ loop factors) built by both packages."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    gj = jpg.chain_graph_from_trajectory(jnp.asarray(p), jnp.asarray(q), **jkw)
    gt = tpg.chain_graph_from_trajectory(*_t(p, q), **kw)
    return gj, gt


def _perturbed(rng, p, q, sigma_p=0.2, sigma_th=0.05):
    """Poses off the truth (the first kept: it is the gauge)."""
    dp = (rng.normal(size=p.shape) * sigma_p).astype(np.float32)
    dp[0] = 0
    rv = (rng.normal(size=(p.shape[0], 3)) * sigma_th).astype(np.float32)
    rv[0] = 0
    dq = jax.vmap(jquat_exp)(jnp.asarray(rv))
    q2 = jax.vmap(lambda a, b: jquat_normalize(jquat_mul(a, b)))(jnp.asarray(q), dq)
    return p + dp, np.asarray(q2)


def _assert_same_optimum(gj, gt, **kw):
    pj, qj, cj = jpg.optimize(gj, **kw)
    pt, qt, ct = tpg.optimize(gt, **kw)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=COST_RTOL, atol=COST_ATOL)
    return pt, ct


def test_relative_pose_and_residual_match_jax():
    p, q = circle_traj(6)
    rng = np.random.default_rng(1)
    dp_meas = rng.normal(size=(5, 3)).astype(np.float32)
    dq_meas = np.asarray(jax.vmap(jquat_exp)(jnp.asarray(rng.normal(size=(5, 3)) * 0.1,
                                                         jnp.float32)))
    args = (p[:-1], q[:-1], p[1:], q[1:])
    jd = jax.vmap(jpg.relative_pose)(*(jnp.asarray(a) for a in args))
    td = tpg.relative_pose(*_t(*args))
    for got, want in zip(td, jd):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ALGEBRA_TOL, rtol=0)
    jr = jax.vmap(jpg.factor_residual)(*(jnp.asarray(a) for a in (*args, dp_meas, dq_meas)))
    tr = tpg.factor_residual(*_t(*args, dp_meas, dq_meas))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ALGEBRA_TOL, rtol=0)
    # at the truth the residual vanishes
    zero = tpg.factor_residual(*_t(*args), *td)
    np.testing.assert_allclose(zero.numpy(), 0.0, atol=ALGEBRA_TOL)


def test_factor_jacobians_match_jax_jacfwd():
    p, q = circle_traj(9)
    p2, q2 = _perturbed(np.random.default_rng(2), p, q, 0.1, 0.05)
    a, b = np.arange(8), np.array([1, 2, 3, 4, 5, 6, 7, 0])
    dp, dq = (np.asarray(x) for x in jax.vmap(jpg.relative_pose)(
        jnp.asarray(p[a]), jnp.asarray(q[a]), jnp.asarray(p[b]), jnp.asarray(q[b])))
    args = (p2[a], q2[a], p2[b], q2[b], dp, dq)
    jr, jji, jjj = jax.vmap(jpg._factor_jacobians)(*(jnp.asarray(x) for x in args))
    tr, tji, tjj = tpg._factor_jacobians(*_t(*args))
    for got, want in ((tr, jr), (tji, jji), (tjj, jjj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAC_TOL, rtol=0)


def test_optimize_recovers_the_chain_like_jax(rng):
    p, q = circle_traj(20)
    gj, gt = _graphs(p, q, sigma_dp=0.01, sigma_dth=0.005)
    p0, q0 = _perturbed(rng, p, q)
    gj = gj._replace(p=jnp.asarray(p0), q=jnp.asarray(q0))
    gt = gt._replace(p=torch.as_tensor(p0), q=torch.as_tensor(q0))
    pt, ct = _assert_same_optimum(gj, gt, iters=15)
    np.testing.assert_allclose(pt.numpy(), p, atol=5e-3)
    assert float(ct[-1]) < float(ct[0]) * 1e-4


def _drifted_chain(rng, p, q, noise=0.03):
    """Odometry integrated from noisy relative positions: (drifted p, q,
    the noisy measurements)."""
    dp, dq = (np.asarray(x) for x in jax.vmap(jpg.relative_pose)(
        jnp.asarray(p[:-1]), jnp.asarray(q[:-1]), jnp.asarray(p[1:]), jnp.asarray(q[1:])))
    dp_noisy = (dp + rng.normal(size=dp.shape) * noise).astype(np.float32)
    p_d, q_d = [p[0]], [q[0]]
    for k in range(len(p) - 1):
        r = np.asarray(jquat_to_rot(jnp.asarray(q_d[-1])))
        p_d.append(p_d[-1] + r @ dp_noisy[k])
        q_d.append(np.asarray(jquat_normalize(jquat_mul(jnp.asarray(q_d[-1]), dq[k]))))
    return np.stack(p_d).astype(np.float32), np.stack(q_d).astype(np.float32), dp_noisy


def _loop_measurements(p, q, pairs, shift=None):
    d = [jpg.relative_pose(*(jnp.asarray(x) for x in (p[a], q[a], p[b], q[b])))
         for a, b in pairs]
    edp = np.stack([np.asarray(x[0]) for x in d])
    if shift is not None:
        edp = edp + shift
    return edp.astype(np.float32), np.stack([np.asarray(x[1]) for x in d])


def test_loop_factors_reduce_drift_like_jax(rng):
    p, q = circle_traj(30)
    n = len(p)
    p_d, q_d, dp_noisy = _drifted_chain(rng, p, q)
    pairs = [(0, n - 1), (5, n - 5), (0, n // 2)]
    edp, edq = _loop_measurements(p, q, pairs)
    gj, gt = _graphs(p_d, q_d, sigma_dp=0.03, sigma_dth=0.01, extra_pairs=pairs,
                     extra_dp=edp, extra_dq=edq, extra_sigma_dp=0.005, extra_sigma_dth=0.002)
    gj = gj._replace(dp_meas=gj.dp_meas.at[: n - 1].set(jnp.asarray(dp_noisy)))
    gt = gt._replace(dp_meas=torch.cat([torch.as_tensor(dp_noisy), gt.dp_meas[n - 1:]]))
    pt, _ = _assert_same_optimum(gj, gt, iters=15)
    drift = np.linalg.norm(p_d[-1] - p[-1])
    assert drift > 0.05
    assert np.linalg.norm(pt.numpy()[-1] - p[-1]) < 0.5 * drift


@pytest.mark.parametrize("huber", [0.0, 3.0])
def test_huber_outlier_like_jax(huber):
    """A confident 1 m outlier loop factor: plain least squares is dragged,
    the Cauchy IRLS is not; both packages agree in either mode."""
    p, q = circle_traj(25)
    n = len(p)
    pairs = [(0, n - 1), (3, n - 3)]
    edp, edq = _loop_measurements(p, q, pairs, shift=np.array([[0, 0, 0], [1.0, 0, 0]]))
    gj, gt = _graphs(p, q, sigma_dp=0.02, sigma_dth=0.01, extra_pairs=pairs, extra_dp=edp,
                     extra_dq=edq, extra_sigma_dp=0.01, extra_sigma_dth=0.01)
    pt, _ = _assert_same_optimum(gj, gt, iters=10, huber_delta=huber)
    err = float(np.mean(np.linalg.norm(pt.numpy() - p, axis=1)))
    assert err > 0.02 if huber == 0.0 else err < 0.01, err


@pytest.mark.parametrize("sigmas", ["scalar", "per_factor", "chain"])
def test_chain_graph_matches_jax(sigmas):
    p, q = circle_traj(12)
    pairs = [(0, 11), (2, 9), (4, 7)]
    edp, edq = _loop_measurements(p, q, pairs, shift=0.1)
    loop = dict(scalar=dict(extra_sigma_dp=0.05, extra_sigma_dth=0.02),
                per_factor=dict(extra_sigma_dp=np.array([0.01, 0.02, 0.04], np.float32),
                                extra_sigma_dth=np.array([0.1, 0.2, 0.3], np.float32)),
                chain={})[sigmas]
    gj, gt = _graphs(p, q, sigma_dp=0.02, sigma_dth=0.01, extra_pairs=pairs, extra_dp=edp,
                     extra_dq=edq, **loop)
    for name in tpg.PoseGraph._fields:
        np.testing.assert_allclose(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)),
                                   atol=ALGEBRA_TOL, rtol=0, err_msg=name)
    assert gt.idx_i.dtype == torch.int64 and gt.sqrt_info.shape == (14, 6, 6)


def test_two_runs_are_bit_identical(rng):
    """The same graph twice gives the same poses and costs bit for bit
    (with repeated blocks: two factors on one pair)."""
    p, q = circle_traj(30)
    p_d, q_d, _ = _drifted_chain(rng, p, q)
    pairs = [(0, 29), (0, 29), (3, 20), (20, 3)]
    edp, edq = _loop_measurements(p, q, pairs, shift=0.02)
    _, gt = _graphs(p_d, q_d, sigma_dp=0.03, sigma_dth=0.01, extra_pairs=pairs, extra_dp=edp,
                    extra_dq=edq, extra_sigma_dp=np.array([0.01, 0.02, 0.03, 0.04], np.float32))
    a = tpg.optimize(gt, iters=6, huber_delta=3.0)
    b = tpg.optimize(gt, iters=6, huber_delta=3.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_normal_equations_equal_the_dense_products(rng):
    """``_normal_equations`` (blocks added into place, repeated pairs and a
    reversed one among them) gives JᵀJ and Jᵀr of the dense whitened
    Jacobian, to float32 rounding (1e-5 relative to the largest entry)."""
    n, idx_i, idx_j = 6, [0, 1, 2, 0, 0, 4, 3], [1, 2, 3, 5, 5, 1, 0]
    m = len(idx_i)
    jiw, jjw = (torch.tensor(rng.normal(size=(m, 6, 6)), dtype=torch.float32) for _ in "ij")
    rw = torch.tensor(rng.normal(size=(m, 6)), dtype=torch.float32)
    h, g = tpg._normal_equations(torch.tensor(idx_i), torch.tensor(idx_j), jiw, jjw, rw, 6 * n)
    jac = np.zeros((6 * m, 6 * n))
    for k, (i, j) in enumerate(zip(idx_i, idx_j)):
        jac[6 * k:6 * k + 6, 6 * i:6 * i + 6] += jiw[k].double().numpy()
        jac[6 * k:6 * k + 6, 6 * j:6 * j + 6] += jjw[k].double().numpy()
    h_ref, g_ref = jac.T @ jac, jac.T @ rw.double().numpy().reshape(-1)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=0, atol=1e-5 * np.abs(h_ref).max())
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=1e-5 * np.abs(g_ref).max())

"""Trajectory association and alignment (umeyama / posyaw / se3 / sim3).

A copy of ``cuahn_vio.eval.align`` (numpy only), plus ``ate_rmse``: the
ATE of ``cuahn_vio.eval.metrics.ResultTrajectory.calculate_ate``.

Rebuilds ov_eval's alignment stack in numpy:
- JPL quaternion helpers            <- ov_eval/src/utils/Math.h
- ``associate`` / ``associate_indices`` <- AlignUtils::perform_association
                                       (AlignUtils.cpp:93-186)
- ``align_umeyama`` + get_best_yaw  <- AlignUtils.cpp:26-91, AlignUtils.h:52
- ``align_trajectory`` dispatch     <- AlignTrajectory.cpp:26-55 (posyaw,
                                       posyawsingle, se3, se3single, sim3,
                                       none)

Pose convention: (N, 7) arrays [x y z qx qy qz qw], JPL quaternion q_GtoI
(world->body), exactly the pose-file convention.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- JPL quat
def jpl_quat_to_rot(q: np.ndarray) -> np.ndarray:
    """JPL xyzw quaternion -> R_GtoI (Math.h quat_2_Rot)."""
    x, y, z, w = q
    qv = np.array([x, y, z])
    sk = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return (2 * w * w - 1) * np.eye(3) - 2 * w * sk + 2 * np.outer(qv, qv)


def jpl_rot_to_quat(rot: np.ndarray) -> np.ndarray:
    """R_GtoI -> JPL xyzw quaternion (Math.h rot_2_quat, trace branch +
    fallbacks)."""
    t = np.trace(rot)
    if t > 0:
        w = 0.5 * np.sqrt(1 + t)
        x = (rot[1, 2] - rot[2, 1]) / (4 * w)
        y = (rot[2, 0] - rot[0, 2]) / (4 * w)
        z = (rot[0, 1] - rot[1, 0]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(rot)))
        v = np.zeros(4)
        j, k = (i + 1) % 3, (i + 2) % 3
        v[i] = 0.5 * np.sqrt(1 + rot[i, i] - rot[j, j] - rot[k, k])
        v[3] = (rot[j, k] - rot[k, j]) / (4 * v[i])
        v[j] = (rot[i, j] + rot[j, i]) / (4 * v[i])
        v[k] = (rot[i, k] + rot[k, i]) / (4 * v[i])
        x, y, z, w = v
    q = np.array([x, y, z, w])
    q /= np.linalg.norm(q)
    if q[3] < 0:
        q = -q
    return q


def jpl_quat_multiply(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """JPL product with R(q⊗p) = R(q) R(p) (Math.h quat_multiply)."""
    q4, p4 = q[3], p[3]
    qv, pv = q[:3], p[:3]
    sk = np.array([[0, -qv[2], qv[1]], [qv[2], 0, -qv[0]], [-qv[1], qv[0], 0]])
    vec = q4 * pv + p4 * qv - sk @ pv
    w = q4 * p4 - qv @ pv
    out = np.array([vec[0], vec[1], vec[2], w])
    out /= np.linalg.norm(out)
    if out[3] < 0:
        out = -out
    return out


def jpl_inv(q: np.ndarray) -> np.ndarray:
    return np.array([-q[0], -q[1], -q[2], q[3]])


def log_so3(rot: np.ndarray) -> np.ndarray:
    """SO(3) log map (Math.h log_so3)."""
    tr = np.clip((np.trace(rot) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-10:
        return 0.5 * np.array(
            [rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]]
        )
    return (
        theta
        / (2 * np.sin(theta))
        * np.array(
            [rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]]
        )
    )


def rot_z(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


# ------------------------------------------------------------- association
def associate_indices(
    est_times, gt_times, offset: float = 0.0, max_difference: float = 0.02
):
    """Greedy injective timestamp association returning index pairs
    (AlignUtils::perform_association, AlignUtils.cpp:93-186)."""
    ie, ig = [], []
    gt_ptr = 0
    n_gt = len(gt_times)
    for i in range(len(est_times)):
        target = est_times[i] + offset
        best_diff, best_idx = max_difference, -1
        while gt_ptr < n_gt and gt_times[gt_ptr] < target and abs(
            gt_times[gt_ptr] - target
        ) > max_difference:
            gt_ptr += 1
        while gt_ptr < n_gt and abs(gt_times[gt_ptr] - target) <= max_difference:
            d = abs(gt_times[gt_ptr] - target)
            if d >= best_diff:
                break
            best_diff, best_idx = d, gt_ptr
            gt_ptr += 1
        if best_idx != -1:
            ie.append(i)
            ig.append(best_idx)
    return np.asarray(ie, np.int64), np.asarray(ig, np.int64)


def associate(
    est_times, gt_times, est_poses, gt_poses,
    offset: float = 0.0, max_difference: float = 0.02,
    est_cov_ori=None, est_cov_pos=None, gt_cov_ori=None, gt_cov_pos=None,
):
    """Greedy injective timestamp association (AlignUtils.cpp:93-186).

    Gather wrapper over ``associate_indices``. Returns matched (times,
    est_poses, gt_poses, est_cov_ori, est_cov_pos, gt_cov_ori, gt_cov_pos);
    matched times are the GT timestamps, as the reference stores them.
    """
    ie, ig = associate_indices(est_times, gt_times, offset, max_difference)
    gt_times = np.asarray(gt_times)
    m_ecovo = m_ecovp = m_gcovo = m_gcovp = None
    if est_cov_ori is not None and len(ie):
        m_ecovo = np.asarray(est_cov_ori)[ie]
        m_ecovp = np.asarray(est_cov_pos)[ie]
        if gt_cov_ori is not None:
            m_gcovo = np.asarray(gt_cov_ori)[ig]
            m_gcovp = np.asarray(gt_cov_pos)[ig]
        else:
            m_gcovo = np.zeros((len(ie), 3, 3))
            m_gcovp = np.zeros((len(ie), 3, 3))
    return (
        gt_times[ig],
        np.asarray(est_poses)[ie].reshape(-1, 7),
        np.asarray(gt_poses)[ig].reshape(-1, 7),
        m_ecovo, m_ecovp, m_gcovo, m_gcovp,
    )


# --------------------------------------------------------------- alignment
def get_best_yaw(c: np.ndarray) -> float:
    """Closed-form yaw of the Frobenius-optimal z-rotation (AlignUtils.h:52-57)."""
    return float(np.arctan2(c[0, 1] - c[1, 0], c[0, 0] + c[1, 1]))


def align_umeyama(data, model, known_scale=False, yaw_only=False):
    """Umeyama closed form s, R, t minimizing ||model - (s R data + t)||²
    (AlignUtils.cpp:26-91). Returns (R, t, s)."""
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    model_z = model - mu_m
    data_z = data - mu_d
    n = model.shape[0]
    c = (model_z.T @ data_z) / n
    sigma2 = (data_z * data_z).sum() / n
    u, d_svd, vt = np.linalg.svd(c)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt.T) < 0:
        s_mat[2, 2] = -1
    if yaw_only:
        rot_c = n * c.T
        r = rot_z(get_best_yaw(rot_c))
    else:
        r = u @ s_mat @ vt
    s = 1.0 if known_scale else (np.diag(d_svd) @ s_mat).trace() / sigma2
    t = mu_m - s * r @ mu_d
    return r, t, s


def align_trajectory(est_poses, gt_poses, method: str = "se3", n_aligned: int = -1):
    """Alignment dispatch (AlignTrajectory.cpp:26-55). Returns (R, t, s)
    mapping est into the GT frame: p_aligned = s R p_est + t."""
    pos_est = est_poses[:, :3]
    pos_gt = gt_poses[:, :3]
    if method == "none":
        return np.eye(3), np.zeros(3), 1.0
    if method in ("posyawsingle", "se3single") or n_aligned == 1:
        q_es0, q_gt0 = est_poses[0, 3:7], gt_poses[0, 3:7]
        est_rot = jpl_quat_to_rot(q_es0).T  # R_ItoG
        g_rot = jpl_quat_to_rot(q_gt0).T
        if method.startswith("posyaw") or method == "posyaw":
            r = rot_z(get_best_yaw(est_rot @ g_rot.T))
        else:
            r = g_rot @ est_rot.T
        t = pos_gt[0] - r @ pos_est[0]
        return r, t, 1.0
    if method == "posyaw":
        r, t, s = align_umeyama(pos_est, pos_gt, known_scale=True, yaw_only=True)
        return r, t, 1.0
    if method == "se3":
        r, t, s = align_umeyama(pos_est, pos_gt, known_scale=True, yaw_only=False)
        return r, t, 1.0
    if method == "sim3":
        return align_umeyama(pos_est, pos_gt, known_scale=False, yaw_only=False)
    raise ValueError(
        f"invalid alignment '{method}' "
        "(posyaw, posyawsingle, se3, se3single, sim3, none)"
    )


def apply_alignment(poses: np.ndarray, r: np.ndarray, t: np.ndarray, s: float):
    """p' = s R p + t; q' = q ⊗ inv(q_R) (ResultTrajectory.cpp:57-67)."""
    out = poses.copy()
    out[:, :3] = (s * (r @ poses[:, :3].T)).T + t
    q_align_inv = jpl_inv(jpl_rot_to_quat(r))
    for i in range(poses.shape[0]):
        out[i, 3:7] = jpl_quat_multiply(poses[i, 3:7], q_align_inv)
    return out


def ate_rmse(est_times, est_poses, gt_times, gt_poses, method: str = "se3"):
    """(ori rmse deg, pos rmse m) after timestamp association (20 ms) and
    alignment of the estimate onto the GT (ResultTrajectory.cpp:28-96)."""
    ie, ig = associate_indices(est_times, gt_times, 0.0, 0.02)
    if len(ie) < 3:
        raise ValueError("not enough common timestamps between trajectories")
    est = np.asarray(est_poses, np.float64)[ie].reshape(-1, 7)
    gt = np.asarray(gt_poses, np.float64)[ig].reshape(-1, 7)
    r, t, s = align_trajectory(est, gt, method)
    est_al = apply_alignment(est, r, t, s)
    pos_err = np.linalg.norm(gt[:, :3] - est_al[:, :3], axis=1)
    ori_err = np.array([
        180.0 / np.pi * np.linalg.norm(
            log_so3(jpl_quat_to_rot(est_al[i, 3:7]).T @ jpl_quat_to_rot(gt[i, 3:7]))
        )
        for i in range(len(est))
    ])
    return float(np.sqrt(np.mean(ori_err**2))), float(np.sqrt(np.mean(pos_err**2)))

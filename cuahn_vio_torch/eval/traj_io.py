"""Trajectory / timing file I/O, byte-format-compatible with ov_eval.

A copy of ``cuahn_vio.eval.traj_io`` (numpy only): the pose txt, the
EuRoC ground-truth csv pair (``format-converter``), the timing csv and
the FRD odometry file.

Formats (the evaluation contract, SURVEY.md §5.5):
- pose txt (Loader::load_data, ov_eval/src/utils/Loader.cpp): lines
  ``t x y z qx qy qz qw [Pr11 Pr12 Pr13 Pr22 Pr23 Pr33 Pt11 ... Pt33]``,
  '#' comments. Quaternions are JPL xyzw.
- EuRoC csv (Loader::load_data_csv): ``t[ns],x,y,z,qw,qx,qy,qz,...``.
- timing csv (VioManager.cpp:98): ``# timestamp, loading image, state
  propagation, network inference, EKF update, total time``.
- odometry txt (RosVisualizer::visualize_odometry): ``t x y z vx vy vz
  roll pitch yaw`` in the FRD frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from cuahn_vio_torch.eval.align import jpl_quat_to_rot


class Trajectory(NamedTuple):
    times: np.ndarray  # (N,)
    poses: np.ndarray  # (N, 7) [x y z qx qy qz qw]
    cov_ori: Optional[np.ndarray]  # (N, 3, 3) or None
    cov_pos: Optional[np.ndarray]  # (N, 3, 3) or None


def load_pose_file(path: str) -> Trajectory:
    """Read a pose txt (Loader.cpp format). Covariance columns optional."""
    times, poses, covo, covp = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = np.array([float(x) for x in line.replace(",", " ").split()])
            if v.size < 8 or not np.all(np.isfinite(v[:8])):
                continue
            times.append(v[0])
            poses.append(v[1:8])
            if v.size >= 20:
                r11, r12, r13, r22, r23, r33 = v[8:14]
                t11, t12, t13, t22, t23, t33 = v[14:20]
                covo.append(
                    [[r11, r12, r13], [r12, r22, r23], [r13, r23, r33]]
                )
                covp.append(
                    [[t11, t12, t13], [t12, t22, t23], [t13, t23, t33]]
                )
    t = np.asarray(times)
    p = np.asarray(poses).reshape(-1, 7)
    co = np.asarray(covo) if covo and len(covo) == len(times) else None
    cp = np.asarray(covp) if covp and len(covp) == len(times) else None
    return Trajectory(t, p, co, cp)


def save_pose_file(
    path: str,
    times: np.ndarray,
    poses: np.ndarray,
    cov_ori: Optional[np.ndarray] = None,
    cov_pos: Optional[np.ndarray] = None,
    header: bool = True,
) -> None:
    """Write a pose txt in the Recorder format (Recorder.h:131-149)."""
    with open(path, "w") as f:
        if header:
            f.write(
                "# timestamp(s) tx ty tz qx qy qz qw Pr11 Pr12 Pr13 Pr22 Pr23 "
                "Pr33 Pt11 Pt12 Pt13 Pt22 Pt23 Pt33\n"
            )
        for i in range(len(times)):
            row = [f"{times[i]:.5f}"] + [f"{x:.6f}" for x in poses[i]]
            if cov_ori is not None and cov_pos is not None:
                o, p = cov_ori[i], cov_pos[i]
                row += [
                    f"{x:.8e}"
                    for x in (
                        o[0, 0], o[0, 1], o[0, 2], o[1, 1], o[1, 2], o[2, 2],
                        p[0, 0], p[0, 1], p[0, 2], p[1, 1], p[1, 2], p[2, 2],
                    )
                ]
            f.write(" ".join(row) + "\n")


def load_euroc_csv(path: str) -> Trajectory:
    """EuRoC groundtruth csv: t[ns], p(3), q wxyz, ... -> Trajectory
    (Loader::load_data_csv semantics; quaternion reordered to xyzw)."""
    times, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line[0].isalpha():
                continue
            v = [float(x) for x in line.split(",")]
            times.append(v[0] * 1e-9)
            x, y, z = v[1:4]
            qw, qx, qy, qz = v[4:8]
            poses.append([x, y, z, qx, qy, qz, qw])
    return Trajectory(np.asarray(times), np.asarray(poses), None, None)


def save_euroc_csv(path: str, traj: Trajectory) -> None:
    """Inverse of load_euroc_csv (format_converter.cpp counterpart)."""
    with open(path, "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for t, p in zip(traj.times, traj.poses):
            f.write(
                f"{int(round(t * 1e9))},"
                + ",".join(f"{x:.9f}" for x in p[:3])
                + f",{p[6]:.9f},{p[3]:.9f},{p[4]:.9f},{p[5]:.9f}\n"
            )


def load_timing_file(path: str):
    """Read the per-frame timing csv (VioManager.cpp:304-312).

    Returns (times (N,), stages (N, 5)): [load_img, prop, net, update, total].
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split(",")])
    arr = np.asarray(rows)
    return arr[:, 0], arr[:, 1:6]


def save_timing_file(path: str, times: np.ndarray, stages: np.ndarray) -> None:
    """Write the timing csv with the reference header (VioManager.cpp:98)."""
    with open(path, "w") as f:
        f.write(
            "# timestamp, loading image, state propagation, network inference,"
            " EKF update, total time\n"
        )
        for t, s in zip(times, stages):
            f.write(
                f"{t:.15f}," + ",".join(f"{x:.5f}" for x in s) + "\n"
            )


# FLU-world <-> FRD-body axis swap used by the controller-facing odometry
# (RosVisualizer.cpp:64)
_I0_R_W = np.array([[0.0, -1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])


def _rot2euler_frd(rot: np.ndarray):
    """Reference Euler extraction (RosVisualizer.cpp:303-315)."""
    sy = np.sqrt(rot[1, 2] ** 2 + rot[2, 2] ** 2)
    if sy < 1e-6:
        yaw = 0.0
        roll = np.arctan2(-rot[2, 1], rot[1, 1])
    else:
        yaw = np.arctan2(rot[0, 1], rot[0, 0])
        roll = np.arctan2(rot[1, 2], rot[2, 2])
    pitch = np.arctan2(-rot[0, 2], sy)
    return roll, pitch, yaw


def save_odom_file(
    path: str,
    times: np.ndarray,
    pose7: np.ndarray,
    v_body: np.ndarray,
) -> None:
    """Controller-facing odometry txt (RosVisualizer::visualize_odometry,
    RosVisualizer.cpp:98-148): FRD position, FRD linear velocity, and
    roll/pitch/yaw of b_R_w = i0_R_w^T R^T i0_R_w.

    Columns: t x y z vx vy vz roll pitch yaw (FRD frame, rad).
    """
    with open(path, "w") as f:
        f.write("# t x y z vx vy vz roll pitch yaw (FRD)\n")
        for i in range(len(times)):
            r_i2w = jpl_quat_to_rot(pose7[i, 3:7]).T  # body->world
            w_pos = pose7[i, :3]
            # (-y, -x, -z): world FLU -> FRD (RosVisualizer.cpp:133-137)
            px, py, pz = -w_pos[1], -w_pos[0], -w_pos[2]
            vx, vy, vz = -v_body[i][1], -v_body[i][0], -v_body[i][2]
            b_r_w = _I0_R_W.T @ r_i2w.T @ _I0_R_W
            roll, pitch, yaw = _rot2euler_frd(b_r_w)
            f.write(
                f"{times[i]:.9f} {px:.6f} {py:.6f} {pz:.6f} "
                f"{vx:.6f} {vy:.6f} {vz:.6f} "
                f"{roll:.6f} {pitch:.6f} {yaw:.6f}\n"
            )

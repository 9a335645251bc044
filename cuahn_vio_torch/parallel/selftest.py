"""Deterministic self-test workload of the parallel layer.

Counterpart of ``cuahn_vio.parallel.selftest``. The same fixed-seed work
runs under any process count and returns scalar checksums that agree (to
float32 tolerance) whether the mesh spans one process or N:

- the filter checksums: a batch of measurement-driven filter sequences
  (``pipeline.vio.run_sequence_with_measurements``), the batch sharded over
  the mesh's ranks, the sums of |p_world| and of the final |cov| reduced by
  ``psum_metrics``;
- the pose-graph checksums: the 40-keyframe ring with 2 loop factors and
  noisy initial poses, solved by the block-partitioned Schur GN
  (``pose_graph_sharded``), the blocks split over the ranks; the sum of
  |p| over every keyframe once, and the final cost.

The workload is that of a JAX mesh of ``n_mesh_devices`` devices (one
sequence and one block a device; the JAX tests' mesh has 8), so its
checksums are the JAX package's ``run_selftest(n_mesh_devices)``'s; here
the sequences and blocks are split evenly over the job's processes, a rank
holding several along a leading axis. Driven by

    python -m cuahn_vio_torch.cli distributed-selftest \\
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id I --device cpu

(one invocation per process, over gloo), or as one process with no
``--coordinator`` (the one card of an H100 machine: NCCL puts one rank
on a GPU).
"""

from __future__ import annotations

import time

import numpy as np
import torch

DEFAULT_MESH_DEVICES = 8  # the JAX tests' mesh (xla_force_host_platform_device_count=8)
T_ITOC = np.eye(4)
T_ITOC[:3, 3] = [0.006, -0.014, -0.012]


def _filter_batch(rng, b: int, frames: int, steps: int):
    """The JAX workload's numpy arrays: states, measurements, windows."""
    z = rng.normal(size=(b, frames, 8)).astype(np.float32) * 0.5
    r = np.tile(np.eye(8, dtype=np.float32) * 4.0, (b, frames, 1, 1))
    valid = np.ones((b, frames), bool)
    w = rng.normal(size=(b, frames, steps, 3)).astype(np.float32) * 0.1
    a = (rng.normal(size=(b, frames, steps, 3)) * 0.1 + [0, 0, 9.81]).astype(np.float32)
    dts = np.full((b, frames, steps), 0.002, np.float32)
    return z, r, valid, w, a, dts


def _states0(b: int, device):
    from cuahn_vio_torch.filter.state import FilterState

    def stack(x):
        return torch.as_tensor(np.tile(np.asarray(x, np.float32), (b,) + (1,) * np.ndim(x)),
                               device=device)

    return FilterState(
        p=stack([0.0, 0.0, 1.5]), q=stack([1.0, 0.0, 0.0, 0.0]),
        v=stack([0.0, 0.0, 0.0]), ba=stack([0.0, 0.0, 0.0]), bg=stack([0.0, 0.0, 0.0]),
        off=stack(np.zeros((4, 3))), cov=stack(np.eye(27, dtype=np.float32) * 1e-4),
    )


def _run_filter_shard(mesh, t_itoc, b: int, arrays):
    """This rank's shard of the batch through the filter: (final state,
    outputs)."""
    from cuahn_vio_torch.filter.state import make_params
    from cuahn_vio_torch.parallel.mesh import shard_batch
    from cuahn_vio_torch.pipeline.vio import VioConfig, run_sequence_with_measurements

    fparams = make_params(t_itoc, device=mesh.local)
    states0 = shard_batch(_states0(b, "cpu"), mesh)
    z, r, valid, w, a, dts = shard_batch(tuple(torch.as_tensor(x) for x in arrays), mesh)
    return run_sequence_with_measurements(states0, fparams, VioConfig(update_gate_frames=0),
                                          z, r, valid, w, a, dts)


def _filter_checksums(mesh, b: int) -> dict:
    from cuahn_vio_torch.parallel.mesh import psum_metrics

    arrays = _filter_batch(np.random.default_rng(0), b, frames=6, steps=5)
    final, outs = _run_filter_shard(mesh, T_ITOC, b, arrays)
    pos, cov = psum_metrics((outs.p_world.abs().flatten(1).sum(1),
                             final.cov.abs().flatten(1).sum(1)), mesh)
    return {"filter_pos_checksum": float(pos), "filter_cov_checksum": float(cov)}


def ring_graph(rng, device, n: int = 40):
    """The self-test's pose graph: a ring of n keyframes with loop factors
    (0, n-1) and (3, n/2), exact measurements, noisy initial poses (the
    JAX workload's draws)."""
    from cuahn_vio_torch.ops.quat import quat_exp, quat_mul, quat_normalize
    from cuahn_vio_torch.parallel.pose_graph import chain_graph_from_trajectory, relative_pose

    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    p = torch.as_tensor(np.stack([np.cos(th), np.sin(th), 0.1 * np.sin(2 * th)], 1),
                        dtype=torch.float32, device=device)
    q = quat_exp(torch.tensor([0.0, 0.0, 1.0], device=device)
                 * torch.as_tensor(th, dtype=torch.float32, device=device)[:, None])
    pairs = [(0, n - 1), (3, n // 2)]
    a, b = (torch.tensor(k, device=device) for k in zip(*pairs))
    edp, edq = relative_pose(p[a], q[a], p[b], q[b])
    graph = chain_graph_from_trajectory(p, q, sigma_dp=0.01, sigma_dth=0.005,
                                        extra_pairs=pairs, extra_dp=edp, extra_dq=edq)
    noise_p = torch.as_tensor(np.asarray(rng.normal(size=(n, 3)) * 0.15, np.float32),
                              device=device)
    noise_p[0] = 0.0
    dq_n = quat_exp(torch.as_tensor(np.asarray(rng.normal(size=(n, 3)) * 0.04, np.float32),
                                    device=device))
    dq_n[0] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    return graph._replace(p=p + noise_p, q=quat_normalize(quat_mul(q, dq_n)))


def _pose_graph_checksums(mesh, n_blocks: int) -> dict:
    from cuahn_vio_torch.parallel.mesh import all_reduce_sum
    from cuahn_vio_torch.parallel.pose_graph_sharded import optimize_sharded, partition_graph

    graph = ring_graph(np.random.default_rng(1), mesh.local)
    sg = partition_graph(graph, n_blocks)
    p_int, _, p_sep, _, costs = optimize_sharded(sg, mesh, iters=10)
    # the interiors' sum over every rank's blocks, by the collective
    ck = float(all_reduce_sum(p_int.abs().sum(), mesh)) + float(p_sep.abs().sum())
    return {"pose_checksum": ck, "pose_final_cost": float(costs[-1])}


def _workload_size(mesh, n_mesh_devices) -> int:
    n = DEFAULT_MESH_DEVICES if n_mesh_devices is None else int(n_mesh_devices)
    if n % mesh.size:
        raise ValueError(f"a workload of {n} mesh devices does not split over "
                         f"{mesh.size} processes")
    return n


def run_selftest(n_mesh_devices=None, device="cuda") -> dict:
    """Both workloads on the job's mesh (call after ``init_distributed``,
    or as one process); returns the checksums."""
    from cuahn_vio_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device)
    n = _workload_size(mesh, n_mesh_devices)
    out = {"n_processes": mesh.size, "process_id": mesh.rank, "n_devices": n,
           "device": str(mesh.local)}
    out.update(_filter_checksums(mesh, n))
    out.update(_pose_graph_checksums(mesh, n))
    return out


def timed_filter_bench(mesh, b: int, frames: int = 400, steps: int = 16,
                       reps: int = 5) -> dict:
    """Throughput of the filter batch (the JAX package's scaling recipe):
    b sequences of ``frames`` frames of ``steps`` IMU steps, this rank's
    shard run after a warm-up run, each repeat closed by a replicated
    metric (the sum of |p_world| over every rank's sequences, an
    all_reduce) and a synchronize; the median of ``reps`` repeats."""
    from cuahn_vio_torch.parallel.mesh import psum_metrics

    arrays = _filter_batch(np.random.default_rng(7), b, frames, steps)
    t_itoc = np.eye(4)

    def workload():
        _, outs = _run_filter_shard(mesh, t_itoc, b, arrays)
        metric = psum_metrics(outs.p_world.abs().flatten(1).sum(1), mesh)
        if mesh.local.type == "cuda":
            torch.cuda.synchronize(mesh.local)
        return metric

    workload()  # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = workload()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {
        "bench_seconds": dt,
        "bench_seconds_all": times,
        "bench_frames": b * frames,
        "bench_frames_per_s": b * frames / dt,
        "bench_frames_per_s_per_device": b * frames / dt / mesh.size,
        "bench_metric_checksum": float(out),
    }


def run_selftest_bench(n_mesh_devices=None, device="cuda", **bench) -> dict:
    """``timed_filter_bench`` on the job's mesh, with the workload of
    ``run_selftest``'s size; ``bench`` overrides its frames, steps and
    repeats."""
    from cuahn_vio_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device)
    n = _workload_size(mesh, n_mesh_devices)
    out = {"n_processes": mesh.size, "n_devices": n, "device": str(mesh.local)}
    out.update(timed_filter_bench(mesh, n, **bench))
    return out

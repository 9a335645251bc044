"""The port's parallel layer (``cuahn_vio_torch.parallel``: ``mesh``,
``sharded_eval``, ``pose_graph_sharded``) against the JAX package's on the
CPU (the conftest's 8 fake CPU devices make the JAX mesh).

- ``partition_graph``: the JAX module's separators, interiors, padding and
  per-block factors, exactly, at 1, 2, 4 and 8 blocks, with and without
  loop factors.
- ``optimize_sharded`` (8 blocks on one process) against the JAX one on the
  8-device mesh: positions within 1e-5 m, quaternions within 1e-5 (measured
  ~6e-7 and ~1e-7); against the port's dense ``optimize``: within 2e-3 m
  (the JAX test's tolerance; measured ~2e-6), the final cost at most 1e-3
  of the first; every block count gives the same poses within 1e-5 m.
  Two runs give the same bits.
- ``aggregate_rmse`` on a one-process mesh: the RMSE of all errors
  (1e-6 relative), and the JAX collective's value.
- ``batched_run_sequences`` / ``run_offline_batch`` with a one-device mesh:
  the outputs of ``mesh=None``, bit for bit; a mesh that does not split the
  batch is refused; ``shard_batch`` of a two-rank mesh takes a rank's half.
- ``smooth-trajectory --mesh`` against the JAX verb (its 8 blocks against
  the port's one-process mesh): pose files within 1e-4 m (printed to 1e-6),
  and refusing ``--mesh --huber``.
- ``init_distributed`` is a no-op in a plain process and raises where
  distributed environment variables are set but the rendezvous fails.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio.parallel import aggregate_rmse as jaggregate_rmse
from cuahn_vio.parallel import make_mesh as jmake_mesh
from cuahn_vio.parallel import pose_graph_sharded as jpgs
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
from cuahn_vio_torch.eval.traj_io import load_pose_file, save_pose_file
from cuahn_vio_torch.parallel import mesh as tmesh
from cuahn_vio_torch.parallel import pose_graph_sharded as tpgs
from cuahn_vio_torch.parallel.pose_graph import PoseGraph, optimize
from cuahn_vio_torch.parallel.sharded_eval import aggregate_rmse
from cuahn_vio_torch.pipeline.runner import run_offline_batch
from cuahn_vio_torch.pipeline.vio import VioConfig
from cuahn_vio_torch.utils.config import VioOptions
from tests.test_pose_graph_sharded import _noisy_graph

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

JAX_POS_TOL_M = 1e-5
JAX_Q_TOL = 1e-5
DENSE_TOL_M = 2e-3
FILE_TOL_M = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.fail("the conftest's 8 fake CPU devices are missing")
    return jmake_mesh((8,), ("seq",))


def _graphs(loops: bool, seed: int = 0):
    graph, p_true = _noisy_graph(np.random.default_rng(seed), n=40, loops=loops)
    return graph, PoseGraph(*(torch.tensor(np.asarray(x)) for x in graph)), np.asarray(p_true)


@pytest.mark.parametrize("loops", [False, True])
@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_partition_graph_is_the_jax_partition(n_blocks, loops):
    jg, tg, _ = _graphs(loops)
    js, ts = jpgs.partition_graph(jg, n_blocks), tpgs.partition_graph(tg, n_blocks)
    for name in js._fields:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name)
        got = got if isinstance(got, np.ndarray) else got.numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


@pytest.mark.parametrize("loops", [False, True])
def test_optimize_sharded_follows_jax_and_the_dense_solve(jax_mesh, loops):
    jg, tg, p_true = _graphs(loops)
    js = jpgs.partition_graph(jg, 8)
    jp, jq = jpgs.reassemble(js, *jpgs.optimize_sharded(js, jax_mesh, iters=12)[:4])
    ts = tpgs.partition_graph(tg, 8)
    *blocks, costs = tpgs.optimize_sharded(ts, iters=12)
    tp, tq = tpgs.reassemble(ts, *blocks)
    np.testing.assert_allclose(tp, jp, atol=JAX_POS_TOL_M, rtol=0)
    np.testing.assert_allclose(tq, jq, atol=JAX_Q_TOL, rtol=0)
    p_dense, _, _ = optimize(tg, iters=12)
    np.testing.assert_allclose(tp, p_dense.numpy(), atol=DENSE_TOL_M, rtol=0)
    np.testing.assert_allclose(tp, p_true, atol=1e-2, rtol=0)
    assert float(costs[-1]) <= 1e-3 * float(costs[0])
    again = tpgs.reassemble(ts, *tpgs.optimize_sharded(ts, iters=12)[:4])
    assert np.array_equal(again[0], tp) and np.array_equal(again[1], tq)


def test_every_block_count_gives_the_same_poses():
    _, tg, _ = _graphs(True, seed=2)
    ref = None
    for n_blocks in (1, 2, 3, 4, 8):
        sg = tpgs.partition_graph(tg, n_blocks)
        p, _ = tpgs.reassemble(sg, *tpgs.optimize_sharded(sg, tmesh.make_mesh(CPU),
                                                          iters=10)[:4])
        if ref is None:
            ref = p
        np.testing.assert_allclose(p, ref, atol=JAX_POS_TOL_M, rtol=0, err_msg=str(n_blocks))


def test_aggregate_rmse(jax_mesh):
    err = np.random.default_rng(4).normal(size=(8, 16)).astype(np.float32)
    got = float(aggregate_rmse(torch.as_tensor(err), tmesh.make_mesh(CPU)))
    np.testing.assert_allclose(got, np.sqrt(np.mean(err.astype(np.float64) ** 2)), rtol=1e-6)
    np.testing.assert_allclose(got, float(jaggregate_rmse(jnp.asarray(err), jax_mesh)),
                               rtol=1e-6)


def test_mesh_places_shards_and_sums_metrics():
    two = tmesh.Mesh(devices=(CPU, CPU), rank=1)
    x = torch.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(tmesh.shard_batch(x, two).numpy(), x[2:].numpy())
    one = tmesh.make_mesh(CPU)
    assert one.size == 1 and one.local == CPU
    state = tmesh.shard_batch((x, None), one)
    assert state[1] is None and torch.equal(state[0], x)
    np.testing.assert_array_equal(tmesh.psum_metrics(x, one).numpy(), x.sum(0).numpy())
    placed = tmesh.replicate((x, None), two)
    assert placed[1] is None and torch.equal(placed[0], x)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(torch.zeros(3), two)


@pytest.fixture(scope="module")
def sequences():
    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    out = []
    for duration, seed in ((0.5, 1), (0.3, 2)):
        s = make_sequence(AnalyticTrajectory(), t_ic, duration=duration, seed=seed,
                          sigma_w=0.002, sigma_a=0.02, texture_seed=seed, device="cpu")
        out.append((s.imu_t, s.imu_w, s.imu_a, s.cam_t, s.frames))
    return out


def test_batched_run_with_a_one_device_mesh_is_bit_equal(sequences):
    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    opts.init_height, opts.calib_camimu_dt, opts.init_imu_thresh = 1.5, 0.0, 0.2
    runs = [run_offline_batch(sequences, None, opts.filter_params("cpu"), VioConfig(),
                              opts.runner_options(), device="cpu", mesh=mesh)
            for mesh in (None, tmesh.make_mesh(CPU))]
    assert len(runs[0]) == len(runs[1]) == 2
    for plain, meshed in zip(*runs):
        for name in ("pose_w", "cov_core", "times"):
            assert np.array_equal(getattr(plain, name), getattr(meshed, name)), name


@pytest.fixture(scope="module")
def est_file(tmp_path_factory):
    jg, _, _ = _graphs(True, seed=5)
    p, q = np.asarray(jg.p), np.asarray(jg.q)
    path = tmp_path_factory.mktemp("smooth") / "est.txt"
    save_pose_file(str(path), 10.0 + 0.1 * np.arange(len(p)), np.concatenate(
        [p, q[:, [1, 2, 3, 0]]], 1))
    return path


def _said(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_smooth_trajectory_mesh_follows_the_jax_verb(est_file, tmp_path):
    d = est_file.parent
    args = [str(est_file), "--loops", "0:39,3:20", "--mesh"]
    jsaid = _said(jcli.main, ["smooth-trajectory", *args, "--out", str(d / "j.txt")])
    tsaid = _said(tcli.main, ["smooth-trajectory", *args, "--out", str(d / "t.txt"),
                              "--device", "cpu"])
    assert "sharded GN over 8 devices" in jsaid and "sharded GN over 1 devices" in tsaid
    plain = _said(tcli.main, ["smooth-trajectory", *args[:-1], "--out", str(d / "p.txt"),
                              "--device", "cpu"])
    assert tsaid.splitlines()[-1] == jsaid.splitlines()[-1].replace("j.txt", "t.txt")
    assert "cost" in plain
    jt, tt, pt = (load_pose_file(str(d / f"{n}.txt")) for n in ("j", "t", "p"))
    np.testing.assert_array_equal(tt.times, jt.times)
    np.testing.assert_allclose(tt.poses[:, :3], jt.poses[:, :3], atol=FILE_TOL_M, rtol=0)
    np.testing.assert_allclose(tt.poses[:, 3:], jt.poses[:, 3:], atol=FILE_TOL_M, rtol=0)
    np.testing.assert_allclose(tt.poses[:, :3], pt.poses[:, :3], atol=DENSE_TOL_M, rtol=0)


def test_smooth_trajectory_refuses_mesh_with_huber(est_file):
    with pytest.raises(SystemExit, match="--mesh .*--huber"):
        tcli.main(["smooth-trajectory", str(est_file), "--mesh", "--huber", "3",
                   "--device", "cpu"])


def test_init_distributed_is_a_no_op_alone_and_strict_in_a_job(monkeypatch):
    for var in tmesh.DIST_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    tmesh.init_distributed(device="cpu")
    assert tmesh.world() == (1, 0)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")  # a half-configured job
    with pytest.raises(RuntimeError, match="refusing to run as a single process"):
        tmesh.init_distributed(device="cpu", timeout_s=5.0)
    assert tmesh.world() == (1, 0)

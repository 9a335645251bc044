"""The port's pose-pair bank (``cuahn_vio_torch.data.trajpairs``) against the
JAX package's, and the trainer's use of it, on the CPU.

The JAX bank caches itself in ``/tmp`` under a name made of its three
float parameters only (``cuahn_vio/data/trajpairs.py:55``), not of the GT
directory: a bank built from another directory would be read back, and a
bank of this test's directory would be read back by every JAX trainer on
the machine. So the JAX call runs with its module's ``os`` and ``np``
seen through stand-ins under which the cache file does not exist and is
never written: the test neither reads, writes nor deletes it. Tolerance:
the same pairs, poses within 2e-6 (two float32 splines,
``tests/test_torch_bspline.py``).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.data import trajpairs as jpairs
from cuahn_vio.data.synthetic import AnalyticTrajectory as JAnalytic
from cuahn_vio_torch.data import trajpairs as tpairs
from cuahn_vio_torch.models.uahn import UAHN
from cuahn_vio_torch.train import trainer as ttrain
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.config import VioOptions

JAX_CACHE = (f"/tmp/cuahn_trajpairs_{0.1}_{jpairs.Z_OFFSET}_{jpairs.FRAME_DT}.npz")


def _gt_file(path, seconds: float, phase: float):
    """An analytic flight (JAX closed forms, shifted by ``phase`` s) written
    as a UZH-FPV GT txt at 100 Hz."""
    traj = JAnalytic()
    t = np.arange(0.0, seconds, 0.01)
    tm = jnp.asarray(t + phase, jnp.float32)
    p, q = np.array(jax.vmap(traj.pos_w)(tm)), np.asarray(jax.vmap(traj.quat_i2w)(tm))
    p[:, 2] -= 1.0  # mocap frame: the offset of 1.7 puts it at 2.2 m
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ti, pi, qi in zip(t, p, q):
            f.write(f"{100.0 + ti:.6f} " + " ".join(f"{x:.7f}" for x in (*pi, *qi[1:], qi[0]))
                    + "\n")


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("uzh_fpv")
    _gt_file(str(d / "outdoor_forward_1_snapdragon_with_gt.txt"), 2.5, 0.0)
    _gt_file(str(d / "indoor_forward_3_snapdragon_with_gt.txt"), 2.0, 1.3)
    _gt_file(str(d / "indoor_45_2_snapdragon_with_gt.txt"), 2.0, 0.0)  # held out
    return str(d)


def _jax_bank_without_cache(gt_dir, monkeypatch):
    """The JAX bank of ``gt_dir``, built with its ``/tmp`` cache out of
    reach: every cache path it asks for is missing, and its writes of it
    are recorded instead of made."""
    cache_paths = (JAX_CACHE, JAX_CACHE + ".tmp.npz")
    writes = []

    def exists(path):
        assert path in cache_paths, path
        return False

    def savez_compressed(path, **_):
        assert path in cache_paths, path
        writes.append(path)

    def replace(src, dst):
        assert src in cache_paths and dst in cache_paths, (src, dst)
        writes.append(dst)

    path_mod = types.SimpleNamespace(exists=exists, join=os.path.join,
                                     basename=os.path.basename)
    np_mod = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                      if not k.startswith("__")})
    np_mod.savez_compressed = savez_compressed
    monkeypatch.setattr(jpairs, "os", types.SimpleNamespace(path=path_mod, replace=replace))
    monkeypatch.setattr(jpairs, "np", np_mod)
    bank = jpairs.build_pose_pair_bank(gt_dir)
    assert writes == [JAX_CACHE + ".tmp.npz", JAX_CACHE]  # held back, not made
    return bank


def test_bank_matches_jax(gt_dir, monkeypatch):
    names = [os.path.basename(f) for f in tpairs.train_trajectory_files(gt_dir)]
    assert names == ["indoor_forward_3_snapdragon_with_gt.txt",
                     "outdoor_forward_1_snapdragon_with_gt.txt"]
    want = _jax_bank_without_cache(gt_dir, monkeypatch)
    got = tpairs.build_pose_pair_bank(gt_dir)
    assert sorted(got) == ["p1", "p2", "q1", "q2"]
    for k in ("p1", "q1", "p2", "q2"):
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=2e-6)
    assert got["p1"].shape[0] > 50


def test_bank_refuses_a_directory_without_trajectories(tmp_path):
    with pytest.raises(ValueError, match="no training trajectory"):
        tpairs.build_pose_pair_bank(str(tmp_path))


def _bank_tensors(gt_dir):
    bank = tpairs.build_pose_pair_bank(gt_dir)
    return bank, tuple(torch.as_tensor(bank[k]) for k in ("p1", "q1", "p2", "q2"))


def test_draw_pairs_takes_its_share_from_the_bank(gt_dir):
    """About ``traj_pair_prob`` of the pairs are the bank's, each turned by
    a world yaw: its height and its relative motion are the bank pair's,
    and the blur motion (dp, rv_d) follows the two poses."""
    from cuahn_vio_torch.ops.quat import quat_conj, quat_log, quat_mul

    bank, pairs = _bank_tensors(gt_dir)
    cfg = ttrain.TrainConfig(traj_pair_prob=0.7)
    d = ttrain.draw_pairs(cfg, prng.split(prng.prng_key(3), 4000), "cpu", None, pairs)
    share = d.from_bank.float().mean().item()
    assert abs(share - 0.7) < 0.03
    sel = d.from_bank
    assert np.isin(d.p1[sel, 2].numpy(), bank["p1"][:, 2]).all()  # a yaw keeps heights
    assert (d.p1[~sel, 2] <= cfg.height_range[1]).all()
    np.testing.assert_allclose(d.dp.numpy(), (d.p2 - d.p1).numpy(), atol=1e-6)
    rel = quat_log(quat_mul(quat_conj(d.q1), d.q2))
    np.testing.assert_allclose(d.rv_d.numpy(), rel.numpy(), atol=1e-6)
    # frame-to-frame motion of a bank pair is the bank's, turned
    dist = torch.linalg.norm(d.p2[sel] - d.p1[sel], dim=1).numpy()
    bank_dist = np.linalg.norm(bank["p2"] - bank["p1"], axis=1)
    assert dist.max() <= bank_dist.max() + 1e-5


def test_train_uses_the_bank_when_gt_files_are_there(gt_dir):
    """``train`` no longer refuses when GT files are present: it builds the
    bank, says so, and trains from its pairs (two steps: the first applies
    the schedule's lr of 0, as optax does)."""
    t = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64)
    c_rot_i = torch.as_tensor(t[:3, :3].astype(np.float32))
    i_t_i2c = torch.as_tensor((-t[:3, :3].T @ t[:3, 3]).astype(np.float32))
    log = []
    model = UAHN(img_height=56, img_width=80)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ttrain.train(model, c_rot_i, i_t_i2c,
                 ttrain.TrainConfig(batch_size=2, blur_taps=2, use_textures=False),
                 steps=2, seed=1, log_every=1, height=56, width=80, probe_every=0,
                 log_fn=lambda m, **_: log.append(m), gt_dir=gt_dir)
    n = tpairs.build_pose_pair_bank(gt_dir)["p1"].shape[0]
    assert f"trajectory pose-pair bank: {n} pairs (70% of samples)" in log
    assert any(m.startswith("step") for m in log)
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())

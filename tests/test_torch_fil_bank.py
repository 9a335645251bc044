"""The port's FIL window bank (``cuahn_vio_torch.train.fil.build_window_bank``)
against ``cuahn_vio.train.fil.build_window_bank`` on the CPU.

The GT directory is a temporary one: a ``make-synthetic`` pose file and
the loop-closure demo's double loop, written as ``*_with_gt.txt``, and a
benchmark replay's name that both packages skip (no test reads the
reference checkout). The JAX bank function reads it through a monkeypatched
``cuahn_vio.data.trajpairs.train_trajectory_files``.

Tolerances: the same windows; positions, quaternions, gyro, velocity and
blur-tap poses within 1e-5 absolute (measured <= 1.2e-6, 6e-8, 1.7e-7,
7.6e-6); the specific force within 5e-4 (measured 1.2e-4: the second
derivative of a float32 spline, ``tests/test_torch_bspline.py``'s bound).
"""

import os

import numpy as np
import pytest
import torch

from cuahn_vio.data import trajpairs as jtrajpairs
from cuahn_vio.train import fil as jfil
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.train import fil as tfil

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

BANK_TOL = 1e-5
FORCE_TOL = 5e-4
# tests/test_fil.py's tiny config
CFG = dict(window=2, batch_size=2, imu_substeps=4, blur_taps=1, exposure_s=0.0,
           img_hw=(64, 64))


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    """A GT directory of two training trajectories (and one benchmark
    replay's name, which both packages skip)."""
    import chip_smoke

    d = tmp_path_factory.mktemp("gt")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        tcli.main(["make-synthetic", "--device", "cpu", "--out", "a.npz", "--duration", "3",
                   "--seed", "4"])
    finally:
        os.chdir(cwd)
    os.replace(d / "a_gt.txt", d / "hover_with_gt.txt")
    chip_smoke.write_loop_trajectory(str(d / "loop_with_gt.txt"))
    chip_smoke.write_loop_trajectory(str(d / "indoor_45_2_snapdragon_with_gt.txt"))
    return str(d)


def _jax_bank(monkeypatch, gt_dir, n, cfg, seed):
    files = jtrajpairs.train_trajectory_files(gt_dir)
    monkeypatch.setattr(jtrajpairs, "train_trajectory_files", lambda *a, **k: files)
    return jfil.build_window_bank(n_windows=n, cfg=cfg, seed=seed)


@pytest.mark.parametrize("cfg", [CFG, dict(window=6, blur_taps=3)], ids=["tiny", "default"])
def test_window_bank_matches_jax(gt_dir, monkeypatch, cfg):
    want = _jax_bank(monkeypatch, gt_dir, 10, jfil.FilConfig(**cfg), seed=3)
    got = tfil.build_window_bank(10, tfil.FilConfig(**cfg), seed=3, gt_dir=gt_dir)
    assert len(tfil.WindowBank._fields) == len(jfil.WindowBank._fields)
    for name in jfil.WindowBank._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == np.float32, name
        tol = FORCE_TOL if name == "a_true" else BANK_TOL
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)
    assert got.tap_p.shape[:3] == (10, cfg["window"] + 1, cfg["blur_taps"])


def test_window_bank_refuses_an_empty_gt_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="_with_gt.txt"):
        tfil.build_window_bank(4, tfil.FilConfig(**CFG), gt_dir=str(tmp_path))



"""The port's numpy-only eval verbs against the JAX CLI's, on the CPU.

``error-dataset``, ``error-comparison``, ``timing-comparison`` and
``align-trajectory`` on the same files (a GT pose file of a 12 s
figure-eight, estimates of it with drift, noise and a rigid offset, one
estimate that overlaps no GT time, and two timing csvs): stdout equal,
character for character, and the written file (``align-trajectory
--out``) equal byte for byte, for every alignment method. The verbs import
neither torch nor JAX (run in a fresh interpreter with both blocked).
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from cuahn_vio import cli as jcli
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.eval.align import jpl_rot_to_quat
from cuahn_vio_torch.eval.traj_io import save_pose_file, save_timing_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _poses(t, rng=None, drift=0.0, noise=0.0, yaw0=0.0, shift=(0.0, 0.0, 0.0)):
    """[x y z qx qy qz qw] of a figure-eight at times t, optionally with a
    linear drift, position noise and a rigid yaw/shift of the whole path."""
    p = np.stack([np.sin(0.5 * t), np.sin(t) * 0.5, 1.5 + 0.1 * np.cos(0.3 * t)], 1)
    p = p + drift * t[:, None] * np.array([1.0, -0.5, 0.2])
    if noise:
        p = p + rng.normal(0, noise, p.shape)
    p = p @ _rot_z(yaw0).T + np.asarray(shift)
    q = np.stack([jpl_rot_to_quat(_rot_z(0.3 * np.sin(0.4 * ti) + yaw0).T) for ti in t])
    return np.concatenate([p, q], 1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("evalverbs")
    rng = np.random.default_rng(0)
    t_gt = np.arange(0.0, 12.0, 0.01)
    t_est = np.arange(0.5, 11.5, 0.05)
    gt_dir, runs = d / "gt", d / "runs"
    for sub in (gt_dir, runs, d / "algos" / "a1", d / "algos" / "a2"):
        sub.mkdir(parents=True)
    for name in ("flight_a", "flight_b"):
        save_pose_file(str(gt_dir / f"{name}.txt"), t_gt, _poses(t_gt))
    estimates = {
        "drift": _poses(t_est, rng, drift=0.01, noise=0.01, yaw0=0.4, shift=(1, 2, 0)),
        "noisy": _poses(t_est, rng, noise=0.03, yaw0=-1.0, shift=(0, -1, 0.5)),
        "late": _poses(t_est + 20.0),  # no GT time overlaps it
    }
    for name, poses in estimates.items():
        times = t_est + (20.0 if name == "late" else 0.0)
        save_pose_file(str(runs / f"{name}.txt"), times, poses)
    save_pose_file(str(d / "algos" / "a1" / "flight_a.txt"), t_est, estimates["drift"])
    save_pose_file(str(d / "algos" / "a1" / "flight_b.txt"), t_est, estimates["noisy"])
    save_pose_file(str(d / "algos" / "a2" / "flight_a.txt"), t_est + 20.0, estimates["late"])
    for k in range(2):
        stages = np.abs(rng.normal([2.5, 80.0, 6.0, 3.0, 0.0], 1.0, (40, 5)))
        stages[:, 4] = stages[:, :4].sum(1)
        save_timing_file(str(d / f"timing{k}.csv"), 100.0 + 0.03 * np.arange(40), stages)
    return d


def _stdout(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _cases(d):
    gt = str(d / "gt" / "flight_a.txt")
    est = str(d / "runs" / "drift.txt")
    cases = {}
    for align in ("posyaw", "se3", "sim3", "none"):
        cases[f"error-dataset {align}"] = (["error-dataset", align, gt, str(d / "runs")], None)
        cases[f"error-comparison {align}"] = (
            ["error-comparison", align, str(d / "gt"), str(d / "algos")], None)
        cases[f"align-trajectory {align}"] = (
            ["align-trajectory", gt, est, "--method", align, "--out", "{out}"], "{out}")
    cases["timing-comparison"] = (
        ["timing-comparison", str(d / "timing0.csv"), str(d / "timing1.csv")], None)
    return cases


VERBS = ["error-dataset", "error-comparison", "align-trajectory", "timing-comparison"]


@pytest.mark.parametrize("verb", VERBS)
def test_verb_prints_and_writes_what_the_jax_verb_does(files, tmp_path, verb):
    cases = {k: v for k, v in _cases(files).items() if k.split()[0] == verb}
    assert cases
    for name, (argv, out) in cases.items():
        said = {}
        for package, main in (("jax", jcli.main), ("port", tcli.main)):
            path = str(tmp_path / f"{package}_{name.replace(' ', '_')}.txt")
            said[package] = _stdout(main, [a.replace("{out}", path) for a in argv])
            if out:
                with open(path, "rb") as f:
                    said[package + " file"] = f.read()
            said[package] = said[package].replace(path, "OUT")
        assert said["port"] == said["jax"], name
        if out:
            assert said["port file"] == said["jax file"], name
        assert "FAILED" in said["port"] or verb != "error-dataset"  # the late run fails


BLOCKED = r'''
import importlib.abc
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "cuahn_vio"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
from cuahn_vio_torch.cli import main

D = sys.argv[1]
main(["error-dataset", "se3", D + "/gt/flight_a.txt", D + "/runs"])
main(["error-comparison", "se3", D + "/gt", D + "/algos"])
main(["timing-comparison", D + "/timing0.csv", D + "/timing1.csv"])
main(["align-trajectory", D + "/gt/flight_a.txt", D + "/runs/drift.txt", "--out",
      D + "/aligned.txt"])
print("numpy only")
'''


def test_verbs_import_neither_torch_nor_jax(files):
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(files)],
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("numpy only")

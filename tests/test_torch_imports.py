"""The port imports neither JAX, flax, optax, msgpack, PyYAML, PIL nor the
JAX package.

In a fresh interpreter where a ``sys.meta_path`` finder makes ``jax``,
``flax``, ``optax``, ``msgpack``, ``yaml``, ``PIL`` and ``cuahn_vio`` (and
their submodules) unimportable,
every module of ``cuahn_vio_torch`` and the port's scripts
(``chip_smoke.py``, ``tune_warp.py``, ``profile_slice.py``,
``smoke_reference.py``) must import, the raw-camera verbs
(``distort-to-euroc``, ``convert-euroc``, ``format-converter``) must run
on the CPU, and so must ``smooth-trajectory`` and ``train-fil``'s refusal
without GT files.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED = r'''
import importlib
import importlib.abc
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "PIL", "cuahn_vio")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())

import cuahn_vio_torch

names = ["cuahn_vio_torch"] + [
    m.name for m in pkgutil.walk_packages(cuahn_vio_torch.__path__, "cuahn_vio_torch.")
]
for name in names + ["chip_smoke", "profile_slice", "smoke_reference", "tune_warp"]:
    importlib.import_module(name)
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
'''


def test_port_imports_without_jax_flax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", GUARDED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every module was walked, the raw-camera slice's too (vision.camera,
    # runtime.undistort, ops.remap, ops.cuda.remap, utils.png, data.euroc,
    # data.gt_loader, data.bspline and their packages) and the loop-closure
    # and FIL slice's (parallel.pose_graph, pipeline.loop_closure, train.fil)
    assert int(proc.stdout.split()[-1]) >= 56


def test_the_guard_blocks_what_it_names():
    """The finder really refuses the JAX package (so the test above can
    fail)."""
    probe = GUARDED.replace(
        'for name in names + ["chip_smoke", "profile_slice", "smoke_reference", "tune_warp"]:',
        'import cuahn_vio.ops.quat\nfor name in []:',
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "blocked import of cuahn_vio" in proc.stderr


def test_the_guard_blocks_yaml():
    """The finder refuses PyYAML too, so the port is shown to import (and
    its config paths to load) without it."""
    probe = GUARDED.replace(
        'for name in names + ["chip_smoke", "profile_slice", "smoke_reference", "tune_warp"]:',
        'import yaml\nfor name in []:',
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "blocked import of yaml" in proc.stderr


RAW_CHAIN = r"""
import numpy as np
from cuahn_vio_torch.cli import main
from cuahn_vio_torch.eval.traj_io import save_pose_file

rng = np.random.default_rng(0)
frames = rng.integers(0, 256, (2, 224, 320)).astype(np.uint8)
imu_t = 1.0 + np.arange(30) * 0.002
np.savez("seq.npz", imu_t=imu_t, imu_w=rng.normal(size=(30, 3)),
         imu_a=rng.normal(size=(30, 3)), cam_t=np.array([1.0, 1.0333]), frames=frames)
main(["distort-to-euroc", "seq.npz", "--out", "raw", "--device", "cpu"])
main(["convert-euroc", "raw", "--out", "back.npz", "--device", "cpu"])
back = np.load("back.npz")["frames"]
assert back.shape == frames.shape, back.shape
save_pose_file("gt.txt", imu_t, np.tile([0, 0, 1.0, 0, 0, 0, 1.0], (30, 1)))
main(["format-converter", "gt.txt", "gt.csv"])
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("raw chain ok")
"""


def test_raw_camera_verbs_run_without_pil_jax_or_yaml(tmp_path):
    """PIL is blocked with the rest: the port's PNG codec writes and reads
    the EuRoC directory."""
    code = GUARDED.split("import cuahn_vio_torch\n")[0] + RAW_CHAIN
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "raw chain ok" in proc.stdout


LOOP_VERBS = r"""
import numpy as np
import pytest
from cuahn_vio_torch.cli import main
from cuahn_vio_torch.data import trajpairs
from cuahn_vio_torch.eval.traj_io import load_pose_file, save_pose_file

t = np.arange(12) * 0.5
poses = np.column_stack([np.sin(t), 0.2 * t, 1.5 + 0 * t, 0 * t, 0 * t, 0 * t, 1 + 0 * t])
save_pose_file("est.txt", t, poses)
main(["smooth-trajectory", "est.txt", "--loops", "0:11,2:9", "--huber", "3", "--out",
      "smoothed.txt", "--device", "cpu"])
assert load_pose_file("smoothed.txt").poses.shape == (12, 7)
trajpairs.GT_DIR = "no_gt_here"
with pytest.raises(SystemExit, match="no training trajectory in no_gt_here"):
    main(["train-fil", "--resume", "w.msgpack", "--device", "cpu"])
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("loop verbs ok")
"""


def test_loop_verbs_run_without_jax_or_yaml(tmp_path):
    """``smooth-trajectory`` smooths on the CPU, and ``train-fil`` refuses a
    GT directory without ``*_with_gt.txt`` files, with JAX and PyYAML
    blocked."""
    code = GUARDED.split("import cuahn_vio_torch\n")[0] + LOOP_VERBS
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "loop verbs ok" in proc.stdout

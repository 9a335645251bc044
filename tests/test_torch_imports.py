"""The port imports neither JAX, flax, optax, msgpack, PyYAML, PIL,
matplotlib nor the JAX package.

In a fresh interpreter where a ``sys.meta_path`` finder makes ``jax``,
``flax``, ``optax``, ``msgpack``, ``yaml``, ``PIL``, ``matplotlib`` and
``cuahn_vio`` (and their submodules) unimportable,
every module of ``cuahn_vio_torch`` and the port's scripts
(``chip_smoke.py``, ``tune_warp.py``, ``profile_slice.py``,
``smoke_reference.py``) must import, the raw-camera verbs
(``distort-to-euroc``, ``convert-euroc``, ``format-converter``) must run
on the CPU, and so must ``smooth-trajectory``, ``train-fil``'s refusal
without GT files, and the diagnostics (``inspect-frame``,
``track-features``, ``calibrate-covariance``,
``calibrate-state-covariance``), and ``distributed-selftest --device
cpu`` with ``smooth-trajectory --mesh``. Each verb of the diagnostics
slice, and each verb of the sweep and parallel slice (``tune-filter``,
``distributed-selftest``, ``pid-monitor``, ``error-dataset``,
``error-comparison``, ``align-trajectory``, ``timing-comparison``), takes
every flag of its JAX verb. So do the plot verbs (``plot-trajectories``,
``plot-trackhist``, ``timing-flamegraph``, ``watch-run``,
``error-simulation``), which write their RGB PNGs with matplotlib blocked.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED = r'''
import importlib
import importlib.abc
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "PIL", "matplotlib",
           "cuahn_vio")


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
print(" ".join(names))
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
    # and the diagnostics slice's (vision.detect, vision.klt,
    # vision.triangulate, vision.preint, eval.flow), and the sweep and
    # parallel slice's
    assert int(proc.stdout.split()[-1]) >= 66
    walked = set(proc.stdout.split()[:-1])
    assert {"cuahn_vio_torch.eval.tuning", "cuahn_vio_torch.eval.recorder",
            "cuahn_vio_torch.parallel.mesh", "cuahn_vio_torch.parallel.pose_graph_sharded",
            "cuahn_vio_torch.parallel.selftest", "cuahn_vio_torch.eval.raster",
            "cuahn_vio_torch.eval.plots", "cuahn_vio_torch.train.trainer"} <= walked


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


DIAGNOSTICS = r"""
import numpy as np
import pytest
from cuahn_vio_torch.cli import main
from cuahn_vio_torch.eval.simulation import StateGT, save_state_gt
from cuahn_vio_torch.utils.png import read_png

rng = np.random.default_rng(0)
frames = rng.integers(0, 256, (4, 224, 320)).astype(np.uint8)
np.savez("seq.npz", frames=frames, cam_t=np.arange(4) / 30.0)
main(["inspect-frame", "seq.npz", "--frame", "1", "--weights", WEIGHTS, "--out", "i.png",
      "--device", "cpu"])
assert read_png("i.png").shape == (224, 960)
main(["track-features", "seq.npz", "--out", "t.npz", "--device", "cpu"])
assert np.load("t.npz")["ids"].shape == (4, 80)
f = 40
a = rng.normal(size=(f, 8, 8))
net = a @ a.transpose(0, 2, 1) + 8 * np.eye(8)
np.savez("log.npz", net_inno=rng.normal(size=(f, 8)), cov_meas=net * 1e-5, net_cov88=net)
main(["calibrate-covariance", "log.npz"])
t = np.arange(200) * 0.01
pose = np.column_stack([np.sin(t), t, 1.5 + 0 * t, 0 * t, 0 * t, 0 * t, 1 + 0 * t])
z = np.zeros((200, 3))
save_state_gt("gt.txt", StateGT(times=t, pose=pose, vel=z, bg=z, ba=z))
k = np.arange(10, 200, 5)
cov = np.tile(np.eye(15) * 1e-4, (len(k), 1, 1))
noise = np.column_stack([rng.normal(0, 0.01, (len(k), 3)), np.zeros((len(k), 4))])
est = dict(times=t[k], pose=pose[k] + noise,
           v_body=rng.normal(0, 0.01, (len(k), 3)), ba=z[k], bg=z[k], cov_core=cov,
           cov_diag=np.einsum("fii->fi", cov))
np.savez("state.npz", **est)
main(["calibrate-state-covariance", "state.npz", "gt.txt"])
np.savez("inflated.npz", **est, cov_calib_blocks=np.array(["pos", "ori", "vel", "ba", "bg"]),
         cov_calib_factors=np.array([2.0, 2.0, 1.0, 1.0, 1.0]))
with pytest.raises(SystemExit, match="already inflated"):
    main(["calibrate-state-covariance", "inflated.npz", "gt.txt"])
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("diagnostics ok")
"""


def test_diagnostics_verbs_run_without_jax_or_matplotlib(tmp_path):
    """``inspect-frame`` writes its figure with the port's PNG writer, and
    the vision and covariance verbs run, with JAX, PIL and matplotlib
    blocked."""
    weights = os.path.join(REPO, "weights", "uahn_fil_v10.msgpack")
    code = (GUARDED.split("import cuahn_vio_torch\n")[0] + f"WEIGHTS = {weights!r}\n"
            + DIAGNOSTICS)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "diagnostics ok" in proc.stdout
    assert "wrote i.png (mean photometric err " in proc.stdout
    assert "run-vio flag:  --cov-calib pos:" in proc.stdout


def _subparser(top, verb: str):
    import argparse

    sub = next(a for a in top._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[verb]


def _jax_subparser(verb: str):
    """The JAX CLI's parser of ``verb`` (built inside its ``main``)."""
    import argparse
    from unittest import mock

    import pytest

    from cuahn_vio import cli as jcli

    class Built(Exception):
        pass

    def grab(parser, *args, **kwargs):
        raise Built(parser)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Built) as built:
            jcli.main([verb])
    return _subparser(built.value.args[0], verb)


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("verb", ["eval-flow", "inspect-frame", "track-features",
                                  "calibrate-covariance", "calibrate-state-covariance"])
def test_diagnostics_verb_takes_every_flag_of_the_jax_verb(verb):
    """Every option of the JAX verb, with its default; the verbs that run
    on the card also take --device (default cuda), the numpy-only fits
    nothing more."""
    from cuahn_vio_torch import cli as tcli

    want, got = _options(_jax_subparser(verb)), _options(_subparser(tcli.build_parser(), verb))
    if not verb.startswith("calibrate"):
        assert got.pop("device") == (("--device",), "cuda", False)
    assert got == want


PARALLEL = r"""
import json
from cuahn_vio_torch.cli import main

import numpy as np
from cuahn_vio_torch.eval.traj_io import save_pose_file

main(["distributed-selftest", "--device", "cpu", "--mesh-devices", "2", "--out", "st.json"])
assert json.load(open("st.json"))["pose_final_cost"] < 1e-6
th = np.linspace(0, 3, 12)
save_pose_file("est.txt", th, np.stack([np.cos(th), np.sin(th), th * 0, th * 0, th * 0,
                                        np.sin(th / 2), np.cos(th / 2)], 1))
main(["smooth-trajectory", "est.txt", "--loops", "0:11", "--mesh", "--device", "cpu"])
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("parallel ok")
"""


def test_parallel_verbs_run_without_jax(tmp_path):
    """The selftest (the measurement-driven filter, the mesh, the Schur
    smoother) and ``smooth-trajectory --mesh`` run on the CPU with JAX and
    the JAX package blocked."""
    code = GUARDED.split("import cuahn_vio_torch\n")[0] + PARALLEL
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "parallel ok" in proc.stdout


@pytest.mark.parametrize("verb", ["tune-filter", "distributed-selftest", "pid-monitor",
                                  "error-dataset", "error-comparison", "align-trajectory",
                                  "timing-comparison"])
def test_sweep_and_parallel_verb_takes_every_flag_of_the_jax_verb(verb):
    """Every option of the JAX verb, with its default; the two verbs that
    run on the card also take --device (default cuda), the numpy-only
    verbs nothing more."""
    from cuahn_vio_torch import cli as tcli

    want, got = _options(_jax_subparser(verb)), _options(_subparser(tcli.build_parser(), verb))
    if verb in ("tune-filter", "distributed-selftest"):
        assert got.pop("device") == (("--device",), "cuda", False)
    assert got == want


PLOTS = r"""
import numpy as np
from cuahn_vio_torch.cli import main
from cuahn_vio_torch.eval.simulation import StateGT, save_state_gt
from cuahn_vio_torch.eval.traj_io import save_pose_file, save_timing_file
from cuahn_vio_torch.utils.png import read_png

rng = np.random.default_rng(0)
t = np.arange(60) * 0.05
poses = np.column_stack([np.cos(t), np.sin(t), 1.5 + 0 * t, 0 * t, 0 * t, 0 * t, 1 + 0 * t])
save_pose_file("gt.txt", t, poses)
save_pose_file("est.txt", t, poses + rng.normal(0, 0.01, poses.shape) * [1, 1, 1, 0, 0, 0, 0])
main(["plot-trajectories", "gt.txt", "est.txt", "--out", "traj.png"])
np.savez("seq.npz", frames=rng.integers(0, 256, (12, 56, 80)).astype(np.uint8))
np.savez("state.npz", net_mean=rng.normal(0, 5, (11, 8)), net_chi2=rng.uniform(1, 20, 11))
main(["plot-trackhist", "seq.npz", "state.npz", "--out", "th.png"])
stages = rng.uniform(1, 5, (30, 5))
save_timing_file("t.csv", np.arange(30) / 30.0, stages)
main(["timing-flamegraph", "t.csv", "--out", "fg.png"])
main(["watch-run", "est.txt", "--gt", "gt.txt", "--max-ticks", "1", "--out", "w.png"])
z = np.zeros((60, 3))
save_state_gt("sgt.txt", StateGT(times=t, pose=poses, vel=z, bg=z, ba=z))
np.savez("st.npz", times=t, pose=poses, v_body=z, ba=z, bg=z)
main(["error-simulation", "st.npz", "sgt.txt", "--plot", "sim.png"])
shapes = [read_png(f).shape for f in ("traj.png", "th.png", "fg.png", "w.png", "sim.png")]
assert shapes == [(1040, 1040), (832, 910), (520, 1300), (770, 770), (1430, 1560)], shapes
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("plots ok")
"""


def test_plot_verbs_run_without_matplotlib_or_jax(tmp_path):
    """The five plot surfaces draw with the port's raster writer and write
    RGB PNGs of figsize x dpi pixels, with matplotlib, PIL, JAX and the JAX
    package blocked."""
    code = GUARDED.split("import cuahn_vio_torch\n")[0] + PLOTS
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "plots ok" in proc.stdout
    for name in ("traj.png", "th.png", "fg.png", "w.png", "sim.png"):
        with open(tmp_path / name, "rb") as f:
            assert f.read(26)[25] == 2, name  # colour type 2: RGB


@pytest.mark.parametrize("verb", ["plot-trajectories", "plot-trackhist", "timing-flamegraph",
                                  "watch-run", "error-simulation"])
def test_plot_verb_takes_every_flag_of_the_jax_verb(verb):
    """Every option and positional of the JAX verb, with its default and
    choices; numpy-only, so no --device."""
    from cuahn_vio_torch import cli as tcli

    def tree(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required, a.nargs,
                         a.type, tuple(a.choices or ())) for a in parser._actions
                if a.dest != "help"}

    assert tree(_subparser(tcli.build_parser(), verb)) == tree(_jax_subparser(verb))

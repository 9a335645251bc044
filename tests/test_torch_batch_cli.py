"""The port's ``run-vio-batch`` and ``make-synthetic`` verbs against the
JAX CLI's on the CPU.

- ``run-vio-batch --no-network --device cpu`` on two sequences of
  different lengths writes the same pose files as ``python -m
  cuahn_vio.cli run-vio-batch --no-network``: times equal, every other
  column within 2e-6 (the files print poses to 1e-6).
- ``make-synthetic --device cpu --texture heldout`` writes the same four
  files as the JAX verb: the same texture pick and config; IMU gyro 1e-6,
  accelerometer 1e-6 absolute + 1e-6 relative; ground-truth files 2e-6
  (printed to 1e-6 and 1e-9); frames within one uint8 level on at least
  99.9 % of the pixels (measured: every pixel, 6.9 % of them one level
  apart on this photo; both renderers truncate intensity * 255, see
  ``tests/test_torch_textures.py``). The JAX verb renders on the CPU
  through its gather sampler; the port samples as the JAX package's TPU
  path does, and on a rendered frame truncates to the same level as that
  path on all but 0.070 % of the pixels, against 0.566 % for the gather
  path (``test_renderer_levels_follow_the_jax_tpu_sampler``): the
  differences lie between the JAX package's two samplers.
- ``run-vio-batch`` without ``--weights`` loads the config's
  ``network_weights_path``, as ``run-vio`` does (the JAX verb does not).
- ``--mesh`` on one process writes the files of the run without it, byte
  for byte, and ``--device cuda`` fails without a GPU.
"""

import os

import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "uahn_fil_v10.msgpack")


@pytest.fixture(scope="module")
def npz_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("seqs")
    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    paths = []
    for duration, seed in ((0.6, 4), (0.4, 5)):
        s = make_sequence(AnalyticTrajectory(), t_ic, duration=duration, seed=seed,
                          sigma_w=0.002, sigma_a=0.02, texture_seed=seed, device="cpu")
        paths.append(str(root / f"s{seed}.npz"))
        np.savez(paths[-1], imu_t=s.imu_t, imu_w=s.imu_w, imu_a=s.imu_a,
                 cam_t=s.cam_t, frames=s.frames)
    return paths


def test_cli_run_vio_batch_matches_jax_cli(npz_paths, tmp_path):
    flags = ["--no-network", "--init-height", "1.5"]
    tcli.main(["run-vio-batch", *npz_paths, "--device", "cpu",
               "--out-dir", str(tmp_path / "t"), *flags])
    jcli.main(["run-vio-batch", *npz_paths, "--out-dir", str(tmp_path / "j"), *flags])
    for stem in ("s4", "s5"):
        out = np.loadtxt(tmp_path / "t" / f"{stem}.txt")
        ref = np.loadtxt(tmp_path / "j" / f"{stem}.txt")
        assert out.shape == ref.shape and out.shape[1] == 20 and len(out) >= 2
        np.testing.assert_array_equal(out[:, 0], ref[:, 0])
        np.testing.assert_allclose(out[:, 1:], ref[:, 1:], atol=2e-6, rtol=0)
    assert len(np.loadtxt(tmp_path / "t" / "s5.txt")) < len(np.loadtxt(tmp_path / "t" / "s4.txt"))


def test_cli_run_vio_batch_reads_the_configs_weights(tmp_path):
    """Without ``--weights``, ``run-vio-batch`` loads the config's
    ``network_weights_path``, as ``run-vio`` does: the same pose file as
    ``--weights`` with that path, and not the randomly initialized UAHN's.
    (The JAX verb reads only ``--weights``, ``cuahn_vio/cli.py:1038-1044``.)
    A 1 s flight, so that network updates pass the filter's first-frames
    gate and move the poses."""
    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    s = make_sequence(AnalyticTrajectory(), t_ic, duration=1.0, seed=5, sigma_w=0.002,
                      sigma_a=0.02, texture_seed=5, device="cpu")
    seq = str(tmp_path / "s.npz")
    np.savez(seq, imu_t=s.imu_t, imu_w=s.imu_w, imu_a=s.imu_a, cam_t=s.cam_t, frames=s.frames)
    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    opts.init_height, opts.calib_camimu_dt, opts.mc_dropout = 1.5, 0.0, 0.0
    plain = str(tmp_path / "plain.yaml")
    opts.to_yaml(plain)
    opts.network_weights_path = WEIGHTS
    named = str(tmp_path / "named.yaml")
    opts.to_yaml(named)
    runs = {"config": ["--config", named], "flag": ["--config", plain, "--weights", WEIGHTS],
            "random": ["--config", plain]}
    poses = {}
    for name, flags in runs.items():
        tcli.main(["run-vio-batch", seq, "--device", "cpu", "--out-dir",
                   str(tmp_path / name), *flags])
        poses[name] = (tmp_path / name / "s.txt").read_text()
    assert len(poses["config"].splitlines()) >= 15
    assert poses["config"] == poses["flag"]
    assert poses["random"] != poses["flag"]  # the weights do reach the poses


def test_cli_run_vio_batch_refuses_mesh(npz_paths, tmp_path, capsys):
    """``--mesh``, once refused, now shards the batch over the job's mesh:
    one process is a one-device mesh (gcd(2, 1) = 1, as the JAX verb
    takes), so the files are those of the run without it, byte for
    byte."""
    flags = ["--no-network", "--init-height", "1.5", "--device", "cpu"]
    tcli.main(["run-vio-batch", *npz_paths, "--out-dir", str(tmp_path / "m"), "--mesh", *flags])
    assert "sharding 2 sequences over 1 devices" in capsys.readouterr().out
    tcli.main(["run-vio-batch", *npz_paths, "--out-dir", str(tmp_path / "p"), *flags])
    for stem in ("s4", "s5"):
        assert (tmp_path / "m" / f"{stem}.txt").read_bytes() == \
            (tmp_path / "p" / f"{stem}.txt").read_bytes()


@pytest.mark.parametrize("verb", [["run-vio-batch", "x.npz"], ["make-synthetic"]])
def test_cli_new_verbs_refuse_cuda_without_a_gpu(verb, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main([*verb, "--out" if verb[0] == "make-synthetic" else "--out-dir",
                   str(tmp_path / "o.npz")])


def test_cli_make_synthetic_matches_jax_cli(tmp_path):
    pytest.importorskip("yaml")  # both verbs write _config.yaml
    flags = ["--texture", "heldout", "--duration", "0.6", "--seed", "3",
             "--sigma-w", "0.002", "--sigma-a", "0.02", "--bias-g", "0.003"]
    tcli.main(["make-synthetic", "--device", "cpu", "--out", str(tmp_path / "t.npz"), *flags])
    jcli.main(["make-synthetic", "--out", str(tmp_path / "j.npz"), *flags])
    out, ref = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(out.files) == sorted(ref.files)
    for name in ("imu_t", "cam_t"):
        np.testing.assert_array_equal(out[name], ref[name])
    np.testing.assert_allclose(out["imu_w"], ref["imu_w"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(out["imu_a"], ref["imu_a"], atol=1e-6, rtol=1e-6)
    assert out["frames"].shape == ref["frames"].shape and out["frames"].dtype == np.uint8
    diff = np.abs(out["frames"].astype(int) - ref["frames"].astype(int))
    assert (diff <= 1).mean() >= 0.999
    for suffix in ("_gt.txt", "_state_gt.txt"):
        a, b = np.loadtxt(tmp_path / f"t{suffix}"), np.loadtxt(tmp_path / f"j{suffix}")
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
    assert (tmp_path / "t_config.yaml").read_text() == (tmp_path / "j_config.yaml").read_text()


@pytest.mark.parametrize("flag", [["--traj-file", "traj.txt"]])
def test_cli_make_synthetic_refuses_flags_not_ported(flag, tmp_path):
    """``--traj-file`` was refused until the B-spline was ported; the verb
    now reads the file (here, one too short for a spline: the spline's
    own error) and writes nothing for it."""
    (tmp_path / flag[1]).write_text("# t x y z qx qy qz qw\n0 0 0 1 0 0 0 1\n")
    with pytest.raises(ValueError, match="fewer than 4 poses"):
        tcli.main(["make-synthetic", "--device", "cpu", "--out", str(tmp_path / "o.npz"),
                   flag[0], str(tmp_path / flag[1])])
    assert not (tmp_path / "o.npz").exists()


def test_cli_make_synthetic_effects(tmp_path):
    """``--effects`` degrades every frame with one draw of the chain per
    sequence from ``--seed``: the same command twice writes the same
    frames, which differ from the clean sequence's."""
    def frames(name, *flags):
        tcli.main(["make-synthetic", "--device", "cpu", "--out", str(tmp_path / name),
                   "--duration", "0.3", "--seed", "3", "--texture", "train", *flags])
        return np.load(tmp_path / name)["frames"]

    a, b, clean = frames("a.npz", "--effects"), frames("b.npz", "--effects"), frames("c.npz")
    assert np.array_equal(a, b)
    assert a.shape == clean.shape and np.abs(a.astype(int) - clean.astype(int)).mean() > 2.0

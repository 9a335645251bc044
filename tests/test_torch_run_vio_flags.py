"""The four run-vio flags of this slice against the JAX CLI and package.

- ``--timing-out``, ``--odom-out``, ``--state-out`` and ``--cov-calib``
  through both CLIs on one short sequence: the same poses, odometry,
  inflated covariances and timing rows;
- the writers (``save_timing_file``, ``save_odom_file``) give the JAX
  writers' bytes, ``apply_cov_inflation`` their arrays;
- ``--bf16``: the bfloat16 UAHN against the JAX bfloat16 UAHN on one frame
  pair at dropout_rate = 0. Each package's bf16 flow must lie within 0.05
  px of its own float32 flow (``bench.py:70``'s bound), so the two lie
  within 0.1 px of each other.

Tolerances are ``tests/test_torch_slice.py``'s (positions 2e-5 m,
quaternions 1e-6, covariances 1e-6) unless a test states another.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.cli import main as jax_main
from cuahn_vio.data.synthetic import AnalyticTrajectory as JaxTraj
from cuahn_vio.data.synthetic import make_sequence as jax_make_sequence
from cuahn_vio.eval.calibration import apply_cov_inflation as jax_apply_cov_inflation
from cuahn_vio.eval.calibration import inflation_diag as jax_inflation_diag
from cuahn_vio.eval.traj_io import load_pose_file
from cuahn_vio.eval.traj_io import save_odom_file as jax_save_odom_file
from cuahn_vio.eval.traj_io import save_timing_file as jax_save_timing_file
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.eval.calibration import COV_BLOCKS, apply_cov_inflation, inflation_diag
from cuahn_vio_torch.eval.traj_io import load_timing_file, save_odom_file, save_timing_file
from cuahn_vio_torch.models.uahn import build_uahn
from cuahn_vio_torch.utils.checkpoint import load_params
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
POS_ATOL = 2e-5
Q_ATOL = 1e-6
COV_ATOL = 1e-6
ODOM_ATOL = 2e-5  # the odometry file's positions, velocities and angles
FILE_STEP = 1e-6  # the pose file's last printed digit (6 decimals)
BF16_OWN_PX = 0.05  # bf16 flow against the same package's float32 flow
BF16_CROSS_PX = 0.1  # the two packages' bf16 flows
SEQ_KW = dict(duration=0.6, seed=1, sigma_w=0.002, sigma_a=0.02, bias_g=0.003,
              bias_a=0.02, texture_seed=1)
FACTORS = "pos:2,ori:3,vel:1.5"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A short sequence npz and its make-synthetic style config (written by
    the port: the JAX writer needs PyYAML)."""
    d = tmp_path_factory.mktemp("flags")
    opts = VioOptions().apply_profile("calibrated")
    opts.calib_camimu_dt, opts.init_height, opts.init_imu_thresh = 0.0, 1.5, 0.2
    seq = jax_make_sequence(JaxTraj(), np.asarray(opts.t_imu_to_cam), **SEQ_KW)
    npz, cfg = str(d / "seq.npz"), str(d / "seq_config.yaml")
    np.savez(npz, imu_t=seq.imu_t, imu_w=seq.imu_w, imu_a=seq.imu_a, cam_t=seq.cam_t,
             frames=seq.frames)
    opts.to_yaml(cfg)
    return npz, cfg


def _run(main, tmp_path, name, npz, cfg, *extra):
    out = {k: str(tmp_path / f"{name}_{k}") for k in ("est.txt", "t.csv", "odom.txt",
                                                      "state.npz")}
    main(["run-vio", npz, "--config", cfg, "--no-network", "--out", out["est.txt"],
          "--timing-out", out["t.csv"], "--odom-out", out["odom.txt"],
          "--state-out", out["state.npz"], "--cov-calib", FACTORS, *extra])
    return out


def test_cli_run_vio_flags_match_jax_cli(files, tmp_path, capsys):
    npz, cfg = files
    ref = _run(jax_main, tmp_path, "jax", npz, cfg)
    jax_said = capsys.readouterr().out
    out = _run(tcli.main, tmp_path, "port", npz, cfg, "--device", "cpu")
    said = capsys.readouterr().out
    # the same lines, the output paths aside
    assert said.replace("port_", "jax_") == jax_said
    assert "applied reported-covariance calibration: {'pos': 2.0, 'ori': 3.0, 'vel': 1.5}" \
        in said
    # poses and the inflated pose covariances
    e, r = load_pose_file(out["est.txt"]), load_pose_file(ref["est.txt"])
    np.testing.assert_array_equal(e.times, r.times)
    np.testing.assert_allclose(e.poses[:, :3], r.poses[:, :3], atol=POS_ATOL + FILE_STEP,
                               rtol=0)
    np.testing.assert_allclose(e.poses[:, 3:], r.poses[:, 3:], atol=Q_ATOL + FILE_STEP,
                               rtol=0)
    np.testing.assert_allclose(e.cov_pos, r.cov_pos, atol=2 * COV_ATOL, rtol=0)
    np.testing.assert_allclose(e.cov_ori, r.cov_ori, atol=3 * COV_ATOL, rtol=0)
    # the state npz: inflated as the JAX verb does, and the factors recorded
    s, sr = np.load(out["state.npz"]), np.load(ref["state.npz"])
    assert set(s.files) == set(sr.files) | {"cov_calib_blocks", "cov_calib_factors"}
    np.testing.assert_allclose(s["cov_core"], sr["cov_core"], atol=3 * COV_ATOL, rtol=0)
    assert list(s["cov_calib_blocks"]) == list(COV_BLOCKS)
    np.testing.assert_array_equal(s["cov_calib_factors"], [2.0, 3.0, 1.5, 1.0, 1.0])
    # the odometry file
    with open(out["odom.txt"]) as f, open(ref["odom.txt"]) as g:
        assert f.readline() == g.readline()
    np.testing.assert_allclose(np.loadtxt(out["odom.txt"]), np.loadtxt(ref["odom.txt"]),
                               atol=ODOM_ATOL, rtol=0)
    # the timing csv: one row a pose, the JAX header and timestamps
    t, stages = load_timing_file(out["t.csv"])
    tr, _ = load_timing_file(ref["t.csv"])
    np.testing.assert_array_equal(t, tr)
    assert stages.shape == (len(e.times), 5) and (stages >= 0).all()
    with open(out["t.csv"]) as f, open(ref["t.csv"]) as g:
        assert f.readline() == g.readline()


def test_cli_cov_calib_inflates_what_run_vio_wrote(files, tmp_path):
    """The npz's cov_core is the uninflated run's, inflated by D P D."""
    npz, cfg = files
    plain = str(tmp_path / "plain.npz")
    tcli.main(["run-vio", npz, "--config", cfg, "--no-network", "--device", "cpu",
               "--out", str(tmp_path / "p.txt"), "--state-out", plain])
    out = _run(tcli.main, tmp_path, "port", npz, cfg, "--device", "cpu")
    want = apply_cov_inflation(np.load(plain)["cov_core"], {"pos": 2, "ori": 3, "vel": 1.5})
    np.testing.assert_array_equal(np.load(out["state.npz"])["cov_core"], want)
    assert "cov_calib_factors" not in np.load(plain).files


def test_cli_cov_calib_refuses_unknown_blocks(files, tmp_path):
    npz, cfg = files
    with pytest.raises(SystemExit, match="unknown blocks"):
        tcli.main(["run-vio", npz, "--config", cfg, "--no-network", "--device", "cpu",
                   "--out", str(tmp_path / "e.txt"), "--cov-calib", "position:2"])


def test_cli_run_vio_bf16_runs_the_bf16_towers(files, tmp_path, monkeypatch):
    npz, cfg = files
    built = []
    real = tcli._model

    def spy(*args, **kw):
        model = real(*args, **kw)
        built.append(model.block4.compute_dtype)
        return model

    monkeypatch.setattr(tcli, "_model", spy)
    flows = {}
    for name, extra in (("f32", []), ("bf16", ["--bf16"])):
        est, state = str(tmp_path / f"{name}.txt"), str(tmp_path / f"{name}.npz")
        tcli.main(["run-vio", npz, "--config", cfg, "--weights", WEIGHTS, "--device", "cpu",
                   "--out", est, "--state-out", state, *extra])
        assert np.isfinite(load_pose_file(est).poses).all()
        flows[name] = np.load(state)["net_mean"]
    assert built == [torch.float32, torch.bfloat16]
    err = np.abs(flows["bf16"] - flows["f32"]).max()
    assert 0 < err < BF16_OWN_PX  # the towers really changed, within the bf16 bound


def test_save_timing_file_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.03, 0.04, 50)) + 2.5
    stages = rng.uniform(0.0, 200.0, (50, 5))
    ours, ref = tmp_path / "ours.csv", tmp_path / "ref.csv"
    save_timing_file(str(ours), times, stages)
    jax_save_timing_file(str(ref), times, stages)
    assert ours.read_bytes() == ref.read_bytes()
    t, s = load_timing_file(str(ours))
    np.testing.assert_allclose(t, times, atol=1e-14)
    np.testing.assert_allclose(s, stages, atol=1e-5)


def test_save_odom_file_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(1)
    n = 64
    q = rng.normal(size=(n, 4))
    q[:4] = [[0, 0, 0, 1], [0, 0, 1, 0], [1, 0, 0, 0], [0.7071068, 0, 0, 0.7071068]]
    pose = np.concatenate([rng.normal(0, 3, (n, 3)),
                           q / np.linalg.norm(q, axis=1, keepdims=True)], axis=1)
    v = rng.normal(0, 2, (n, 3))
    times = np.arange(n) * 0.05 + 3.0
    ours, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    save_odom_file(str(ours), times, pose, v)
    jax_save_odom_file(str(ref), times, pose, v)
    assert ours.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_apply_cov_inflation_matches_jax(dtype):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(7, 15, 15))
    cov = (a @ a.transpose(0, 2, 1)).astype(dtype)
    for factors in ({}, {"pos": 2.0}, {"pos": 5.1, "ori": 3.4, "vel": 8.7, "ba": 0.5,
                                        "bg": 1.0}):
        np.testing.assert_array_equal(inflation_diag(factors, dtype),
                                      jax_inflation_diag(factors, dtype))
        out = apply_cov_inflation(cov, factors)
        assert out.dtype == cov.dtype
        np.testing.assert_array_equal(out, jax_apply_cov_inflation(cov, factors))


@pytest.fixture(scope="module")
def frames():
    """``tests/test_torch_uahn.py``'s textured pair and prior."""
    rng = np.random.default_rng(30)
    base = rng.integers(0, 256, (232, 330)).astype(np.uint8)
    return base[4:228, 5:325].copy(), base[2:226, 2:322].copy(), \
        rng.normal(0, 2.0, (4, 2)).astype(np.float32)


@pytest.mark.parametrize("use_prior", [True, False])
def test_bf16_uahn_matches_jax_bf16(frames, use_prior):
    from flax import serialization

    img1, img2, prior = frames
    with open(WEIGHTS, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    flows = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        f, _ = JaxUAHN(dropout_rate=0.0, compute_dtype=dtype).apply(
            {"params": params}, jnp.array(img1, jnp.float32) / 255.0,
            jnp.array(img2, jnp.float32) / 255.0, jnp.array(prior) if use_prior else None,
            use_prior=use_prior, rngs={"dropout": jax.random.PRNGKey(1)})
        flows["jax " + name] = np.asarray(f)
    state = load_params(WEIGHTS)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = build_uahn(state, device="cpu", dropout_rate=0.0, compute_dtype=dtype)
        f, c = model(torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
                     torch.from_numpy(prior)[None], use_prior=use_prior)
        assert f.dtype == c.dtype == torch.float32 and torch.isfinite(c).all()
        flows["port " + name] = f[0].numpy()
    for pkg in ("jax", "port"):
        err = np.abs(flows[f"{pkg} bf16"] - flows[f"{pkg} f32"]).max()
        assert 0 < err < BF16_OWN_PX, (pkg, err)
    np.testing.assert_allclose(flows["port bf16"], flows["jax bf16"], atol=BF16_CROSS_PX,
                               rtol=0)


def test_bf16_weights_stay_float32():
    model = build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0,
                       compute_dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    x = torch.rand(1, 2, 112, 160)
    assert model.block3(x).dtype == torch.float32
    assert model.block3.compute_dtype == torch.bfloat16
    assert model.block2.compute_dtype == model.block4.compute_dtype == torch.bfloat16

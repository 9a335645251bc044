"""The port's loop closure (``cuahn_vio_torch.pipeline.loop_closure``) and
the verbs ``close-loops`` and ``smooth-trajectory`` against the JAX
package on the CPU.

The revisit sequence: frames rendered by the port on a procedural
texture at three poses and at three revisits of them 5-15 cm off, plus
one far pose whose predicted flow fails the geometric gate; the
"estimated" poses are the truth with 2 cm noise. Both packages run the
v10 weights with MC dropout off (``dropout_rate = 0``), so that these
tests hold the geometry alone; ``tests/test_torch_dropout_parity.py``
holds ``close-loops`` at p = 0.05, where the port draws the JAX verb's
``fold_in`` masks.

Tolerances:
- ``find_loop_candidates``: the same pairs;
- ``position_from_flow``: 1e-4 m (the port's ``torch.linalg.lstsq`` is
  QR-based where JAX's is SVD-based; measured <= 1.2e-6 m);
- ``generate_loop_factors``: the same kept pairs, ``dp_meas`` within
  1e-3 m, ``dq_meas`` within 1e-5, ``sigma_p`` within 1e-3 relative
  (the port warps the uint8 frames, the JAX module their float /255
  copies);
- the verbs: ``close-loops`` as the function, the factor file's format
  the JAX verb's; ``smooth-trajectory`` poses within 1e-4 m of the JAX
  verb's (the pose files print 6 decimals).
"""

import argparse
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.pipeline import loop_closure as jlc
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.data.synthetic import render_frame
from cuahn_vio_torch.eval.traj_io import load_pose_file, save_pose_file
from cuahn_vio_torch.models import uahn as tuahn
from cuahn_vio_torch.ops.quat import quat_exp
from cuahn_vio_torch.pipeline import loop_closure as tlc
from cuahn_vio_torch.utils.checkpoint import load_params
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
POS_TOL_M = 1e-4
DP_TOL_M = 1e-3
DQ_TOL = 1e-5
SIGMA_RTOL = 1e-3
SMOOTH_TOL_M = 1e-4
PAIRS = np.array([[0, 3], [1, 4], [2, 5], [0, 6]])


def _camera(opts=None):
    t = np.asarray((opts or VioOptions.uzhfpv_indoor45()).t_imu_to_cam, np.float64)
    return t[:3, :3].astype(np.float32), (-t[:3, :3].T @ t[:3, 3]).astype(np.float32)


@pytest.fixture(scope="module")
def revisits():
    """(frames (7, 224, 320) uint8, times, estimated p (7, 3), q (7, 4)
    wxyz, true p, true q)."""
    c_rot_i, i_t_i2c = (torch.as_tensor(x) for x in _camera())
    base = np.array([[0.0, 0.0, 1.7], [0.3, 0.1, 1.75], [0.6, 0.25, 1.65]], np.float32)
    off = np.array([[0.08, -0.05, 0.03], [-0.1, 0.04, -0.02], [0.05, 0.12, 0.0]], np.float32)
    p = np.concatenate([base, base + off, [[2.5, 1.5, 1.7]]]).astype(np.float32)
    rv = np.array([[0.02, -0.01, 0.0], [0.01, 0.02, 0.1], [-0.02, 0.0, 0.2],
                   [0.0, 0.01, 0.03], [0.02, 0.0, 0.12], [-0.01, -0.02, 0.16],
                   [0.0, 0.0, 0.0]], np.float32)
    q = quat_exp(torch.as_tensor(rv)).numpy()
    tex = torch.as_tensor(ttex.texture_u8(ttex.quantize_u8(
        np.stack(ttex._procedural_extras(ttex.TEXTURE_SIZE)))[5]))
    frames = np.stack([
        np.round(np.clip(render_frame(torch.as_tensor(p[k]), torch.as_tensor(q[k]), c_rot_i,
                                      i_t_i2c, None, 224, 320, tex,
                                      ttex.default_tex_params(4.0)).numpy(), 0, 1) * 255)
        for k in range(len(p))]).astype(np.uint8)
    rng = np.random.default_rng(5)
    p_est = (p + rng.normal(0, 0.02, p.shape)).astype(np.float32)
    times = np.arange(len(p), dtype=np.float64) * 4.0
    return frames, times, p_est, q, p, q


@pytest.fixture(scope="module")
def jax_params():
    from flax import serialization

    with open(WEIGHTS, "rb") as f:
        return serialization.msgpack_restore(f.read())


def test_find_loop_candidates_matches_jax():
    rng = np.random.default_rng(3)
    t = np.arange(300) * 0.05
    p = np.cumsum(rng.normal(0, 0.05, (300, 3)), axis=0)
    p[:, 0] += np.sin(t)
    for kw in (dict(), dict(min_dt=2.0, max_dist=0.5, stride=2, max_pairs=100),
               dict(min_dt=5.0, max_dist=2.0, stride=3, max_pairs=5)):
        want = jlc.find_loop_candidates(t, p, **kw)
        got = tlc.find_loop_candidates(t, p, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), kw
    assert len(tlc.find_loop_candidates(t, p, min_dt=100.0)) == 0


def test_position_from_flow_matches_jax(revisits):
    _, _, _, _, p, q = revisits
    c_rot_i, i_t_i2c = _camera()
    jflow = [jlc.flow_between(*(jnp.asarray(x) for x in (p[i], q[i], p[j], q[j], c_rot_i,
                                                          i_t_i2c))) for i, j in PAIRS]
    want = np.stack([np.asarray(jlc.position_from_flow(
        f, *(jnp.asarray(x) for x in (p[i], q[i], q[j], c_rot_i, i_t_i2c))))
        for f, (i, j) in zip(jflow, PAIRS)])
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    i, j = PAIRS[:, 0], PAIRS[:, 1]
    flow = tlc.flow_between(t(p[i]), t(q[i]), t(p[j]), t(q[j]), t(c_rot_i), t(i_t_i2c))
    np.testing.assert_allclose(flow.numpy(), np.stack([np.asarray(f) for f in jflow]),
                               atol=1e-3)
    got = tlc.position_from_flow(flow, t(p[i]), t(q[i]), t(q[j]), t(c_rot_i), t(i_t_i2c))
    np.testing.assert_allclose(got.numpy(), want, atol=POS_TOL_M, rtol=0)
    np.testing.assert_allclose(got.numpy(), p[j], atol=POS_TOL_M, rtol=0)  # exact flow


def _assert_same_factors(got, want):
    assert np.array_equal(got.pairs, want.pairs)
    np.testing.assert_allclose(got.dp_meas, want.dp_meas, atol=DP_TOL_M, rtol=0)
    np.testing.assert_allclose(got.dq_meas, want.dq_meas, atol=DQ_TOL, rtol=0)
    np.testing.assert_allclose(got.sigma_p, want.sigma_p, rtol=SIGMA_RTOL)


@pytest.mark.parametrize("max_sigma_px", [25.0, 0.5])
def test_generate_loop_factors_matches_jax(revisits, jax_params, max_sigma_px):
    """Both gates in the JAX order: the far pair (0, 6) never reaches the
    network; a tight confidence gate drops what a loose one keeps."""
    frames, times, p_est, q_est, _, _ = revisits
    c_rot_i, i_t_i2c = _camera()
    want = jlc.generate_loop_factors(frames, times, p_est, q_est, c_rot_i, i_t_i2c,
                                     JaxUAHN(dropout_rate=0.0), jax_params, pairs=PAIRS,
                                     max_sigma_px=max_sigma_px)
    model = tuahn.build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)
    got = tlc.generate_loop_factors(frames, times, p_est, q_est, c_rot_i, i_t_i2c, model,
                                    pairs=PAIRS, max_sigma_px=max_sigma_px)
    _assert_same_factors(got, want)
    assert got.inferred == 3
    if max_sigma_px == 25.0:
        assert got.pairs.tolist() == PAIRS[:3].tolist()
    else:
        assert len(got.pairs) < 3


def test_generate_loop_factors_batches_the_network(revisits, monkeypatch):
    """The network runs once per LOOP_BATCH pairs inside the geometric
    gate, on the uint8 frames, and gives the factors of one big batch."""
    frames, times, p_est, q_est, _, _ = revisits
    c_rot_i, i_t_i2c = _camera()
    model = tuahn.build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)
    full = tlc.generate_loop_factors(frames, times, p_est, q_est, c_rot_i, i_t_i2c, model,
                                     pairs=PAIRS, max_sigma_px=25.0)
    calls = []
    forward = tuahn.UAHN.forward

    def spy(self, img1, img2, *args, **kw):
        calls.append((img1.shape[0], img1.dtype, img2.dtype))
        return forward(self, img1, img2, *args, **kw)

    monkeypatch.setattr(tlc, "LOOP_BATCH", 2)
    monkeypatch.setattr(tuahn.UAHN, "forward", spy)
    small = tlc.generate_loop_factors(frames, times, p_est, q_est, c_rot_i, i_t_i2c, model,
                                      pairs=PAIRS, max_sigma_px=25.0)
    assert calls == [(2, torch.uint8, torch.uint8), (1, torch.uint8, torch.uint8)]
    _assert_same_factors(small, full)


def _jax_subparser(verb: str) -> argparse.ArgumentParser:
    """The JAX CLI's parser of ``verb`` (built inside its ``main``)."""
    class Built(Exception):
        pass

    def grab(parser, *args, **kwargs):
        raise Built(parser)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Built) as built:
            jcli.main([verb])
    top = built.value.args[0]
    sub = next(a for a in top._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[verb]


def _port_subparser(verb: str) -> argparse.ArgumentParser:
    top = tcli.build_parser()
    sub = next(a for a in top._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[verb]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("verb", ["close-loops", "smooth-trajectory", "train-fil"])
def test_verb_takes_every_flag_of_the_jax_verb(verb):
    """Every option of the JAX verb, with its default, plus --device."""
    want, got = _options(_jax_subparser(verb)), _options(_port_subparser(verb))
    assert got.pop("device") == (("--device",), "cuda", False)
    assert got == want


@pytest.fixture(scope="module")
def run_files(revisits, tmp_path_factory):
    """A sequence npz and a run-vio state npz over the revisit frames (each
    state row on its camera frame), and the estimate as a pose file."""
    frames, times, p_est, q_est, _, _ = revisits
    d = tmp_path_factory.mktemp("loops")
    opts = VioOptions.uzhfpv_indoor45()
    cam_t = times - opts.calib_camimu_dt
    np.savez(d / "seq.npz", frames=frames, cam_t=cam_t, imu_t=times,
             imu_w=np.zeros((len(times), 3)), imu_a=np.zeros((len(times), 3)))
    pose = np.concatenate([p_est, q_est[:, [1, 2, 3, 0]]], axis=1)
    np.savez(d / "state.npz", times=times, pose=pose)
    # a longer estimate to smooth: a drifting chain through the revisits
    n = 40
    ts = np.arange(n) * 0.25
    pc = np.stack([np.sin(0.3 * ts), 0.2 * ts, 1.6 + 0.05 * np.sin(ts)], 1)
    qc = quat_exp(torch.as_tensor(np.stack([0.02 * np.sin(ts), 0.01 * ts, 0.1 * ts], 1),
                                  dtype=torch.float32)).numpy()
    pc = pc + np.cumsum(np.random.default_rng(9).normal(0, 0.01, pc.shape), axis=0)
    save_pose_file(str(d / "chain.txt"), ts, np.concatenate([pc, qc[:, [1, 2, 3, 0]]], 1))
    return d


def _no_dropout(monkeypatch):
    """Both verbs' UAHNs with dropout off, so that their factors compare."""
    from cuahn_vio.models import uahn as juahn

    init = juahn.init_uahn
    monkeypatch.setattr(juahn, "init_uahn", lambda *a, **k: (
        lambda mp: (mp[0].clone(dropout_rate=0.0), mp[1]))(init(*a, **k)))
    build = tuahn.build_uahn
    monkeypatch.setattr(tuahn, "build_uahn",
                        lambda *a, **k: build(*a, **dict(k, dropout_rate=0.0)))


def _read_factors(path):
    rows = np.loadtxt(path, comments="#", ndmin=2)
    return tlc.LoopFactors(rows[:, :2].astype(np.int64), rows[:, 2:5], rows[:, 5:9],
                           rows[:, 9])


def test_cli_close_loops_matches_jax_verb(run_files, monkeypatch, capsys):
    _no_dropout(monkeypatch)
    d = run_files
    flags = ["--weights", WEIGHTS, "--min-dt", "3.0", "--max-dist", "3.0", "--stride", "1",
             "--max-sigma-px", "25"]
    jcli.main(["close-loops", str(d / "seq.npz"), str(d / "state.npz"), "--out",
               str(d / "jl.txt"), *flags])
    jsaid = capsys.readouterr().out
    tcli.main(["close-loops", str(d / "seq.npz"), str(d / "state.npz"), "--out",
               str(d / "tl.txt"), "--device", "cpu", *flags])
    tsaid = capsys.readouterr().out
    with open(d / "jl.txt") as fj, open(d / "tl.txt") as ft:
        assert fj.readline() == ft.readline()  # the header
    want, got = _read_factors(d / "jl.txt"), _read_factors(d / "tl.txt")
    assert len(want.pairs) > 0
    _assert_same_factors(got, want)
    jlines, tlines = jsaid.splitlines(), tsaid.splitlines()
    assert tlines[0] == jlines[0]  # the candidates
    assert tlines[-1] == jlines[-1].replace("jl.txt", "tl.txt")  # the factors
    assert "candidates inside the geometric gate" in tlines[1]


@pytest.mark.parametrize("extra", [[], ["--huber", "3", "--iters", "4"],
                                   ["--loop-sigma-scale", "2.5"],
                                   ["--loop-sigma-dp", "0.05", "--loop-sigma-dth", "0.02"]])
def test_cli_smooth_trajectory_matches_jax_verb(run_files, extra, capsys):
    d = run_files
    with open(d / "loops.txt", "w") as f:
        f.write("# i j dpx dpy dpz dqw dqx dqy dqz sigma_p\n")
        f.write("0 39 0.5 7.0 0.2 0.99 0.0 0.02 0.1 0.02\n")
        f.write("3 30 0.1 5.0 -0.1 0.995 0.01 0.0 0.09 0.05\n")
    args = ["smooth-trajectory", str(d / "chain.txt"), "--loops-file", str(d / "loops.txt"),
            *extra]
    jcli.main([*args, "--out", str(d / "js.txt")])
    jsaid = capsys.readouterr().out
    tcli.main([*args, "--out", str(d / "ts.txt"), "--device", "cpu"])
    tsaid = capsys.readouterr().out
    want, got = load_pose_file(str(d / "js.txt")), load_pose_file(str(d / "ts.txt"))
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.poses, want.poses, atol=SMOOTH_TOL_M, rtol=0)
    assert tsaid.splitlines()[-1] == jsaid.splitlines()[-1].replace("js.txt", "ts.txt")


def test_cli_smooth_trajectory_loops_pairs_and_empty_file(run_files, capsys):
    d = run_files
    jcli.main(["smooth-trajectory", str(d / "chain.txt"), "--loops", "0:20,5:35", "--out",
               str(d / "jp.txt")])
    tcli.main(["smooth-trajectory", str(d / "chain.txt"), "--loops", "0:20,5:35", "--out",
               str(d / "tp.txt"), "--device", "cpu"])
    np.testing.assert_allclose(load_pose_file(str(d / "tp.txt")).poses,
                               load_pose_file(str(d / "jp.txt")).poses, atol=SMOOTH_TOL_M)
    with open(d / "empty.txt", "w") as f:
        f.write("# i j dpx dpy dpz dqw dqx dqy dqz sigma_p\n")
    capsys.readouterr()
    with pytest.warns(UserWarning):
        tcli.main(["smooth-trajectory", str(d / "chain.txt"), "--loops-file",
                   str(d / "empty.txt"), "--out", str(d / "te.txt"), "--device", "cpu"])
    assert "chain-only smoothing" in capsys.readouterr().out


def test_cli_smooth_trajectory_refuses_mesh(run_files):
    with pytest.raises(SystemExit, match="--mesh"):
        tcli.main(["smooth-trajectory", str(run_files / "chain.txt"), "--mesh", "--huber",
                   "3", "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
@pytest.mark.parametrize("verb", ["close-loops", "smooth-trajectory"])
def test_cli_loop_verbs_refuse_cuda_without_a_gpu(run_files, verb):
    d = run_files
    argv = (["close-loops", str(d / "seq.npz"), str(d / "state.npz"), "--weights", WEIGHTS]
            if verb == "close-loops" else ["smooth-trajectory", str(d / "chain.txt")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(argv)

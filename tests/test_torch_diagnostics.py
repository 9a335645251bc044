"""The port's measurement diagnostics against the JAX package on the CPU:
the UAHN's photometric error map, ``eval-flow``, ``inspect-frame`` and
``track-features``.

The sequence: 7 frames of the procedural ground rendered by the port from
a gentle drift (2 cm, 1 cm and 0.5 cm a frame, a slow yaw), its cameras'
GT poses written as a 17-column state GT. Both packages run the v10
weights with MC dropout off (``dropout_rate = 0``), so that these tests
hold the network and the statistics alone;
``tests/test_torch_dropout_parity.py`` holds ``eval-flow --prior noisy``
at p = 0.05, where the port draws the JAX verb's ``fold_in`` keys.

Tolerances:
- the error map (2 pairs, float frames): within 0.05 levels of JAX's on
  at least 99.9 % of the pixels, its mean within 0.01 levels;
- ``eval-flow`` (4 pairs, prior gt and none): the oracle flow within 1e-4
  px, predictions within 5e-4 px, covariances 1e-4 relative plus 1e-4
  px² (``tests/test_torch_uahn.py``'s), every printed statistic within
  one unit of its last printed digit, the "frames" line equal;
- ``inspect-frame``: the printed flow and covariance diagonal within 2e-3
  (printed to 3 decimals), the mean photometric error within 0.01;
- ``track-features`` (6 frames): ``ids`` and ``valid`` equal to the JAX
  verb's, ``pts`` within 1e-3 px where valid.
"""

import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio.models import uahn as juahn
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.data.synthetic import render_frame
from cuahn_vio_torch.eval.flow import eval_flow, flow_report
from cuahn_vio_torch.eval.simulation import StateGT, save_state_gt
from cuahn_vio_torch.models import uahn as tuahn
from cuahn_vio_torch.ops.quat import quat_exp
from cuahn_vio_torch.utils.checkpoint import load_params
from cuahn_vio_torch.utils.config import VioOptions
from cuahn_vio_torch.utils.png import read_pngs

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
ERR_LEVELS = 0.05
ERR_SHARE = 0.999
ERR_MEAN = 0.01
TRUE_TOL_PX = 1e-4
FLOW_ATOL = 5e-4
COV_ATOL = 1e-4
COV_RTOL = 1e-4
PRINTED_TOL = 2e-3
TRACK_TOL_PX = 1e-3
FRAMES = 7


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """``seq.npz`` (frames, cam_t and a still IMU) and ``seq_state_gt.txt``
    in a temporary directory; returns the directory."""
    opts = VioOptions.uzhfpv_indoor45()
    t = np.asarray(opts.t_imu_to_cam, np.float64)
    c_rot_i = torch.as_tensor(t[:3, :3], dtype=torch.float32)
    i_t_i2c = torch.as_tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32)
    k = np.arange(FRAMES, dtype=np.float32)[:, None]
    p = np.array([0.1, -0.2, 1.6], np.float32) + k * np.array([0.02, 0.01, 0.005], np.float32)
    q = quat_exp(torch.as_tensor(k * np.array([0.01, -0.005, 0.02], np.float32))).numpy()
    tex = torch.as_tensor(ttex.texture_u8(ttex.quantize_u8(
        np.stack(ttex._procedural_extras(ttex.TEXTURE_SIZE)))[5]))
    frames = np.stack([
        np.round(np.clip(render_frame(torch.as_tensor(p[i]), torch.as_tensor(q[i]), c_rot_i,
                                      i_t_i2c, None, 224, 320, tex,
                                      ttex.default_tex_params(4.0)).numpy(), 0, 1) * 255)
        for i in range(FRAMES)]).astype(np.uint8)
    cam_t = 10.0 + np.arange(FRAMES) / 30.0
    d = tmp_path_factory.mktemp("diag")
    np.savez(d / "seq.npz", frames=frames, cam_t=cam_t, imu_t=cam_t,
             imu_w=np.zeros((FRAMES, 3)), imu_a=np.zeros((FRAMES, 3)))
    save_state_gt(str(d / "seq_state_gt.txt"), StateGT(
        times=cam_t, pose=np.concatenate([p, q[:, [1, 2, 3, 0]]], 1),
        vel=np.zeros((FRAMES, 3)), bg=np.zeros((FRAMES, 3)), ba=np.zeros((FRAMES, 3))))
    return d


@pytest.fixture(scope="module")
def torch_model():
    return tuahn.build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)


@pytest.fixture(scope="module")
def jax_params():
    from flax import serialization

    with open(WEIGHTS, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture
def no_dropout(monkeypatch):
    """Both CLIs' UAHNs with dropout off, so that their outputs compare."""
    init = juahn.init_uahn
    monkeypatch.setattr(juahn, "init_uahn", lambda *a, **k: (
        lambda mp: (mp[0].clone(dropout_rate=0.0), mp[1]))(init(*a, **k)))
    build = tuahn.build_uahn
    monkeypatch.setattr(tuahn, "build_uahn",
                        lambda *a, **k: build(*a, **dict(k, dropout_rate=0.0)))


def _numbers(line: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", line)]


def _assert_same_printed(got: list[str], want: list[str]):
    """Lines of the same words; each number within one unit of its last
    printed digit."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert re.sub(r"[-\d.]+", "#", g) == re.sub(r"[-\d.]+", "#", w), (g, w)
        for x, y, text in zip(_numbers(g), _numbers(w), re.findall(r"-?\d+\.?\d*", w)):
            unit = 10.0 ** -(len(text.split(".")[1]) if "." in text else 0)
            assert abs(x - y) <= unit * 1.0001, (g, w)


def test_error_map_matches_jax(sequence, torch_model, jax_params):
    frames = np.load(sequence / "seq.npz")["frames"]
    imgs = frames[[1, 4, 2, 5]].astype(np.float32) / 255.0  # pairs (1, 2) and (4, 5)
    model = juahn.UAHN(dropout_rate=0.0)

    @jax.jit
    @partial(jax.vmap, in_axes=(0, 0))
    def jax_map(a, b):
        return model.apply({"params": jax_params}, a, b, None, use_prior=False,
                           return_error_map=True, rngs={"dropout": jax.random.PRNGKey(0)})

    jf, jc, jmap = (np.asarray(x) for x in jax_map(jnp.asarray(imgs[:2]), jnp.asarray(imgs[2:])))
    f, c, err = torch_model(torch.as_tensor(imgs[:2]), torch.as_tensor(imgs[2:]), None,
                            use_prior=False, return_error_map=True)
    assert err.shape == (2, 224, 320) and err.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), jf, atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), jc, atol=COV_ATOL, rtol=COV_RTOL)
    diff = np.abs(err.numpy() - jmap)
    assert (diff <= ERR_LEVELS).mean() >= ERR_SHARE, diff.max()
    assert abs(err.numpy().mean() - jmap.mean()) <= ERR_MEAN
    # without the flag: the two outputs of the main path, unchanged
    f2, c2 = torch_model(torch.as_tensor(imgs[:2]), torch.as_tensor(imgs[2:]), None,
                         use_prior=False)
    assert torch.equal(f2, f) and torch.equal(c2, c)


@pytest.mark.parametrize("prior", ["gt", "none"])
def test_eval_flow_matches_the_jax_verb(sequence, torch_model, no_dropout, prior, capsys,
                                        monkeypatch):
    monkeypatch.chdir(sequence)
    jcli.main(["eval-flow", "seq.npz", "seq_state_gt.txt", "--weights", WEIGHTS, "--prior",
               prior, "--limit", "4", "--batch", "3", "--out", f"jax_{prior}.npz"])
    want_lines = capsys.readouterr().out.splitlines()[:-1]  # less "wrote ..."
    want = np.load(f"jax_{prior}.npz")
    d = np.load("seq.npz")
    opts = VioOptions.uzhfpv_indoor45()
    fp = opts.filter_params("cpu")
    from cuahn_vio_torch.eval.simulation import load_state_gt

    gt = load_state_gt("seq_state_gt.txt")
    ev = eval_flow(d["frames"], d["cam_t"], gt.times, gt.pose, fp.c_rot_i, fp.i_t_i2c,
                   torch_model, prior=prior, batch=3, limit=4)
    assert ev.pred.shape == (4, 8) and ev.cov.shape == (4, 8, 8)
    np.testing.assert_allclose(ev.true, want["true"], atol=TRUE_TOL_PX, rtol=0)
    np.testing.assert_allclose(ev.pred, want["pred"], atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(ev.cov, want["cov"], atol=COV_ATOL, rtol=COV_RTOL)
    np.testing.assert_array_equal(ev.times, want["times"])
    lines = flow_report(ev, prior)
    assert lines[0] == want_lines[0] == f"frames: 4, prior={prior}"
    _assert_same_printed(lines[1:-1], want_lines[1:-1])
    # the verb prints the function's lines and writes the JAX verb's npz
    tcli.main(["eval-flow", "seq.npz", "seq_state_gt.txt", "--weights", WEIGHTS, "--prior",
               prior, "--limit", "4", "--batch", "3", "--out", "port.npz", "--device", "cpu"])
    said = capsys.readouterr().out.splitlines()
    assert said[:-1] == lines and said[-1] == "wrote port.npz"
    got = np.load("port.npz")
    assert sorted(got.files) == sorted(want.files)
    assert all(np.array_equal(got[k], v) for k, v in ev._asdict().items())


def test_eval_flow_noisy_prior_draws_from_the_seed(sequence, torch_model):
    d = np.load(sequence / "seq.npz")
    from cuahn_vio_torch.eval.simulation import load_state_gt

    gt = load_state_gt(str(sequence / "seq_state_gt.txt"))
    fp = VioOptions.uzhfpv_indoor45().filter_params("cpu")
    run = partial(eval_flow, d["frames"], d["cam_t"], gt.times, gt.pose, fp.c_rot_i,
                  fp.i_t_i2c, torch_model, limit=4)
    a, b, c = run(prior="noisy", seed=3), run(prior="noisy", seed=3), run(prior="noisy", seed=4)
    clean = run(prior="gt")
    assert np.array_equal(a.pred, b.pred) and not np.array_equal(a.pred, c.pred)
    assert not np.array_equal(a.pred, clean.pred)
    with pytest.raises(ValueError, match="prior"):
        run(prior="oracle")


def test_inspect_frame_matches_the_jax_verb(sequence, no_dropout, capsys, monkeypatch):
    pytest.importorskip("matplotlib")  # the JAX verb draws its figure with it
    monkeypatch.chdir(sequence)
    jcli.main(["inspect-frame", "seq.npz", "--frame", "2", "--weights", WEIGHTS, "--out",
               "jax.png"])
    want = capsys.readouterr().out.splitlines()
    tcli.main(["inspect-frame", "seq.npz", "--frame", "2", "--weights", WEIGHTS, "--out",
               "port.png", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == 3 and got[2].startswith("wrote port.png (mean photometric err ")
    for g, w in zip(got[:2], want[:2]):
        assert g.split(":")[0] == w.split(":")[0]
        np.testing.assert_allclose(_numbers(g.split(":", 1)[1]), _numbers(w.split(":", 1)[1]),
                                   atol=PRINTED_TOL, rtol=0)
    mean = lambda line: float(line.rsplit(" ", 1)[1].rstrip(")"))  # noqa: E731
    assert abs(mean(got[2]) - mean(want[2])) <= ERR_MEAN + 0.005
    panels = read_pngs(["port.png"])[0]
    frames = np.load("seq.npz")["frames"]
    assert panels.shape == (224, 960)
    assert np.array_equal(panels[:, :320], frames[2]) and np.array_equal(panels[:, 320:640],
                                                                          frames[3])
    assert abs(panels[:, 640:].mean() - mean(got[2])) <= 0.5  # the rounded map


def test_track_features_matches_the_jax_verb(sequence, capsys, monkeypatch):
    monkeypatch.chdir(sequence)
    jcli.main(["track-features", "seq.npz", "--out", "jax_tracks.npz", "--max-frames", "6"])
    want_lines = capsys.readouterr().out.splitlines()
    tcli.main(["track-features", "seq.npz", "--out", "tracks.npz", "--max-frames", "6",
               "--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    strip = lambda line: re.sub(r"[\d.]+ ms/frame", "", line)  # noqa: E731
    assert [strip(x) for x in got_lines] == [strip(x.replace("jax_tracks", "tracks"))
                                             for x in want_lines]
    got, want = np.load("tracks.npz"), np.load("jax_tracks.npz")
    assert sorted(got.files) == sorted(want.files) == ["ids", "pts", "times", "valid"]
    assert got["pts"].shape == (6, 80, 2) and got["ids"].dtype == want["ids"].dtype
    assert np.array_equal(got["ids"], want["ids"]) and np.array_equal(got["valid"],
                                                                      want["valid"])
    assert np.array_equal(got["times"], want["times"])
    v = got["valid"]
    np.testing.assert_allclose(got["pts"][v], want["pts"][v], atol=TRACK_TOL_PX, rtol=0)
    assert (np.diff(got["ids"], axis=0) >= 0).all()

"""The port's sparse-vision front end (``cuahn_vio_torch.vision``) against
the JAX package's on the CPU, on the same numpy inputs.

The frames are ``tests/test_vision.py``'s: a straight-down camera over the
procedural ground, rendered by the JAX ``render_frame`` and fed to both.
The JAX package's own cases run through the port too.

Tolerances:
- ``shi_tomasi_score``: 1e-6 of the image's largest score (XLA's and
  oneDNN's convolutions round differently); ``build_pyramid`` 1e-6 (the
  means' summation order);
- ``grid_detect``: best scores within 1e-6 of the largest score, and the
  same pixel in every cell except at a near-tie: a cell whose port pick
  differs must score, under the JAX scores, within that tolerance of the
  JAX maximum; ``valid`` equal where the picks agree;
- ``track_pyramidal``: ``valid`` equal, except where JAX's residual or
  determinant lies within 1e-5 of its threshold; ``pts2`` within 1e-3 px
  where both are valid;
- ``triangulate_nview``: positions within 1e-4 m (relative 1e-5 beyond
  1 m), ``ok`` equal;
- ``preintegrate``: ``dq``, ``dv``, ``dp`` within 1e-5, the Jacobians
  within 1e-4 of their largest entry; ``predict_from_factor`` within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.data.synthetic import render_frame
from cuahn_vio.ops.quat import quat_exp as jquat_exp
from cuahn_vio.ops.quat import quat_to_rot as jquat_to_rot
from cuahn_vio.vision import detect as jdetect
from cuahn_vio.vision import klt as jklt
from cuahn_vio.vision import preint as jpreint
from cuahn_vio.vision import triangulate as jtri
from cuahn_vio_torch import vision as tvision
from cuahn_vio_torch.vision import detect as tdetect
from cuahn_vio_torch.vision import klt as tklt
from cuahn_vio_torch.vision import preint as tpreint
from cuahn_vio_torch.vision import triangulate as ttri

torch.set_num_threads(2)

SCORE_RTOL = 1e-6
THRESH_TOL = 1e-5
PTS_TOL_PX = 1e-3
POS_TOL_M = 1e-4
PREINT_TOL = 1e-5
JAC_RTOL = 1e-4
PREDICT_TOL = 1e-4

DOWN_EXTR = (jnp.diag(jnp.array([1.0, -1.0, -1.0])), jnp.zeros(3))


def _down_cam_frames(dp, key=0):
    """``tests/test_vision.py``'s two frames: the textured ground plane
    from a straight-down camera displaced by dp (world) between them."""
    c_rot_i, i_t_i2c = DOWN_EXTR
    p1 = jnp.array([0.0, 0.0, 1.5])
    q = jnp.array([1.0, 0.0, 0.0, 0.0])
    img1 = render_frame(p1, q, c_rot_i, i_t_i2c, jax.random.PRNGKey(key))
    img2 = render_frame(p1 + jnp.array(dp), q, c_rot_i, i_t_i2c, jax.random.PRNGKey(key))
    return np.array(img1), np.array(img2)


def _t(x):
    return torch.as_tensor(np.array(x))


def assert_same_picks(got, want, want_score_map, grid_x=10, ch=28, cw=32):
    """``grid_detect`` outputs (pts, valid, best) of the port against JAX's:
    best within SCORE_RTOL of the largest score; a differing pick only at a
    near-tie (its JAX score within that tolerance of the cell maximum)."""
    pts, valid, best = (np.asarray(x) for x in got)
    jpts, jvalid, jbest = (np.asarray(x) for x in want)
    tol = SCORE_RTOL * float(np.max(want_score_map))
    np.testing.assert_allclose(best, jbest, atol=tol, rtol=0)
    differ = np.any(pts != jpts, axis=1)
    for g in np.flatnonzero(differ):
        u, v = pts[g].astype(int)
        assert (v // ch) * grid_x + (u // cw) == g  # still inside its own cell
        assert want_score_map[v, u] >= jbest[g] - tol, (g, pts[g], jpts[g])
    assert np.array_equal(valid[~differ], jvalid[~differ])
    return int(differ.sum())


def test_port_exports_the_jax_names():
    import cuahn_vio.vision as jvision

    assert sorted(tvision.__all__) == sorted(jvision.__all__)


def test_shi_tomasi_matches_jax():
    img1, _ = _down_cam_frames([0.0, 0.0, 0.0])
    corner = np.zeros((64, 64), np.float32)
    corner[32:, 32:] = 1.0
    for img in (img1, corner):
        want = np.asarray(jdetect.shi_tomasi_score(jnp.asarray(img)))
        got = tdetect.shi_tomasi_score(_t(img)).numpy()
        np.testing.assert_allclose(got, want, atol=SCORE_RTOL * want.max(), rtol=0)
    # a batch is its images one by one
    both = tdetect.shi_tomasi_score(_t(np.stack([img1, img1[::-1].copy()])))
    assert torch.equal(both[0], tdetect.shi_tomasi_score(_t(img1)))


def test_shi_tomasi_peaks_on_corner():
    img = torch.zeros((64, 64))
    img[32:, 32:] = 1.0
    score = tdetect.shi_tomasi_score(img)
    v, u = np.unravel_index(int(torch.argmax(score)), score.shape)
    assert abs(v - 32) <= 3 and abs(u - 32) <= 3
    assert float(score[10, 10]) < 1e-6
    assert float(score[10, 40]) < float(score[v, u]) * 0.2


@pytest.mark.parametrize("border", [8, 24])
def test_grid_detect_matches_jax(border):
    img1, img2 = _down_cam_frames([0.06, 0.04, 0.0])
    for img in (img1, img2):
        want = jdetect.grid_detect(jnp.asarray(img), grid_y=8, grid_x=10, border=border)
        got = tdetect.grid_detect(_t(img), grid_y=8, grid_x=10, border=border)
        assert got[0].shape == (80, 2) and got[1].dtype == torch.bool
        score_map = np.asarray(jdetect.shi_tomasi_score(jnp.asarray(img)))
        assert_same_picks(got, want, score_map)
    # a batch is its images one by one
    batch = tdetect.grid_detect(_t(np.stack([img1, img2])), border=border)
    for k, img in enumerate((img1, img2)):
        one = tdetect.grid_detect(_t(img), border=border)
        assert all(torch.equal(b[k], o) for b, o in zip(batch, one))


def test_grid_detect_shapes_and_spread():
    img1, _ = _down_cam_frames([0.0, 0.0, 0.0])
    pts, valid, _ = tdetect.grid_detect(_t(img1), grid_y=8, grid_x=10)
    assert pts.shape == (80, 2) and valid.shape == (80,)
    assert int(valid.sum()) > 40
    cell = (pts[:, 1] // 28).long() * 10 + (pts[:, 0] // 32).long()
    assert torch.equal(cell[valid], torch.nonzero(valid)[:, 0])


def test_grid_detect_first_maximum_on_exact_ties():
    """A flat image ties every pixel: both take each cell's first pixel."""
    img = np.full((56, 64), 0.5, np.float32)
    want = jdetect.grid_detect(jnp.asarray(img), grid_y=2, grid_x=2, border=0)
    got = tdetect.grid_detect(_t(img), grid_y=2, grid_x=2, border=0)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_build_pyramid_matches_jax():
    img1, _ = _down_cam_frames([0.0, 0.0, 0.0])
    for got, want in zip(tklt.build_pyramid(_t(img1)), jklt.build_pyramid(jnp.asarray(img1))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_bilinear_matches_jax_at_every_kind_of_coordinate():
    rng = np.random.default_rng(0)
    img = rng.random((24, 32)).astype(np.float32)
    u = np.concatenate([rng.uniform(-3, 35, 200), [0, 31, 31.5, -0.5, -1, 32, -2.5, 1e9,
                                                    -1e9, 3e38]]).astype(np.float32)
    v = np.concatenate([rng.uniform(-3, 27, 200), [0, 23, 5, 5, 5, 5, 5, 5, 5, 5]])
    v = v.astype(np.float32)
    want = np.asarray(jklt._bilinear(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    got = tklt._bilinear(_t(img), _t(u), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # an infinite or NaN coordinate gives NaN in both
    for bad in (np.inf, -np.inf, np.nan):
        uu = np.array([bad, 3.0], np.float32)
        vv = np.array([3.0, bad], np.float32)
        assert np.isnan(tklt._bilinear(_t(img), _t(uu), _t(vv)).numpy()).all()
        assert np.isnan(np.asarray(jklt._bilinear(jnp.asarray(img), jnp.asarray(uu),
                                                  jnp.asarray(vv)))).all()


def assert_same_tracks(got, want, stats):
    """``track_pyramidal`` (pts2, valid) of the port against JAX's:
    ``valid`` equal except where the port's residual or determinant lies
    within THRESH_TOL of its threshold, pts2 within PTS_TOL_PX where both
    are valid. Returns the number of near-threshold disagreements."""
    pts2, valid = (np.asarray(x) for x in got)
    jpts2, jvalid = (np.asarray(x) for x in want)
    near = (np.abs(np.asarray(stats["residual"]) - 0.08) < THRESH_TOL) | np.any(
        np.abs(np.asarray(stats["det"]) - 1e-8) < THRESH_TOL, axis=0)
    differ = valid != jvalid
    assert not np.any(differ & ~near), np.flatnonzero(differ & ~near)
    both = valid & jvalid
    np.testing.assert_allclose(pts2[both], jpts2[both], atol=PTS_TOL_PX, rtol=0)
    return int(differ.sum())


@pytest.mark.parametrize("dp", [[0.02, -0.015, 0.0], [0.06, 0.04, 0.0]])
def test_klt_matches_jax(dp):
    img1, img2 = _down_cam_frames(dp)
    pts, valid, _ = jdetect.grid_detect(jnp.asarray(img1), grid_y=8, grid_x=10, border=24)
    want = jklt.track_pyramidal(jnp.asarray(img1), jnp.asarray(img2), pts)
    pts2, ok, stats = tklt.track_pyramidal(_t(img1), _t(img2), _t(pts), with_stats=True)
    assert_same_tracks((pts2, ok), want, stats)
    assert stats["det"].shape == (3, 80) and stats["residual"].shape == (80,)
    # the JAX package's check: the known uniform ground flow
    okv = (ok.numpy() & np.asarray(valid))
    assert okv.sum() > 30
    flow = (pts2.numpy() - np.asarray(pts))[okv]
    f, h = 159.5, 1.5
    expect = np.array([-f * dp[0] / h, f * dp[1] / h])
    assert np.median(np.linalg.norm(flow - expect, axis=1)) < 0.35


def test_klt_flags_bad_tracks_as_jax():
    """``tests/test_vision.py``'s flat patch, plus tracks that diverge or
    start off the image, NaN or infinite: the same ``valid`` as JAX."""
    img1, img2 = _down_cam_frames([0.02, 0.0, 0.0])
    img1[:64, :64] = 0.5
    img2[:64, :64] = 0.5
    pts = np.array([[32.0, 32.0], [160.0, 112.0], [-500.0, 40.0], [1e9, 1e9],
                    [np.nan, 100.0], [np.inf, 50.0], [318.0, 222.0], [3.0, 3.0]], np.float32)
    want = jklt.track_pyramidal(jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(pts))
    got = tklt.track_pyramidal(_t(img1), _t(img2), _t(pts))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert not bool(got[1][0]) and bool(got[1][1])  # flat patch; textured point


def _views(rng, n_feat, m):
    """(bearings, rot_c2a, p_cia, true points) of n_feat features seen from
    m cameras near the origin with small random attitude, looking +z."""
    p_true = rng.normal(size=(n_feat, 3)) * [0.5, 0.5, 0.3] + [0, 0, 2.0]
    rots = np.asarray(jquat_to_rot(jquat_exp(jnp.asarray(rng.normal(size=(n_feat, m, 3))
                                                         * 0.05, jnp.float32))))
    pos = rng.normal(size=(n_feat, m, 3)) * np.array([0.4, 0.4, 0.05])
    pf_c = np.einsum("fmji,fmj->fmi", rots, p_true[:, None] - pos)
    bear = pf_c / np.linalg.norm(pf_c, axis=-1, keepdims=True)
    return (bear.astype(np.float32), rots.astype(np.float32), pos.astype(np.float32),
            p_true)


def test_triangulate_matches_jax():
    rng = np.random.default_rng(3)
    bear, rots, pos, p_true = _views(rng, 16, 6)
    valid = np.ones((16, 6), bool)
    valid[1, 1:] = False  # one view only: not ok
    valid[2, 3:] = False  # three views
    bear[3] = [0.0, 0.0, 1.0]  # the same ray from every view: ill-conditioned
    pos[3] = 0.0
    rots[3] = np.eye(3)
    want_p, want_ok = jax.vmap(jtri.triangulate_nview)(*(jnp.asarray(x) for x in
                                                         (bear, rots, pos, valid)))
    got_p, got_ok = ttri.triangulate_nview(_t(bear), _t(rots), _t(pos), _t(valid))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not got_ok[1] and not got_ok[3] and got_ok[0] and got_ok[2]
    ok = got_ok.numpy()
    want_p = np.asarray(want_p)
    np.testing.assert_allclose(got_p.numpy()[ok], want_p[ok],
                               atol=POS_TOL_M, rtol=1e-5)
    np.testing.assert_allclose(got_p.numpy()[ok], p_true[ok], atol=2e-3)


def test_triangulate_rejects_single_view():
    b = torch.tensor([[[0.0, 0.0, 1.0]] * 4])
    r = torch.eye(3).expand(1, 4, 3, 3)
    p = torch.zeros((1, 4, 3))
    valid = torch.tensor([[True, False, False, False]])
    _, ok = ttri.triangulate_nview(b, r, p, valid)
    assert not bool(ok[0])


def _imu(rng, t, pad=0):
    dt = np.concatenate([np.full(t, 0.0025), np.zeros(pad)]).astype(np.float32)
    w = (rng.normal(size=(t + pad, 3)) * 0.4).astype(np.float32)
    a = (rng.normal(size=(t + pad, 3)) + [0.1, -0.2, 9.81]).astype(np.float32)
    return w, a, dt


def assert_same_factor(got, want):
    for name in ("dq", "dv", "dp", "dt"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=PREINT_TOL, rtol=0, err_msg=name)
    for name in ("j_q_bg", "j_v_bg", "j_v_ba", "j_p_bg", "j_p_ba"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w,
                                   atol=JAC_RTOL * max(np.abs(w).max(), 1e-6), rtol=0,
                                   err_msg=name)


def test_preintegrate_matches_jax(rng):
    w, a, dt = _imu(rng, 40)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.02, -0.04], np.float32)
    want = jpreint.preintegrate(*(jnp.asarray(x) for x in (w, a, dt, bg, ba)))
    got = tpreint.preintegrate(*(_t(x) for x in (w, a, dt, bg, ba)))
    assert type(got).__name__ == "PreintFactor" and got._fields == want._fields
    assert_same_factor(got, want)
    q0 = np.asarray(jquat_exp(jnp.asarray(rng.normal(size=3) * 0.3, jnp.float32)))
    p0 = np.array([1.0, 2.0, 1.5], np.float32)
    v0 = np.array([0.3, -0.1, 0.2], np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    dbg = np.array([0.004, -0.003, 0.002], np.float32)
    dba = np.array([0.02, 0.01, -0.015], np.float32)
    for extra in ((), (dbg, dba)):
        want_end = jpreint.predict_from_factor(want, *(jnp.asarray(x) for x in
                                                      (q0, p0, v0, g, *extra)))
        got_end = tpreint.predict_from_factor(got, *(_t(x) for x in (q0, p0, v0, g, *extra)))
        for x, y in zip(got_end, want_end):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=PREDICT_TOL, rtol=0)


def test_preintegrate_batch_is_its_windows(rng):
    """A (B, T) batch gives each window's factor (within the tolerance:
    the batch's products round differently); padding rows (dt == 0) change
    nothing, bit for bit, as in the JAX function."""
    w, a, dt = _imu(rng, 20, pad=12)
    w2, a2, dt2 = _imu(rng, 32)
    zeros = np.zeros(3, np.float32)
    batch = tpreint.preintegrate(_t(np.stack([w, w2])), _t(np.stack([a, a2])),
                                 _t(np.stack([dt, dt2])), _t(np.zeros((2, 3), np.float32)),
                                 _t(np.zeros((2, 3), np.float32)))
    for k, (ww, aa, dd) in enumerate(((w, a, dt), (w2, a2, dt2))):
        want = jpreint.preintegrate(*(jnp.asarray(x) for x in (ww, aa, dd, zeros, zeros)))
        assert_same_factor(tpreint.PreintFactor(*(f[k] for f in batch)), want)
    padded = tpreint.preintegrate(_t(w), _t(a), _t(dt), _t(zeros), _t(zeros))
    cut = tpreint.preintegrate(_t(w[:20]), _t(a[:20]), _t(dt[:20]), _t(zeros), _t(zeros))
    for name in ("dq", "dv", "dp"):
        assert torch.equal(getattr(padded, name), getattr(cut, name)), name


def test_preintegration_bias_jacobians(rng):
    """First-order bias correction tracks re-integration with shifted bias
    (``tests/test_vision.py``'s case)."""
    w, a, dt = _imu(rng, 30)
    zeros = torch.zeros(3)
    f0 = tpreint.preintegrate(_t(w), _t(a), _t(dt), zeros, zeros)
    dbg = torch.tensor([0.004, -0.003, 0.002])
    dba = torch.tensor([0.02, 0.01, -0.015])
    f1 = tpreint.preintegrate(_t(w), _t(a), _t(dt), dbg, dba)
    dv_corr = f0.dv + f0.j_v_bg @ dbg + f0.j_v_ba @ dba
    dp_corr = f0.dp + f0.j_p_bg @ dbg + f0.j_p_ba @ dba
    np.testing.assert_allclose(dv_corr.numpy(), f1.dv.numpy(), atol=5e-5)
    np.testing.assert_allclose(dp_corr.numpy(), f1.dp.numpy(), atol=5e-5)

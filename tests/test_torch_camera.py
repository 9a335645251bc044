"""The port's camera models (``cuahn_vio_torch.vision.camera``) against the
JAX package's (``cuahn_vio.vision.camera``) on the same seeded points, in
float32 on the CPU.

Tolerances: distort 1e-3 px on ~300-600 px values (a few float32 ulps:
XLA may contract the polynomials into fmas, torch does not); undistort
2e-6 in normalized coords after 20 fixed-point iterations; the Jacobians
1e-4 relative. The round trip holds to 2e-5, as the JAX test's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from cuahn_vio.vision import camera as jcam
from cuahn_vio_torch.vision import camera as tcam

# the JAX package's test calibrations (tests/test_camera.py)
FISHEYE_CALIB = np.array(
    [275.46015578667294, 274.9948095922592, 315.958384100568,
     242.7123497822731, -6.545154718304953e-06, -0.010379525898159981,
     0.014935312423953146, -0.005639061406567785], np.float64
)
RADTAN_CALIB = np.array(
    [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907,
     0.00019359, 1.76187114e-05], np.float64
)
MODELS = pytest.mark.parametrize("calib, fisheye", [(RADTAN_CALIB, False), (FISHEYE_CALIB, True)],
                                 ids=["radtan", "equidistant"])


def _points(rng, n=257):
    pts = rng.uniform(-0.7, 0.7, (n, 2)).astype(np.float32)
    pts[0] = 0.0  # on the optical axis
    pts[1] = [3e-9, 0.0]  # inside the axis branch
    pts[2] = [2e-8, 0.0]  # just outside it
    return pts


@MODELS
def test_distort_and_undistort_match_jax(calib, fisheye, rng):
    cal32 = calib.astype(np.float32)
    pts = _points(rng)
    want = np.asarray(jax.vmap(lambda p: jcam.distort(p, jnp.asarray(cal32), fisheye))(
        jnp.asarray(pts)))
    got = tcam.distort(torch.as_tensor(pts), torch.as_tensor(cal32), fisheye).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    raw = want + rng.normal(0, 2.0, want.shape).astype(np.float32)
    raw[0] = cal32[2:4]  # exactly the principal point
    back_j = np.asarray(jcam.undistort_points(jnp.asarray(raw), jnp.asarray(cal32), fisheye))
    back_t = tcam.undistort_points(torch.as_tensor(raw), torch.as_tensor(cal32), fisheye).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=2e-6, rtol=0)
    assert np.isfinite(back_t).all()
    # points of any leading shape
    grid = torch.as_tensor(raw[:256].reshape(4, 64, 2))
    np.testing.assert_array_equal(tcam.undistort(grid, torch.as_tensor(cal32), fisheye).numpy(),
                                  back_t[:256].reshape(4, 64, 2))


@MODELS
def test_roundtrip(calib, fisheye, rng):
    cal = torch.as_tensor(calib.astype(np.float32))
    uv = torch.as_tensor(rng.uniform(-0.7, 0.7, (64, 2)).astype(np.float32))
    back = tcam.undistort_points(tcam.distort(uv, cal, fisheye), cal, fisheye)
    np.testing.assert_allclose(back.numpy(), uv.numpy(), atol=2e-5)


@MODELS
@pytest.mark.parametrize("point", [[0.31, -0.22], [0.0, 0.0], [3e-9, -1e-9]],
                         ids=["off-axis", "on-axis", "inside-axis-branch"])
def test_distort_jacobian_matches_jax(calib, fisheye, point):
    cal32 = calib.astype(np.float32)
    pt = np.array(point, np.float32)
    j_zn, j_zeta = jcam.distort_jacobian(jnp.asarray(pt), jnp.asarray(cal32), fisheye)
    t_zn, t_zeta = tcam.distort_jacobian(torch.as_tensor(pt), torch.as_tensor(cal32), fisheye)
    assert t_zn.shape == (2, 2) and t_zeta.shape == (2, 8)
    for got, want in ((t_zn, j_zn), (t_zeta, j_zeta)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("fisheye", [False, True], ids=["radtan", "equidistant"])
def test_no_nan_reaches_a_reverse_gradient_on_the_axis(fisheye):
    """The double where keeps the axis branch's 0/0 out of reverse-mode
    gradients too (a single where would pass 0 * inf = NaN back)."""
    cal = torch.as_tensor(FISHEYE_CALIB.astype(np.float32) if fisheye
                          else RADTAN_CALIB.astype(np.float32))
    for pt in ([0.0, 0.0], [cal[2].item(), cal[3].item()]):
        p = torch.tensor(pt, dtype=torch.float32)
        fwd = jacrev(lambda x: tcam.distort(x, cal, fisheye))(p * 0)
        inv = jacrev(lambda x: tcam.undistort(x, cal, fisheye))(p)
        assert torch.isfinite(fwd).all() and torch.isfinite(inv).all()

"""The port's motion-blurred render and the batched texture sampler against
cuahn_vio on the CPU.

Tolerances:
- ``render_frame_blurred`` (3 taps) vs the JAX ``render_frame_blurred``,
  on the photo ground and on the procedural ground fed JAX's own draws:
  the sharp-render tests' bound on uint8 levels (truncated as the
  renderers do: within one level, apart on under 0.1 % of the pixels) and
  1e-4 absolute on the float32 image (the float32 ray geometry of two
  frameworks, ~1e-7 relative, times the texture's gradient; measured
  1.4e-5 on the photo ground).
- blurred ``make_sequence`` vs the JAX one (``exposure_s`` = 8 ms): IMU,
  times and ground truth as ``test_textured_make_sequence_matches_jax``
  (gyro 1e-6 absolute, accelerometer 1e-6 absolute + 1e-6 relative, GT
  1e-6, times equal); frames within one uint8 level on at least 99.9 % of
  the pixels (both renderers truncate intensity * 255; see
  ``tests/test_torch_textures.py`` for where one-level differences come
  from).
- the batched plain sampler vs ``jax.vmap`` of the Pallas
  ``bilinear_sample_pallas`` in interpret mode over 3 textures: 1e-5
  absolute, NaN exactly where Pallas has NaN (as the unbatched test).
- batched ``sample_plane`` vs ``jax.vmap`` of the JAX ``sample_plane``:
  1e-5 absolute.
- ``make-synthetic --exposure-ms 8`` vs the JAX verb: the files as
  ``test_cli_make_synthetic_matches_jax_cli`` holds them.
- each tap of a blurred render equals its sharp render bit for bit, and
  the blurred frame is their float32 mean: 0.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio.data import synthetic as jsyn
from cuahn_vio.data import textures as jtex
from cuahn_vio.ops.pallas import warp_kernel as wk
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data import synthetic as tsyn
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.warp import bilinear_sample, bilinear_sample_flat
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

TOL = 1e-5
RENDER_TOL = 1e-4
EXPOSURE_S = 0.008
SEQ_KW = dict(duration=0.5, seed=2, sigma_w=0.002, sigma_a=0.02, bias_g=0.003, bias_a=0.02,
              texture_seed=2)


def _levels(img):
    """uint8 levels of a rendered image, truncated as both renderers do."""
    return np.clip(img * np.float32(255.0), 0, 255).astype(np.uint8).astype(int)


def _extrinsics():
    t_ic = np.asarray(VioOptions().t_imu_to_cam, np.float64)
    return t_ic[:3, :3].astype(np.float32), (-t_ic[:3, :3].T @ t_ic[:3, 3]).astype(np.float32)


def _taps(t_end=2.0, exposure_s=EXPOSURE_S):
    """(3, 3) positions and (3, 4) quaternions across an exposure window
    that ends at ``t_end`` seconds into the flight."""
    traj = tsyn.AnalyticTrajectory()
    ts = torch.tensor(np.linspace(t_end - exposure_s, t_end, 3), dtype=torch.float32)
    return (torch.stack([traj.pos_w(t) for t in ts]),
            torch.stack([traj.quat_i2w(t) for t in ts]))


def _jax_draws(seed):
    """The JAX ground_texture's draws for ``seed``, as the port takes them."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (np.asarray(jax.random.uniform(k1, (24, 2), minval=0.5, maxval=14.0)),
            np.asarray(jnp.sign(jax.random.normal(k3, (24, 2)))),
            np.asarray(jax.random.uniform(k2, (24,), minval=0.0, maxval=2 * jnp.pi)))


def _photo():
    tex = ttex.quantize_u8(ttex._procedural_extras(ttex.TEXTURE_SIZE)[7])
    params = np.array([2.5, np.cos(1.1), np.sin(1.1), 0.4, 1.3], np.float32)
    return tex, params


@pytest.mark.parametrize("ground", ["photo", "procedural"])
def test_render_frame_blurred_matches_jax(ground):
    c_rot_i, i_t_i2c = _extrinsics()
    p, q = _taps()
    if ground == "photo":
        tex, params = _photo()
        port_kw = dict(texture=torch.as_tensor(ttex.texture_u8(tex)),
                       tex_params=torch.as_tensor(params))
        jax_kw = dict(texture=jnp.asarray(tex), tex_params=jnp.asarray(params))
        key = None
    else:
        port_kw = dict(waves=[torch.as_tensor(x) for x in _jax_draws(3)])
        jax_kw = {}
        key = jax.random.PRNGKey(3)
    out = tsyn.render_frame_blurred(p, q, torch.as_tensor(c_rot_i), torch.as_tensor(i_t_i2c),
                                    **port_kw).numpy()
    ref = np.asarray(jsyn.render_frame_blurred(
        jnp.asarray(p.numpy()), jnp.asarray(q.numpy()), jnp.asarray(c_rot_i),
        jnp.asarray(i_t_i2c), key, **jax_kw))
    assert out.shape == ref.shape == (224, 320) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=RENDER_TOL, rtol=0)
    # the sharp-render tests' bound on the truncated uint8 levels
    diff = np.abs(_levels(out) - _levels(ref))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_blurred_render_is_the_mean_of_its_sharp_taps_in_one_sampler_call(monkeypatch):
    """The K taps are rendered in one pass, with one sampler call over K x H
    x W points; each tap equals its own ``render_frame`` bit for bit, and
    the frame is their float32 mean (sum / K, as ``jnp.mean``)."""
    c_rot_i, i_t_i2c = (torch.as_tensor(x) for x in _extrinsics())
    p, q = _taps()
    tex, params = _photo()
    kw = dict(texture=torch.as_tensor(ttex.texture_u8(tex)), tex_params=torch.as_tensor(params))
    calls = []

    def spy(texture, su, sv):
        calls.append(tuple(su.shape))
        return bilinear_sample(texture, su, sv)

    monkeypatch.setattr(ttex, "bilinear_sample", spy)
    blurred = tsyn.render_frame_blurred(p, q, c_rot_i, i_t_i2c, **kw)
    assert calls == [(3 * 224 * 320,)]
    taps = tsyn.render_frame(p, q, c_rot_i, i_t_i2c, **kw)
    sharp = torch.stack([tsyn.render_frame(p[k], q[k], c_rot_i, i_t_i2c, **kw)
                         for k in range(3)])
    assert taps.shape == (3, 224, 320) and torch.equal(taps, sharp)
    assert torch.equal(blurred, sharp.sum(dim=0) / 3)


def _blurred_sequences(ground):
    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    if ground == "photo":
        tex, params = _photo()
        kw = dict(texture=tex, tex_params=params)
        port_kw = jax_kw = kw
    else:
        port_kw, jax_kw = dict(texture=_jax_draws(SEQ_KW["texture_seed"])), {}
    ref = jsyn.make_sequence(jsyn.AnalyticTrajectory(), t_ic, exposure_s=EXPOSURE_S,
                             **jax_kw, **SEQ_KW)
    before = dict(tcuda.launch_counts)
    out = tsyn.make_sequence(tsyn.AnalyticTrajectory(), t_ic, exposure_s=EXPOSURE_S,
                             device="cpu", **port_kw, **SEQ_KW)
    assert tcuda.launch_counts == before  # the CPU path launches no kernel
    sharp = tsyn.make_sequence(tsyn.AnalyticTrajectory(), t_ic, device="cpu", **port_kw,
                               **SEQ_KW)
    return out, ref, sharp


@pytest.mark.parametrize("ground", ["photo", "procedural"])
def test_blurred_make_sequence_matches_jax(ground):
    out, ref, sharp = _blurred_sequences(ground)
    for name in ("imu_t", "cam_t", "gt_times", "true_bg", "true_ba"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(out.imu_w, ref.imu_w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.imu_a, ref.imu_a, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out.gt_pose_w, ref.gt_pose_w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.gt_vel_w, ref.gt_vel_w, atol=1e-6, rtol=0)
    assert out.frames.shape == ref.frames.shape and out.frames.dtype == np.uint8
    diff = np.abs(out.frames.astype(int) - ref.frames.astype(int))
    assert (diff <= 1).mean() >= 0.999
    # the blur is really applied: the sharp sequence's frames differ
    moved = np.abs(sharp.frames.astype(int) - out.frames.astype(int))
    assert (moved > 1).mean() > 0.01
    assert np.array_equal(sharp.imu_w, out.imu_w) and np.array_equal(sharp.cam_t, out.cam_t)


@pytest.mark.parametrize("exact_u8", [True, False])
def test_batched_sampler_matches_vmapped_pallas(exact_u8):
    """(B, H, W) images, each at its own row of (B, N) coordinates, against
    ``jax.vmap`` of the Pallas kernel over a batch of images; each row also
    equals the unbatched plain sampler on its image."""
    rng = np.random.default_rng(8)
    b, hgt, wid, n = 3, 40, 56, 500
    if exact_u8:
        img_u8 = rng.integers(0, 256, (b, hgt, wid)).astype(np.uint8)
        img_j, img_t = img_u8.astype(np.float32) / 255.0, img_u8
    else:
        img_j = img_t = rng.random((b, hgt, wid)).astype(np.float32)
    su = rng.uniform(-2.0, wid + 1.0, (b, n)).astype(np.float32)
    sv = rng.uniform(-2.0, hgt + 1.0, (b, n)).astype(np.float32)
    su[0, :4] = [np.inf, -np.inf, np.nan, 1e5]
    sv[2, -3:] = [np.nan, -np.inf, 3.0]
    ref = np.asarray(jax.vmap(lambda i, u, v: wk.bilinear_sample_pallas(
        i, u, v, interpret=True, exact_u8=exact_u8))(
        jnp.asarray(img_j), jnp.asarray(su), jnp.asarray(sv)))
    img_t, su_t, sv_t = (torch.as_tensor(x) for x in (img_t, su, sv))
    out = bilinear_sample(img_t, su_t, sv_t)
    assert out.shape == (b, n)
    out = out.numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out).sum() == 2
    finite = ~np.isnan(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=TOL, rtol=0)
    for k in range(b):
        row = bilinear_sample_flat(img_t[k], su_t[k], sv_t[k]).numpy()
        np.testing.assert_array_equal(row, out[k])


def test_batched_sampler_rejects_mismatched_batches():
    img = torch.zeros((3, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"\(B, N\) with B=3"):
        bilinear_sample_flat(img, torch.zeros((2, 5)), torch.zeros((2, 5)))
    with pytest.raises(ValueError):
        bilinear_sample_flat(img, torch.zeros((3, 5)), torch.zeros((3, 4)))
    with pytest.raises(ValueError):
        bilinear_sample_flat(img[None], torch.zeros((1, 3, 5)), torch.zeros((1, 3, 5)))


def test_batched_sample_plane_matches_vmapped_jax():
    """The JAX trainer's ``vmap`` of ``sample_plane`` (one bank texture,
    its own points and its own random transform per sample), written out
    as the port's batch dim."""
    extras = ttex._procedural_extras(ttex.TEXTURE_SIZE)
    tex = np.stack([ttex.quantize_u8(extras[i]) for i in (1, 8, 11)])
    rng = np.random.default_rng(9)
    xy = rng.normal(0.0, 3.0, (3, 12, 17, 2)).astype(np.float32)
    th = rng.uniform(0.0, 2 * np.pi, 3)
    params = np.stack([np.exp(rng.uniform(np.log(1.5), np.log(10.0), 3)), np.cos(th),
                       np.sin(th), *rng.uniform(0.0, 2.0, (2, 3))], axis=1).astype(np.float32)
    ref = np.asarray(jax.vmap(jtex.sample_plane)(jnp.asarray(tex), jnp.asarray(xy),
                                                 jnp.asarray(params)))
    tex_u8 = torch.as_tensor(np.stack([ttex.texture_u8(t) for t in tex]))
    out = ttex.sample_plane(tex_u8, torch.as_tensor(xy), torch.as_tensor(params)).numpy()
    assert out.shape == ref.shape == (3, 12, 17)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_cli_make_synthetic_exposure_matches_jax_cli(tmp_path):
    pytest.importorskip("yaml")  # both verbs write _config.yaml
    sharp_flags = ["--texture", "heldout", "--duration", "0.5", "--seed", "4",
                   "--sigma-w", "0.002", "--sigma-a", "0.02", "--bias-g", "0.003"]
    flags = [*sharp_flags, "--exposure-ms", "8"]
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
    # the flag reaches the frames: without it they are sharp
    tcli.main(["make-synthetic", "--device", "cpu", "--out", str(tmp_path / "s.npz"),
               *sharp_flags])
    sharp = np.load(tmp_path / "s.npz")["frames"]
    assert np.abs(sharp.astype(int) - out["frames"].astype(int)).max() > 1


def test_smoke_blurred_coords_are_a_blurred_frames(monkeypatch):
    """``chip_smoke.py`` holds the flat sampler to its plain version, and
    times it, at shape 2: the coordinates that ``render_frame_blurred``
    hands it, in one call, for one frame at ``--exposure-ms 8`` (the poses
    ``make_sequence`` takes for a frame 2 s into the motion)."""
    import chip_smoke

    seen = []

    def spy(texture, su, sv):
        seen.append((su, sv))
        return bilinear_sample(texture, su, sv)

    monkeypatch.setattr(ttex, "bilinear_sample", spy)
    p, q = tsyn.exposure_taps(tsyn.AnalyticTrajectory(), [2.0], chip_smoke.EXPOSURE_S, "cpu")
    tex = torch.zeros((chip_smoke.TEX_SIZE,) * 2, dtype=torch.uint8)
    tsyn.render_frame_blurred(p[0], q[0], *chip_smoke.camera(torch, "cpu"), texture=tex,
                              tex_params=ttex.default_tex_params(chip_smoke.TEX_SCALE_M))
    su, sv = chip_smoke.frame_sample_coords(torch, "cpu", chip_smoke.EXPOSURE_S)
    assert len(seen) == 1 and su.shape == (3 * 224 * 320,)
    assert torch.equal(seen[0][0], su) and torch.equal(seen[0][1], sv)

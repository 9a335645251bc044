"""The port's texture bank, flat sampler (B4's plain version) and textured
``make_sequence`` against cuahn_vio on the CPU.

Tolerances:
- ``bilinear_sample_flat`` vs the Pallas ``bilinear_sample_pallas`` in
  interpret mode (exact_u8 on a uint8-level image, hi/lo on a float32
  one): 1e-5 absolute, NaN exactly where Pallas gives NaN (a NaN
  coordinate), 0 for infinite and off-image coordinates; the two sum the
  same taps in another order.
- the bank and its procedural part: equal bit for bit (the same numpy
  code on the same installed assets); splits and default parameters
  equal.
- ``sample_plane`` vs the JAX ``sample_plane`` (its gather path and its
  interpret-mode Pallas path): 1e-5 absolute (measured ~2.4e-7).
- textured ``make_sequence`` vs the JAX one on the same texture: IMU
  gyro 1e-6 absolute, accelerometer 1e-6 absolute + 1e-6 relative
  (float32 rounding of ~9.8 m/s² specific force in another framework,
  measured 2.9e-6 m/s²), times equal, ground
  truth 1e-6; frames within one uint8 level on at least 99.9 % of the
  pixels. Measured: every pixel within one level; 0.43 % of them one level
  apart (the renderers truncate intensity * 255 to uint8, so a float32
  rounding difference next to an integer level moves a pixel by one). The
  JAX renderer here takes its CPU gather path; the port samples as the JAX
  package's TPU path (Pallas exact_u8) does, and on one rendered frame
  truncates to the same level as that path on all but 0.070 % of the
  pixels (``test_renderer_levels_follow_the_jax_tpu_sampler``).
- the port's sampler vs the JAX package's two samplers on one rendered
  frame's coordinates, levels after truncation: within one level
  everywhere; one level apart from the TPU path on at most 0.1 % of the
  pixels and from the gather path on at least 4x that share (measured:
  0.070 %, the port never the brighter; 0.566 %, the port the brighter on
  0.513 %; the TPU path vs the gather path 0.530 %, the TPU path always
  the brighter).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuahn_vio.data import textures as jtex
from cuahn_vio.data.synthetic import AnalyticTrajectory as JaxTraj
from cuahn_vio.data.synthetic import make_sequence as jax_make_sequence
from cuahn_vio.ops.pallas import warp_kernel as wk
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.warp import bilinear_sample, bilinear_sample_flat
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

TOL = 1e-5


def _coords(rng, hgt, wid, n=600):
    """Flat (su, sv): in-range, edges, off-image, +-inf and NaN."""
    inside = rng.uniform(-0.5, [wid - 0.5, hgt - 0.5], (n, 2)).T
    edge_u = np.array([0.0, wid - 1.0, -1.0, float(wid), -0.999, wid - 0.001, 5.0, 5.0])
    edge_v = np.array([hgt - 1.0, 0.0, 3.0, 3.0, 2.0, 2.0, -1.0, float(hgt)])
    spec_u = np.array([-600.0, 1e5, np.inf, -np.inf, np.nan, 3.0, 2.5, np.inf])
    spec_v = np.array([3.0, 3.0, 4.0, 4.0, 4.0, np.nan, -np.inf, np.nan])
    su = np.concatenate([inside[0], edge_u, spec_u]).astype(np.float32)
    sv = np.concatenate([inside[1], edge_v, spec_v]).astype(np.float32)
    return su, sv


@pytest.mark.parametrize("exact_u8", [True, False])
def test_bilinear_sample_flat_matches_pallas_interpret(exact_u8):
    rng = np.random.default_rng(5)
    hgt, wid = 48, 64
    if exact_u8:
        img_u8 = rng.integers(0, 256, (hgt, wid)).astype(np.uint8)
        img_j, img_t = img_u8.astype(np.float32) / 255.0, img_u8
    else:
        img_j = img_t = rng.random((hgt, wid)).astype(np.float32)
    su, sv = _coords(rng, hgt, wid)
    ref = np.asarray(wk.bilinear_sample_pallas(
        jnp.asarray(img_j), jnp.asarray(su), jnp.asarray(sv),
        interpret=True, exact_u8=exact_u8,
    ))
    before = dict(tcuda.launch_counts)
    out = bilinear_sample(torch.as_tensor(img_t), torch.as_tensor(su), torch.as_tensor(sv))
    assert tcuda.launch_counts == before  # the CPU path launches no kernel
    out = out.numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out).sum() == 3
    finite = ~np.isnan(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=TOL, rtol=0)
    assert (out[-8:-4] == 0.0).all()  # off-image and infinite coordinates: 0


def test_flat_sampler_rejects_what_it_does_not_take():
    img = torch.zeros((4, 4), dtype=torch.uint8)
    su = torch.zeros(3)
    with pytest.raises(ValueError):
        bilinear_sample_flat(img[None], su, su)
    with pytest.raises(ValueError):
        bilinear_sample_flat(img, su, torch.zeros(2))
    with pytest.raises(TypeError):
        bilinear_sample_flat(img.half(), su, su)
    with pytest.raises(TypeError):
        bilinear_sample_flat(img, su.double(), su.double())


def test_texture_bank_equals_jax_bank():
    extras_t = ttex._procedural_extras(ttex.TEXTURE_SIZE)
    extras_j = jtex._procedural_extras(jtex.TEXTURE_SIZE)
    assert len(extras_t) == len(extras_j) == 12
    for a, b in zip(extras_t, extras_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bank_t = ttex.build_texture_bank()
    bank_j = jtex.build_texture_bank()
    assert bank_t.dtype == bank_j.dtype == np.float32
    assert bank_t.shape == bank_j.shape and np.array_equal(bank_t, bank_j)
    # every entry is at uint8 levels, so the sampler can read raw levels
    levels = ttex.texture_u8(bank_t[0])
    assert levels.dtype == np.uint8 and np.array_equal(levels / np.float32(255.0), bank_t[0])


def test_texture_u8_refuses_a_texture_off_uint8_levels():
    with pytest.raises(ValueError, match="uint8 levels"):
        ttex.texture_u8(np.full((4, 4), 0.5, np.float32))


def test_splits_and_default_tex_params_equal_jax():
    for n in (12, 13, 104):
        np.testing.assert_array_equal(ttex.heldout_mask(n), jtex.heldout_mask(n))
        np.testing.assert_array_equal(ttex.train_indices(n), jtex.train_indices(n))
        np.testing.assert_array_equal(ttex.heldout_indices(n), jtex.heldout_indices(n))
    for scale in (4.0, 2.5):
        np.testing.assert_array_equal(ttex.default_tex_params(scale).numpy(),
                                      np.asarray(jtex.default_tex_params(scale)))


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_sample_plane_matches_jax(impl, monkeypatch):
    tex = ttex.quantize_u8(ttex._procedural_extras(ttex.TEXTURE_SIZE)[3])
    rng = np.random.default_rng(6)
    xy = rng.normal(0.0, 3.0, (20, 30, 2)).astype(np.float32)
    params = np.array([3.0, np.cos(0.4), np.sin(0.4), 0.3, 1.2], np.float32)
    monkeypatch.setattr(jtex, "SAMPLE_IMPL", impl)
    if impl == "pallas":  # the TPU kernel, run by the Pallas interpreter
        orig = wk.bilinear_sample_pallas
        monkeypatch.setattr(wk, "bilinear_sample_pallas",
                            lambda *a, **k: orig(*a, interpret=True, **k))
    ref = np.asarray(jtex.sample_plane(jnp.asarray(tex), jnp.asarray(xy), jnp.asarray(params)))
    out = ttex.sample_plane(torch.as_tensor(ttex.texture_u8(tex)), torch.as_tensor(xy),
                            torch.as_tensor(params)).numpy()
    assert out.shape == ref.shape == (20, 30)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_textured_make_sequence_matches_jax():
    tex = ttex.quantize_u8(ttex._procedural_extras(ttex.TEXTURE_SIZE)[5])
    params = np.array([3.5, np.cos(0.3), np.sin(0.3), 0.2, 0.7], np.float32)
    kw = dict(duration=0.6, seed=1, sigma_w=0.002, sigma_a=0.02, bias_g=0.003,
              bias_a=0.02)
    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    ref = jax_make_sequence(JaxTraj(), t_ic, texture=tex, tex_params=params, **kw)
    before = dict(tcuda.launch_counts)
    out = make_sequence(AnalyticTrajectory(), t_ic, texture=tex, tex_params=params,
                        device="cpu", **kw)
    assert tcuda.launch_counts == before
    for name in ("imu_t", "cam_t", "gt_times", "true_bg", "true_ba"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(out.imu_w, ref.imu_w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.imu_a, ref.imu_a, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out.gt_pose_w, ref.gt_pose_w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.gt_vel_w, ref.gt_vel_w, atol=1e-6, rtol=0)
    assert out.frames.shape == ref.frames.shape and out.frames.dtype == np.uint8
    diff = np.abs(out.frames.astype(int) - ref.frames.astype(int))
    assert (diff <= 1).mean() >= 0.999
    assert (diff > 0).mean() < 0.01  # 0.43 % measured
    # the photo ground is really there: textured frames differ from the
    # procedural ground's
    plain = make_sequence(AnalyticTrajectory(), t_ic, device="cpu", **kw)
    assert np.abs(plain.frames.astype(int) - out.frames.astype(int)).mean() > 10


def test_texture_bank_cache_is_the_ports_own(tmp_path, monkeypatch):
    """The port's bank cache has its own file name in the temporary
    directory, so neither package reads the other's cache."""
    monkeypatch.setattr(ttex.tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.setattr(ttex, "_BANK_CACHE", None)
    monkeypatch.setattr(ttex, "build_texture_bank",
                        lambda size: np.zeros((1, size, size), np.float32))
    bank = ttex.get_texture_bank(8)
    assert bank.shape == (1, 8, 8)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["cuahn_vio_torch_texture_bank_8.npz"]


def test_smoke_sampler_coords_are_a_rendered_frames(monkeypatch):
    """``chip_smoke.py`` holds the flat sampler to its plain version, and
    times it, at the coordinates ``sample_plane`` hands it for one rendered
    frame: the main path's shape (224 x 320 points) and values."""
    import chip_smoke
    from cuahn_vio_torch.data.synthetic import render_frame

    seen = []

    def spy(texture, su, sv):
        seen.append((su, sv))
        return bilinear_sample(texture, su, sv)

    monkeypatch.setattr(ttex, "bilinear_sample", spy)
    t_ic = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64)
    c_rot_i = torch.tensor(t_ic[:3, :3], dtype=torch.float32)
    i_t_i2c = torch.tensor(-t_ic[:3, :3].T @ t_ic[:3, 3], dtype=torch.float32)
    traj, t = AnalyticTrajectory(), torch.tensor(2.0)
    tex = torch.zeros((chip_smoke.TEX_SIZE,) * 2, dtype=torch.uint8)
    render_frame(traj.pos_w(t), traj.quat_i2w(t), c_rot_i, i_t_i2c, texture=tex,
                 tex_params=ttex.default_tex_params(chip_smoke.TEX_SCALE_M))
    su, sv = chip_smoke.frame_sample_coords(torch, "cpu")
    assert len(seen) == 1 and su.shape == (224 * 320,)
    assert torch.equal(seen[0][0], su) and torch.equal(seen[0][1], sv)
    # mirror tiling keeps every point on the texture
    assert 0.0 <= float(su.min()) and float(su.max()) <= chip_smoke.TEX_SIZE - 1


def test_renderer_levels_follow_the_jax_tpu_sampler(monkeypatch):
    """Where the one-level differences of rendered frames come from: one
    frame's mirror-tiled texture coordinates (``plane_coords`` on
    ``ground_points``) sampled by the port (raw levels, blend times 1/255),
    by the JAX package's TPU path (``bilinear_sample_pallas`` exact_u8 on
    the k/255 texture, in interpret mode) and by its CPU gather path
    (``sample_plane`` with ``SAMPLE_IMPL = "gather"``), each truncated
    ``* 255`` to uint8 as both renderers do. The port agrees with the TPU
    path far more closely than the two JAX paths agree with each other, so
    the frames' one-level differences lie between the JAX package's two
    samplers."""
    from cuahn_vio_torch.data.synthetic import ground_points

    tex = ttex.quantize_u8(ttex._procedural_extras(ttex.TEXTURE_SIZE)[5])
    params = np.array([3.5, np.cos(0.3), np.sin(0.3), 0.2, 0.7], np.float32)
    t_ic = np.asarray(VioOptions().t_imu_to_cam, np.float64)
    c_rot_i = torch.tensor(t_ic[:3, :3], dtype=torch.float32)
    i_t_i2c = torch.tensor(-t_ic[:3, :3].T @ t_ic[:3, 3], dtype=torch.float32)
    traj, t = AnalyticTrajectory(), torch.tensor(2.0)
    ground, _ = ground_points(traj.pos_w(t), traj.quat_i2w(t), c_rot_i, i_t_i2c)
    su, sv = ttex.plane_coords(ttex.TEXTURE_SIZE, ground, torch.as_tensor(params))
    su, sv = su.reshape(-1).contiguous(), sv.reshape(-1).contiguous()

    port = bilinear_sample_flat(torch.as_tensor(ttex.texture_u8(tex)), su, sv).numpy()
    tpu = np.asarray(wk.bilinear_sample_pallas(
        jnp.asarray(tex), jnp.asarray(su.numpy()), jnp.asarray(sv.numpy()),
        interpret=True, exact_u8=True))
    monkeypatch.setattr(jtex, "SAMPLE_IMPL", "gather")
    gather = np.asarray(jtex.sample_plane(jnp.asarray(tex), jnp.asarray(ground.numpy()),
                                          jnp.asarray(params))).reshape(-1)

    def levels(x):
        return np.clip(x * np.float32(255.0), 0, 255).astype(np.uint8).astype(int)

    vs_tpu = levels(port) - levels(tpu)
    vs_gather = levels(port) - levels(gather)
    assert su.numel() == 224 * 320
    assert np.abs(vs_tpu).max() <= 1 and np.abs(vs_gather).max() <= 1
    share_tpu, share_gather = (vs_tpu != 0).mean(), (vs_gather != 0).mean()
    assert share_tpu <= 0.001  # 0.070 % measured
    assert share_gather >= 4 * share_tpu  # 0.566 % measured
    assert (vs_tpu <= 0).all()  # the port is never the brighter of the two

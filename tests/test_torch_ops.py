"""The port's ops (cuahn_vio_torch.ops, weight reader) against cuahn_vio.

Same numpy inputs through both packages on the CPU. Tolerances:
- quaternion/SO(3), DLT and covariance transfer: float32 math in both,
  ops in another order -> 1e-5 relative/absolute (DLT: 1e-4 on pixel-
  scale entries, whose magnitudes reach ~300);
- warp: the port's plain version against the Pallas kernel in interpret
  mode (exact_u8 and hi/lo) and ``homography_warp_mm``: 1e-5 absolute,
  NaN exactly where the Pallas kernel gives NaN;
- weights: bytes identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio import ops as jops
from cuahn_vio.ops.pallas.warp_kernel import (
    homography_warp_pallas,
    homography_warp_pallas_batch,
)
from cuahn_vio_torch import ops as tops
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.cuda import build as tbuild
from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda
from cuahn_vio_torch.utils import checkpoint as tckpt
from cuahn_vio_torch.utils.msgpack_reader import unpackb

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
H_TEST = np.array(
    [[1.02, 0.01, -2.0], [0.005, 0.98, 1.5], [1e-5, -2e-5, 1.0]], np.float32
)


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ quat
@pytest.fixture(scope="module")
def quat_inputs():
    rng = np.random.default_rng(10)
    rv = rng.normal(0, 0.7, (6, 3)).astype(np.float32)
    rv[0] = 0.0  # the zero-rotation limit
    rv[1] = 1e-9
    q = np.asarray(jops.quat_exp(jnp.array(rv)))
    v = rng.normal(size=(6, 3)).astype(np.float32)
    return rv, q, v


@pytest.mark.parametrize("name", ["skew", "quat_exp", "jr_so3", "quat_to_rot"])
def test_quat_unary_matches_jax(quat_inputs, name):
    rv, q, _ = quat_inputs
    x = q if name == "quat_to_rot" else rv
    ref = np.asarray(getattr(jops, name)(jnp.array(x)))
    out = getattr(tops, name)(t(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["quat_log", "quat_conj", "quat_normalize"])
def test_quat_of_quat_matches_jax(quat_inputs, name):
    _, q, _ = quat_inputs
    ref = np.asarray(getattr(jops, name)(jnp.array(q)))
    np.testing.assert_allclose(getattr(tops, name)(t(q)).numpy(), ref, atol=1e-6, rtol=1e-5)


def test_quat_mul_rotate_and_rot_to_quat_match_jax(quat_inputs):
    rv, q, v = quat_inputs
    ref = np.asarray(jops.quat_mul(jnp.array(q), jnp.array(q[::-1])))
    np.testing.assert_allclose(tops.quat_mul(t(q), t(q[::-1].copy())).numpy(), ref, atol=1e-6)
    ref = np.asarray(jops.quat_rotate(jnp.array(q), jnp.array(v)))
    np.testing.assert_allclose(tops.quat_rotate(t(q), t(v)).numpy(), ref, atol=1e-5)
    rot = np.asarray(jops.quat_to_rot(jnp.array(q)))
    batched = tops.rot_to_quat(t(rot)).numpy()  # batched in the port
    for i in range(len(rot)):
        ref = np.asarray(jops.rot_to_quat(jnp.array(rot[i])))
        np.testing.assert_allclose(batched[i], ref, atol=1e-6)


# ------------------------------------------------------------ homography
@pytest.fixture(scope="module")
def four_points():
    rng = np.random.default_rng(11)
    src = np.asarray(jops.corner_points(224, 320))
    dst = (src[None] + rng.normal(0, 6.0, (5, 4, 2))).astype(np.float32)
    return src, dst


def test_corner_points_and_cam_constants():
    np.testing.assert_array_equal(
        tops.corner_points(224, 320).numpy(), np.asarray(jops.corner_points(224, 320))
    )
    for a, b in zip(tops.virtual_cam_k(224, 320), jops.virtual_cam_k(224, 320)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
    np.testing.assert_array_equal(
        tops.pixel_grid_uv1(7, 5).numpy(), np.asarray(jops.pixel_grid_uv1(7, 5))
    )


def test_dlt_solve_matches_jax_batched(four_points):
    src, dst = four_points
    src_b = np.broadcast_to(src, dst.shape).copy()
    out = tops.dlt_solve(t(src_b), t(dst)).numpy()
    for i in range(len(dst)):
        ref = np.asarray(jops.dlt_solve(jnp.array(src), jnp.array(dst[i])))
        np.testing.assert_allclose(out[i], ref, rtol=1e-4, atol=1e-6)
        # and it maps the corners where they were sent
        uv1 = np.concatenate([src, np.ones((4, 1), np.float32)], 1) @ out[i].T
        np.testing.assert_allclose(uv1[:, :2] / uv1[:, 2:], dst[i], atol=2e-3)


def test_transfer_mean_var_and_block_diag_match_jax(four_points):
    src, dst = four_points
    rng = np.random.default_rng(12)
    h = np.asarray(jops.dlt_solve(jnp.array(src), jnp.array(dst[0])))
    var = rng.uniform(0.5, 4.0, (4, 2)).astype(np.float32)
    warped = dst[1]
    ref_pts, ref_cov = jops.transfer_mean_var(jnp.array(var), jnp.array(h), jnp.array(warped))
    pts, cov = tops.transfer_mean_var(t(var)[None], t(h)[None], t(warped)[None])
    np.testing.assert_allclose(pts[0].numpy(), np.asarray(ref_pts), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cov[0].numpy(), np.asarray(ref_cov), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tops.block_diag_cov8(cov)[0].numpy(),
        np.asarray(jops.block_diag_cov8(ref_cov)), rtol=1e-5, atol=1e-6,
    )


# ------------------------------------------------------------------ warp
def _frames(rng, b, shape=(224, 320)):
    return rng.integers(0, 256, (b,) + shape).astype(np.uint8)


def _special_homographies(rng, b):
    hs = np.tile(H_TEST, (b, 1, 1))
    hs[:, :2, 2] += rng.normal(0, 4.0, (b, 2)).astype(np.float32)
    return hs


def test_plain_warp_matches_pallas_b1_exact_u8():
    """B1: the main-path kernel (warp_pallas_u8 = exact_u8) at 224x320."""
    rng = np.random.default_rng(20)
    img = _frames(rng, 1)
    ref = homography_warp_pallas(
        jnp.array(img[0], jnp.float32) / 255.0, jnp.array(H_TEST),
        interpret=True, exact_u8=True,
    )
    out = tops.homography_warp(t(img), t(H_TEST)[None])
    assert out.dtype == torch.float32 and out.shape == (1, 224, 320)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_plain_warp_matches_pallas_b1_float_hilo():
    """B1': the hi/lo (arbitrary float32 image) instantiation."""
    rng = np.random.default_rng(21)
    img = rng.random((1, 112, 160)).astype(np.float32)
    ref = homography_warp_pallas(
        jnp.array(img[0]), jnp.array(H_TEST), interpret=True, exact_u8=False
    )
    out = tops.homography_warp(t(img), t(H_TEST)[None])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_plain_warp_matches_pallas_batched_b2():
    """B2: the batched kernel, every image with its own homography."""
    rng = np.random.default_rng(22)
    imgs = _frames(rng, 3)
    hs = _special_homographies(rng, 3)
    hs[1] = np.eye(3, dtype=np.float32)
    ref = homography_warp_pallas_batch(
        jnp.array(imgs, jnp.float32) / 255.0, jnp.array(hs),
        interpret=True, exact_u8=True,
    )
    out = tops.homography_warp(t(imgs), t(hs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["inf", "nan", "off_image", "z_nonpositive"])
def test_plain_warp_nonfinite_coordinates_follow_pallas(case):
    """Clipped to ±1e4: an infinite coordinate samples nothing (0); a NaN
    one gives NaN (the gather bilinear_sample would give 0)."""
    rng = np.random.default_rng(23)
    img = _frames(rng, 1, (56, 80))
    h = {
        "inf": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 0]], np.float32),  # z = 0
        "nan": np.array([[np.nan, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
        "off_image": np.array([[1, 0, 5000], [0, 1, 5000], [0, 0, 1]], np.float32),
        "z_nonpositive": np.array([[1, 0, 0], [0, 1, 0], [0.02, 0, -0.8]], np.float32),
    }[case]
    img_f = jnp.array(img[0], jnp.float32) / 255.0
    ref = np.asarray(homography_warp_pallas(img_f, jnp.array(h), interpret=True, exact_u8=True))
    out = tops.homography_warp(t(img), t(h)[None])[0].numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    finite = ~np.isnan(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=1e-5, rtol=0)
    if case == "nan":
        assert np.isnan(out).all()
    if case in ("off_image",):
        assert (out == 0).all()
    mm = np.asarray(jops.homography_warp_mm(img_f, jnp.array(h)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(mm))
    np.testing.assert_allclose(out[finite], mm[finite], atol=1e-5, rtol=0)


def test_plain_warp_matches_homography_warp_mm():
    """The XLA formulation the JAX model runs on the CPU."""
    rng = np.random.default_rng(24)
    img = rng.random((1, 112, 160)).astype(np.float32)
    ref = jops.homography_warp_mm(jnp.array(img[0]), jnp.array(H_TEST))
    out = tops.homography_warp(t(img), t(H_TEST)[None])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_uint8_warp_equals_float_warp_of_normalized_frame():
    rng = np.random.default_rng(25)
    img = _frames(rng, 2, (56, 80))
    hs = _special_homographies(rng, 2)
    a = tops.homography_warp(t(img), t(hs))
    b = tops.homography_warp(t(img.astype(np.float32) / 255.0), t(hs))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_warp_rejects_bad_arguments_and_cpu_path_counts_no_launch():
    img = torch.zeros((2, 8, 8), dtype=torch.uint8)
    before = dict(tcuda.launch_counts)
    tops.homography_warp(img, torch.eye(3).expand(2, 3, 3).contiguous())
    assert tcuda.launch_counts == before
    with pytest.raises(ValueError):
        tops.homography_warp(img, torch.eye(3)[None])
    with pytest.raises(TypeError):
        tops.homography_warp(img.double(), torch.eye(3).expand(2, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        homography_warp_cuda(img, torch.eye(3).expand(2, 3, 3).contiguous())


def test_kernel_build_is_keyed_by_source_and_flags(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    p1 = tbuild.library_path(str(src))
    src.write_text("// two\n")
    p2 = tbuild.library_path(str(src))
    assert p1 != p2 and p1.startswith(tbuild.BUILD_DIR)
    assert "arch=compute_90a,code=sm_90a" in tbuild.NVCC_FLAGS


@pytest.mark.parametrize("shape, strides, ok", [
    ((1, 224, 320), (71680, 320, 1), True),
    ((65535, 224, 320), (71680, 320, 1), False),  # 4.7e9 output elements
    ((29000, 274, 270), (73980, 270, 1), True),  # 2,145,420,000 < 2**31 - 1
    ((2, 8, 8), (2**31, 8, 1), False),  # a batch stride past int
    ((2, 8, 8), (2**30, 8, 1), True),
])
def test_kernel_int_indexing_check(shape, strides, ok):
    """The warp wrappers refuse (never fall back on) images whose element
    count or element offsets exceed the kernels' 32-bit indexing."""
    from cuahn_vio_torch.ops.cuda.warp import check_int_indexing

    if ok:
        check_int_indexing(shape, strides)
    else:
        with pytest.raises(ValueError, match="int indexing"):
            check_int_indexing(shape, strides)


def test_ptxas_report_reads_each_kernel(tmp_path):
    lib = tmp_path / "libwarp.so"
    (tmp_path / "libwarp.so.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114rowskip_kernelIhLi2EEEvPKT_PKfPfiiifb' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_114rowskip_kernelIhLi2EEEvPKT_PKfPfiiifb\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 16424 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111flat_kernelIfEEvPKT_PKfS4_Pfiiiiif' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_111flat_kernelIfEEvPKT_PKfS4_Pfiiiiif\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 25 registers, 400 bytes cmem[0]\n")
    report = tbuild.ptxas_report(str(lib))
    assert report == {
        "rowskip_kernel<h,2>": dict(registers=40, smem_bytes=16424, stack_bytes=0,
                                    spill_stores=0, spill_loads=0),
        "flat_kernel<f>": dict(registers=25, smem_bytes=0, stack_bytes=8,
                               spill_stores=4, spill_loads=8),
    }


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_111warp_kernelIhLi4EEEvPKT_PKfPfiiiiiifb", "warp_kernel<h,4>"),
    ("_ZN12_GLOBAL__N_111flat_kernelIfEEvPKT_PKfS4_Pfiiiiif", "flat_kernel<f>"),
    ("_ZN12_GLOBAL__N_111flat_kernelIhLi8ELb1EEEvPKT_PKfS5_Pfiiixiif", "flat_kernel<h,8,1>"),
    ("_ZN12_GLOBAL__N_111flat_kernelIfLi1ELb0EEEvPKT_PKfS5_Pfiiixiif", "flat_kernel<f,1,0>"),
    ("_ZN12_GLOBAL__N_113resident_threadsEv", None),
])
def test_kernel_name_keeps_every_template_argument(mangled, name):
    """Each instantiation of a kernel template gets its own name (type,
    points a thread and, for the flat sampler, whether it reads whole
    words), so no two share an entry of the ptxas report."""
    assert tbuild.kernel_name(mangled) == name


# --------------------------------------------------------------- weights
@pytest.fixture(scope="module")
def weight_trees():
    from flax import serialization

    with open(WEIGHTS, "rb") as f:
        data = f.read()
    return unpackb(data), serialization.msgpack_restore(data)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_msgpack_reader_matches_flax_on_v10(weight_trees):
    mine, ref = weight_trees
    mine_l, ref_l = dict(_leaves(mine)), dict(_leaves(ref))
    assert mine_l.keys() == ref_l.keys() and len(mine_l) == 54
    for k, v in ref_l.items():
        v = np.asarray(v)
        assert mine_l[k].shape == v.shape and mine_l[k].dtype == v.dtype, k
        assert mine_l[k].tobytes() == v.tobytes(), k


def test_msgpack_reader_scalars_and_containers():
    import msgpack

    obj = {"a": [1, -3, 300, -70000, 2**40, 1.5, None, True, False],
           "b": b"\x00\x01", "s": "x" * 40, "n": {"deep": [2.25]}}
    assert unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_params_from_numpy_layouts(weight_trees):
    mine, _ = weight_trees
    sd = tckpt.params_from_numpy(mine)
    k = mine["block4"]["conv0"]["kernel"]  # HWIO (7, 7, 2, 8)
    np.testing.assert_array_equal(sd["block4.conv0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = mine["head_mean"]["fc0"]["kernel"]  # (5120, 256)
    np.testing.assert_array_equal(sd["head_mean.fc0.weight"].numpy(), d.T)
    assert sd["fc_block2.bias"].shape == (8,)

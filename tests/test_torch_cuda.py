"""The port's CUDA kernels on the card (skips without a GPU).

A CUDA kernel has no CPU mode, so these run only where a GPU is present:
``python -m pytest --noconftest tests/test_torch_cuda.py`` on the GPU
machine (the suite's conftest imports JAX; these tests do not need it).
Each kernel is held to its plain PyTorch version on the same CUDA tensors,
NaN exactly where the plain version has NaN: the warp (B1/B2) and the
flat sampler (B4) to max abs error 1e-5, the row-band warp (B3) to the
warp kernel bit for bit (0.0); at the shapes the tiling of several pixels
per thread makes risky (ragged and tiny widths, B = 1 and 65, row bands
just under and over the shared band) and at a rendered frame's texture
coordinates, all three bit for bit (0.0); the flat sampler's batched form
(B = 1, 3 and 16 textures, ragged N, misaligned coordinates) bit for bit
too. The batched path, the blurred render and the CLI run on the card too.
"""

import numpy as np
import pytest
import torch

from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.warp import homography_warp, homography_warp_plain

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


def _cases(rng, b, dtype, dev):
    if dtype == torch.uint8:
        imgs = rng.integers(0, 256, (b, 224, 320)).astype(np.uint8)
    else:
        imgs = rng.random((b, 224, 320)).astype(np.float32)
    hs = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    hs[:, :2, :] += rng.normal(0, 0.02, (b, 2, 3)).astype(np.float32) * [1, 1, 300]
    hs[:, 2, :2] += rng.normal(0, 1e-4, (b, 2)).astype(np.float32)
    if b >= 4:
        hs[1] = [[1, 0, 5000], [0, 1, 5000], [0, 0, 1]]
        hs[2] = [[1, 0, 0], [0, 1, 0], [0.01, 0, -1.6]]
        hs[3, 1, 1] = np.nan
    return torch.as_tensor(imgs, device=dev), torch.as_tensor(hs, device=dev)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b", [1, 8])
def test_warp_kernel_matches_plain_version(gpu, dtype, b):
    imgs, hs = _cases(np.random.default_rng(b), b, dtype, gpu)
    before = tcuda.launch_counts["homography_warp"]
    out = homography_warp(imgs, hs)
    ref = homography_warp_plain(imgs, hs)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["homography_warp"] == before + 1
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    finite = ~torch.isnan(ref)
    assert (out - ref).abs()[finite].max().item() <= TOL


def test_model_on_gpu_warps_through_the_kernel(gpu):
    from cuahn_vio_torch.models.uahn import build_uahn

    model = build_uahn(None, device=gpu, dropout_rate=0.0)
    imgs, _ = _cases(np.random.default_rng(0), 2, torch.uint8, gpu)
    tcuda.reset_launch_counts()
    flow, cov = model(imgs[:1], imgs[1:], torch.zeros((1, 4, 2), device=gpu),
                      use_prior=True)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["homography_warp"] == 3
    assert torch.isfinite(flow).all() and torch.isfinite(cov).all()


def test_warp_wrapper_rejects_what_the_kernel_does_not_take(gpu):
    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda

    imgs = torch.zeros((2, 16, 16), dtype=torch.uint8, device=gpu)
    hs = torch.eye(3, device=gpu).expand(2, 3, 3)
    with pytest.raises(ValueError, match="contiguous"):
        homography_warp_cuda(imgs, hs)
    with pytest.raises(ValueError):
        homography_warp_cuda(imgs, hs.cpu().contiguous())
    with pytest.raises(TypeError):
        homography_warp_cuda(imgs.half(), hs.contiguous())


def _roll_cases(rng, b, dtype, dev):
    """_cases plus an extreme (90 deg) and a 20 deg roll about the centre."""
    imgs, hs = _cases(rng, b, dtype, dev)
    if b >= 6:
        for i, deg in ((4, 90.0), (5, 20.0)):
            c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
            hs[i] = torch.tensor([[c, -s, 159.5 - c * 159.5 + s * 111.5],
                                  [s, c, 111.5 - s * 159.5 - c * 111.5],
                                  [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    return imgs, hs


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b", [1, 8])
def test_rowskip_kernel_is_bit_identical_to_the_warp_kernel(gpu, dtype, b):
    from cuahn_vio_torch.ops import warp
    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda, homography_warp_rowskip_cuda

    imgs, hs = _roll_cases(np.random.default_rng(10 + b), b, dtype, gpu)
    before = dict(tcuda.launch_counts)
    out = homography_warp_rowskip_cuda(imgs, hs)
    full = homography_warp_cuda(imgs, hs)
    ref = homography_warp_plain(imgs, hs)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["homography_warp_rowskip"] == before["homography_warp_rowskip"] + 1
    assert torch.equal(torch.isnan(out), torch.isnan(full))
    assert torch.equal(out.nan_to_num(), full.nan_to_num())
    assert torch.equal(out.nan_to_num(), ref.nan_to_num())
    # the selector routes a CUDA batch to the row-band kernel
    warp.BATCH_SAMPLER = "rowskip"
    try:
        routed = warp.homography_warp(imgs, hs)
    finally:
        warp.BATCH_SAMPLER = "full"
    torch.cuda.synchronize()
    want = 2 if b > 1 else 1  # a single frame stays on the warp kernel
    assert tcuda.launch_counts["homography_warp_rowskip"] == before["homography_warp_rowskip"] + want
    assert torch.equal(routed.nan_to_num(), full.nan_to_num())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_flat_sampler_matches_plain_version(gpu, dtype):
    from cuahn_vio_torch.ops.warp import bilinear_sample, bilinear_sample_flat

    rng = np.random.default_rng(20)
    tex = (rng.integers(0, 256, (512, 512)).astype(np.uint8) if dtype == torch.uint8
           else rng.random((512, 512)).astype(np.float32))
    coords = np.concatenate([
        rng.uniform(-2.0, 513.0, (2, 5000)),
        np.array([[0.0, 511.0, -0.5, 511.5, -1.0, 512.0, np.inf, -np.inf, np.nan, 3.0],
                  [511.0, 0.0, 3.0, 7.0, 2.0, 2.0, 5.0, 5.0, 5.0, np.nan]]),
    ], axis=1).astype(np.float32)
    tex = torch.as_tensor(tex, device=gpu)
    su, sv = (torch.as_tensor(np.ascontiguousarray(c), device=gpu) for c in coords)
    before = tcuda.launch_counts["bilinear_sample"]
    out = bilinear_sample(tex, su, sv)
    ref = bilinear_sample_flat(tex, su, sv)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["bilinear_sample"] == before + 1
    assert torch.equal(torch.isnan(out), torch.isnan(ref)) and torch.isnan(out).sum() == 2
    finite = ~torch.isnan(ref)
    assert (out - ref).abs()[finite].max().item() <= TOL


def _short_sequences(dev):
    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.data.textures import _procedural_extras, quantize_u8
    from cuahn_vio_torch.utils.config import VioOptions

    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    tex = quantize_u8(_procedural_extras(512)[0])
    tcuda.reset_launch_counts()
    seqs = [make_sequence(AnalyticTrajectory(), t_ic, duration=d, seed=s, texture=tex,
                          device=dev) for d, s in ((0.6, 1), (0.45, 2))]
    torch.cuda.synchronize()
    assert tcuda.launch_counts["bilinear_sample"] == sum(len(q.cam_t) for q in seqs)
    return seqs


def test_batched_path_on_gpu_warps_once_per_site_and_frame(gpu):
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.pipeline.runner import run_offline, run_offline_batch
    from cuahn_vio_torch.utils.config import VioOptions

    opts = VioOptions().apply_profile("calibrated")
    opts.calib_camimu_dt, opts.init_height, opts.init_imu_thresh = 0.0, 1.5, 0.2
    seqs = [(q.imu_t, q.imu_w, q.imu_a, q.cam_t, q.frames) for q in _short_sequences(gpu)]
    model = build_uahn(None, device=gpu, dropout_rate=0.0)
    fp, cfg, ro = opts.filter_params(gpu), opts.vio_config(), opts.runner_options()
    tcuda.reset_launch_counts()
    res = run_offline_batch(seqs, model, fp, cfg, ro, device="cuda")
    torch.cuda.synchronize()
    f_max = max(len(r.times) for r in res)
    assert tcuda.launch_counts["homography_warp"] == 3 * f_max
    for seq, r in zip(seqs, res):
        single = run_offline(*seq, model, fp, cfg, ro, device="cuda")
        np.testing.assert_allclose(r.pose_w[:, :3], single.pose_w[:, :3], atol=2e-5, rtol=0)


def test_cli_runs_on_the_gpu_by_default(gpu, tmp_path):
    from cuahn_vio_torch import cli

    paths = []
    for i, q in enumerate(_short_sequences(gpu)):
        paths.append(str(tmp_path / f"s{i}.npz"))
        np.savez(paths[-1], imu_t=q.imu_t, imu_w=q.imu_w, imu_a=q.imu_a,
                 cam_t=q.cam_t, frames=q.frames)
    flags = ["--no-network", "--init-height", "1.5", "--calib-dt", "0",
             "--init-imu-thresh", "0.2"]
    cli.main(["run-vio", paths[0], "--out", str(tmp_path / "est.txt"), *flags])
    cli.main(["run-vio-batch", *paths, "--out-dir", str(tmp_path / "b"), "--no-network",
              "--init-height", "1.5"])
    assert (tmp_path / "est.txt").exists()
    assert all((tmp_path / "b" / f"s{i}.txt").exists() for i in range(2))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b, hgt, wid", [(1, 224, 320), (4, 224, 320), (65, 224, 320),
                                         (8, 224, 317), (8, 7, 5), (8, 6, 3), (50000, 6, 3)])
def test_warp_kernels_are_bit_identical_at_ragged_shapes(gpu, dtype, b, hgt, wid):
    """Widths that are not a multiple of a thread's pixels, images narrower
    than them (50,000 images 3 wide take 8 pixels a thread), B = 1, 4 and
    65, with chip_smoke's special homographies (off-image, z <= 0, NaN,
    rolls, z = 0)."""
    import chip_smoke
    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda, homography_warp_rowskip_cuda

    imgs, hs = chip_smoke.parity_cases(torch, np.random.default_rng(b * wid), b, dtype, hgt, wid)
    imgs, hs = torch.as_tensor(imgs, device=gpu), torch.as_tensor(hs, device=gpu)
    out = homography_warp_cuda(imgs, hs)
    band = homography_warp_rowskip_cuda(imgs, hs)
    ref = homography_warp_plain(imgs, hs)
    torch.cuda.synchronize()
    for got in (out, band):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(got.nan_to_num(), ref.nan_to_num())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_rowskip_kernel_is_bit_identical_around_its_band_limit(gpu, dtype):
    """A roll whose tiles' row bands lie just under and just over the
    shared band (one image row either side): the kernel switches between
    its shared band and global memory, and stays bit-identical."""
    import chip_smoke
    from cuahn_vio_torch.ops.cuda.warp import (
        band_bytes,
        homography_warp_cuda,
        homography_warp_rowskip_cuda,
    )

    item = torch.tensor([], dtype=dtype).element_size()
    deg = chip_smoke.BAND_EDGE_ROLL_DEG[item]
    imgs, _ = chip_smoke.parity_cases(torch, np.random.default_rng(40), 2, dtype)
    imgs = torch.as_tensor(imgs, device=gpu)
    hs = torch.tensor([chip_smoke.rolled(deg), chip_smoke.rolled(-deg)], dtype=torch.float32,
                      device=gpu)
    bands = chip_smoke.tile_bands(torch, hs, 224, 320, item)
    limit, row = band_bytes(), 320 * item
    assert ((bands <= limit) & (bands > limit - row)).any()
    assert ((bands > limit) & (bands <= limit + row)).any()
    out = homography_warp_rowskip_cuda(imgs, hs)
    full = homography_warp_cuda(imgs, hs)
    ref = homography_warp_plain(imgs, hs)
    torch.cuda.synchronize()
    assert torch.equal(out, full) and torch.equal(out, ref)


def test_flat_sampler_is_bit_identical_at_a_rendered_frames_coordinates(gpu):
    import chip_smoke
    from cuahn_vio_torch.ops.warp import bilinear_sample, bilinear_sample_flat

    su, sv = chip_smoke.frame_sample_coords(torch, gpu)
    tex = torch.as_tensor(np.random.default_rng(41).integers(0, 256, (512, 512)).astype(np.uint8),
                          device=gpu)
    out = bilinear_sample(tex, su, sv)
    ref = bilinear_sample_flat(tex, su, sv)
    torch.cuda.synchronize()
    assert su.numel() == 224 * 320 and torch.equal(out, ref)


def test_warp_wrapper_refuses_what_int_cannot_index(gpu):
    from cuahn_vio_torch.ops.cuda.warp import homography_warp_cuda

    b = 2**31 // (224 * 320) + 1  # 2.15e9 pixels: past int
    imgs = torch.empty((b, 224, 320), dtype=torch.uint8, device=gpu)
    hs = torch.eye(3, device=gpu).expand(b, 3, 3).contiguous()
    before = tcuda.launch_counts["homography_warp"]
    with pytest.raises(ValueError, match="int indexing"):
        homography_warp_cuda(imgs, hs)
    assert tcuda.launch_counts["homography_warp"] == before


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_batched_flat_sampler_is_bit_identical(gpu, dtype, b):
    """B textures, each at its own row of blurred-frame coordinates (the
    trainer batch's shape at B = 16), whole, at a ragged N (N mod 8 != 0)
    and 4 bytes past alignment: one launch each, bit for bit."""
    import chip_smoke
    from cuahn_vio_torch.ops.warp import bilinear_sample, bilinear_sample_flat

    texs, su, sv = chip_smoke.batch_sample_inputs(torch, gpu, dtype)
    texs, su, sv = texs[:b], su[:b], sv[:b]
    cut = su.shape[1] - 5
    cases = [(su, sv), (su[:, :cut].contiguous(), sv[:, :cut].contiguous()),
             (chip_smoke.misaligned(torch, su), chip_smoke.misaligned(torch, sv))]
    for csu, csv in cases:
        before = tcuda.launch_counts["bilinear_sample"]
        out = bilinear_sample(texs, csu, csv)
        ref = bilinear_sample_flat(texs, csu, csv)
        torch.cuda.synchronize()
        assert tcuda.launch_counts["bilinear_sample"] == before + 1
        assert out.shape == csu.shape and torch.equal(out, ref)
    one = bilinear_sample(texs[0], su[0][1:], sv[0][1:])  # su[1:]: 4-byte aligned only
    assert torch.equal(one, bilinear_sample_flat(texs[0], su[0][1:], sv[0][1:]))


def test_flat_sampler_wrapper_refuses_what_the_kernel_does_not_take(gpu):
    from cuahn_vio_torch.ops.cuda.warp import bilinear_sample_cuda

    tex = torch.zeros((3, 16, 16), dtype=torch.uint8, device=gpu)
    su = torch.zeros((3, 10), device=gpu)
    before = tcuda.launch_counts["bilinear_sample"]
    with pytest.raises(ValueError, match="devices|CUDA"):
        bilinear_sample_cuda(tex, su, su.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        bilinear_sample_cuda(tex, su[:, ::2], su[:, ::2])
    with pytest.raises(ValueError):  # a batch of textures takes (B, N) coordinates
        bilinear_sample_cuda(tex[:1], su[0], su[0])
    big = torch.empty((2, 2**30), device=gpu)  # B x N = 2**31: past int
    with pytest.raises(ValueError, match="int indexing"):
        bilinear_sample_cuda(tex[:2], big, big)
    assert tcuda.launch_counts["bilinear_sample"] == before


def test_blurred_make_sequence_samples_once_per_frame(gpu):
    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.data.textures import _procedural_extras, quantize_u8
    from cuahn_vio_torch.utils.config import VioOptions

    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    tex = quantize_u8(_procedural_extras(512)[2])
    tcuda.reset_launch_counts()
    seq = make_sequence(AnalyticTrajectory(), t_ic, duration=0.5, seed=3, texture=tex,
                        exposure_s=0.008, device=gpu)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["bilinear_sample"] == len(seq.cam_t) == len(seq.frames)
    cpu = make_sequence(AnalyticTrajectory(), t_ic, duration=0.5, seed=3, texture=tex,
                        exposure_s=0.008, device="cpu")
    diff = np.abs(seq.frames.astype(int) - cpu.frames.astype(int))
    assert (diff <= 1).mean() >= 0.999

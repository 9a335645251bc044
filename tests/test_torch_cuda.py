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
too; the undistortion remap C1 to its plain version bit for bit (0.0) at
raw 640x480, 641x479 and 752x480 -> 224x320 on fisheye, radtan, edge and
scattered maps (each tile's path as ``ops/remap.tile_boxes`` states it),
from 1 to 165 frames, on frames off a 16-byte boundary and a ragged map;
the threefry kernel
T1 to its plain version bit for bit in bits, uniform and bernoulli and
within 2 float32 ulp in normal, at the MC-dropout masks' and the sensor
effects' shapes and at the layouts its runs of values make risky, its
Bernoulli coin at the edges of p, a refused launch raising with no
fallback, and the masks of a network call on the card equal to the
CPU's. The batched path,
the stepwise runner, the bf16 towers, the blurred
render and the CLI run on the card too, and the sparse-vision front end
and the UAHN's error map follow their CPU results (``chip_smoke.py``
phase 15a's checks at test size), as do the measurement replay of the
filter-parameter sweep, the Schur smoother (bit for bit across repeats)
and the one-process self-test; the trainer's data-parallel path in a
one-rank NCCL group follows its plain path.
"""

import os

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


# (rows, count of each row) of T1's cases: the four masks of one call and
# of a 64-pair batch (widths 5120 and 256 alternating), the effects' two
# noise frames, ragged counts with an empty row, and the layouts a thread's
# run of values makes risky (tests/test_torch_prng_runs.py): rows of 0, 1,
# R - 1, R + 1 and 3R values for runs of R = 4, 8 and 16, runs over many
# rows of 1 value, empty rows at both ends, 4,096 rows of 1,001 values,
# and ragged rows at totals that take each run length
T1_CASES = {
    "masks_1": [16 * 5120, 16 * 256] * 2,
    "masks_64": [16 * 5120, 16 * 256] * 128,
    "effects": [224 * 320] * 2,
    "ragged": [1, 0, 257, 65537],
    "short_rows": [c for r in (4, 8, 16) for c in (0, 1, r - 1, r + 1, 3 * r)] + [2],
    "ones": [1] * 37 + [0, 0] + [1] * 3,
    "empty_ends": [0, 0, 17, 0, 33, 0, 0],
    "rows_4096x1001": [1001] * 4096,
    # a batch of 4 sequences' masks (runs of 4), totals at which a draw
    # takes runs of 2, 4 and 8 (``values_per_thread``), and runs of 16 (8)
    # over many rows of 0, 1, 3 and 5 values
    "masks_4": [16 * 5120, 16 * 256] * 8,
    "ragged_mid": [3, 0, 100_003, 1, 200_000, 7, 0, 150_001],
    "ragged_large": [5, 700_001, 0, 1, 99_999],
    "ragged_xl": [1_500_001, 3, 0, 99_998],
    "many_short_rows": [1] * 5000 + [0, 3, 1, 5] * 1000 + [2_200_000],
}


@pytest.mark.parametrize("case", sorted(T1_CASES))
def test_threefry_kernel_matches_plain_version(gpu, case):
    from cuahn_vio_torch.utils import prng

    counts = T1_CASES[case]
    keys = prng.keys_tensor(prng.split(prng.prng_key(len(counts)), len(counts)), gpu)
    for mode, a, b in ((prng.BITS, 0.0, 1.0), (prng.UNIFORM, 0.3, 1.7),
                       (prng.BERNOULLI, 0.95, 1.0), (prng.NORMAL, 0.0, 1.0),
                       (prng.TRUNC_NORMAL, -2.0, 2.0)):
        before = tcuda.launch_counts["threefry"]
        by_mode = tcuda.threefry_launches_by_mode[prng.MODE_NAMES[mode]]
        out = prng.draw(keys, counts, mode, a, b)
        ref = prng.draw_plain(keys, counts, mode, a, b)
        torch.cuda.synchronize()
        assert tcuda.launch_counts["threefry"] == before + 1
        assert tcuda.threefry_launches_by_mode[prng.MODE_NAMES[mode]] == by_mode + 1
        assert out.dtype == ref.dtype and out.shape == ref.shape == (sum(counts),)
        if mode in (prng.NORMAL, prng.TRUNC_NORMAL):
            ulps = (out.view(torch.int32).long() - ref.view(torch.int32).long()).abs()
            assert ulps.max().item() <= 2 and torch.equal(torch.sign(out), torch.sign(ref))
        else:
            assert torch.equal(out, ref)


@pytest.mark.parametrize("p", [0.0, 0.05, 0.5, 0.95, 1.0 - 2.0**-24, 1.0, 2.0, 1e-45, -0.5],
                         ids=["zero", "rate", "half", "keep", "below_one", "one", "two",
                              "subnormal", "negative"])
def test_threefry_bernoulli_threshold_matches_plain_version(gpu, p):
    """The kernel's coin, (bits >> 9) < bernoulli_threshold(p), is the
    plain version's float compare at the edges of p, one value a thread
    and in long runs."""
    from cuahn_vio_torch.utils import prng

    for counts in ([16 * 5120, 16 * 256, 5, 0, 3000], [16 * 5120, 5, 0, 2_200_000]):
        keys = prng.keys_tensor(prng.split(prng.prng_key(9), len(counts)), gpu)
        out = prng.draw(keys, counts, prng.BERNOULLI, p)
        assert torch.equal(out, prng.draw_plain(keys, counts, prng.BERNOULLI, p)), counts


def test_threefry_launch_failure_raises_without_fallback(gpu, monkeypatch):
    """A refused launch raises; a draw on CUDA keys never reaches the plain
    version."""
    from cuahn_vio_torch.ops.cuda import prng as prng_cuda
    from cuahn_vio_torch.utils import prng

    keys = prng.keys_tensor(prng.split(prng.prng_key(3), 2), gpu)
    prng_cuda.build_kernel()

    def refused(*args):
        return 1  # cudaErrorInvalidValue

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA draw reached the plain version")

    monkeypatch.setattr(prng, "draw_plain", plain)
    lib = prng_cuda._library()
    monkeypatch.setattr(lib, "threefry_draw", refused)
    before = tcuda.launch_counts["threefry"]
    with pytest.raises(RuntimeError, match="launch failed"):
        prng.draw(keys, [7, 9], prng.BERNOULLI, 0.95)
    assert tcuda.launch_counts["threefry"] == before


def test_init_uahn_on_gpu_equals_the_cpu(gpu):
    """The random UAHN drawn on the card (every kernel in one T1 launch,
    truncated normal) is the CPU's: biases 0, every kernel value within a
    unit draw's 2.4e-7 times the leaf's scale plus one rounding (the bound
    the CPU's build is held to against JAX's, ``tests/test_torch_init.py``:
    the card's log1pf and the CPU's torch.log1p round apart at a few
    values)."""
    from cuahn_vio_torch.models.uahn import TRUNC_NORMAL_STD, init_uahn
    from cuahn_vio_torch.utils import prng

    before = dict(tcuda.threefry_launches_by_mode)
    card = init_uahn(prng.prng_key(0), device=gpu).state_dict()
    assert tcuda.threefry_launches_by_mode["truncated_normal"] == \
        before["truncated_normal"] + 1
    cpu = init_uahn(prng.prng_key(0), device="cpu").state_dict()
    for name, want in cpu.items():
        got = card[name].cpu().numpy()
        want = want.numpy()
        if name.endswith(".bias"):
            assert not got.any() and not want.any(), name
            continue
        std = np.sqrt(np.float32(1.0 / got[0].size)) / np.float32(TRUNC_NORMAL_STD)
        assert (np.abs(got - want) <= 2.4e-7 * std + np.spacing(np.abs(want))).all(), name


def test_network_masks_on_gpu_equal_the_cpu(gpu):
    """A 16-member head call's four masks, drawn in one launch on the card,
    are the CPU's (the plain version's) for the same keys."""
    from cuahn_vio_torch.models.uahn import draw_masks
    from cuahn_vio_torch.utils import prng

    keys = prng.split(prng.prng_key(1), 3)
    before = tcuda.launch_counts["threefry"]
    on_gpu = draw_masks(keys, 0.05, 5120, gpu)
    assert tcuda.launch_counts["threefry"] == before + 1
    on_cpu = draw_masks(keys, 0.05, 5120, "cpu")
    for head_g, head_c in zip(on_gpu, on_cpu):
        for g, c in zip(head_g, head_c):
            assert g.dtype == torch.bool and torch.equal(g.cpu(), c)


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


def test_stepwise_runner_on_gpu_follows_run_offline(gpu):
    """Staged and fused, at one seed with MC dropout on: the poses of
    run_offline, a warp launch per site and frame (plus the warm-up
    step's), a threefry launch per frame (the four masks of a call in one)
    and a stage row per frame."""
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.pipeline.runner import run_offline, run_stepwise
    from cuahn_vio_torch.utils.config import VioOptions

    opts = VioOptions().apply_profile("calibrated")
    opts.calib_camimu_dt, opts.init_height, opts.init_imu_thresh = 0.0, 1.5, 0.2
    q = _short_sequences(gpu)[0]
    model = build_uahn(None, device=gpu, dropout_rate=0.05)
    args = (q.imu_t, q.imu_w, q.imu_a, q.cam_t, q.frames, model, opts.filter_params(gpu),
            opts.vio_config(), opts.runner_options())
    ref = run_offline(*args, seed=3, device="cuda")
    for staged in (True, False):
        tcuda.reset_launch_counts()
        res = run_stepwise(*args, seed=3, device="cuda", staged_timing=staged)
        assert tcuda.launch_counts["homography_warp"] == 3 * (len(res.times) + 1)
        assert tcuda.launch_counts["threefry"] == len(res.times) + 1
        assert res.stage_ms.shape == (len(res.times), 5) and res.n_recoveries == 0
        np.testing.assert_allclose(res.pose_w, ref.pose_w, atol=1e-6, rtol=0)


def test_bf16_towers_on_gpu_stay_near_float32(gpu):
    """The v10 UAHN with cuDNN bf16 towers: within bench.py:70's 0.05 px of
    its float32 flow."""
    import os

    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params

    rng = np.random.default_rng(30)
    base = rng.integers(0, 256, (232, 330)).astype(np.uint8)
    img1 = torch.as_tensor(base[4:228, 5:325].copy(), device=gpu)[None]
    img2 = torch.as_tensor(base[2:226, 2:322].copy(), device=gpu)[None]
    prior = torch.as_tensor(rng.normal(0, 2.0, (1, 4, 2)).astype(np.float32), device=gpu)
    weights = load_params(os.path.join(os.path.dirname(__file__), "..", "weights",
                                       "uahn_fil_v10.msgpack"))
    f32 = build_uahn(weights, device=gpu, dropout_rate=0.0)
    bf16 = build_uahn(weights, device=gpu, dropout_rate=0.0, compute_dtype=torch.bfloat16)
    tcuda.reset_launch_counts()
    a, _ = f32(img1, img2, prior, use_prior=True)
    b, cov = bf16(img1, img2, prior, use_prior=True)
    assert tcuda.launch_counts["homography_warp"] == 6  # the warp stays the kernel
    assert b.dtype == cov.dtype == torch.float32 and torch.isfinite(cov).all()
    assert 0 < (a - b).abs().max().item() < 0.05


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


def test_train_step_on_gpu_follows_the_cpu(gpu):
    """One 56x80 training step (batch 4, dropout off, TF32 off) on the card
    against the same step on the CPU, in both modes: the loss within 1e-5
    relative, every gradient leaf within 1e-3 of its max |g| (cuDNN's and
    oneDNN's convolutions sum in other orders), the updated weights finite;
    on the card the three warps of a step launch the warp kernel, the batch
    render launches the flat sampler twice (the first and the second
    frames, all textures in one launch each)."""
    import copy

    from cuahn_vio_torch.models.uahn import UAHN
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.data.textures import texture_bank_u8
    from cuahn_vio_torch.train import trainer as T
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.config import VioOptions

    f32_parity_mode()
    hgt, wid = 56, 80
    cfg = T.TrainConfig(batch_size=4, blur_taps=2, warmup_steps=0)
    t = np.asarray(VioOptions().t_imu_to_cam, np.float64)
    cam = (torch.tensor(t[:3, :3], dtype=torch.float32),
           torch.tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32))
    bank = texture_bank_u8(gpu)
    tcuda.reset_launch_counts()
    batch = T.make_batch(cfg, prng.prng_key(0), *(x.to(gpu) for x in cam), hgt, wid, bank,
                         torch.arange(bank.shape[0], device=gpu))
    assert tcuda.launch_counts["bilinear_sample"] == 2
    torch.manual_seed(0)
    initial = UAHN(dropout_rate=0.0, img_height=hgt, img_width=wid)
    for use_prior in (True, False):
        # each mode's step from the same weights on both devices (a step's
        # update would carry rounding into the next mode's comparison)
        cpu_model = copy.deepcopy(initial)
        gpu_model = copy.deepcopy(initial).to(gpu)
        out = []
        for model, dev in ((cpu_model, torch.device("cpu")), (gpu_model, gpu)):
            step = T.make_train_step(model, cfg, T.make_optimizer(model, cfg, 10))
            tcuda.reset_launch_counts()
            loss, _ = step(T.Batch(*(x.to(dev) for x in batch)), use_prior, None)
            grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                     for n, p in model.named_parameters()}
            assert all(torch.isfinite(p).all() for p in model.parameters())
            out.append((loss.item(), grads, dict(tcuda.launch_counts)))
        (l_cpu, g_cpu, n_cpu), (l_gpu, g_gpu, n_gpu) = out
        assert n_cpu["homography_warp"] == 0 and n_gpu["homography_warp"] == 3
        assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
        for name, g in g_cpu.items():
            scale = g.abs().max().item()
            assert (g_gpu[name] - g).abs().max().item() <= 1e-3 * scale, name


def _remap_maps(kind, dev, src_h=480, src_w=640):
    from cuahn_vio_torch.runtime.undistort import build_undist_map

    if kind in ("fisheye", "radtan"):
        k, d = (([275.46015578667294, 274.9948095922592, 315.958384100568, 242.7123497822731],
                 [-6.545154718304953e-06, -0.010379525898159981, 0.014935312423953146,
                  -0.005639061406567785]) if kind == "fisheye" else
                ([458.654, 457.296, 367.215, 248.375],
                 [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]))
        return build_undist_map(k, d, kind == "fisheye", device=dev)
    if kind == "scattered":  # every tile's taps spread over the frame: all over the stage
        rng = np.random.default_rng(5)
        return (torch.as_tensor(rng.uniform(-3, src_w + 2, (224, 320)).astype(np.float32),
                                device=dev),
                torch.as_tensor(rng.uniform(-3, src_h + 2, (224, 320)).astype(np.float32),
                                device=dev))
    v, u = torch.meshgrid(torch.arange(224, dtype=torch.float32, device=dev),
                          torch.arange(320, dtype=torch.float32, device=dev), indexing="ij")
    mx, my = u * 2.1 - 20.0, v * 2.3 - 15.0  # integer, fractional, off-image, edges
    mx[0, :6] = torch.tensor([-1.0, -0.5, src_w - 1.0, src_w - 0.5, float(src_w), float("nan")])
    my[1, :5] = torch.tensor([src_h - 1.0, src_h - 0.75, float(src_h), -1.0, 1e9])
    # the four corners in one tile: its box is the whole frame (global taps)
    mx[2, :4] = torch.tensor([0.0, src_w - 1.0, 0.5, src_w - 1.5])
    my[2, :4] = torch.tensor([0.0, src_h - 1.0, src_h - 1.5, 0.25])
    return mx.contiguous(), my.contiguous()


@pytest.mark.parametrize("src_h, src_w", [(480, 640), (479, 641), (480, 752)])
@pytest.mark.parametrize("kind", ["fisheye", "radtan", "edges", "scattered"])
@pytest.mark.parametrize("n", [1, 9, 17, 165])
def test_remap_kernel_is_bit_identical_to_its_plain_version(gpu, kind, n, src_h, src_w):
    """C1 against ``remap_u8_plain`` on the card, raw -> 224x320, one launch
    for the batch (9 and 17 frames: a ring's and a frame chunk's tails; 165,
    a sequence), at raw widths whose rows are 16-byte aligned (640, EuRoC's
    752) and not (641); the tiles by path as ``tile_boxes`` states them:
    the camera maps all on the shared ring, the edge map one tile and the
    scattered map every tile on global taps."""
    from cuahn_vio_torch.ops.cuda.remap import remap_u8_cuda
    from cuahn_vio_torch.ops.remap import remap_u8, remap_u8_plain, tile_boxes

    rng = np.random.default_rng(n)
    frames = torch.as_tensor(rng.integers(0, 256, (n, src_h, src_w)).astype(np.uint8),
                             device=gpu)
    mx, my = _remap_maps(kind, gpu, src_h, src_w)
    tcuda.reset_launch_counts()
    out = remap_u8(frames, mx, my)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["remap"] == 1
    assert torch.equal(out, remap_u8_plain(frames, mx, my))
    counted = torch.zeros(2, dtype=torch.int32, device=gpu)
    assert torch.equal(remap_u8_cuda(frames, mx, my, counted), out)
    shared = tile_boxes(mx, my, src_h, src_w)["shared"]
    assert counted.tolist() == [int(shared.sum()), int((~shared).sum())]
    assert {"fisheye": shared.all(), "radtan": shared.all(), "edges": (~shared).sum() == 1,
            "scattered": ~shared.any()}[kind]


def test_remap_kernel_takes_offset_frames_and_ragged_maps(gpu):
    """Frames that start off a 16-byte boundary (a slice of a batch) fill the
    ring byte by byte, and a 37x55 map leaves ragged tiles and stores byte
    by byte: both bit-identical to the plain version."""
    from cuahn_vio_torch.ops.remap import remap_u8, remap_u8_plain

    rng = np.random.default_rng(3)
    batch = torch.as_tensor(rng.integers(0, 256, (6 * 480 * 640 + 1,)).astype(np.uint8),
                            device=gpu)
    frames = batch[1:].view(6, 480, 640)
    for mx, my in (_remap_maps("fisheye", gpu), tuple(m[:37, :55].contiguous() for m in
                                                     _remap_maps("edges", gpu))):
        out = remap_u8(frames, mx, my)
        torch.cuda.synchronize()
        assert torch.equal(out, remap_u8_plain(frames, mx, my))


def test_remap_wrapper_refuses_what_the_kernel_does_not_take(gpu):
    from cuahn_vio_torch.ops.cuda.remap import remap_u8_cuda

    frames = torch.zeros((2, 48, 64), dtype=torch.uint8, device=gpu)
    m = torch.zeros((8, 8), device=gpu)
    with pytest.raises(ValueError, match="CUDA device"):
        remap_u8_cuda(frames, m.cpu(), m)
    with pytest.raises(ValueError, match="contiguous"):
        remap_u8_cuda(frames[:, :, ::2], m, m)
    with pytest.raises(ValueError, match="uint8"):
        remap_u8_cuda(frames.float(), m, m)


def test_convert_euroc_on_gpu_remaps_in_one_launch(gpu, tmp_path):
    """``load_euroc_sequence`` on the card: one C1 launch for all frames,
    the frames equal to the CPU path's."""
    from cuahn_vio_torch.data.euroc import load_euroc_sequence, write_euroc_dir

    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (5, 480, 640)).astype(np.uint8)
    imu_t = 1.0 + np.arange(40) * 0.002
    write_euroc_dir(str(tmp_path), raw, imu_t, rng.normal(size=(40, 3)),
                    rng.normal(size=(40, 3)), 1.0 + np.arange(5) / 30.0)
    k = [275.46015578667294, 274.9948095922592, 315.958384100568, 242.7123497822731]
    d = [-6.545154718304953e-06, -0.010379525898159981, 0.014935312423953146,
         -0.005639061406567785]
    tcuda.reset_launch_counts()
    on_gpu = load_euroc_sequence(str(tmp_path), k, d, True, device=gpu)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["remap"] == 1
    np.testing.assert_array_equal(on_gpu.frames,
                                  load_euroc_sequence(str(tmp_path), k, d, True,
                                                      device="cpu").frames)


def test_pose_graph_on_gpu_is_deterministic_and_follows_the_cpu(gpu):
    """``optimize`` of a 300-keyframe chain with 40 loop factors (repeated
    pairs among them) twice on the card: bit for bit the same poses and
    costs (the assembly uses no atomics); within 1e-4 m of the CPU's."""
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.ops.quat import quat_exp
    from cuahn_vio_torch.parallel import pose_graph as pg

    f32_parity_mode()
    rng = np.random.default_rng(0)
    n = 300
    th = np.linspace(0, 4 * np.pi, n)
    p = np.stack([np.cos(th), np.sin(th), 1.5 + 0.05 * np.sin(3 * th)], 1).astype(np.float32)
    q = quat_exp(torch.tensor(np.stack([0.02 * np.sin(th), 0 * th, th], 1),
                              dtype=torch.float32))
    pairs = [(int(a), int(a + n // 2)) for a in rng.integers(0, n // 2, 40)]
    dp = rng.normal(0, 0.05, (40, 3)).astype(np.float32)
    dq = quat_exp(torch.tensor(rng.normal(0, 0.01, (40, 3)), dtype=torch.float32))
    sigmas = rng.uniform(0.01, 0.1, 40)
    out = {}
    for dev in ("cpu", gpu):
        graph = pg.chain_graph_from_trajectory(
            torch.tensor(p, device=dev), q.to(dev), 0.02, 0.01, extra_pairs=pairs,
            extra_dp=dp, extra_dq=dq.to(dev), extra_sigma_dp=sigmas)
        out[str(dev)] = [pg.optimize(graph, iters=5, huber_delta=3.0) for _ in range(2)]
    (a, b), (c, _) = out[str(gpu)], out["cpu"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (a[0].cpu() - c[0]).abs().max().item() <= 1e-4


def test_fil_step_on_gpu_follows_the_cpu(gpu, tmp_path):
    """FIL windows (64x64, window 2, batch 2, dropout off) on the card
    against the CPU: the window render launches the flat sampler once for
    the batch and agrees within one level; on the CPU's frames, the window
    loss within 1e-4 relative and each gradient leaf's cosine >= 0.9999,
    the network's warps launching the warp kernel 3 times a frame at
    B = 2."""
    import copy

    from cuahn_vio_torch.data.textures import _procedural_extras, quantize_u8
    from cuahn_vio_torch.filter.state import make_params
    from cuahn_vio_torch.models.uahn import UAHN
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.pipeline.vio import VioConfig
    from cuahn_vio_torch.train import fil
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.config import VioOptions

    import chip_smoke

    f32_parity_mode()
    chip_smoke.write_loop_trajectory(str(tmp_path / "loop_with_gt.txt"))
    cfg = fil.FilConfig(window=2, batch_size=2, imu_substeps=4, img_hw=(64, 64))
    bank = fil.build_window_bank(2, cfg, seed=0, gt_dir=str(tmp_path))
    t = np.asarray(VioOptions().t_imu_to_cam, np.float64)
    cam = (torch.tensor(t[:3, :3], dtype=torch.float32),
           torch.tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32))
    tex = torch.as_tensor(quantize_u8(np.stack(_procedural_extras(128)[:4])))
    torch.manual_seed(0)
    cpu_model = UAHN(dropout_rate=0.0, img_height=64, img_width=64)
    draws = fil.draw_windows(cfg, prng.split(prng.prng_key(0), 2), torch.arange(4), "cpu")
    frames, out = None, []
    for model, dev in ((cpu_model, torch.device("cpu")), (copy.deepcopy(cpu_model).to(gpu), gpu)):
        win = {k: torch.as_tensor(v, device=dev) for k, v in bank._asdict().items()}
        d = fil.WindowDraws(*(x.to(dev) for x in draws))
        tcuda.reset_launch_counts()
        imgs = fil.render_windows(win, d, cfg, *(x.to(dev) for x in cam), tex.to(dev))
        rendered = dict(tcuda.launch_counts)
        frames = imgs.cpu() if frames is None else frames
        tcuda.reset_launch_counts()
        loss = fil.mean_finite(fil.window_losses(
            model.flow_and_cov, make_params(VioOptions().t_imu_to_cam, device=dev), cfg,
            VioConfig(update_gate_frames=-1), win, frames.to(dev), d))
        loss.backward()
        out.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()
                                  if p.grad is not None}, rendered, dict(tcuda.launch_counts),
                    imgs.cpu()))
    (l_cpu, g_cpu, _, _, i_cpu), (l_gpu, g_gpu, r_gpu, n_gpu, i_gpu) = out
    assert r_gpu["bilinear_sample"] == 1 and n_gpu["homography_warp"] == 3 * cfg.window
    assert (i_cpu.int() - i_gpu.int()).abs().max().item() <= 1
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    assert g_cpu.keys() == g_gpu.keys() and g_cpu
    for name, g in g_cpu.items():
        cos = (g * g_gpu[name]).sum() / (g.norm() * g_gpu[name].norm())
        assert cos.item() >= 0.9999, name


def _ground_frames(n: int) -> np.ndarray:
    """(n, 224, 320) uint8 views of the procedural ground from a gentle
    drift (2 cm, 1 cm a frame and a slow yaw), rendered on the CPU."""
    from cuahn_vio_torch.data import textures as ttex
    from cuahn_vio_torch.data.synthetic import render_frame
    from cuahn_vio_torch.ops.quat import quat_exp
    from cuahn_vio_torch.utils.config import VioOptions

    t = np.asarray(VioOptions().t_imu_to_cam, np.float64)
    c_rot_i = torch.as_tensor(t[:3, :3], dtype=torch.float32)
    i_t_i2c = torch.as_tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32)
    k = torch.arange(n, dtype=torch.float32)[:, None]
    p = torch.tensor([0.1, -0.2, 1.6]) + k * torch.tensor([0.02, 0.01, 0.0])
    q = quat_exp(k * torch.tensor([0.01, -0.005, 0.02]))
    tex = torch.as_tensor(ttex.texture_u8(ttex.quantize_u8(
        np.stack(ttex._procedural_extras(ttex.TEXTURE_SIZE)))[5]))
    imgs = render_frame(p, q, c_rot_i, i_t_i2c, None, 224, 320, tex, ttex.default_tex_params(4.0))
    return np.round(np.clip(imgs.numpy(), 0, 1) * 255).astype(np.uint8)


def test_vision_front_end_on_gpu_follows_the_cpu(gpu):
    """chip_smoke phase 15a's checks at test size: ``grid_detect`` on 3
    frames and ``track_pyramidal`` on their 3 pairs (scores within 1e-5 of
    the largest, a differing pick only at a near-tie; ``valid`` equal away
    from its thresholds, tracks within 1e-3 px), ``triangulate_nview`` on
    64 points from 5 poses of a drifting flight (``ok`` equal, 1e-4 m) and
    ``preintegrate`` over 16 camera intervals of random IMU samples (1e-5,
    Jacobians 1e-4 relative). No kernel of the port launches."""
    import chip_smoke
    from cuahn_vio_torch.ops.homography import f32_parity_mode

    f32_parity_mode()
    frames = _ground_frames(4)
    rng = np.random.default_rng(0)
    s = np.linspace(0.0, 1.0, 200)[:, None]
    pose = np.concatenate([s * [1.0, 0.6, 0.2] + [0, 0, 1.5],
                           np.tile([0.02, -0.03, 0.1, 0.994], (200, 1))], axis=1)
    pose[:, 3:] /= np.linalg.norm(pose[:, 3:], axis=1, keepdims=True)
    imu_t = np.arange(600) / 500.0
    inputs = chip_smoke.preint_inputs(imu_t, rng.normal(0, 0.4, (600, 3)),
                                      rng.normal(0, 1, (600, 3)) + [0, 0, 9.81],
                                      np.arange(36) / 30.0, [0.01, 0, 0], [0, 0.05, 0])
    tcuda.reset_launch_counts()
    found = [chip_smoke.check_grid_detect(torch, gpu, frames[:3]),
             chip_smoke.check_tracks(torch, gpu, frames),
             chip_smoke.check_triangulation(torch, gpu, pose),
             chip_smoke.check_preintegration(torch, gpu, inputs)]
    assert found[1]["cpu_valid_tracks"] > 100 and found[2]["ok"] > 32
    assert inputs[2].shape == (16, 17)
    assert not any(tcuda.launch_counts.values())


def test_error_map_on_gpu_follows_the_cpu(gpu):
    """The UAHN's error map of one pair (v10, dropout 0, float frames) on
    the card within 0.05 levels of the CPU's on 99.9 % of the pixels
    (chip_smoke phase 15a), through 4 launches of the float32 warp."""
    import chip_smoke
    from cuahn_vio_torch.ops.homography import f32_parity_mode

    f32_parity_mode()
    tcuda.reset_launch_counts()
    found = chip_smoke.check_error_map(torch, gpu, _ground_frames(2))
    assert tcuda.launch_counts["homography_warp"] == 4
    assert found["share_within"] >= 0.999


def test_diagnostics_verbs_on_gpu(gpu, tmp_path):
    """``inspect-frame``, ``eval-flow`` and ``track-features`` on the card
    by default: the PNG, the npz files, and the warp launches (4 at B = 1
    for inspect-frame, 3 a batch for eval-flow, none for track-features)."""
    from cuahn_vio_torch import cli
    from cuahn_vio_torch.eval.simulation import StateGT, save_state_gt
    from cuahn_vio_torch.utils.png import read_png

    import chip_smoke

    frames = _ground_frames(6)
    cam_t = np.arange(6) / 30.0
    np.savez(tmp_path / "seq.npz", frames=frames, cam_t=cam_t)
    k = np.arange(6)[:, None]
    save_state_gt(str(tmp_path / "gt.txt"), StateGT(
        times=cam_t, pose=np.concatenate([[0.1, -0.2, 1.6] + k * [0.02, 0.01, 0.0],
                                          np.tile([0, 0, 0, 1.0], (6, 1))], 1),
        vel=np.zeros((6, 3)), bg=np.zeros((6, 3)), ba=np.zeros((6, 3))))
    path = lambda name: str(tmp_path / name)  # noqa: E731
    tcuda.reset_launch_counts()
    cli.main(["inspect-frame", path("seq.npz"), "--frame", "1", "--weights",
              chip_smoke.WEIGHTS, "--out", path("i.png")])
    assert tcuda.launch_counts["homography_warp"] == 4 and read_png(path("i.png")).shape == (
        224, 960)
    tcuda.reset_launch_counts()
    cli.main(["eval-flow", path("seq.npz"), path("gt.txt"), "--weights", chip_smoke.WEIGHTS,
              "--batch", "3", "--out", path("f.npz")])
    assert tcuda.launch_counts["homography_warp"] == 6
    assert np.isfinite(np.load(path("f.npz"))["pred"]).all()
    tcuda.reset_launch_counts()
    cli.main(["track-features", path("seq.npz"), "--out", path("t.npz")])
    assert not any(tcuda.launch_counts.values())
    assert np.load(path("t.npz"))["ids"].shape == (6, 80)


def test_replay_on_gpu_follows_the_cpu(gpu):
    """``replay_measurements`` of the smoke's committed log
    (``chip_smoke.TUNE_LOG``) on its sequence (the card's ``make_sequence``
    of ``chip_smoke.SEQ``) over an 8-point grid on the card and on the
    CPU: positions within 1e-4 m, no kernel launched by the replay."""
    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.eval import tuning
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.utils.config import VioOptions

    import chip_smoke

    f32_parity_mode()
    log = np.load(os.path.join(chip_smoke.REPO, chip_smoke.TUNE_LOG))
    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    made = make_sequence(AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam), device=gpu,
                         **chip_smoke.SEQ)
    seq = {k: getattr(made, k) for k in ("imu_t", "imu_w", "imu_a", "cam_t")}
    opts.calib_camimu_dt, opts.init_imu_thresh = 0.0, 0.2
    opts.init_height = float(made.gt_pose_w[0, 2])
    grid = [tuning.SweepConfig(k_net_cov=k, q_scale=qs, echo_beta=eb, bias_sigma_px=eb)
            for k in (4.0, 12.0) for qs in (1.0, 4.0) for eb in (0.0, 0.3)]
    outs = {}
    tcuda.reset_launch_counts()
    for dev in ("cpu", gpu):
        outs[str(dev)], _ = tuning.replay_measurements(
            seq["imu_t"], seq["imu_w"], seq["imu_a"], seq["cam_t"], log["net_mean"],
            log["net_cov88"], opts.filter_params(dev), grid, opts.runner_options(),
            opts.vio_config())
    assert not any(tcuda.launch_counts.values())
    np.testing.assert_allclose(outs[str(gpu)].p_world, outs["cpu"].p_world, atol=1e-4, rtol=0)


def test_schur_smoother_on_gpu_is_deterministic_and_follows_the_cpu(gpu):
    """``optimize_sharded`` of the self-test's ring in 4 blocks on one card,
    twice: the same bits; within 1e-5 m of the CPU's and 2e-3 m of the
    dense solve on the card."""
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.parallel import pose_graph as pg
    from cuahn_vio_torch.parallel import pose_graph_sharded as pgs
    from cuahn_vio_torch.parallel.mesh import make_mesh
    from cuahn_vio_torch.parallel.selftest import ring_graph

    f32_parity_mode()
    out = {}
    for dev in ("cpu", gpu):
        sg = pgs.partition_graph(ring_graph(np.random.default_rng(1), dev), 4)
        runs = [pgs.optimize_sharded(sg, make_mesh(dev), iters=10) for _ in range(2)]
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        out[str(dev)] = pgs.reassemble(sg, *runs[0][:4])
    np.testing.assert_allclose(out[str(gpu)][0], out["cpu"][0], atol=1e-5, rtol=0)
    dense, _, _ = pg.optimize(ring_graph(np.random.default_rng(1), gpu), iters=10)
    np.testing.assert_allclose(out[str(gpu)][0], dense.cpu().numpy(), atol=2e-3, rtol=0)


def test_selftest_on_gpu_follows_the_cpu(gpu):
    """``distributed-selftest`` as one process on the card: the checksums
    of the CPU run within 1e-5 relative."""
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.parallel.selftest import run_selftest

    f32_parity_mode()
    card, cpu = run_selftest(device=gpu), run_selftest(device="cpu")
    assert card["device"].startswith("cuda") and card["n_processes"] == 1
    for key in ("filter_pos_checksum", "filter_cov_checksum", "pose_checksum"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=1e-5, err_msg=key)


def test_train_data_parallel_in_a_one_rank_nccl_group_follows_the_plain_path(gpu, tmp_path):
    """Two 56x80 steps (batch 4, photo textures and effects, the echo
    penalty on) plain, then inside a one-rank NCCL group (``FileStore``, in
    process): the data-parallel path (global denominators and echo moments
    through NCCL, the flat gradient's ``all_reduce``) logs its line and the
    plain path's losses, and its weights are within 1e-5 of the plain
    path's (cuDNN's backward is not bit-deterministic)."""
    import torch.distributed as dist

    from cuahn_vio_torch.models.uahn import init_uahn
    from cuahn_vio_torch.train import trainer as T
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.config import VioOptions

    t = np.asarray(VioOptions().t_imu_to_cam, np.float64)
    cam = (torch.tensor(t[:3, :3], dtype=torch.float32),
           torch.tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32))
    cfg = T.TrainConfig(batch_size=4, blur_taps=2, echo_weight=0.5, prior_prob=1.0)

    def run():
        model = init_uahn(prng.prng_key(0), 56, 80, device=gpu)
        log = []
        T.train(model, *cam, cfg, steps=2, seed=0, log_every=1, height=56, width=80,
                log_fn=lambda m, **_: log.append(m), probe_every=0,
                gt_dir=str(tmp_path / "no_gt"))
        return model.state_dict(), log

    plain, plain_log = run()
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        parallel, log = run()
    finally:
        dist.destroy_process_group()
    assert log[0] == "data-parallel over 1 ranks (seq mesh)"
    assert log[1:] == plain_log
    assert max((parallel[k] - plain[k]).abs().max().item() for k in plain) <= 1e-5

"""The port's undistortion map and remap against the JAX package's C++ host
runtime (``cuahn_vio.runtime``, ``undistort.cpp``), on the CPU.

- ``build_undist_map`` (float64 torch ops, rounded to float32) against the
  C++ maps: equal on at least 99.99 % of the entries and within one
  float32 ulp everywhere (the port takes the fisheye angle from the C
  library's ``atan``, as the C++ does, and is equal here; the bound is for
  float64 operations that another build may round otherwise).
- ``remap_u8_plain`` against the C++ ``remap_u8_batch``, bit for bit (at
  48x64, and at the raw widths 641 and 752 at N = 3). That
  needs the C++ rounding as the JAX package builds it: ``g++ -O3
  -march=native -std=c++17`` does contract ``acc += w * src`` into a fused
  multiply-add (GCC's ``-ffp-contract=off`` in ISO mode is for C, not
  C++; the built library holds ``vfmadd`` instructions on an FMA host), so
  the port accumulates the taps with an exact float32 fma
  (``ops.remap.fma_f32``). Without that, ~2 pixels in a million of a
  640x480 fisheye remap differ by a level.

The C1 kernel against ``remap_u8_plain`` on the card is in
``tests/test_torch_cuda.py`` (it skips here).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from cuahn_vio_torch.ops import remap as tremap
from cuahn_vio_torch.runtime import undistort as trt

jrt = pytest.importorskip("cuahn_vio.runtime")

UZH_K = [275.46015578667294, 274.9948095922592, 315.958384100568, 242.7123497822731]
UZH_D = [-6.545154718304953e-06, -0.010379525898159981, 0.014935312423953146,
         -0.005639061406567785]  # Kannala-Brandt, the default config's
EUROC_K = [458.654, 457.296, 367.215, 248.375]
EUROC_D = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]  # radtan


@pytest.mark.parametrize("k, d, fisheye, shape", [
    (UZH_K, UZH_D, True, (320, 224)),
    (EUROC_K, EUROC_D, False, (320, 224)),
    ([300.0, 290.0, 200.0, 150.0], [0.05, -0.02, 0.004, -0.001], True, (97, 61)),
    ([300.0, 290.0, 200.0, 150.0], [-0.2, 0.05, 0.001, -0.002], False, (97, 61)),
], ids=["fisheye", "radtan", "fisheye-97x61", "radtan-97x61"])
def test_undist_map_matches_the_cpp_runtime(k, d, fisheye, shape):
    out_w, out_h = shape
    want = jrt.build_undist_map(k, d, fisheye, out_w, out_h)
    got = trt.build_undist_map(k, d, fisheye, out_w, out_h, device="cpu")
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.float32 and g.shape == (out_h, out_w)
        assert (g == w).mean() >= 0.9999
        ulp = np.spacing(np.abs(w).astype(np.float32))
        assert (np.abs(g - w) <= ulp).all()


def _maps(kind: str, rng, out_h: int, out_w: int, src_h: int, src_w: int):
    u, v = np.meshgrid(np.arange(out_w, dtype=np.float32), np.arange(out_h, dtype=np.float32))
    if kind == "identity":
        return u, v
    if kind == "translation":
        return u + np.float32(3.25), v - np.float32(1.5)
    if kind == "off-image":  # left, top, right and bottom of the image, and its edges
        mx = (u - out_w / 2) * np.float32(3.0) + src_w / 2
        my = (v - out_h / 2) * np.float32(3.0) + src_h / 2
        mx[0, :5] = [-1.0, -0.5, src_w - 1, src_w - 0.5, src_w]
        my[0, :5] = [0.0, -1.0, src_h - 1, src_h - 0.75, -0.0]
        return mx, my
    return (rng.uniform(-3.0, src_w + 2.0, (out_h, out_w)).astype(np.float32),
            rng.uniform(-3.0, src_h + 2.0, (out_h, out_w)).astype(np.float32))


@pytest.mark.parametrize("kind", ["identity", "translation", "off-image", "random"])
@pytest.mark.parametrize("n", [1, 3])
def test_remap_plain_is_bit_identical_to_the_cpp_remap(kind, n, rng):
    src_h, src_w, out_h, out_w = 48, 64, 40, 56
    frames = rng.integers(0, 256, (n, src_h, src_w)).astype(np.uint8)
    mx, my = _maps(kind, rng, out_h, out_w, src_h, src_w)
    want = jrt.undistort_frames(frames, mx, my)
    got = tremap.remap_u8_plain(torch.as_tensor(frames), torch.as_tensor(mx),
                                torch.as_tensor(my)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the entry point takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        tremap.remap_u8(torch.as_tensor(frames), torch.as_tensor(mx), torch.as_tensor(my)).numpy(),
        want)


@pytest.mark.parametrize("src_h, src_w", [(479, 641), (480, 752)], ids=["641x479", "752x480"])
@pytest.mark.parametrize("kind", ["identity", "translation", "off-image", "random"])
def test_remap_plain_is_bit_identical_to_the_cpp_remap_at_raw_widths(kind, src_h, src_w, rng):
    """The same at the raw widths the kernel C1 handles apart (641: rows off
    16-byte boundaries; EuRoC's 752), 224x320 out, N = 3."""
    frames = rng.integers(0, 256, (3, src_h, src_w)).astype(np.uint8)
    mx, my = _maps(kind, rng, 224, 320, src_h, src_w)
    want = jrt.undistort_frames(frames, mx, my)
    got = tremap.remap_u8_plain(torch.as_tensor(frames), torch.as_tensor(mx),
                                torch.as_tensor(my)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_h, src_w", [(479, 641), (480, 752)], ids=["641x479", "752x480"])
@pytest.mark.parametrize("fisheye", [True, False], ids=["fisheye", "radtan"])
def test_undistort_frames_match_the_cpp_runtime_at_raw_widths(fisheye, src_h, src_w, rng):
    """The camera maps at those raw sizes, N = 3, bit for bit."""
    k, d = (UZH_K, UZH_D) if fisheye else (EUROC_K, EUROC_D)
    frames = rng.integers(0, 256, (3, src_h, src_w)).astype(np.uint8)
    want = jrt.undistort_frames(frames, *jrt.build_undist_map(k, d, fisheye))
    got = trt.undistort_frames(torch.as_tensor(frames),
                               *trt.build_undist_map(k, d, fisheye, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fisheye", [True, False], ids=["fisheye", "radtan"])
def test_undistort_frames_match_the_cpp_runtime_at_640x480(fisheye, rng):
    """The whole CPU path at the real shape: raw 640x480 frames through the
    port's map and remap equal the C++ runtime's, bit for bit."""
    k, d = (UZH_K, UZH_D) if fisheye else (EUROC_K, EUROC_D)
    frames = rng.integers(0, 256, (2, 480, 640)).astype(np.uint8)
    want = jrt.undistort_frames(frames, *jrt.build_undist_map(k, d, fisheye))
    got = trt.undistort_frames(torch.as_tensor(frames),
                               *trt.build_undist_map(k, d, fisheye, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_remap_defines_what_the_cpp_leaves_undefined(rng):
    """NaN and huge coordinates (undefined in the C++: a float cast to int
    out of range) give 0 in the port."""
    frames = torch.as_tensor(rng.integers(1, 256, (2, 8, 8)).astype(np.uint8))
    mx = torch.tensor([[np.nan, 3.0, 1e9, -1e9, 2.5]], dtype=torch.float32)
    my = torch.tensor([[3.0, np.nan, 3.0, 3.0, 1e30]], dtype=torch.float32)
    assert (tremap.remap_u8_plain(frames, mx, my) == 0).all()


def test_remap_refuses_what_it_does_not_take():
    frames = torch.zeros((1, 4, 4), dtype=torch.uint8)
    m = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="uint8"):
        tremap.remap_u8_plain(frames.float(), m, m)
    with pytest.raises(TypeError, match="float32"):
        tremap.remap_u8_plain(frames, m.double(), m.double())
    with pytest.raises(ValueError, match="map_x, map_y"):
        tremap.remap_u8_plain(frames, m, m[:1])


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded once to the nearest float32, ties to even."""
    guess = np.float32(float(x))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma_f32_rounds_once(rng):
    """``fma_f32`` is fmaf: a * b + c rounded once, against exact rational
    arithmetic, on random operands and on sums whose float64 rounding lands
    on a float32 midpoint (where a float64 sum rounded to float32 rounds
    twice)."""
    a = rng.uniform(-2, 2, 3000).astype(np.float32)
    b = rng.uniform(-300, 300, 3000).astype(np.float32)
    c = rng.uniform(-300, 300, 3000).astype(np.float32)
    # a*b = 2^-24 + 2^-60 (9916672 x 14192008 = 2^11 (2^36 + 1)) and c = 1:
    # the float64 sum rounds to 1 + 2^-24, a float32 midpoint, and then to
    # 1.0 (ties to even); fmaf gives 1 + 2^-23. Its mirror image likewise.
    a[:2] = [np.float32(9916672 * 2.0 ** -48), np.float32(-9916672 * 2.0 ** -48)]
    b[:2] = [np.float32(14192008 * 2.0 ** -23)] * 2
    c[:2] = [np.float32(1.0), np.float32(-1.0)]
    got = tremap.fma_f32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    naive = (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)
    assert (naive[:2] != want[:2]).all() and want[0] == np.float32(1 + 2.0 ** -23)

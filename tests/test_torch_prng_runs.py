"""The parts of kernel T1's run layout that the CPU can check.

T1 (``cuahn_vio_torch/ops/cuda/prng.cu``) draws a run of consecutive flat
values a thread and takes its Bernoulli coin as one integer compare,
``(bits >> 9) < utils/prng.bernoulli_threshold(p)``. Here, on the CPU:

- that threshold equals ``jax.random.bernoulli``'s float compare
  ``unit float < float32(p)`` over all 2^23 mantissas (the 9 low bits,
  which the unit float drops, drawn at random), both as numpy's float32
  arithmetic and as the plain version's ``uniform_from_bits``, at every p
  the port draws a Bernoulli with (run-vio's MC-dropout keep rate, the
  trainer's bank and big-baseline shares, the effects' clean share) and at
  0, 1, 1 - 2^-24, a subnormal, NaN and the values a tolerance would hide;
- the plain version (``draw_plain``) on the layouts the runs make risky
  (rows of 0, 1, R - 1, R + 1 and 3R values for runs of R = 4, 8 and 16,
  runs over many rows of 1 value, 4,096 rows of 1,001 values) equals each
  key drawn alone and, for the small rows, ``jax.random`` bit for bit;
  the large layout equals the host's threefry and the threshold's coins;
- the kernel's source itself, built for the host by g++ (CUDA's few
  intrinsics as plain C++, the grid run block by block, thread by
  thread), bit for bit the plain version on those layouts at its own
  constants and at constants that make them take runs of 2, 4 and the
  longest runs (a run over many rows, a partial last run), with nothing
  written past the output.

The kernel itself is held to ``draw_plain`` on these layouts on the card
(``tests/test_torch_cuda.py``, ``T1_CASES``; ``chip_smoke.py`` phase 3b).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio_torch.data.sensor_effects import EffectsConfig
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.train.trainer import TrainConfig
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.config import VioOptions

torch.set_num_threads(2)

MANTISSAS = 2**23
# the p of every Bernoulli the port draws, at their defaults, and the edges
PORT_PS = {
    "mc_dropout_keep": 1.0 - VioOptions().mc_dropout,
    "traj_pair_prob": TrainConfig().traj_pair_prob,
    "big_baseline_prob": TrainConfig().big_baseline_prob,
    "clean_prob": EffectsConfig().clean_prob,
}
EDGE_PS = {
    "zero": 0.0, "one": 1.0, "below_one": 1.0 - 2.0**-24, "two": 2.0,
    "subnormal": float(np.nextafter(np.float32(0), np.float32(1))), "tiny": 1e-30,
    "half": 0.5, "rate": 0.05, "near_one": 0.9999999, "negative": -0.5, "nan": float("nan"),
}
RUNS = (4, 8, 16)  # run lengths the kernel takes (prng.cu's kRunMask, kRunWord, halved)
LAYOUTS = {
    "short_rows": [c for r in RUNS for c in (0, 1, r - 1, r + 1, 3 * r)] + [2],
    "ones": [1] * 37 + [0, 0] + [1] * 3,
    "empty_ends": [0, 0, 17, 0, 33, 0, 0],
}


@pytest.mark.parametrize("p", list({**PORT_PS, **EDGE_PS}.values()),
                         ids=list({**PORT_PS, **EDGE_PS}))
def test_bernoulli_threshold_is_the_float_compare(p):
    t = prng.bernoulli_threshold(p)
    assert 0 <= t <= MANTISSAS
    m = np.arange(MANTISSAS, dtype=np.uint32)
    low = np.random.default_rng(0).integers(0, 512, MANTISSAS, dtype=np.uint32)
    bits = (m << np.uint32(9)) | low
    unit = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    with np.errstate(invalid="ignore"):
        want = unit < np.float32(p)
    np.testing.assert_array_equal(m < t, want)
    # the plain version's own coin on the same bits
    plain = prng.uniform_from_bits(torch.from_numpy(bits.astype(np.int64)), 0.0, 1.0)
    np.testing.assert_array_equal((plain < float(np.float32(p))).numpy(), want)


def _keys(n: int) -> np.ndarray:
    return prng.split(prng.prng_key(n), n)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_short_rows_are_each_keys_own_draw_and_jaxs(name):
    counts = LAYOUTS[name]
    keys = _keys(len(counts))
    kt = prng.keys_tensor(keys)
    before = dict(tcuda.launch_counts)
    for mode, a, b in ((prng.BITS, 0.0, 1.0), (prng.UNIFORM, 0.3, 1.7),
                       (prng.BERNOULLI, 0.95, 1.0), (prng.NORMAL, 0.0, 1.0),
                       (prng.TRUNC_NORMAL, -2.0, 2.0)):
        flat = prng.draw(kt, counts, mode, a, b)
        assert flat.shape == (sum(counts),)
        for i, (row, c) in enumerate(zip(torch.split(flat, counts), counts)):
            assert torch.equal(row, prng.draw(kt[i:i + 1], [c], mode, a, b)), (mode, i)
            k = jnp.asarray(keys[i])
            if mode == prng.BITS:
                want = np.asarray(jax.random.bits(k, (c,), jnp.uint32))
                np.testing.assert_array_equal(row.numpy().view(np.uint32), want)
            elif mode == prng.UNIFORM:
                want = np.asarray(jax.random.uniform(k, (c,), minval=0.3, maxval=1.7))
                np.testing.assert_array_equal(row.numpy().view(np.uint32), want.view(np.uint32))
            elif mode == prng.BERNOULLI:
                want = np.asarray(jax.random.bernoulli(k, 0.95, (c,)))
                np.testing.assert_array_equal(row.numpy().astype(bool), want)
    assert tcuda.launch_counts == before  # CPU keys take the plain version


def test_many_rows_match_the_host_threefry_and_the_threshold():
    """4,096 rows of 1,001 values (runs end inside rows, a run spans two
    rows at every row's end): the plain bits are the host's threefry of
    (key, (0, j)), its Bernoulli coins are ``(bits >> 9) < T``, and sampled
    rows are each key's own draw and JAX's."""
    rows, n = 4096, 1001
    keys = _keys(rows)
    kt = prng.keys_tensor(keys)
    bits = prng.draw(kt, [n] * rows, prng.BITS).numpy().view(np.uint32).reshape(rows, n)
    j = np.arange(n, dtype=np.uint32)
    y0, y1 = prng.threefry2x32(keys[:, None, :], np.zeros_like(j), j)
    np.testing.assert_array_equal(bits, y0 ^ y1)
    coins = prng.draw(kt, [n] * rows, prng.BERNOULLI, 0.95).numpy().reshape(rows, n)
    np.testing.assert_array_equal(coins, (bits >> np.uint32(9)) < prng.bernoulli_threshold(0.95))
    for i in (0, 1, 2047, rows - 1):
        np.testing.assert_array_equal(
            bits[i], prng.draw(kt[i:i + 1], [n], prng.BITS).numpy().view(np.uint32))
        np.testing.assert_array_equal(
            bits[i], np.asarray(jax.random.bits(jnp.asarray(keys[i]), (n,), jnp.uint32)))


# The kernel's source compiled for the host: CUDA's few intrinsics as plain
# C++, a loop over the grid's blocks and threads in place of the launch.
HOST_SHIM = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct Idx { unsigned x; };
static Idx blockIdx, threadIdx;
struct dim3 { unsigned x; dim3(unsigned x_) : x(x_) {} };
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return cudaSuccess; }  // one SM
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
template <class T> T __ldg(const T* p) { return *p; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
template <int M, int R>
void threefry_kernel(const uint32_t*, const int64_t*, void*, int, int64_t, float, float, float,
                     float, uint32_t);
template <int M, int R, class... A>
void emulate(dim3 grid, unsigned threads, A... args) {
  for (unsigned b = 0; b < grid.x; ++b)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      threefry_kernel<M, R>(args...);
    }
}
"""
# constants of prng.cu set for the host build (one SM: a draw's run is
# halved while it would leave fewer than kFillPerSM threads): the source's
# own, every run the longest (runs over many short rows), runs of 4 and 2,
# runs of 2, and blocks of 32 threads
HOST_VARIANTS = {
    "source": {},
    "longest_runs": {"kFillPerSM": "0"},
    "runs_of_4": {"kThreads": "32", "kRunMask": "4", "kRunWord": "4", "kFillPerSM": "3"},
    "runs_of_2": {"kRunMask": "2", "kRunWord": "2", "kFillPerSM": "0"},
    "small_blocks": {"kThreads": "32", "kFillPerSM": "2"},
}
HOST_LAYOUTS = dict(LAYOUTS, ragged=[1, 0, 257, 4099], rows=[1001] * 24, single=[1],
                    last_empty=[5, 0], eight=[0, 3, 0, 17, 1, 0, 40, 0])


def _host_library(tmp_path, consts: dict):
    import ctypes
    import re
    import shutil
    import subprocess

    from cuahn_vio_torch.ops.cuda import prng as prng_cuda
    from tune_remap import variant_source

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    source = prng_cuda.SOURCE
    if consts:
        source = variant_source(source, "variant", ",".join(f"{k}={v}" for k, v in consts.items()),
                                str(tmp_path))
    with open(source) as f:
        src = f.read()
    src, n = re.subn(r"threefry_kernel<(\w+), (\w+)><<<(\w+), (\w+), 0, \w+>>>\(",
                     r"emulate<\1, \2>(\3, \4, ", src)
    assert n == 1, "prng.cu's launch is not where the host build expects it"
    src = src.replace("#include <cuda_runtime.h>", HOST_SHIM)
    (tmp_path / "prng_host.cpp").write_text(src)
    lib = tmp_path / "libprng_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib), str(tmp_path / "prng_host.cpp")], check=True, timeout=300)
    host = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    host.threefry_draw.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                   *[ctypes.c_float] * 4, ctypes.c_uint, p]
    host.threefry_values_per_thread.argtypes = [ctypes.c_int, ctypes.c_longlong]
    return host


@pytest.mark.parametrize("variant", sorted(HOST_VARIANTS))
def test_kernel_layout_on_the_host_is_the_plain_version(tmp_path, variant):
    """prng.cu built for the host runs its grid thread by thread: bits,
    uniform and Bernoulli bit for bit the plain version's on every layout,
    nothing written past the output, at the source's constants and at
    constants that make every layout take long or short runs (the normals
    are left out: the host's log1pf is not the card's)."""
    host = _host_library(tmp_path, HOST_VARIANTS[variant])
    runs = set()
    for name, counts in HOST_LAYOUTS.items():
        keys = prng.keys_tensor(_keys(len(counts)))
        offsets = torch.tensor([0, *np.cumsum(counts)], dtype=torch.int64)
        total = sum(counts)
        for mode, a, b, dtype in ((prng.BITS, 0.0, 1.0, torch.int32),
                                  (prng.UNIFORM, 0.3, 1.7, torch.float32),
                                  (prng.BERNOULLI, 0.95, 1.0, torch.uint8)):
            size = total * dtype.itemsize
            out = torch.full((size + 64,), 0xAB, dtype=torch.uint8)
            t = prng.bernoulli_threshold(a) if mode == prng.BERNOULLI else 0
            runs.add(host.threefry_values_per_thread(mode, total))
            assert host.threefry_draw(keys.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                                      len(counts), total, mode, a, b, 0.0, 0.0, t, None) == 0
            assert bool((out[size:] == 0xAB).all()), (name, mode)
            got = out[:size].view(dtype)
            assert torch.equal(got, prng.draw_plain(keys, counts, mode, a, b)), (name, mode)
    if variant != "source":
        assert max(runs) > 1

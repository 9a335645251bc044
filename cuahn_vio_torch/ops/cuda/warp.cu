// Bilinear sampling kernels for Hopper (sm_90a): the homography warp, its
// row-band batched form, and the flat-coordinate sampler.
//
// Replaces the Pallas TPU kernels of cuahn_vio/ops/pallas/warp_kernel.py:
//   warp_kernel      homography_warp_pallas (exact_u8 and hi/lo, :512-547,
//                    via _sample_flat :154/:165), warp_pallas_u8 (:551) and
//                    homography_warp_pallas_batch (:484-508, via
//                    _sample_lanes_batched :468/:475);
//   rowskip_kernel   _sample_lanes_rowskip (:290-417, call :403), the batched
//                    warp under BATCH_SAMPLER = "rowskip";
//   flat_kernel      bilinear_sample_pallas (:173-188, via _sample_flat), the
//                    texture sampler of data/textures.py sample_plane, and
//                    its batch over textures (jax.vmap in the JAX trainer).
//
// What every kernel computes, per sample point: source coordinates (su, sv),
// for the warps [x, y, z] = H_b [u, v, 1] in float32 (see row_dot) and
// su = x/z, sv = y/z (IEEE divisions); a NaN coordinate gives NaN; otherwise
// both are clipped to +-1e4 (an infinite coordinate then samples nothing and
// gives 0) and the image is sampled bilinearly with zeros padding
// (grid_sample bilinear / zeros / align_corners=True, in pixel coordinates).
// uint8 images are read directly and the blend of the raw values is
// multiplied by 1/255; float32 images are sampled as they are. All three
// share sample_bilinear, so the tap arithmetic is one piece of code, and
// each is bit-identical to the plain version (ops/warp.py): built with
// -fmad=false, the only fma is row_dot's, which the plain version repeats.
//
// What bounds them: a 224x320 frame is 71,680 B of uint8 read and 286,720 B
// of float32 written, ~0.11 us at 3.35 TB/s, far below a launch's few
// microseconds; at B = 64 the bytes take ~7 us. The arithmetic is ~40 flops
// a pixel, but two IEEE divisions (each a reciprocal, five fmas and a
// slow-path check), four gathers and their addressing make each pixel
// ~100-150 instructions: at large B the warps are bound by instruction issue
// before bytes, at small B by the launch and one chain of dependent loads
// (homography, taps) that the card's threads must hide. The flat sampler
// reads 8 B of coordinates and writes 4 B per point, plus the texture.
//
// What the design does about it: the TPU kernels avoid gathers with
// one-hot bf16 MXU matmuls, which Hopper does not need; here taps are
// gathers through the read-only path.
//   warp_kernel: each thread owns P adjacent output pixels of one row. Its
//   row and first column come from one division per thread, not per pixel;
//   the 9 homography floats are loaded once into registers; offsets inside
//   an image are 32-bit (the wrapper refuses larger images); each tap is
//   read at an in-image index (an off-image one mapped there by one
//   unsigned min) and an off-image tap is selected to 0 (its weight is
//   >= 0, so w * 0 = +0 and the sum is unchanged bit for bit), so there is
//   no branch per tap; a row's outputs go out as 8- or 16-byte stores when
//   the width allows. P (1, 2, 4 or 8) is chosen per launch from its size:
//   the fewest pixels a thread whose threads all fit on the card at once
//   (a small launch is bound by the latency of its loads, which more
//   threads hide), else the most (a large one is bound by instruction
//   issue, which per-thread work spread over more pixels saves). The grid
//   is (pixel tiles of kThreads x P, B), one launch for the whole batch.
//   rowskip_kernel is the TPU row-skip translated: the TPU prefetched each
//   tile's touched row range from the host and skipped 128-row image blocks
//   outside it; here a block computes its own range. It tiles as
//   warp_kernel does. Each thread computes its pixels' coordinates once and
//   keeps them in registers; a warp min/max reduction and one shared slot
//   per warp give the rows [rmin, rmax] that the tile's in-image taps read;
//   one thread copies just those rows into shared memory with a bulk
//   asynchronous copy (cp.async.bulk, completion on an mbarrier) when the
//   band is 16-byte aligned, else every thread copies bytes; the block
//   samples from there. A tile whose band exceeds kBandBytes reads its taps
//   from global memory as warp_kernel does (the TPU's straddling tile
//   likewise pays for every block it needs); a tile with no in-image tap
//   loads nothing. The band holds copies of the very values warp_kernel
//   reads, so the two are bit-identical.
//   flat_kernel takes coordinates instead of a homography, for B textures
//   at once (B = 1 for a render). Its shapes: a sharp frame, 71,680
//   points; a blurred frame, 3 x 71,680 in one launch; the trainer's
//   batch, 16 textures x 215,040. The first two fit on the card in one
//   wave, so the launch (~1.3 us of a ~2.9 us call) and two dependent
//   round trips (the coordinates, then the taps they address) bound them.
//   At the third, 41 MB of coordinates and outputs cross device memory
//   (~12 us at 3.35 TB/s), but the taps bound it: at the trainer's texture
//   scales the points of a warp scatter over the texture, and each load
//   of a warp costs one L1 wavefront per distinct line it touches, up to
//   32. So a block takes kFlatThreads x P adjacent points and a thread
//   every kFlatThreads-th of them (P per launch by the warps' rule,
//   pixels_per_thread on B rows of n points: 1 at the first two shapes,
//   8 at the third): each load of a warp covers 32 adjacent points, whose
//   coordinates and outputs are whole lines and whose taps lie close.
//   (P adjacent points a thread with 16-byte coordinate loads spread each
//   tap load over P times the texture and was 1.5x slower at the third
//   shape; PERF.md.) uint8 rows of whole 4-byte words read both taps of a
//   row from one word (WordTaps): two or three loads a point instead of
//   four. The grid is (point tiles, B), each
//   texture's pointer in a register (opaque), offsets 32-bit within a
//   texture and over the B x n points.
//
// The tile and band sizes, the bulk copy and the flat sampler's point
// layout and word taps were chosen on the H100 by timing alternatives (tune_warp.py builds a modified copy of this file
// with --baseline; PERF.md has the table).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;  // threads per block of the warps
// adjacent output pixels per thread of the warps: a power of two in
// [kPixelsMin, kPixelsMax], chosen per launch (pixels_per_thread)
constexpr int kPixelsMin = 1;
constexpr int kPixelsMax = 8;
constexpr int kBandBytes = 16384;  // rowskip_kernel's shared row band
constexpr int kWarps = kThreads / 32;
constexpr int kFlatThreads = 256;  // threads per block of the flat sampler
constexpr float kClip = 1e4f;

// h0*u + h1*v + h2, rounded as fma(h1, v, h0*u) + h2: the rounding of the
// reference's float32 H @ grid matmul (and of the plain version). The fma
// rounds once over h1*v + h0*u, so no part of it can be hoisted per row.
__device__ __forceinline__ float row_dot(float h0, float h1, float h2, float u, float v) {
  return __fadd_rn(__fmaf_rn(h1, v, __fmul_rn(h0, u)), h2);
}

struct Homography {  // one row-major 3x3, held in registers
  float m[9];
  __device__ __forceinline__ explicit Homography(const float* hs) {
#pragma unroll
    for (int i = 0; i < 9; ++i) m[i] = __ldg(hs + i);
  }
  // source coordinates of output pixel (u, v)
  __device__ __forceinline__ void coords(float u, float v, float* su, float* sv) const {
    const float x = row_dot(m[0], m[1], m[2], u, v);
    const float y = row_dot(m[3], m[4], m[5], u, v);
    const float z = row_dot(m[6], m[7], m[8], u, v);
    *su = __fdiv_rn(x, z);
    *sv = __fdiv_rn(y, z);
  }
};

// Tap readers: a tap row's and column's offsets, and the raw value at row
// offset + column offset. An in-image tap's index is its own; any other is
// mapped to some index the reader may touch (one unsigned min: a negative
// index wraps to the last), whose value sample_bilinear then discards.
__device__ __forceinline__ unsigned inside(int i, int last) {
  return min(static_cast<unsigned>(i), static_cast<unsigned>(last));
}

// p, as a value the compiler keeps in registers: without this it
// recomputes an image's address from the kernel parameters (two constant
// loads, a multiply and a sign extension) for every tap.
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm("" : "+l"(p));
  return p;
}

template <typename T>
struct GlobalTaps {  // a whole image in global memory, read-only path
  static constexpr bool kPairs = false;
  const T* img;  // opaque()
  int h, w, sh, sw;
  __device__ __forceinline__ unsigned row(int y) const { return inside(y, h - 1) * sh; }
  __device__ __forceinline__ unsigned col(int x) const { return inside(x, w - 1) * sw; }
  __device__ __forceinline__ float at(unsigned off) const {
    return static_cast<float>(__ldg(img + off));
  }
};

template <typename T>
struct BandTaps {  // rows r0..r1 of a contiguous w-wide image, in shared memory
  static constexpr bool kPairs = false;
  const T* band;
  int r0, r1, w;
  __device__ __forceinline__ unsigned row(int y) const { return inside(y - r0, r1 - r0) * w; }
  __device__ __forceinline__ unsigned col(int x) const { return inside(x, w - 1); }
  __device__ __forceinline__ float at(unsigned off) const {
    return static_cast<float>(band[off]);
  }
};

struct NoTaps {  // a tile none of whose taps is in the image
  static constexpr bool kPairs = false;
  __device__ __forceinline__ unsigned row(int) const { return 0; }
  __device__ __forceinline__ unsigned col(int) const { return 0; }
  __device__ __forceinline__ float at(unsigned) const { return 0.0f; }
};

// uint8 rows that are whole 4-byte words (w % 4 == 0, each row 4-byte
// aligned), read a row's two taps (x, x + 1) at a time: both from the one
// aligned word that holds them, or from two where they straddle words (x %
// 4 == 3), so a point takes two or three loads instead of four. The loads
// are what bound the flat sampler when a warp's taps scatter over the
// texture (one L1 wavefront per distinct line a load touches).
struct WordTaps {
  static constexpr bool kPairs = true;
  const uint8_t* img;  // opaque()
  int h, w, sh;
  // row y's taps at x (if a) and x + 1 (if b); each 0 where not read
  __device__ __forceinline__ void pair(int y, int x, bool a, bool b, float* ta,
                                       float* tb) const {
    const unsigned* row = reinterpret_cast<const unsigned*>(img + inside(y, h - 1) * sh);
    const int q = min(max(x, 0), w - 1) >> 2;  // the word of x (of x + 1 = 0 when x = -1)
    const int k = x - 4 * q;                    // x's byte in it: -1..3 where a tap is read
    const unsigned lo = __ldg(row + q);
    const unsigned hi = b && k == 3 ? __ldg(row + q + 1) : 0u;
    const unsigned two = __byte_perm(lo, hi, max(k, 0) | ((k + 1) & 7) << 4);
    *ta = a ? static_cast<float>(two & 0xffu) : 0.0f;
    *tb = b ? static_cast<float>((two >> 8) & 0xffu) : 0.0f;
  }
};

// The bilinear tap-and-blend of every entry point (see the header). An
// off-image tap is read at a clamped index and selected to 0.
template <typename Taps>
__device__ __forceinline__ float sample_bilinear(float su, float sv, int h, int w,
                                                 float scale, const Taps& taps) {
  const bool nan = isnan(su) || isnan(sv);  // before clipping: fminf/fmaxf drop NaN
  su = fminf(fmaxf(su, -kClip), kClip);
  sv = fminf(fmaxf(sv, -kClip), kClip);
  const float x0 = floorf(su);
  const float y0 = floorf(sv);
  const float wx = su - x0;
  const float wy = sv - y0;
  const int xi = static_cast<int>(x0);
  const int yi = static_cast<int>(y0);
  const bool xa = static_cast<unsigned>(xi) < static_cast<unsigned>(w);
  const bool xb = static_cast<unsigned>(xi + 1) < static_cast<unsigned>(w);
  const bool ya = static_cast<unsigned>(yi) < static_cast<unsigned>(h);
  const bool yb = static_cast<unsigned>(yi + 1) < static_cast<unsigned>(h);
  float t00, t01, t10, t11;
  if constexpr (Taps::kPairs) {
    taps.pair(yi, xi, ya && xa, ya && xb, &t00, &t01);
    taps.pair(yi + 1, xi, yb && xa, yb && xb, &t10, &t11);
  } else {
    const unsigned ra = taps.row(yi), rb = taps.row(yi + 1);
    const unsigned ca = taps.col(xi), cb = taps.col(xi + 1);
    t00 = ya && xa ? taps.at(ra + ca) : 0.0f;
    t01 = ya && xb ? taps.at(ra + cb) : 0.0f;
    t10 = yb && xa ? taps.at(rb + ca) : 0.0f;
    t11 = yb && xb ? taps.at(rb + cb) : 0.0f;
  }
  const float acc = (1.0f - wx) * (1.0f - wy) * t00 + wx * (1.0f - wy) * t01 +
                    (1.0f - wx) * wy * t10 + wx * wy * t11;
  return nan ? __int_as_float(0x7fc00000) : acc * scale;
}

// Rows [lo, hi] of the in-image taps sample_bilinear reads at (su, sv),
// merged into *lo, *hi (nothing for a NaN coordinate or no in-image tap).
__device__ __forceinline__ void tap_rows(float su, float sv, int h, int w, int* lo, int* hi) {
  if (isnan(su) || isnan(sv)) return;
  const int xi = static_cast<int>(floorf(fminf(fmaxf(su, -kClip), kClip)));
  const int yi = static_cast<int>(floorf(fminf(fmaxf(sv, -kClip), kClip)));
  const int rlo = max(yi, 0);
  const int rhi = min(yi + 1, h - 1);
  if (xi + 1 >= 0 && xi < w && rlo <= rhi) {
    *lo = min(*lo, rlo);
    *hi = max(*hi, rhi);
  }
}

// The thread's output pixels: P adjacent columns of one row, from one
// division per thread. row >= h for a thread past the image.
struct Slot {
  int row, col;
};
template <int P>
__device__ __forceinline__ Slot thread_slot(int w) {
  const int groups = (w + P - 1) / P;  // thread slots per row
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int row = g / groups;
  return {row, (g - row * groups) * P};
}

// Floats per vector store of a thread's P pixels.
template <int P>
__host__ __device__ constexpr int vec_width() {
  return P >= 4 ? 4 : P;
}

// Samples the thread's P pixels and stores the `valid` (> 0) of them that
// lie in the row at o: whole vectors when `vec` (w % vec_width == 0 and the
// output 16-byte aligned, so o is aligned), else one float at a time.
template <int P, typename Taps>
__device__ __forceinline__ void sample_store(const float (&su)[P], const float (&sv)[P], int h,
                                             int w, float scale, const Taps& taps, float* o,
                                             int valid, bool vec) {
  constexpr int V = vec_width<P>();
  float res[P];
#pragma unroll
  for (int k = 0; k < P; ++k) res[k] = sample_bilinear(su[k], sv[k], h, w, scale, taps);
  if (V > 1 && vec) {
#pragma unroll
    for (int j = 0; j < P; j += V) {
      if (j >= valid) break;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(o + j) = make_float4(res[j], res[j + 1], res[j + 2], res[j + 3]);
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(o + j) = make_float2(res[j], res[j + 1]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k < valid) o[k] = res[k];
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ imgs, const float* __restrict__ hs,
            float* __restrict__ out, int h, int w, int sb, int sh, int sw, int hb,
            float scale, bool vec) {
  const Slot s = thread_slot<P>(w);
  if (s.row >= h) return;
  const int b = blockIdx.y;
  const Homography hm(hs + b * hb);
  float su[P], sv[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    hm.coords(static_cast<float>(s.col + k), static_cast<float>(s.row), &su[k], &sv[k]);
  }
  sample_store(su, sv, h, w, scale, GlobalTaps<T>{opaque(imgs + b * sb), h, w, sh, sw},
               out + b * h * w + s.row * w + s.col, w - s.col, vec);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies n bytes (0 < n <= kBandBytes) from src to band. Every thread of
// the block calls it; it returns when the whole band is in shared memory.
// `bar` is an mbarrier initialized for one arrival (mbarrier_init).
__device__ __forceinline__ void copy_band(unsigned char* band, const unsigned char* src, int n,
                                          uint64_t* bar) {
  if (((reinterpret_cast<uintptr_t>(src) | n) & 15) != 0) {  // unaligned: bytes
    for (int i = threadIdx.x; i < n; i += kThreads) band[i] = __ldg(src + i);
    __syncthreads();
    return;
  }
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%2], %3;\n"
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %3, [%2];\n" ::"r"(smem_addr(band)),
        "l"(src), "r"(smem_addr(bar)), "r"(n)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Batched warp of contiguous (B, h, w) images through a per-tile row band.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
rowskip_kernel(const T* __restrict__ imgs, const float* __restrict__ hs,
               float* __restrict__ out, int h, int w, int hb, float scale, bool vec) {
  __shared__ __align__(128) unsigned char band[kBandBytes];
  __shared__ int s_lo[kWarps], s_hi[kWarps];
  __shared__ uint64_t copied;  // mbarrier of the bulk band copy
  const Slot s = thread_slot<P>(w);
  const bool live = s.row < h;
  const int b = blockIdx.y;
  const T* img = imgs + b * h * w;
  if (threadIdx.x == 0) mbarrier_init(&copied);

  float su[P] = {}, sv[P] = {};
  int lo = h, hi = -1;
  if (live) {
    const Homography hm(hs + b * hb);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      hm.coords(static_cast<float>(s.col + k), static_cast<float>(s.row), &su[k], &sv[k]);
      if (s.col + k < w) tap_rows(su[k], sv[k], h, w, &lo, &hi);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x / 32] = lo;
    s_hi[threadIdx.x / 32] = hi;
  }
  __syncthreads();  // also publishes the mbarrier's initialization
  int rmin = s_lo[0], rmax = s_hi[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    rmin = min(rmin, s_lo[i]);
    rmax = max(rmax, s_hi[i]);
  }
  // at most h*w*sizeof(T) bytes, which the wrapper keeps in int range
  const int band_bytes = rmax >= rmin ? (rmax - rmin + 1) * w * static_cast<int>(sizeof(T)) : 0;
  float* o = out + b * h * w + s.row * w + s.col;
  if (band_bytes > kBandBytes) {  // too tall for the band: taps from global memory
    if (live) {
      sample_store(su, sv, h, w, scale, GlobalTaps<T>{opaque(img), h, w, w, 1}, o, w - s.col,
                   vec);
    }
    return;
  }
  if (band_bytes == 0) {  // no in-image tap: load nothing
    if (live) sample_store(su, sv, h, w, scale, NoTaps{}, o, w - s.col, vec);
    return;
  }
  copy_band(band, reinterpret_cast<const unsigned char*>(img + rmin * w), band_bytes, &copied);
  if (live) {
    sample_store(su, sv, h, w, scale,
                 BandTaps<T>{reinterpret_cast<const T*>(band), rmin, rmax, w}, o, w - s.col,
                 vec);
  }
}

// Image b of (B, h, w) sampled at row b of (B, n) flat coordinates. A
// block takes kFlatThreads x P adjacent points of a row and a thread every
// kFlatThreads-th of them, so each load of a warp covers 32 adjacent
// points: coordinates and outputs move in whole lines, and the taps of
// adjacent points, which lie close on the texture, share lines. kWords:
// uint8 rows read a word at a time (WordTaps).
template <typename T, int P, bool kWords>
__global__ void __launch_bounds__(kFlatThreads)
flat_kernel(const T* __restrict__ imgs, const float* __restrict__ su,
            const float* __restrict__ sv, float* __restrict__ out, int n, int h, int w,
            long long sb, int sh, int sw, float scale) {
  const int first = blockIdx.x * (kFlatThreads * P) + threadIdx.x;
  const int b = blockIdx.y;
  const int row = b * n;  // B * n fits in int (the launcher checks)
  const T* img = opaque(imgs + b * sb);
  float x[P], y[P], res[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = first + k * kFlatThreads;
    x[k] = i < n ? __ldg(su + row + i) : 0.0f;
    y[k] = i < n ? __ldg(sv + row + i) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if constexpr (kWords) {
      res[k] = sample_bilinear(x[k], y[k], h, w, scale, WordTaps{img, h, w, sh});
    } else {
      res[k] = sample_bilinear(x[k], y[k], h, w, scale, GlobalTaps<T>{img, h, w, sh, sw});
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = first + k * kFlatThreads;
    if (i < n) out[row + i] = res[k];
  }
}

constexpr long long kIntMax = 2147483647LL;

// The kernels index with int: every element offset they form, and every
// thread index (up to a block past the last pixel), must fit.
bool int_indexable(int b, int h, int w, long long sb, long long sh, long long sw) {
  if (b <= 0 || h <= 0 || w <= 0 || sb < 0 || sh < 0 || sw < 0) return false;
  const long long last = (b - 1LL) * sb + (h - 1LL) * sh + (w - 1LL) * sw;
  return static_cast<long long>(b) * h * w <= kIntMax - 1024 && last <= kIntMax &&
         sb <= kIntMax && sh <= kIntMax && sw <= kIntMax;
}

long long thread_slots(int b, int h, int w, int pixels) {
  return static_cast<long long>(b) * h * ((w + pixels - 1) / pixels);
}

constexpr int kMaxDevices = 64;

// Threads the current card holds at once (its SMs x threads per SM), or -1;
// read from the device once per device.
long long resident_threads() {
  static std::atomic<long long> cached[kMaxDevices];  // 0: not read yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  long long n = dev < kMaxDevices ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (n != 0) return n;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev) !=
          cudaSuccess) {
    return -1;
  }
  n = static_cast<long long>(sms) * per_sm;
  if (dev < kMaxDevices) cached[dev].store(n, std::memory_order_relaxed);
  return n;
}

// Pixels per thread of a warp launch: the fewest whose threads all fit on
// the card at once, else kPixelsMax. A launch that fits is bound by the
// latency of its chain of loads, which more threads hide; one that does not
// by instruction issue, which fewer threads, each on more pixels, save.
// (On the H100, of the batches of 224x320 frames timed, this is the
// fastest count but for warp_kernel at B = 16, where 4 pixels beat the 8
// chosen by 4 %: PERF.md.)
int pixels_per_thread(int b, int h, int w) {
  const long long resident = resident_threads();
  int p = kPixelsMin;
  while (p < kPixelsMax && (resident <= 0 || thread_slots(b, h, w, p) > resident)) p *= 2;
  return p;
}

template <int P>
dim3 warp_grid(int b, int h, int w) {
  const long long slots = thread_slots(1, h, w, P);
  return dim3(static_cast<unsigned>((slots + kThreads - 1) / kThreads), b);
}

template <int P>
bool vec_stores(const void* out, int w) {
  return w % vec_width<P>() == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <typename T, int P>
void start_warp(const void* imgs, const void* hs, void* out, int b, int h, int w, int sb,
                int sh, int sw, int hb, float scale, cudaStream_t stream) {
  warp_kernel<T, P><<<warp_grid<P>(b, h, w), kThreads, 0, stream>>>(
      static_cast<const T*>(imgs), static_cast<const float*>(hs), static_cast<float*>(out), h,
      w, sb, sh, sw, hb, scale, vec_stores<P>(out, w));
}

template <typename T>
int launch_warp(const void* imgs, const void* hs, void* out, int b, int h, int w,
                long long sb, long long sh, long long sw, long long hb, float scale,
                void* stream) {
  if (!int_indexable(b, h, w, sb, sh, sw) || hb < 0 || (b - 1LL) * hb + 9 > kIntMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto start = start_warp<T, 8>;
  switch (pixels_per_thread(b, h, w)) {
    case 1: start = start_warp<T, 1>; break;
    case 2: start = start_warp<T, 2>; break;
    case 4: start = start_warp<T, 4>; break;
  }
  start(imgs, hs, out, b, h, w, static_cast<int>(sb), static_cast<int>(sh),
        static_cast<int>(sw), static_cast<int>(hb), scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
void start_rowskip(const void* imgs, const void* hs, void* out, int b, int h, int w, int hb,
                   float scale, cudaStream_t stream) {
  rowskip_kernel<T, P><<<warp_grid<P>(b, h, w), kThreads, 0, stream>>>(
      static_cast<const T*>(imgs), static_cast<const float*>(hs), static_cast<float*>(out), h,
      w, hb, scale, vec_stores<P>(out, w));
}

template <typename T>
int launch_rowskip(const void* imgs, const void* hs, void* out, int b, int h, int w,
                   long long hb, float scale, void* stream) {
  const long long frame = static_cast<long long>(h) * w;
  if (!int_indexable(b, h, w, frame, w, 1) || frame * sizeof(T) > kIntMax || hb < 0 ||
      (b - 1LL) * hb + 9 > kIntMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto start = start_rowskip<T, 8>;
  switch (pixels_per_thread(b, h, w)) {
    case 1: start = start_rowskip<T, 1>; break;
    case 2: start = start_rowskip<T, 2>; break;
    case 4: start = start_rowskip<T, 4>; break;
  }
  start(imgs, hs, out, b, h, w, static_cast<int>(hb), scale,
        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, bool kWords>
void start_flat(const void* imgs, const void* su, const void* sv, void* out, int b, int n,
                int h, int w, long long sb, int sh, int sw, float scale, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((n + kFlatThreads * P - 1LL) / (kFlatThreads * P));
  flat_kernel<T, P, kWords><<<dim3(tiles, b), kFlatThreads, 0, stream>>>(
      static_cast<const T*>(imgs), static_cast<const float*>(su), static_cast<const float*>(sv),
      static_cast<float*>(out), n, h, w, sb, sh, sw, scale);
}

template <typename T, bool kWords>
auto flat_start(int points_per_thread) {
  auto start = start_flat<T, 8, kWords>;
  switch (points_per_thread) {
    case 1: start = start_flat<T, 1, kWords>; break;
    case 2: start = start_flat<T, 2, kWords>; break;
    case 4: start = start_flat<T, 4, kWords>; break;
  }
  return start;
}

template <typename T>
int launch_flat(const void* imgs, const void* su, const void* sv, void* out, int b, int n,
                int h, int w, long long sb, long long sh, long long sw, float scale,
                void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || sb < 0 || !int_indexable(1, h, w, 0, sh, sw) ||
      static_cast<long long>(b) * n > kIntMax - kFlatThreads * kPixelsMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = pixels_per_thread(b, 1, n);  // B rows of n points
  auto start = flat_start<T, false>(p);
  if constexpr (sizeof(T) == 1) {  // rows of whole, aligned words: WordTaps
    if (sw == 1 && w % 4 == 0 && sh % 4 == 0 && sb % 4 == 0 &&
        reinterpret_cast<uintptr_t>(imgs) % 4 == 0) {
      start = flat_start<T, true>(p);
    }
  }
  start(imgs, su, sv, out, b, n, h, w, sb, static_cast<int>(sh), static_cast<int>(sw), scale,
        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers (bound with ctypes). Strides are in elements; outputs
// are contiguous. Each returns cudaGetLastError(), or cudaErrorInvalidValue
// (launching nothing) for arguments outside the kernels' int indexing.
extern "C" int homography_warp_u8(const void* imgs, const void* hs, void* out, int b,
                                  int h, int w, long long sb, long long sh,
                                  long long sw, long long hb, void* stream) {
  return launch_warp<uint8_t>(imgs, hs, out, b, h, w, sb, sh, sw, hb, 1.0f / 255.0f,
                              stream);
}

extern "C" int homography_warp_f32(const void* imgs, const void* hs, void* out, int b,
                                   int h, int w, long long sb, long long sh,
                                   long long sw, long long hb, void* stream) {
  return launch_warp<float>(imgs, hs, out, b, h, w, sb, sh, sw, hb, 1.0f, stream);
}

// imgs: contiguous (B, h, w).
extern "C" int homography_warp_rowskip_u8(const void* imgs, const void* hs, void* out,
                                          int b, int h, int w, long long hb,
                                          void* stream) {
  return launch_rowskip<uint8_t>(imgs, hs, out, b, h, w, hb, 1.0f / 255.0f, stream);
}

extern "C" int homography_warp_rowskip_f32(const void* imgs, const void* hs, void* out,
                                           int b, int h, int w, long long hb,
                                           void* stream) {
  return launch_rowskip<float>(imgs, hs, out, b, h, w, hb, 1.0f, stream);
}

// The warps' tiling: threads per block, and adjacent output pixels per
// thread of a launch on B h x w images (a row-band tile is their product);
// the row-band kernel's shared band in bytes.
extern "C" int warp_threads_per_block() { return kThreads; }

extern "C" int warp_pixels_per_thread(int b, int h, int w) {
  return pixels_per_thread(b, h, w);
}

extern "C" int rowskip_band_bytes() { return kBandBytes; }

// imgs: B images of h x w (image stride sb); su, sv, out: contiguous (B, n).
extern "C" int bilinear_sample_batch_u8(const void* imgs, const void* su, const void* sv,
                                        void* out, int b, int n, int h, int w, long long sb,
                                        long long sh, long long sw, void* stream) {
  return launch_flat<uint8_t>(imgs, su, sv, out, b, n, h, w, sb, sh, sw, 1.0f / 255.0f, stream);
}

extern "C" int bilinear_sample_batch_f32(const void* imgs, const void* su, const void* sv,
                                         void* out, int b, int n, int h, int w, long long sb,
                                         long long sh, long long sw, void* stream) {
  return launch_flat<float>(imgs, su, sv, out, b, n, h, w, sb, sh, sw, 1.0f, stream);
}

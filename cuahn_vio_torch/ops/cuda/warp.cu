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
//                    texture sampler of data/textures.py sample_plane.
//
// What every kernel computes, per sample point: source coordinates (su, sv),
// for the warps [x, y, z] = H_b [u, v, 1] in float32 (see row_dot) and
// su = x/z, sv = y/z; a NaN coordinate gives NaN; otherwise both are clipped
// to +-1e4 (an infinite coordinate then samples nothing and gives 0) and the
// image is sampled bilinearly with zeros padding (grid_sample bilinear /
// zeros / align_corners=True, in pixel coordinates). uint8 images are read
// directly and the blend of the raw values is multiplied by 1/255; float32
// images are sampled as they are. All three share sample_bilinear, so the
// tap arithmetic is one piece of code.
//
// What bounds them: bytes. A 224x320 frame is 71,680 B of uint8 read and
// 286,720 B of float32 written; the arithmetic is ~40 flops per pixel. At
// 3.35 TB/s that is ~0.11 us of traffic per frame, far below the launch
// latency of a few microseconds, so at B = 1 (single-stream run-vio) the
// launch itself is the bound, and at B = 64 the bytes are. The flat sampler
// reads 8 B of coordinates and writes 4 B per point, plus the texture.
//
// What the design does about it: the TPU kernels avoid gathers with
// one-hot bf16 MXU matmuls, which Hopper does not need. Here each thread
// owns one output point and reads its four taps; neighbouring threads write
// neighbouring floats, so stores are coalesced.
//   warp_kernel reads its taps through the read-only (L1) path; the grid is
//   (pixel tiles of 256, B), one launch for the whole batch.
//   rowskip_kernel is the TPU row-skip translated: the TPU prefetched each
//   tile's touched row range from the host and skipped 128-row image blocks
//   outside it; here a block computes its own range. Each thread computes
//   its pixel's coordinates, a block reduction (shared-memory atomics) gives
//   the rows [rmin, rmax] that the tile's in-image taps read, the block
//   copies only those rows into shared memory with 16-byte loads and samples
//   from there. A tile whose band exceeds kBandBytes reads its taps from
//   global memory instead, as warp_kernel does (the TPU's straddling tile
//   likewise pays for every block it needs); a tile with no in-image tap
//   loads nothing. The band holds copies of the very values warp_kernel
//   reads, so the two are bit-identical.
//   flat_kernel takes coordinates instead of a homography: grid over points.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kClip = 1e4f;
constexpr int kBandBytes = 16384;  // rowskip_kernel's shared row band

// h0*u + h1*v + h2, rounded as fma(h1, v, h0*u) + h2: the rounding of the
// reference's float32 H @ grid matmul (and of the plain version).
__device__ __forceinline__ float row_dot(const float* h, float u, float v) {
  return __fadd_rn(__fmaf_rn(h[1], v, __fmul_rn(h[0], u)), h[2]);
}

// Source coordinates of output pixel p of a w-wide image under H (row-major 3x3).
__device__ __forceinline__ void warp_coords(const float* hm, int p, int w, float* su,
                                            float* sv) {
  const int v = p / w;
  const float fu = static_cast<float>(p - v * w);
  const float fv = static_cast<float>(v);
  const float x = row_dot(hm, fu, fv);
  const float y = row_dot(hm + 3, fu, fv);
  const float z = row_dot(hm + 6, fu, fv);
  *su = x / z;
  *sv = y / z;
}

// Tap readers: the raw value of an in-image tap (row y, column x).
template <typename T>
struct GlobalTaps {
  const T* img;
  long long sh, sw;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return static_cast<float>(__ldg(img + y * sh + x * sw));
  }
};

template <typename T>
struct BandTaps {  // rows row0.. of a contiguous image, copied to shared memory
  const T* band;
  int row0, w;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return static_cast<float>(band[(y - row0) * w + x]);
  }
};

template <typename Taps>
__device__ __forceinline__ float tap(const Taps& taps, int y, int x, int h, int w) {
  if (x < 0 || x >= w || y < 0 || y >= h) return 0.0f;
  return taps(y, x);
}

// The bilinear tap-and-blend of every entry point (see the header).
template <typename Taps>
__device__ __forceinline__ float sample_bilinear(float su, float sv, int h, int w,
                                                 float scale, const Taps& taps) {
  if (isnan(su) || isnan(sv)) return __int_as_float(0x7fc00000);  // NaN in, NaN out
  su = fminf(fmaxf(su, -kClip), kClip);
  sv = fminf(fmaxf(sv, -kClip), kClip);
  const float x0 = floorf(su);
  const float y0 = floorf(sv);
  const float wx = su - x0;
  const float wy = sv - y0;
  const int xi = static_cast<int>(x0);
  const int yi = static_cast<int>(y0);
  const float acc = (1.0f - wx) * (1.0f - wy) * tap(taps, yi, xi, h, w) +
                    wx * (1.0f - wy) * tap(taps, yi, xi + 1, h, w) +
                    (1.0f - wx) * wy * tap(taps, yi + 1, xi, h, w) +
                    wx * wy * tap(taps, yi + 1, xi + 1, h, w);
  return acc * scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ imgs, const float* __restrict__ hs,
            float* __restrict__ out, int h, int w, long long sb, long long sh,
            long long sw, long long hb, float scale) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= h * w) return;
  float su, sv;
  warp_coords(hs + b * hb, p, w, &su, &sv);
  out[static_cast<long long>(b) * h * w + p] =
      sample_bilinear(su, sv, h, w, scale, GlobalTaps<T>{imgs + b * sb, sh, sw});
}

// Batched warp of contiguous (B, h, w) images through a per-tile row band.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowskip_kernel(const T* __restrict__ imgs, const float* __restrict__ hs,
               float* __restrict__ out, int h, int w, long long hb, float scale) {
  __shared__ __align__(16) unsigned char band[kBandBytes];
  __shared__ int s_rmin, s_rmax;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = p < h * w;
  const T* img = imgs + static_cast<long long>(b) * h * w;

  if (threadIdx.x == 0) {
    s_rmin = h;
    s_rmax = -1;
  }
  __syncthreads();
  float su = 0.0f, sv = 0.0f;
  if (live) {
    warp_coords(hs + b * hb, p, w, &su, &sv);
    if (!isnan(su) && !isnan(sv)) {
      // the rows of this pixel's in-image taps (sample_bilinear's xi, yi)
      const int xi = static_cast<int>(floorf(fminf(fmaxf(su, -kClip), kClip)));
      const int yi = static_cast<int>(floorf(fminf(fmaxf(sv, -kClip), kClip)));
      const int lo = max(yi, 0);
      const int hi = min(yi + 1, h - 1);
      if (xi + 1 >= 0 && xi < w && lo <= hi) {
        atomicMin(&s_rmin, lo);
        atomicMax(&s_rmax, hi);
      }
    }
  }
  __syncthreads();
  const int rmin = s_rmin;
  const int rmax = s_rmax;
  const long long band_bytes =
      rmax >= rmin ? static_cast<long long>(rmax - rmin + 1) * w * sizeof(T) : 0;
  const bool in_band = band_bytes <= kBandBytes;
  if (band_bytes > 0 && in_band) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(img + static_cast<long long>(rmin) * w);
    const int n = static_cast<int>(band_bytes);
    if (((reinterpret_cast<uintptr_t>(src) | n) & 15) == 0) {
      const uint4* src16 = reinterpret_cast<const uint4*>(src);
      uint4* dst16 = reinterpret_cast<uint4*>(band);
      for (int i = threadIdx.x; i < n / 16; i += kThreads) dst16[i] = __ldg(src16 + i);
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) band[i] = __ldg(src + i);
    }
  }
  __syncthreads();
  if (!live) return;
  float* o = out + static_cast<long long>(b) * h * w + p;
  if (in_band) {
    *o = sample_bilinear(su, sv, h, w, scale,
                         BandTaps<T>{reinterpret_cast<const T*>(band), rmin, w});
  } else {
    *o = sample_bilinear(su, sv, h, w, scale, GlobalTaps<T>{img, w, 1});
  }
}

// One (h, w) image sampled at n flat coordinates.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_kernel(const T* __restrict__ img, const float* __restrict__ su,
            const float* __restrict__ sv, float* __restrict__ out, int n, int h, int w,
            long long sh, long long sw, float scale) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = sample_bilinear(__ldg(su + i), __ldg(sv + i), h, w, scale,
                           GlobalTaps<T>{img, sh, sw});
}

template <typename T>
int launch_warp(const void* imgs, const void* hs, void* out, int b, int h, int w,
                long long sb, long long sh, long long sw, long long hb, float scale,
                void* stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, b);
  warp_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(imgs), static_cast<const float*>(hs),
      static_cast<float*>(out), h, w, sb, sh, sw, hb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rowskip(const void* imgs, const void* hs, void* out, int b, int h, int w,
                   long long hb, float scale, void* stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, b);
  rowskip_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(imgs), static_cast<const float*>(hs),
      static_cast<float*>(out), h, w, hb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flat(const void* img, const void* su, const void* sv, void* out, int n,
                int h, int w, long long sh, long long sw, float scale, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  flat_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(img), static_cast<const float*>(su),
      static_cast<const float*>(sv), static_cast<float*>(out), n, h, w, sh, sw, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers (bound with ctypes). Strides are in elements; outputs
// are contiguous. Each returns cudaGetLastError().
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

extern "C" int bilinear_sample_u8(const void* img, const void* su, const void* sv,
                                  void* out, int n, int h, int w, long long sh,
                                  long long sw, void* stream) {
  return launch_flat<uint8_t>(img, su, sv, out, n, h, w, sh, sw, 1.0f / 255.0f, stream);
}

extern "C" int bilinear_sample_f32(const void* img, const void* su, const void* sv,
                                   void* out, int n, int h, int w, long long sh,
                                   long long sw, void* stream) {
  return launch_flat<float>(img, su, sv, out, n, h, w, sh, sw, 1.0f, stream);
}

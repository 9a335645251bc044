// V1, the low-channel convolution kernel for Hopper (sm_90a): bias plus a
// direct float32 convolution plus LeakyReLU 0.1, in one pass, for the UAHN
// towers' layers with few channels at full or half resolution:
//
//   (C_in, C_out, k, stride)   layer            output at 224x320 input
//   (2, 8, 7, 1)               block 4 conv0    224x320
//   (8, 16, 5, 2)              block 4 conv1    112x160
//   (2, 16, 7, 1)              block 3 conv0    112x160 (after the pool by 2)
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (cuahn_vio/models/uahn.py ConvTower), and the port first left them to
// cuDNN. As GEMMs they have N = C_out <= 16 and K = C_in k^2 <= 200, where
// cuDNN's float32 implicit GEMMs and its FFT path use the card worst, and
// each layer's output went to device memory to be read back and written
// again by a separate LeakyReLU.
//
// What bounds it: float32 FFMA. A call at B = 64 is 7.19 + 7.34 + 3.60
// GFLOP, 0.271 ms at the card's 67 TFLOP/s, against 0.055 + 0.066 + 0.025
// ms for each input float read once and each output float written once at
// 3.35 TB/s. No tensor core: the layers are float32 with TF32 off.
//
// What the design does about it: every product is an FFMA whose two other
// operands are already in registers. A block owns a tile of kRows output
// rows x kCols columns of one image, for all C_out channels. It stages the
// layer's filter, transposed to [c_in][ky][kx][c_out], and the tile's input
// with its halo (zeros outside the image) in shared memory, the input by
// asynchronous 16-byte copies (cp.async), kChunk channels at a time, the
// next chunk landing in a second buffer while one is read. Each thread
// owns kPx adjacent outputs of one row: per input channel and filter row
// it reads the row's input values once (float4s), and per filter tap the
// C_out weights once (float4s of one address for the whole warp, a
// broadcast); each input value then feeds C_out FFMAs and each weight kPx,
// into kPx x C_out accumulators held in registers.
// Consecutive threads own consecutive rows, and a staged row is an odd
// number of float4s long, so the eight threads of each quarter-warp read
// eight distinct bank groups; a stride-2 layer stores even and odd input
// rows in two planes, so that its consecutive output rows still read
// consecutive staged rows. The accumulators start at the bias and take the
// products in (c_in, ky, kx) order, each an fma rounded once (the build's
// -fmad=false leaves only these explicit fmas); the epilogue applies the
// LeakyReLU and writes float32 NCHW, float4s where the row allows, so the
// next (cuDNN) layer reads it unchanged. The plain version in conv.py sums
// in the same order with a multiply and an add, so the two differ by
// rounding alone.
//
// The tilings below were chosen on the H100 by timing alternatives
// (PERF.md has the table).

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr float kLeak = 0.1f;

// The tiling of each layer shape: adjacent outputs a thread (kPx), output
// rows a block (kRows, a divisor of 32 of at least 8), threads a block,
// input channels staged at a time (kChunk, a divisor of C_in), and the
// filter rows unrolled in the inner loop (1 or k).
template <int CIN, int COUT, int K, int S>
struct Tiling;
template <>
struct Tiling<2, 8, 7, 1> {
  static constexpr int kPx = 4, kRows = 16, kThreads = 128, kChunk = 2, kUnrollKy = 1;
};
template <>
struct Tiling<8, 16, 5, 2> {
  static constexpr int kPx = 4, kRows = 16, kThreads = 128, kChunk = 1, kUnrollKy = 5;
};
template <>
struct Tiling<2, 16, 7, 1> {
  static constexpr int kPx = 4, kRows = 16, kThreads = 128, kChunk = 2, kUnrollKy = 1;
};

template <int CIN, int COUT, int K, int S>
struct Tile : Tiling<CIN, COUT, K, S> {
  using T = Tiling<CIN, COUT, K, S>;
  static constexpr int kPad = (K - 1) / 2;
  // a staged row starts kLead columns left of the tile's first tap, at a
  // multiple of 4 (the tile's first output column times S is one)
  static constexpr int kLead = (kPad + 3) / 4 * 4 - kPad;
  static constexpr int kGroups = T::kThreads / T::kRows;  // column groups a block
  static constexpr int kCols = kGroups * T::kPx;           // output columns a block
  static constexpr int kInRows = S * (T::kRows - 1) + K;   // input rows a block reads
  static constexpr int kPlaneRows = (kInRows + S - 1) / S; // rows of one row-parity plane
  static constexpr int kLoad = (kLead + S * (T::kPx - 1) + K + 3) / 4 * 4;  // a thread's row, float4s
  static constexpr int kInCols = S * (kCols - T::kPx) + kLoad;  // input columns staged
  static constexpr int kPitch = (kInCols + 7) / 8 * 8 + 4;      // an odd number of float4s
  static constexpr int kChannelFloats = S * kPlaneRows * kPitch;
  static constexpr int kInFloats = T::kChunk * kChannelFloats;
  static constexpr int kChunks = CIN / T::kChunk;
  static constexpr int kBuffers = kChunks > 1 ? 2 : 1;  // the next chunk lands while one is read
  static constexpr int kWeightFloats = CIN * K * K * COUT;
  static_assert(32 % T::kRows == 0 && T::kRows >= 8, "a quarter-warp shares a column group");
  static_assert(T::kThreads % 32 == 0 && T::kThreads % T::kRows == 0, "whole warps and groups");
  static_assert(CIN % T::kChunk == 0, "whole chunks of channels");
  static_assert((T::kPx * S) % 4 == 0 && COUT % 4 == 0, "float4 reads");
  static_assert(T::kUnrollKy == 1 || T::kUnrollKy == K, "filter rows unrolled: none or all");
  static_assert((kCols * S) % 4 == 0 && kInCols % 4 == 0, "16-byte copies");
  static_assert((kBuffers * kInFloats + kWeightFloats) * 4 <= 48 * 1024, "static shared memory");
};

template <int N>
__device__ __forceinline__ void load4s(const float* src, float* dst) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + j);
    dst[j] = q.x;
    dst[j + 1] = q.y;
    dst[j + 2] = q.z;
    dst[j + 3] = q.w;
  }
}

__device__ __forceinline__ float leaky(float a) { return a > 0.0f ? a : __fmul_rn(a, kLeak); }

// Asynchronous copies into shared memory (cp.async): `bytes` of `src`, the
// rest of the 16 (or 4) bytes zeros; `src` is not read when `bytes` is 0.
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage one chunk of input channels (xc: its first channel of the image)
// for the tile whose staged rows and columns start at (iy0, ix0): rows of
// each channel in its row-parity plane, zeros outside the image. A row of
// whole 16-byte words (wd a multiple of 4) goes as 16-byte copies: the
// tile's columns start at a multiple of 4, so a word lies wholly inside or
// wholly outside the image; any other row as 4-byte copies.
template <class L, int S>
__device__ __forceinline__ void stage(float* buf, const float* xc, int tid, int h, int wd,
                                      int iy0, int ix0) {
  if ((wd & 3) == 0) {
    constexpr int kWords = L::kInCols / 4;
    for (int i = tid; i < L::kChunk * L::kInRows * kWords; i += L::kThreads) {
      const int c = i / (L::kInRows * kWords);
      const int rest = i - c * (L::kInRows * kWords);
      const int yl = rest / kWords, q = rest - yl * kWords;
      const int y = iy0 + yl, xx = ix0 + 4 * q;
      const bool in = y >= 0 && y < h && xx >= 0 && xx < wd;
      copy16(buf + c * L::kChannelFloats + ((yl % S) * L::kPlaneRows + yl / S) * L::kPitch + 4 * q,
             in ? xc + (static_cast<size_t>(c) * h + y) * wd + xx : xc, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < L::kChunk * L::kInRows * L::kInCols; i += L::kThreads) {
      const int c = i / (L::kInRows * L::kInCols);
      const int rest = i - c * (L::kInRows * L::kInCols);
      const int yl = rest / L::kInCols, xl = rest - yl * L::kInCols;
      const int y = iy0 + yl, xx = ix0 + xl;
      const bool in = y >= 0 && y < h && xx >= 0 && xx < wd;
      copy4(buf + c * L::kChannelFloats + ((yl % S) * L::kPlaneRows + yl / S) * L::kPitch + xl,
            in ? xc + (static_cast<size_t>(c) * h + y) * wd + xx : xc, in ? 4 : 0);
    }
  }
}

// x (B, CIN, h, wd), w (COUT, CIN, K, K), bias (COUT), out (B, COUT, oh,
// ow), all contiguous float32; grid (column tiles, row tiles, B).
template <int CIN, int COUT, int K, int S>
__global__ void __launch_bounds__(Tiling<CIN, COUT, K, S>::kThreads)
    lowc_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int h, int wd,
                     int oh, int ow) {
  using L = Tile<CIN, COUT, K, S>;
  constexpr int kUnrollKy = L::kUnrollKy;
  __shared__ __align__(16) float s_in[L::kBuffers * L::kInFloats];
  __shared__ __align__(16) float s_w[L::kWeightFloats];
  const int tid = threadIdx.x;
  const int r = tid % L::kRows;  // the thread's output row in the tile
  const int g = tid / L::kRows;  // its column group
  const int ox0 = blockIdx.x * L::kCols, oy0 = blockIdx.y * L::kRows;
  const int ix0 = ox0 * S - L::kPad - L::kLead, iy0 = oy0 * S - L::kPad;
  const size_t plane_floats = static_cast<size_t>(h) * wd;
  const float* xb = x + blockIdx.z * CIN * plane_floats;

  stage<L, S>(s_in, xb, tid, h, wd, iy0, ix0);
  copies_commit();
  for (int i = tid; i < L::kWeightFloats; i += L::kThreads) {
    const int co = i / (CIN * K * K);
    s_w[(i - co * (CIN * K * K)) * COUT + co] = __ldg(w + i);
  }
  float acc[L::kPx][COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    const float b = __ldg(bias + co);
#pragma unroll
    for (int p = 0; p < L::kPx; ++p) acc[p][co] = b;
  }

#pragma unroll 1
  for (int chunk = 0; chunk < L::kChunks; ++chunk) {
    if (chunk + 1 < L::kChunks) {  // the next chunk into the other buffer, freed by the last sync
      stage<L, S>(s_in + ((chunk + 1) % L::kBuffers) * L::kInFloats,
                  xb + (chunk + 1) * L::kChunk * plane_floats, tid, h, wd, iy0, ix0);
      copies_commit();
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncthreads();  // this chunk (and the filter) in shared memory for every thread
#pragma unroll 1
    for (int c = 0; c < L::kChunk; ++c) {
      const float* plane = s_in + (chunk % L::kBuffers) * L::kInFloats + c * L::kChannelFloats +
                           r * L::kPitch + g * L::kPx * S;
      const float* wc = s_w + (chunk * L::kChunk + c) * K * K * COUT;
#pragma unroll (kUnrollKy)
      for (int ky = 0; ky < K; ++ky) {
        float v[L::kLoad];
        load4s<L::kLoad>(plane + ((ky % S) * L::kPlaneRows + ky / S) * L::kPitch, v);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float wv[COUT];
          load4s<COUT>(wc + (ky * K + kx) * COUT, wv);
#pragma unroll
          for (int p = 0; p < L::kPx; ++p) {
            const float xv = v[L::kLead + S * p + kx];
#pragma unroll
            for (int co = 0; co < COUT; ++co) acc[p][co] = __fmaf_rn(xv, wv[co], acc[p][co]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this chunk's buffer
  }

  const int oy = oy0 + r, ox = ox0 + g * L::kPx;
  if (oy >= oh || ox >= ow) return;
  const bool whole = (ow & 3) == 0 && ox + L::kPx <= ow;
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    float* o = out + ((static_cast<size_t>(blockIdx.z) * COUT + co) * oh + oy) * ow + ox;
    if (whole) {
#pragma unroll
      for (int p = 0; p < L::kPx; p += 4) {
        *reinterpret_cast<float4*>(o + p) = make_float4(
            leaky(acc[p][co]), leaky(acc[p + 1][co]), leaky(acc[p + 2][co]), leaky(acc[p + 3][co]));
      }
    } else {
#pragma unroll
      for (int p = 0; p < L::kPx; ++p) {
        if (ox + p < ow) o[p] = leaky(acc[p][co]);
      }
    }
  }
}

template <int CIN, int COUT, int K, int S>
int launch(const void* x, const void* w, const void* bias, void* out, int b, int h, int wd,
           int oh, int ow, void* stream) {
  using L = Tile<CIN, COUT, K, S>;
  const long long tiles_x = (ow + L::kCols - 1) / L::kCols;
  const long long tiles_y = (oh + L::kRows - 1) / L::kRows;
  if (b <= 0 || b > 65535 || tiles_y > 65535 || tiles_x > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles_x), static_cast<unsigned>(tiles_y), b);
  lowc_conv_kernel<CIN, COUT, K, S><<<grid, L::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), h, wd, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous (b, cin, h, wd) float32; w: contiguous (cout, cin, k, k);
// bias: (cout); out: contiguous (b, cout, oh, ow), oh and ow those of
// padding (k - 1) / 2 at the stride; all on the current device. Returns the
// launch's cudaError_t (0 on success), cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int lowc_conv_f32(const void* x, const void* w, const void* bias, void* out, int b,
                             int cin, int cout, int k, int stride, int h, int wd, int oh,
                             int ow, void* stream) {
  const int pad = (k - 1) / 2;
  if (h <= 0 || wd <= 0 || stride <= 0 || oh != (h + 2 * pad - k) / stride + 1 ||
      ow != (wd + 2 * pad - k) / stride + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cin == 2 && cout == 8 && k == 7 && stride == 1) {
    return launch<2, 8, 7, 1>(x, w, bias, out, b, h, wd, oh, ow, stream);
  }
  if (cin == 8 && cout == 16 && k == 5 && stride == 2) {
    return launch<8, 16, 5, 2>(x, w, bias, out, b, h, wd, oh, ow, stream);
  }
  if (cin == 2 && cout == 16 && k == 7 && stride == 1) {
    return launch<2, 16, 7, 1>(x, w, bias, out, b, h, wd, oh, ow, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

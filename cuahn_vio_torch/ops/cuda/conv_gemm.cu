// V2, the towers' implicit-GEMM convolution kernel for Hopper (sm_90a):
// bias plus a float32 convolution plus LeakyReLU 0.1, in one pass, for the
// UAHN towers' layers of blocks 2-4 that V1 (conv.cu) does not take:
//
//   (C_in, C_out, k, stride)   layers                                output at 224x320
//   (2, 64, 7, 2)              block 2 conv0                          28x40
//   (64, 128, 5, 2)            block 2 conv1                          14x20
//   (16, 32, 5, 2)             block 3 conv1                          56x80
//   (16, 32, 3, 2)             block 4 conv2                          56x80
//   (32, 64, 3, 2)             block 3 conv2, block 4 conv3           28x40
//   (64, 128, 3, 2)            block 3 conv3, block 4 conv4           14x20
//   (128, 256, 3, 2)           block 2 conv2, block 3 conv4,          7x10
//                              block 4 conv5 (and block 1 conv2)
//   (256, 256, 3, 2)           block 2 conv3, block 3 conv5,          4x5
//                              block 4 conv6
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (cuahn_vio/models/uahn.py ConvTower), and the port first left them to
// cuDNN, whose float32 implicit GEMMs ran them at 23-38 % of the FMA peak
// and wrote each output to device memory to be read back by a separate
// bias pass and written again by a separate LeakyReLU.
//
// What bounds it: float32 FFMA. The fourteen layers of a call at B = 64 are
// 41.25 GFLOP, 0.616 ms at the card's 67 TFLOP/s; the largest input (block
// 3's conv1, 73 MB) takes ~0.02 ms at 3.35 TB/s. No tensor core: the layers
// are float32 with TF32 off.
//
// What the design does about it. The GEMM view: M = B oh ow output pixels,
// N = C_out, K = C_in k^2 in (c_in, ky, kx) order, the filter's own. A
// block owns a BM x BN tile of the output. Its threads form KS groups (of
// 16 threads or more); each group sums over its own BK of every stage's
// KS BK rows of K, so that a layer with few output tiles (M = 1,280 at
// 4x5) still fills the card. A stage is 8 filter rows (c_in, ky) of k
// taps each. Every stage, all threads copy the tile's im2col A rows
// ([k][m], zeros outside the image) and the filter's K x BN slice
// (transposed to [k][n] on the way, the rows padded by 4 floats so that
// the transposing copies hit distinct banks) into shared memory with
// 4-byte cp.async copies, STAGES buffers deep, so the next stages land
// while one is read. A thread copies whole filter rows of one output
// pixel: one table entry (the row's offset, made once a block) and one
// test of the pixel's row mask a row, then the row's k taps at fixed
// steps from one address, each tap's bytes (0 outside the image) fixed
// for the thread, so that a copy is one instruction. A thread keeps a
// TM x TN micro-tile of accumulators in registers (its m in TM/4 runs of
// 4, its n in TN/4 runs of 4, each run a float4 of shared memory,
// consecutive threads on consecutive runs: a quarter-warp reads one float4
// or eight consecutive ones, no bank conflict) and takes each k row as
// TM + TN broadcast values and TM TN FFMAs. Group 0's accumulators start
// at the bias; the groups' sums meet in shared memory, added in group
// order; the epilogue applies the LeakyReLU and stores float32 NCHW,
// float4s of 4 consecutive pixels of one channel where the plane's size
// allows (a warp then writes runs of 64 bytes a channel).
//
// The sum of an output is set by the layer shape alone: the bias, then the
// products in k order within a group's rows of each stage, one fma each
// (the build's -fmad=false leaves only these explicit fmas), then the
// groups in order. Neither the batch nor the output's place in its tile
// changes it, so a pair's outputs are the same bits at any batch size.
// The filter is read as it stands at each launch (no copy kept between
// launches), and a launch allocates nothing and waits on nothing, so a
// CUDA graph can hold it.
//
// The split path, for the two shapes of the smallest outputs (7x10 and
// 4x5: M = 4,480 and 1,280 at B = 64, K = 1,152 and 2,304). With K whole in
// a block, such an M fills the card only with small tiles (32 x 32 at 4x5:
// 8 FLOPs for each byte brought into shared memory) or with few blocks (280
// 64 x 64 tiles at 7x10: three on some SMs, two on most). So these shapes
// split K across blocks: each of a 64 x 64 tile's kSplits blocks sums one
// run of c_in (nearly equal runs; its products in k order from 0 in each
// group, as above) and writes its partial sums to a workspace the caller
// allocates, [split][C_out][M]; a second kernel, sum_gemm_conv_kernel,
// starts each output at its bias, adds the partials in split order,
// applies the LeakyReLU and stores the output NCHW. No atomics: each
// partial has one writer, and every sum's order is set by the layer shape
// alone, so the bits are the same at any batch here too. (128 x 128 tiles,
// 32 FLOPs a byte, ran slower at every split count tried: PERF.md.)
//
// The tilings below were chosen on the H100 by timing alternatives
// (PERF.md has the table).

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLeak = 0.1f;

// The tiling of each layer shape: output pixels (BM) and channels (BN) a
// block, a thread's (TM, TN, multiples of 4), the groups splitting K (KS),
// the k rows a group takes a stage (BK; KS BK = 8 filter rows of k taps),
// the stages in flight and the runs of c_in that K is split into across
// blocks (kSplits: the split path where above 1). kSplits, KS and BK set
// each output's sum order; the others only where it is computed.
struct Whole {
  static constexpr int kSplits = 1;
};
template <int CIN, int COUT, int K, int S>
struct Tiling;
template <>
struct Tiling<2, 64, 7, 2> : Whole {
  static constexpr int kBM = 64, kBN = 64, kTM = 8, kTN = 8, kKS = 2, kBK = 28, kStages = 2;
};
template <>
struct Tiling<64, 128, 5, 2> : Whole {
  static constexpr int kBM = 64, kBN = 64, kTM = 8, kTN = 8, kKS = 2, kBK = 20, kStages = 2;
};
template <>
struct Tiling<16, 32, 5, 2> : Whole {
  static constexpr int kBM = 128, kBN = 32, kTM = 8, kTN = 8, kKS = 2, kBK = 20, kStages = 2;
};
template <>
struct Tiling<16, 32, 3, 2> : Whole {
  static constexpr int kBM = 128, kBN = 32, kTM = 8, kTN = 4, kKS = 1, kBK = 24, kStages = 3;
};
template <>
struct Tiling<32, 64, 3, 2> : Whole {
  static constexpr int kBM = 128, kBN = 64, kTM = 8, kTN = 8, kKS = 1, kBK = 24, kStages = 2;
};
template <>
struct Tiling<64, 128, 3, 2> : Whole {
  static constexpr int kBM = 32, kBN = 64, kTM = 8, kTN = 8, kKS = 4, kBK = 6, kStages = 2;
};
template <>
struct Tiling<128, 256, 3, 2> {
  static constexpr int kBM = 64, kBN = 64, kTM = 8, kTN = 8, kKS = 2, kBK = 12, kStages = 2,
                       kSplits = 4;
};
template <>
struct Tiling<256, 256, 3, 2> {
  static constexpr int kBM = 64, kBN = 64, kTM = 8, kTN = 8, kKS = 2, kBK = 12, kStages = 2,
                       kSplits = 6;
};

// The narrow tiling of a call whose wide tiles would leave SMs idle (a few
// pairs): 32 x 32 outputs a block, 4 x 4 a thread, and the wide tiling's
// K splits (kSplits, KS, BK), so the same sums; more, smaller blocks share
// the work.
template <class W>
struct Narrow {
  static constexpr int kBM = 32, kBN = 32, kTM = 4, kTN = 4, kKS = W::kKS, kBK = W::kBK,
                       kStages = W::kStages, kSplits = W::kSplits;
};
template <int CIN, int COUT, int K, int S, bool N>
using TilingOf =
    std::conditional_t<N, Narrow<Tiling<CIN, COUT, K, S>>, Tiling<CIN, COUT, K, S>>;

template <int CIN, int COUT, int K, int S, bool N>
struct Gemm : TilingOf<CIN, COUT, K, S, N> {
  using T = TilingOf<CIN, COUT, K, S, N>;
  static constexpr int kDepth = CIN * K * K;                        // K of the GEMM
  static constexpr int kRunIn = (CIN + T::kSplits - 1) / T::kSplits;  // c_in a split, at most
  static constexpr int kPad = (K - 1) / 2;
  static constexpr int kRows = T::kKS * T::kBK;                     // k rows a stage
  static constexpr int kTapRows = kRows / K;                        // filter rows (ci, ky) a stage
  static constexpr int kChunks = (kRunIn * K + kTapRows - 1) / kTapRows;  // stages a split, at most
  // every split takes whole stages of kRunIn channels (else each block
  // counts its own)
  static constexpr bool kEven = CIN % T::kSplits == 0 && (kRunIn * K * K) % kRows == 0;
  static constexpr int kGroup = (T::kBM / T::kTM) * (T::kBN / T::kTN);  // threads a group
  static constexpr int kThreads = kGroup * T::kKS;
  static constexpr int kNT = T::kBN / T::kTN;                       // a group's threads along n
  static constexpr int kPitchB = T::kBN + 4;
  static constexpr int kStageFloats = kRows * (T::kBM + kPitchB);
  static constexpr int kARows = kTapRows * T::kBM / kThreads;       // filter rows a thread copies
  static constexpr int kBLoads = kRows * T::kBN / kThreads;         // B words a thread copies
  static constexpr int kAcc = T::kTM * T::kTN;
  static constexpr int kRingFloats = T::kStages * kStageFloats;
  static constexpr int kSumFloats = T::kKS > 1 ? kThreads * kAcc : 0;
  static constexpr int kDataFloats = kRingFloats > kSumFloats ? kRingFloats : kSumFloats;
  static constexpr size_t kSmemBytes = kDataFloats * 4 + kChunks * kTapRows * sizeof(int2);
  static constexpr int kNoRow = 31;  // a bit of a thread's row mask that is never set
  static_assert(T::kTM % 4 == 0 && T::kTN % 4 == 0, "float4 runs");
  static_assert(kGroup % 16 == 0, "a quarter-warp reads within one group");
  static_assert(kThreads % T::kBM == 0, "a thread copies A words of one output pixel");
  static_assert(kRows % K == 0 && (kTapRows * T::kBM) % kThreads == 0,
                "whole filter rows a stage and a thread");
  static_assert((kRows * T::kBN) % kThreads == 0, "whole B copies a thread");
  static_assert(kRows % 8 == 0 && (8 * T::kBN) % kThreads == 0, "B copies in runs of 8 rows");
  static_assert(COUT % T::kBN == 0, "whole channel tiles");
  static_assert(T::kStages >= 2, "a stage lands while one is read");
  static_assert(T::kSplits <= CIN, "a channel or more a split");
  static_assert(kSmemBytes <= 227 * 1024, "shared memory of a block");
};

__device__ __forceinline__ float leaky(float a) { return a > 0.0f ? a : __fmul_rn(a, kLeak); }

// A 4-byte asynchronous copy into shared memory (cp.async): `bytes` (4 or
// 0) of `src`, zeros for the rest; `src` is not read when `bytes` is 0. No
// "memory" clobber: a stage's copies go to a buffer no thread reads until
// the wait and the barrier of a later stage (both order memory), so the
// compiler may interleave them with the reads and FFMAs of this stage.
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x (B, CIN, h, wd), w (COUT, CIN, K, K), bias (COUT), out (B, COUT, oh,
// ow), all contiguous float32; m_total = B oh ow; grid (M tiles, N tiles,
// kSplits); N: the narrow tiling. On the split path (kSplits > 1) out is
// the workspace [kSplits][COUT][m_pad], m_pad = m_total rounded up to a
// multiple of 4, and split z writes its partial sums, without the bias or
// the LeakyReLU, to [z].
template <int CIN, int COUT, int K, int S, bool N>
__global__ void __launch_bounds__(Gemm<CIN, COUT, K, S, N>::kThreads)
    gemm_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int h, int wd,
                     int oh, int ow, int m_total) {
  using G = Gemm<CIN, COUT, K, S, N>;
  constexpr int BM = G::kBM, BN = G::kBN, TM = G::kTM, TN = G::kTN, BK = G::kBK;
  constexpr int kStages = G::kStages;
  extern __shared__ __align__(16) float smem[];
  int2* tab = reinterpret_cast<int2*>(smem + G::kDataFloats);
  const int tid = threadIdx.x;
  const int plane = oh * ow;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  constexpr bool kSplit = G::kSplits > 1;
  // this block's run of c_in, [c0, c0 + run_in): split z of kSplits nearly
  // equal runs, and the stages and k rows it takes
  const int split = kSplit ? blockIdx.z : 0;
  const int c0 = split * CIN / G::kSplits;
  const int run_in = (split + 1) * CIN / G::kSplits - c0;
  const int chunks = G::kEven ? G::kChunks : (run_in * K + G::kTapRows - 1) / G::kTapRows;
  const int depth = run_in * K * K;

  // Each filter row's (c_in, ky) offset in an image (from the run's first
  // channel) and its ky, once a block.
  for (int q = tid; q < G::kChunks * G::kTapRows; q += G::kThreads) {
    const int ci = q / K, ky = q - ci * K;
    tab[q] = q < run_in * K ? make_int2((ci * h + ky) * wd, ky) : make_int2(0, G::kNoRow);
  }

  // The output pixel whose A words this thread copies: the offset of its
  // window's first tap in an image, the window's rows inside the image (a
  // mask), and each column's bytes (0 outside the image).
  const int a_m = tid % BM, a_r = tid / BM;
  const float* xb = x;
  int corner = 0;
  uint32_t rows = 0;
  int bytes[K];
  {
    const int m = m0 + a_m;
    const int b = m < m_total ? m / plane : 0, p = m - b * plane, oy = p / ow, ox = p - oy * ow;
    const int iy0 = oy * S - G::kPad, ix0 = ox * S - G::kPad;
    xb = x + (static_cast<size_t>(b) * CIN + c0) * h * wd;
    corner = iy0 * wd + ix0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (m < m_total && iy0 + k >= 0 && iy0 + k < h) rows |= 1u << k;
      bytes[k] = ix0 + k >= 0 && ix0 + k < wd ? 4 : 0;
    }
  }
  __syncthreads();  // the table

  // Stage `chunk` of K into ring buffer `buf`: A rows [k][m], B rows [k][n].
  // The filter words a thread copies are runs of 8 k rows of one channel,
  // word tid first (row tid % 8 of channel n0 + tid / 8): a quarter-warp
  // reads one 32-byte sector and writes 8 distinct banks.
  const float* b_src =
      w + static_cast<size_t>(n0 + tid / 8) * G::kDepth + c0 * K * K + tid % 8;
  const int b_at = (tid % 8) * G::kPitchB + tid / 8;
  auto stage = [&](int chunk, int buf) {
    float* sa = smem + buf * G::kStageFloats;
    float* b_dst = sa + G::kRows * BM + b_at;
    const int k0 = chunk * G::kRows;
#pragma unroll
    for (int i = 0; i < G::kARows; ++i) {  // filter row r: its K taps at fixed steps
      const int r = a_r + i * (G::kThreads / BM);
      const int2 e = tab[chunk * G::kTapRows + r];
      float* dst = sa + r * K * BM + a_m;
      if ((rows >> e.y) & 1) {
        // a tap outside the image copies no byte (its address, up to kPad
        // words before or after the row, is not read)
        const float* src = xb + (corner + e.x);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) copy4(dst + kx * BM, src + kx, bytes[kx]);
      } else {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) copy4(dst + kx * BM, x, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kBLoads; ++i) {  // word tid + i threads: a fixed step from b_src
      constexpr int kRuns = 8 * BN / G::kThreads;  // copies before the next 8 rows
      const int kr = (i / kRuns) * 8, n = (i % kRuns) * (G::kThreads / 8);
      const float* src = b_src + k0 + static_cast<size_t>(n) * G::kDepth + kr;
      if constexpr (G::kEven) {
        copy4(b_dst + kr * G::kPitchB + n, src, 4);
      } else {
        const bool in = k0 + kr + tid % 8 < depth;
        copy4(b_dst + kr * G::kPitchB + n, in ? src : w, in ? 4 : 0);
      }
    }
  };

  const int g = tid / G::kGroup, tig = tid - g * G::kGroup;
  const int tn = tig % G::kNT, tm = tig / G::kNT;
  float acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float b0 =
        g == 0 && !kSplit ? __ldg(bias + n0 + (j / 4) * (4 * G::kNT) + tn * 4 + j % 4) : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = b0;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage(s, s);
    copies_commit();
  }
#pragma unroll 1
  for (int chunk = 0; chunk < chunks; ++chunk) {
    copies_wait<kStages - 2>();
    __syncthreads();  // this chunk landed for every thread; the last one's buffer is free
    const int next = chunk + kStages - 1;
    if (next < chunks) stage(next, next % kStages);
    copies_commit();
    const float* sa = smem + (chunk % kStages) * G::kStageFloats + g * BK * BM + tm * 4;
    const float* sb = smem + (chunk % kStages) * G::kStageFloats + G::kRows * BM +
                      g * BK * G::kPitchB + tn * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(sa + k * BM + (i / 4) * (BM * 4 / TM));
        a[i] = q.x;
        a[i + 1] = q.y;
        a[i + 2] = q.z;
        a[i + 3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 q =
            *reinterpret_cast<const float4*>(sb + k * G::kPitchB + (j / 4) * (4 * G::kNT));
        bv[j] = q.x;
        bv[j + 1] = q.y;
        bv[j + 2] = q.z;
        bv[j + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
      }
    }
  }

  // The groups' sums meet in shared memory, in group order; group g then
  // finishes the runs (i / 4, j) with (i / 4) * TN + j = g mod KS.
  constexpr int kRuns = (TM / 4) * TN;
  if constexpr (G::kKS > 1) {
    copies_wait<0>();
    __syncthreads();  // every group is done with the ring
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) smem[((g * TM + i) * TN + j) * G::kGroup + tig] = acc[i][j];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      if (r % G::kKS != g) continue;
      const int i0 = (r / TN) * 4, j = r % TN;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = smem[((i0 + q) * TN + j) * G::kGroup + tig];
#pragma unroll
        for (int g2 = 1; g2 < G::kKS; ++g2) {
          s = __fadd_rn(s, smem[((g2 * TM + i0 + q) * TN + j) * G::kGroup + tig]);
        }
        acc[i0 + q][j] = s;
      }
    }
  }

  const bool whole = (plane & 3) == 0;  // a run of 4 pixels lies in one plane
  const int m_pad = (m_total + 3) & ~3;  // a row of the workspace
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    if (r % G::kKS != g) continue;
    const int i0 = (r / TN) * 4, j = r % TN;
    const int n = n0 + (j / 4) * (4 * G::kNT) + tn * 4 + j % 4;
    const int m = m0 + (i0 / 4) * (BM * 4 / TM) + tm * 4;
    if (m >= m_total) continue;
    if constexpr (kSplit) {  // the partials, [split][n][m]: a float4 of 4 pixels
      *reinterpret_cast<float4*>(out + (static_cast<size_t>(split) * COUT + n) * m_pad + m) =
          make_float4(acc[i0][j], acc[i0 + 1][j], acc[i0 + 2][j], acc[i0 + 3][j]);
      continue;
    }
    const int b = m / plane, p = m - b * plane;
    float* o = out + (static_cast<size_t>(b) * COUT + n) * plane + p;
    if (whole) {
      *reinterpret_cast<float4*>(o) = make_float4(leaky(acc[i0][j]), leaky(acc[i0 + 1][j]),
                                                  leaky(acc[i0 + 2][j]), leaky(acc[i0 + 3][j]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int mq = m + q;
        if (mq >= m_total) break;
        const int bq = mq / plane, pq = mq - bq * plane;
        out[(static_cast<size_t>(bq) * COUT + n) * plane + pq] = leaky(acc[i0 + q][j]);
      }
    }
  }
}

// The split path's second pass: out (B, COUT, oh, ow) = LeakyReLU(bias +
// the kSplits partials of the workspace [split][COUT][m_pad], added in
// split order); grid (runs of kSumPixels pixels, COUT), a thread every
// kSumThreads-th pixel of its block's run, so that each load and store
// of a warp is 32 consecutive words (but where a plane ends).
constexpr int kSumThreads = 256, kSumPixels = 4 * kSumThreads;
template <int CIN, int COUT, int K, int S>
__global__ void __launch_bounds__(kSumThreads)
    sum_gemm_conv_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                         float* __restrict__ out, int plane, int m_total) {
  constexpr int kSplits = Tiling<CIN, COUT, K, S>::kSplits;
  const int m_pad = (m_total + 3) & ~3, n = blockIdx.y;
  const float b0 = __ldg(bias + n);
#pragma unroll
  for (int q = 0; q < kSumPixels / kSumThreads; ++q) {
    const int m = blockIdx.x * kSumPixels + q * kSumThreads + threadIdx.x;
    if (m >= m_total) break;
    float acc = b0;
#pragma unroll
    for (int z = 0; z < kSplits; ++z) {
      acc = __fadd_rn(acc, ws[(static_cast<size_t>(z) * COUT + n) * m_pad + m]);
    }
    const int b = m / plane, p = m - b * plane;
    out[(static_cast<size_t>(b) * COUT + n) * plane + p] = leaky(acc);
  }
}

template <int CIN, int COUT, int K, int S, bool N>
int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      gemm_conv_kernel<CIN, COUT, K, S, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Gemm<CIN, COUT, K, S, N>::kSmemBytes)));
}

template <int CIN, int COUT, int K, int S, bool N>
int launch_tiled(const void* x, const void* w, const void* bias, void* out, int h, int wd,
                 int oh, int ow, int m_total, void* stream) {
  using G = Gemm<CIN, COUT, K, S, N>;
  const dim3 grid(static_cast<unsigned>((m_total + G::kBM - 1) / G::kBM), COUT / G::kBN,
                  G::kSplits);
  gemm_conv_kernel<CIN, COUT, K, S, N><<<grid, G::kThreads, G::kSmemBytes,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), h, wd, oh, ow, m_total);
  return static_cast<int>(cudaGetLastError());
}

// The wide tiling, or the narrow one where the wide grid has fewer blocks
// than the card has SMs; on the split path, into the workspace `ws`, then
// the sum of the splits into `out`.
template <int CIN, int COUT, int K, int S>
int launch(const void* x, const void* w, const void* bias, void* out, void* ws, int b, int h,
           int wd, int oh, int ow, void* stream) {
  using G = Gemm<CIN, COUT, K, S, false>;
  constexpr bool kSplit = G::kSplits > 1;
  const long long m_total = static_cast<long long>(b) * oh * ow;
  if (b <= 0 || m_total > INT_MAX - G::kBM || (kSplit && ws == nullptr) ||
      static_cast<long long>(CIN) * h * wd > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wide_blocks =
      (m_total + G::kBM - 1) / G::kBM * (COUT / G::kBN) * G::kSplits;
  const int m = static_cast<int>(m_total);
  void* dst = kSplit ? ws : out;
  const int e = wide_blocks < sms
              ? launch_tiled<CIN, COUT, K, S, true>(x, w, bias, dst, h, wd, oh, ow, m, stream)
              : launch_tiled<CIN, COUT, K, S, false>(x, w, bias, dst, h, wd, oh, ow, m, stream);
  if constexpr (kSplit) {
    if (e != 0) return e;
    const dim3 sums(static_cast<unsigned>((m_total + kSumPixels - 1) / kSumPixels), COUT);
    sum_gemm_conv_kernel<CIN, COUT, K, S><<<sums, kSumThreads, 0,
                                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<float*>(out), oh * ow, m);
    return static_cast<int>(cudaGetLastError());
  }
  return e;
}

// The shapes whose K is whole in a block, then those of the split path.
#define V2_SHAPES(X)        \
  X(2, 64, 7, 2)            \
  X(64, 128, 5, 2)          \
  X(16, 32, 5, 2)           \
  X(16, 32, 3, 2)           \
  X(32, 64, 3, 2)           \
  X(64, 128, 3, 2)
#define V2_SPLIT_SHAPES(X)  \
  X(128, 256, 3, 2)         \
  X(256, 256, 3, 2)

int check_sizes(int k, int stride, int h, int wd, int oh, int ow) {
  const int pad = (k - 1) / 2;
  return h <= 0 || wd <= 0 || stride <= 0 || oh != (h + 2 * pad - k) / stride + 1 ||
                 ow != (wd + 2 * pad - k) / stride + 1
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

// Lets every shape's kernel take its dynamic shared memory (above the
// default 48 KB); called once, when the library is loaded, so that no
// launch (nor a CUDA graph's capture of one) sets an attribute. Returns
// the first cudaError_t that is not 0, or 0.
extern "C" int conv_gemm_init() {
  int err = 0;
#define V2_ALLOW(CIN, COUT, K, S)                          \
  if (err == 0) err = allow_smem<CIN, COUT, K, S, false>(); \
  if (err == 0) err = allow_smem<CIN, COUT, K, S, true>();
  V2_SHAPES(V2_ALLOW)
  V2_SPLIT_SHAPES(V2_ALLOW)
#undef V2_ALLOW
  return err;
}

// The runs of c_in that the split path splits a shape's K into; 0 for a
// shape it does not take.
extern "C" int conv_gemm_splits(int cin, int cout, int k, int stride) {
#define V2_SPLITS(CIN, COUT, K, S) \
  if (cin == CIN && cout == COUT && k == K && stride == S) return Tiling<CIN, COUT, K, S>::kSplits;
  V2_SPLIT_SHAPES(V2_SPLITS)
#undef V2_SPLITS
  return 0;
}

// x: contiguous (b, cin, h, wd) float32; w: contiguous (cout, cin, k, k);
// bias: (cout); out: contiguous (b, cout, oh, ow), oh and ow those of
// padding (k - 1) / 2 at the stride; all on the current device. Returns the
// launch's cudaError_t (0 on success), cudaErrorInvalidValue for a shape
// the kernel does not take (those of the split path included).
extern "C" int conv_gemm_f32(const void* x, const void* w, const void* bias, void* out, int b,
                             int cin, int cout, int k, int stride, int h, int wd, int oh,
                             int ow, void* stream) {
  if (const int err = check_sizes(k, stride, h, wd, oh, ow)) return err;
#define V2_LAUNCH(CIN, COUT, K, S)                                            \
  if (cin == CIN && cout == COUT && k == K && stride == S) {                  \
    return launch<CIN, COUT, K, S>(x, w, bias, out, nullptr, b, h, wd, oh, ow, stream); \
  }
  V2_SHAPES(V2_LAUNCH)
#undef V2_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split path: as conv_gemm_f32, for the shapes of conv_gemm_splits
// alone, with ws a float32 workspace of conv_gemm_splits(...) x cout x
// m_pad (b oh ow rounded up to a multiple of 4) on the same device, which
// the launch overwrites.
extern "C" int conv_gemm_split_f32(const void* x, const void* w, const void* bias, void* out,
                                   void* ws, int b, int cin, int cout, int k, int stride, int h,
                                   int wd, int oh, int ow, void* stream) {
  if (const int err = check_sizes(k, stride, h, wd, oh, ow)) return err;
#define V2_LAUNCH(CIN, COUT, K, S)                                       \
  if (cin == CIN && cout == COUT && k == K && stride == S) {             \
    return launch<CIN, COUT, K, S>(x, w, bias, out, ws, b, h, wd, oh, ow, stream); \
  }
  V2_SPLIT_SHAPES(V2_LAUNCH)
#undef V2_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

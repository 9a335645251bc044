// H1, the UAHN's two 16-member MC-dropout heads for Hopper (sm_90a), as a
// fixed pair of launches:
//
//   mc_heads_gemm_kernel   fc0 of both heads (5120 -> 256), split over K,
//                          each member's Dropout_0 mask applied as the
//                          features load; partial sums to a workspace
//   mc_heads_tail_kernel   per pair: the splits summed in a fixed order,
//                          the fc0 bias, LeakyReLU 0.1, the Dropout_1 mask,
//                          fc1 (256 -> 8) with its bias, the log-variance
//                          head's 1e-3, and the ensemble statistics
//
// Replaces no TPU kernel: the JAX package leaves the heads to XLA
// (cuahn_vio/models/uahn.py McHead), and the port first ran them eagerly:
// the (B, 5120) features expanded to (B, 16, 5120), `x / keep` and the
// masked copy written out, cuBLAS's SIMT sgemm for fc0 (a 128x64 tile over
// M = 16 B rows and N = 256, 32 blocks a head at B = 64: a quarter of the
// card's 132 SMs) and some thirty passes for the rest.
//
// What bounds it: float32 FFMA. fc0 of both heads is 2 x 16 B x 256 x 5120
// multiply-adds, 5.37 GFLOP at B = 64, 0.080 ms at the card's 67 TFLOP/s;
// its operands (the weights, 10.5 MB; the masks, 10.5 MB; the features,
// 1.3 MB) take ~0.007 ms at 3.35 TB/s. No tensor core: the heads are
// float32 with TF32 off.
//
// What the design does about it. fc0 is one GEMM a head with M = 16 B rows
// (a pair's 16 members, pair after pair), N = 256, K = 5120. A block owns
// a BM x BN tile of one head over one of kSplits equal ranges of K, so that
// the grid (row tiles x N tiles x heads x splits: 256 blocks of 256
// threads at B = 64) fills the card. Its rows are whole pairs. Every stage
// of kBK = 16 k rows, the block copies the weights' BN x 16 slice through
// registers into shared memory, transposed to [k][n] (a float4 of one
// weight row a thread, stored as four words under an XOR of the column by
// 8 (k / 4 mod 4), so that the transposing stores and the float4 reads of
// a quarter-warp fall on distinct banks); each pair's 16 features of the
// stage are divided by keep once (x_s), and each member row's 16 mask
// bytes, read as two 8-byte words, select `mask ? x / keep : 0` into the A
// tile [k][m]: the (B, 16, 5120) expansion is never written. The stage
// after next's features and the next stage's weights and masks are in
// flight while a stage is read: one barrier a stage. A thread keeps a
// TM x TN micro-tile of accumulators (its m in runs of 4, its n in runs of
// 4, float4 reads of shared memory, as V2 in conv_gemm.cu) and takes each
// k row as TM + TN values and TM TN FFMAs. The tiles' partial sums go to
// the workspace [head][split][row][n], no atomics.
//
// The sums are set by the shape alone: each split's partial starts at 0
// and takes its 640 products in k order, one fma each (the build's
// -fmad=false leaves only these explicit fmas); the tail adds the splits
// in split order, then the bias; fc1 sums each lane's 8 hidden units of a
// member in order and the 32 lanes in a fixed butterfly, then the bias;
// the statistics sum the members in order. A grid smaller than the card's SM
// count takes a narrow tiling (one pair a block) with the same splits and
// sums, so a pair's outputs are the same bits at any batch. A launch
// allocates nothing (the workspace is the caller's) and waits on nothing,
// so a CUDA graph can hold it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMembers = 16;  // MC-dropout members a pair
constexpr int kIn = 5120;     // fc0's inputs: block 4's 256 x 4 x 5 features
constexpr int kHidden = 256;  // fc0's outputs, fc1's inputs
constexpr int kOut = 8;       // fc1's outputs: a member's 4-point offset (or log-variance)
constexpr int kHeads = 2;     // the mean head, then the log-variance head
constexpr int kSplits = 8;    // fc0's K ranges, each summed alone
constexpr int kSplitK = kIn / kSplits;
constexpr int kBK = 16;  // k rows a stage
constexpr int kChunks = kSplitK / kBK;
constexpr float kLeak = 0.1f;
constexpr float kLogvarScale = 1e-3f;
constexpr float kLogvarClamp = 11.5f;
constexpr float kInvMembers = 0.0625f;  // 1 / 16: the members' mean, exactly
static_assert(kIn % (kSplits * kBK) == 0, "whole stages a split");

// Each head's operands, the mean head's first. A pair b's member r reads
// its Dropout_0 mask at mask0 + b * mask_stride + r * kIn and its
// Dropout_1 mask at mask1 + b * mask_stride + r * kHidden (bytes, 0 or 1).
struct Heads {
  const float* w0[kHeads];  // fc0 weights (kHidden, kIn)
  const float* b0[kHeads];  // (kHidden)
  const float* w1[kHeads];  // fc1 weights (kOut, kHidden)
  const float* b1[kHeads];  // (kOut)
  const uint8_t* mask0[kHeads];
  const uint8_t* mask1[kHeads];
};

// fc0's tiling: rows (BM, whole pairs) and hidden units (BN) a block, a
// thread's (TM, TN, multiples of 4). It sets only where a sum is computed.
template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int kBM = BM, kBN = BN, kTM = TM, kTN = TN;
  static constexpr int kNT = BN / TN;  // threads along n
  static constexpr int kThreads = (BM / TM) * kNT;
  static constexpr int kPairs = BM / kMembers;
  static constexpr int kAUnits = BM * (kBK / 8);          // (row, 8 k rows) a stage
  static constexpr int kXUnits = kPairs * kBK;            // features a stage
  static constexpr int kBLoads = BN * (kBK / 4) / kThreads;  // weight float4s a thread a stage
  static constexpr int kAFloats = kBK * BM, kBFloats = kBK * BN;
  static constexpr int kStageFloats = kAFloats + kBFloats + kXUnits;
  static constexpr size_t kSmemBytes = 2 * kStageFloats * sizeof(float);
  static_assert(BM % kMembers == 0 && kHidden % BN == 0, "whole pairs, whole hidden tiles");
  static_assert(TM % 4 == 0 && TN % 4 == 0 && kNT % 8 == 0, "float4 runs, a quarter-warp a row");
  static_assert(BN % 32 == 0, "the XOR swizzle stays inside 32 columns");
  static_assert(kAUnits <= kThreads && kXUnits <= kThreads, "one unit a thread a stage");
  static_assert((BN * (kBK / 4)) % kThreads == 0, "whole weight copies a thread");
  static_assert(kSmemBytes <= 48 * 1024, "static shared memory limit");
};
using Wide = Tile<128, 128, 8, 8>;  // 256 threads, 8 pairs a block
using Narrow = Tile<16, 64, 4, 4>;  // 64 threads, one pair a block

__device__ __forceinline__ float leaky(float a) { return a > 0.0f ? a : __fmul_rn(a, kLeak); }

// heads.field[head] without indexing the kernel's parameters at a runtime
// index (which would copy them to the stack).
template <class P>
__device__ __forceinline__ P of(const P (&field)[kHeads], int head) {
  return head ? field[1] : field[0];
}

// The column of hidden unit n in a stage's row k of the weights' tile.
__device__ __forceinline__ int swizzled(int n, int k) { return n ^ (8 * ((k >> 2) & 3)); }

// feat (pairs, kIn); ws [kHeads][kSplits][16 pairs][kHidden]; grid (row
// tiles, kHidden / BN, kHeads * kSplits). Two wide blocks fit an SM.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(Tile<BM, BN, TM, TN>::kThreads,
                                  512 / Tile<BM, BN, TM, TN>::kThreads)
    mc_heads_gemm_kernel(const float* __restrict__ feat, Heads heads, float* __restrict__ ws,
                         int pairs, long long mask_stride, float keep) {
  using T = Tile<BM, BN, TM, TN>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int rows = pairs * kMembers;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int head = blockIdx.z / kSplits, k_begin = (blockIdx.z % kSplits) * kSplitK;
  const int pair0 = m0 / kMembers;

  // The A unit this thread builds each stage: row a_row, k rows 8 a_half..+8.
  const int a_row = tid % BM, a_half = tid / BM;
  const bool a_in = tid < T::kAUnits && pair0 + a_row / kMembers < pairs;
  const uint8_t* a_mask =
      of(heads.mask0, head) +
      (a_in ? (pair0 + a_row / kMembers) * mask_stride + (a_row % kMembers) * kIn : 0) +
      k_begin + 8 * a_half;
  // The feature this thread divides each stage: pair pair0 + tid / kBK, k row tid % kBK.
  const bool x_in = tid < T::kXUnits && pair0 + tid / kBK < pairs;
  const float* x_src = feat + (x_in ? static_cast<size_t>(pair0 + tid / kBK) * kIn : 0) +
                       k_begin + tid % kBK;
  // The weights' float4s: f = tid + i kThreads is hidden unit f / 4, k rows 4 (f % 4)..+4.
  const float* w_src = of(heads.w0, head) + static_cast<size_t>(n0) * kIn + k_begin;

  uint2 mask_reg = make_uint2(0u, 0u);
  float x_reg = 0.0f;
  float4 w_reg[T::kBLoads];
  auto a_tile = [&](int buf) { return smem + buf * T::kStageFloats; };
  auto b_tile = [&](int buf) { return a_tile(buf) + T::kAFloats; };
  auto x_tile = [&](int buf) { return b_tile(buf) + T::kBFloats; };

  auto load = [&](int chunk) {  // the stage's masks and weights into registers
    if (a_in) mask_reg = __ldg(reinterpret_cast<const uint2*>(a_mask + chunk * kBK));
#pragma unroll
    for (int i = 0; i < T::kBLoads; ++i) {
      const int f = tid + i * T::kThreads;
      w_reg[i] = __ldg(reinterpret_cast<const float4*>(w_src + static_cast<size_t>(f / 4) * kIn +
                                                        chunk * kBK + 4 * (f % 4)));
    }
  };
  auto load_x = [&](int chunk) { x_reg = x_in ? __ldg(x_src + chunk * kBK) : 0.0f; };
  auto put_x = [&](int chunk) {  // the stage's features divided by keep, once a pair
    if (tid < T::kXUnits) x_tile(chunk % 2)[tid] = __fdiv_rn(x_reg, keep);
  };
  auto put = [&](int chunk) {  // the stage's weights and masked features into shared memory
    float* sb = b_tile(chunk % 2);
#pragma unroll
    for (int i = 0; i < T::kBLoads; ++i) {
      const int f = tid + i * T::kThreads, n = f / 4, q = f % 4;
      const int col = n ^ (8 * q);  // swizzled(n, 4 q + e) for e = 0..3
      sb[(4 * q) * BN + col] = w_reg[i].x;
      sb[(4 * q + 1) * BN + col] = w_reg[i].y;
      sb[(4 * q + 2) * BN + col] = w_reg[i].z;
      sb[(4 * q + 3) * BN + col] = w_reg[i].w;
    }
    if (tid < T::kAUnits) {
      const float* xs = x_tile(chunk % 2) + (a_row / kMembers) * kBK + 8 * a_half;
      const float4 lo = *reinterpret_cast<const float4*>(xs);
      const float4 hi = *reinterpret_cast<const float4*>(xs + 4);
      const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float* sa = a_tile(chunk % 2) + (8 * a_half) * BM + a_row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned word = j < 4 ? mask_reg.x : mask_reg.y;
        sa[j * BM] = ((word >> (8 * (j % 4))) & 0xffu) != 0u ? x[j] : 0.0f;
      }
    }
  };

  const int tn = tid % T::kNT, tm = tid / T::kNT;
  int b_col[4][TN / 4];  // a thread's swizzled float4 columns, by k / 4 mod 4
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) b_col[q][j] = swizzled(j * 4 * T::kNT + tn * 4, 4 * q);
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  load_x(0);
  put_x(0);
  load_x(1);
  put_x(1);
  load(0);
  __syncthreads();  // x_tile(0)
  put(0);
  __syncthreads();
#pragma unroll 1
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    if (chunk + 1 < kChunks) load(chunk + 1);
    if (chunk + 2 < kChunks) load_x(chunk + 2);
    const float* sa = a_tile(chunk % 2) + tm * 4;
    const float* sb = b_tile(chunk % 2);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sa + k * BM + (i / 4) * (BM * 4 / TM));
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sb + k * BN + b_col[(k >> 2) & 3][j / 4]);
        bv[j] = v.x;
        bv[j + 1] = v.y;
        bv[j + 2] = v.z;
        bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
      }
    }
    // the next stage's tiles go to the other buffers; the stage after
    // next's features to this stage's (read by put(chunk) before the last
    // barrier)
    if (chunk + 1 < kChunks) put(chunk + 1);
    if (chunk + 2 < kChunks) put_x(chunk + 2);
    __syncthreads();
  }

  float* out = ws + (static_cast<size_t>(blockIdx.z) * rows) * kHidden + n0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM * 4 / TM) + tm * 4 + i % 4;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * kHidden + (j / 4) * 4 * T::kNT +
                                 tn * 4) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
  }
}

template <class T>
int launch_gemm(const float* feat, const Heads& heads, float* ws, int pairs, long long mask_stride,
                float keep, cudaStream_t stream) {
  const int row_tiles = (pairs * kMembers + T::kBM - 1) / T::kBM;
  const dim3 grid(static_cast<unsigned>(row_tiles), kHidden / T::kBN, kHeads * kSplits);
  mc_heads_gemm_kernel<T::kBM, T::kBN, T::kTM, T::kTN>
      <<<grid, T::kThreads, T::kSmemBytes, stream>>>(feat, heads, ws, pairs, mask_stride, keep);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTailThreads = kHeads * kHidden;  // a thread a hidden unit of each head
constexpr int kHPitch = kHidden + 2;            // a member's row of hidden units in shared memory
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kTailSmemFloats =
    kHeads * kMembers * kHPitch + kHeads * kMembers * kOut + kMembers * kOut;
static_assert(kTailSmemFloats * sizeof(float) <= 48 * 1024, "static shared memory limit");
static_assert(kHidden % 32 == 0 && (kHeads * kMembers * kOut) % kTailWarps == 0,
              "fc1: whole hidden units a lane, whole outputs a warp");

}  // namespace

// (At file scope, so that its symbol names it as ptxas and a trace do.)

// One block a pair: ws as mc_heads_gemm_kernel wrote it; corners (4, 2);
// members (pairs, kHeads, 16, kOut); pred and var (pairs, 4, 2).
__global__ void __launch_bounds__(kTailThreads)
    mc_heads_tail_kernel(const float* __restrict__ ws, Heads heads,
                         const float* __restrict__ corners, float* __restrict__ members,
                         float* __restrict__ pred, float* __restrict__ var, int pairs,
                         long long mask_stride, float keep) {
  extern __shared__ __align__(16) float smem[];
  float* hidden = smem;                                     // [head][member][kHPitch]
  float* outs = hidden + kHeads * kMembers * kHPitch;       // [head][member][kOut]
  float* exps = outs + kHeads * kMembers * kOut;            // [member][kOut]: exp(log-variance)
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t rows = static_cast<size_t>(pairs) * kMembers;

  {  // hidden unit n of each member: the splits in order, the bias, LeakyReLU, Dropout_1
    const int head = tid / kHidden, n = tid % kHidden;
    const float* src = ws + (static_cast<size_t>(head) * kSplits * rows + b * kMembers) * kHidden + n;
    const uint8_t* mask = of(heads.mask1, head) + b * mask_stride + n;
    const float bias = __ldg(of(heads.b0, head) + n);
    float h[kMembers];  // the members side by side: 16 loads in flight a split
#pragma unroll
    for (int r = 0; r < kMembers; ++r) h[r] = src[r * kHidden];
#pragma unroll
    for (int s = 1; s < kSplits; ++s) {
#pragma unroll
      for (int r = 0; r < kMembers; ++r) h[r] = __fadd_rn(h[r], src[(s * rows + r) * kHidden]);
    }
#pragma unroll
    for (int r = 0; r < kMembers; ++r) {
      const float a = leaky(__fadd_rn(h[r], bias));
      hidden[(head * kMembers + r) * kHPitch + n] = mask[r * kHidden] ? __fdiv_rn(a, keep) : 0.0f;
    }
  }
  __syncthreads();
  {  // fc1: warp w takes outputs o = w, w + kTailWarps, .. of (head, member,
     // i); lane l sums hidden units l + 32 j in order of j, and the 32 lane
     // sums meet in a fixed butterfly (xor 16, 8, 4, 2, 1)
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll 4
    for (int o = warp; o < kHeads * kMembers * kOut; o += kTailWarps) {
      const int head = o / (kMembers * kOut), r = (o / kOut) % kMembers, i = o % kOut;
      const float* h = hidden + (head * kMembers + r) * kHPitch + lane;
      const float* w = of(heads.w1, head) + i * kHidden + lane;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kHidden / 32; ++j) s = __fmaf_rn(h[32 * j], __ldg(w + 32 * j), s);
#pragma unroll
      for (int x = 16; x > 0; x /= 2) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, x));
      if (lane == 0) {
        float v = __fadd_rn(s, __ldg(of(heads.b1, head) + i));
        if (head == 1) {
          v = __fmul_rn(v, kLogvarScale);
          // clamped as torch.clamp (NaN stays NaN), then its exp
          const float lv =
              v < -kLogvarClamp ? -kLogvarClamp : (v > kLogvarClamp ? kLogvarClamp : v);
          exps[o - kMembers * kOut] = expf(lv);
        }
        outs[o] = v;
        members[static_cast<size_t>(b) * kHeads * kMembers * kOut + o] = v;
      }
    }
  }
  __syncthreads();
  if (tid < kOut) {  // the ensemble statistics of coordinate tid, members in order
    const float* means = outs + tid;
    const float* ex = exps + tid;
    float sum = means[0];
    for (int r = 1; r < kMembers; ++r) sum = __fadd_rn(sum, means[r * kOut]);
    const float mean = __fmul_rn(sum, kInvMembers);
    float spread = 0.0f, expsum = 0.0f;
    for (int r = 0; r < kMembers; ++r) {
      const float d = __fsub_rn(means[r * kOut], mean);
      spread = r ? __fadd_rn(spread, __fmul_rn(d, d)) : __fmul_rn(d, d);
      expsum = r ? __fadd_rn(expsum, ex[r * kOut]) : ex[0];
    }
    pred[b * kOut + tid] = __fadd_rn(__ldg(corners + tid), mean);
    var[b * kOut + tid] =
        __fadd_rn(__fmul_rn(spread, kInvMembers), __fmul_rn(expsum, kInvMembers));
  }
}


// fc0's K splits: the workspace is kHeads x kSplits x 16 pairs x kHidden floats.
extern "C" int mc_heads_splits() { return kSplits; }

// feat: contiguous (pairs, 5120) float32; the heads' weights contiguous
// float32 (fc0 (256, 5120) and (256), fc1 (8, 256) and (8)), the mean
// head's first; the masks as struct Heads reads them (mask0 8-byte
// aligned, mask_stride a multiple of 8); corners (4, 2); ws as
// mc_heads_splits() says; members (pairs, 2, 16, 8), pred and var (pairs,
// 4, 2); all on the current device. Launches mc_heads_gemm_kernel (the
// wide tiling, or the narrow one where the wide grid has fewer blocks than
// the card has SMs) and then mc_heads_tail_kernel on `stream`. Returns the
// first cudaError_t that is not 0 (cudaErrorInvalidValue for arguments
// the kernels do not take), or 0.
extern "C" int mc_heads_f32(const float* feat, const float* w0_mean, const float* b0_mean,
                            const float* w1_mean, const float* b1_mean, const float* w0_logvar,
                            const float* b0_logvar, const float* w1_logvar,
                            const float* b1_logvar, const uint8_t* mask0_mean,
                            const uint8_t* mask1_mean, const uint8_t* mask0_logvar,
                            const uint8_t* mask1_logvar, long long mask_stride,
                            const float* corners, float* ws, float* members, float* pred,
                            float* var, int pairs, float keep, void* stream) {
  if (pairs <= 0 || pairs > INT_MAX / (kMembers * kHidden * kHeads * kSplits) ||
      mask_stride % 8 != 0 || mask_stride < kMembers * kIn ||
      (reinterpret_cast<uintptr_t>(mask0_mean) | reinterpret_cast<uintptr_t>(mask0_logvar)) % 8 ||
      !(keep > 0.0f && keep <= 1.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Heads heads = {{w0_mean, w0_logvar}, {b0_mean, b0_logvar}, {w1_mean, w1_logvar},
                       {b1_mean, b1_logvar}, {mask0_mean, mask0_logvar},
                       {mask1_mean, mask1_logvar}};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long wide_blocks = static_cast<long long>((pairs * kMembers + Wide::kBM - 1) /
                                                       Wide::kBM) *
                                (kHidden / Wide::kBN) * kHeads * kSplits;
  int e = wide_blocks < sms ? launch_gemm<Narrow>(feat, heads, ws, pairs, mask_stride, keep, s)
                            : launch_gemm<Wide>(feat, heads, ws, pairs, mask_stride, keep, s);
  if (e != 0) return e;
  mc_heads_tail_kernel<<<pairs, kTailThreads, kTailSmemFloats * sizeof(float), s>>>(
      ws, heads, corners, members, pred, var, pairs, mask_stride, keep);
  return static_cast<int>(cudaGetLastError());
}

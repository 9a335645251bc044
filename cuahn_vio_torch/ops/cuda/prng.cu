// The JAX random stream on Hopper (sm_90a): Threefry-2x32 draws, as bits,
// uniform floats, Bernoulli masks, normals or truncated normals, for K keys
// in one launch.
//
// Replaces no TPU kernel: XLA lowers jax.random's threefry itself. It is
// written by hand because the port must draw what the JAX package draws at
// a seed (the MC-dropout masks of every network call, the sensor-effect
// noise of make-synthetic and of the trainers' pairs and windows, their
// poses, textures and IMU noise, the UAHN's initial kernels), and the plain
// version (utils/prng.draw_plain)
// is ~150 int64 launches a draw on a path that is already bound by the
// host's launches.
//
// What it computes, for row i (key i, count n_i, rows back to back in the
// output from offsets[i]) and flat index j < n_i of that row:
//   bits = x0 ^ x1 of threefry2x32(key_i, (hi(j), lo(j)))
//     (jax._src.prng: _threefry_random_bits_partitionable, the default
//     jax_threefry_partitionable = True; 5 x 4 rounds with rotations
//     13/15/26/6 and 17/29/16/24, key schedule k0, k1, k0^k1^0x1BD11BDA)
//   mode 0, bits:      bits (uint32)
//   mode 1, uniform:   f = float((bits >> 9) | 0x3F800000) - 1;
//                      max(a, fma(f, b - a, a)) (float32)
//   mode 2, bernoulli: f < p (uint8), computed as (bits >> 9) < T with
//                      T = ceil(float32(p) 2^23) clamped to [0, 2^23]
//                      (utils/prng.bernoulli_threshold, made on the host):
//                      f is (bits >> 9) 2^-23 exactly, so the two agree
//   mode 3, normal:    u = max(lo, fma(f, 1 - lo, lo)), lo = nextafter(-1, 0);
//                      sqrt(2) * erf_inv(u) (float32), with XLA's float32
//                      erf_inv: w = -log1p(-u*u), Giles' polynomial in
//                      w - 2.5 (w < 5) or sqrt(w) - 3, Horner in fmas.
//   mode 4, truncated normal: u = max(a, fma(f, b - a, a)), a and b the erf
//                      of the bounds over sqrt(2); min(max(sqrt(2) *
//                      erf_inv(u), c), d), c and d the bounds moved one
//                      float inward (jax.random.truncated_normal).
// The fmas are where XLA's CPU backend contracts jax.random's arithmetic
// (uniform's scale-and-shift, the Horner steps); the build has -fmad=false,
// so no other contraction happens and the plain version repeats the
// arithmetic op for op. bits, uniform and bernoulli equal it bit for bit;
// the normals may differ where log1pf rounds otherwise than torch.log1p.
//
// What bounds it: the integer operations. A value costs ~78 32-bit integer
// operations of threefry (20 rounds of add, funnel-shift rotate, xor; 5 key
// injections) and a few float ones; it writes 1 (mask) or 4 bytes. So a
// draw is bound by the ALUs (64 lanes a clock an SM), not memory, and at
// the network's 4 masks (172,032 values) by the launch.
//
// What the design does about it: a thread draws a run of R consecutive
// flat values, so that what is not the hash is paid once a run or once a
// row, not once a value:
// - the row: one binary search over the K + 1 offsets for the run's first
//   value (it was ceil(log2 K) dependent loads and ~10 instructions a step
//   for every value); inside the run a thread holds how many of its values
//   lie before the row's end (one compare a value with an immediate), and
//   on crossing it walks to the next non-empty row and loads its key (rows
//   of 0 values, of fewer values than a run, and runs over three or more
//   rows all take that walk);
// - the key schedule: k2 and the five injected words (a key word plus the
//   round count) are made once a row;
// - the store: up to 4 values side by side, stored as one 16-byte word
//   (32-bit modes), or a run of up to 16 coins as one word (Bernoulli);
// - the Bernoulli coin: one shift and one integer compare.
// R is chosen per draw (run_for): the mode's longest run (kRunMask coins,
// kRunWord 32-bit values), halved while the draw would leave fewer than
// kFillPerSM threads an SM of the card, down to 1. A small draw, such as a
// network call's masks, is bound by its latency and the launch, and needs
// threads more than it needs its searches shared; a batch of a few
// sequences' masks takes runs of 2 or 4 (10 and 22 % faster there than
// one value a thread). At R = 1 the kernel is the earlier one value a
// thread with the float coin, which is the same coin and measured 1.3 %
// faster there than the integer compare. Every run has its own kernel
// (threefry_kernel<mode, R>), 128 threads a block. The rounds are unrolled
// with the rotations as immediates (SHF.L.W), no shared memory, and no
// divergence but the row walk and the normal's branch-free select. The
// keys and the row offsets are read from device memory (a CUDA graph can
// replay a launch with new keys written there).
// Runs are aligned on the flat index and the output comes from the caching
// allocator (256-byte aligned), so every full run stores whole aligned
// words; the last thread's partial run stores value by value.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kRunMask = 16;  // Bernoulli values a thread at most: one 16-byte store
constexpr int kRunWord = 8;   // 32-bit values a thread at most: two 16-byte stores
// a draw's run is halved until it leaves this many threads an SM (8 warps
// a scheduler), down to 1
constexpr int kFillPerSM = 4 * 8 * 32;
constexpr int kMaxDevices = 64;
static_assert(kRunMask > 0 && kRunMask <= 16 && (kRunMask & (kRunMask - 1)) == 0,
              "a run of coins is stored as one word of 1 to 16 bytes");
static_assert(kRunWord > 0 && kRunWord <= 16 && (kRunWord & (kRunWord - 1)) == 0,
              "a run of 32-bit values halves down to 1");
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kNormalLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421354f;      // float32(sqrt(2))

template <int kMode>
__host__ __device__ constexpr int run_of() { return kMode == 2 ? kRunMask : kRunWord; }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// a row's key schedule, made once a row: the key words, and the words
// injected into x0 and x1 after each 4 rounds (k1, k2, k0, ... and k2 + 1,
// k0 + 2, ...; k2 = k0 ^ k1 ^ parity)
struct RowKey {
  uint32_t k0, k1, inj0[5], inj1[5];
};

__device__ __forceinline__ RowKey row_key(const uint32_t* __restrict__ keys, int row) {
  RowKey key;
  key.k0 = __ldg(keys + 2 * row);
  key.k1 = __ldg(keys + 2 * row + 1);
  const uint32_t k2 = key.k0 ^ key.k1 ^ kParity;
  const uint32_t ks[3] = {key.k0, key.k1, k2};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    key.inj0[i] = ks[(i + 1) % 3];
    key.inj1[i] = ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return key;
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

// x0 ^ x1 of threefry2x32((k0, k1), (x0, x1))
__device__ __forceinline__ uint32_t threefry_bits(const RowKey& key, uint32_t x0, uint32_t x1) {
  x0 += key.k0;
  x1 += key.k1;
  TF_ROUNDS_A x0 += key.inj0[0]; x1 += key.inj1[0];
  TF_ROUNDS_B x0 += key.inj0[1]; x1 += key.inj1[1];
  TF_ROUNDS_A x0 += key.inj0[2]; x1 += key.inj1[2];
  TF_ROUNDS_B x0 += key.inj0[3]; x1 += key.inj1[3];
  TF_ROUNDS_A x0 += key.inj0[4]; x1 += key.inj1[4];
  return x0 ^ x1;
}

#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// XLA's float32 erf_inv (ErfInv32), Horner steps as fmas
__device__ __forceinline__ float erf_inv_f32(float x) {
  float w = -log1pf(-(x * x));
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = __fmaf_rn(p, w, lt ? 3.43273939e-07f : 0.000100950558f);
  p = __fmaf_rn(p, w, lt ? -3.5233877e-06f : 0.00134934322f);
  p = __fmaf_rn(p, w, lt ? -4.39150654e-06f : -0.00367342844f);
  p = __fmaf_rn(p, w, lt ? 0.00021858087f : 0.00573950773f);
  p = __fmaf_rn(p, w, lt ? -0.00125372503f : -0.0076224613f);
  p = __fmaf_rn(p, w, lt ? -0.00417768164f : 0.00943887047f);
  p = __fmaf_rn(p, w, lt ? 0.246640727f : 1.00167406f);
  p = __fmaf_rn(p, w, lt ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? x * FLT_MAX : p * x;
}

// the mode's value of 32 random bits: a 32-bit word (the float's bits in
// modes 1, 3 and 4), or the coin 0 / 1 in mode 2: the integer compare in
// a run, the float compare, which is the same coin, one value a thread
template <int kMode, int kRun>
__device__ __forceinline__ uint32_t value_of(uint32_t bits, float a, float b, float c, float d,
                                             uint32_t threshold) {
  if constexpr (kMode == 0) {
    return bits;
  } else if constexpr (kMode == 1) {
    return __float_as_uint(fmaxf(a, __fmaf_rn(unit_float(bits), b - a, a)));
  } else if constexpr (kMode == 2 && kRun == 1) {
    return unit_float(bits) < a ? 1u : 0u;
  } else if constexpr (kMode == 2) {
    return (bits >> 9) < threshold ? 1u : 0u;
  } else if constexpr (kMode == 3) {
    const float u = fmaxf(kNormalLo, __fmaf_rn(unit_float(bits), 1.0f - kNormalLo, kNormalLo));
    return __float_as_uint(kSqrt2 * erf_inv_f32(u));
  } else {
    const float u = fmaxf(a, __fmaf_rn(unit_float(bits), b - a, a));
    return __float_as_uint(fminf(fmaxf(kSqrt2 * erf_inv_f32(u), c), d));
  }
}

// how many of a run's values, from `first`, lie before `next` (> first)
__device__ __forceinline__ int values_before(int64_t next, int64_t first, int run) {
  return next - first < run ? static_cast<int>(next - first) : run;
}

}  // namespace

template <int kBytes>
__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
  if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (kBytes == 4) {
    *static_cast<uint32_t*>(p) = w[0];
  } else if constexpr (kBytes == 2) {
    *static_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  } else {
    *static_cast<uint8_t*>(p) = static_cast<uint8_t>(w[0]);
  }
}

// One thread a run of kRun consecutive flat values, starting at a multiple
// of the run; a group of up to 4 of them is drawn side by side and stored
// as one word (32-bit modes) or packed into one (Bernoulli).
// The blocks an SM must hold give ptxas 64 registers a thread (1,024
// threads an SM; left to itself it took 32 and spilled the uniform mode's
// run).
template <int kMode, int kRun>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
threefry_kernel(const uint32_t* __restrict__ keys, const int64_t* __restrict__ offsets,
                void* __restrict__ out, int k, int64_t total, float a, float b, float c,
                float d, uint32_t threshold) {
  constexpr int kGroup = kRun < 4 ? kRun : 4;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kRun;
  if (first >= total) return;
  int row = 0, hi = k - 1;  // the row: the last i with offsets[i] <= first
  while (row < hi) {
    const int mid = (row + hi + 1) >> 1;
    if (__ldg(offsets + mid) <= first) row = mid; else hi = mid - 1;
  }
  int64_t next = kRun > 1 ? __ldg(offsets + row + 1) : 0;
  int64_t j0 = first - __ldg(offsets + row);  // the run's first value's counter in the row
  int before_end = kRun > 1 ? values_before(next, first, kRun) : 1;
  RowKey key = row_key(keys, row);

  uint32_t words[kRun / kGroup];  // Bernoulli: each group's coins packed into a word
#pragma unroll
  for (int g = 0; g < kRun / kGroup; ++g) {
    uint32_t vals[kGroup];
#pragma unroll
    for (int v = 0; v < kGroup; ++v) {
      const int at = kGroup * g + v;
      // past the row's end: walk to the next row (a run of 1 never is)
      if (kRun > 1 && at >= before_end && row < k - 1) {
        const int64_t idx = first + at;
        int64_t start;
        do {
          ++row;
          start = next;
          next = __ldg(offsets + row + 1);
        } while (idx >= next && row < k - 1);
        j0 = first - start;
        before_end = values_before(next, first, kRun);
        key = row_key(keys, row);
      }
      // past the total (the last run only) the value is drawn and not stored
      const uint64_t j = static_cast<uint64_t>(j0 + at);
      const uint32_t bits =
          threefry_bits(key, static_cast<uint32_t>(j >> 32), static_cast<uint32_t>(j));
      vals[v] = value_of<kMode, kRun>(bits, a, b, c, d, threshold);
    }
    if constexpr (kMode == 2) {
      words[g] = 0;
#pragma unroll
      for (int v = 0; v < kGroup; ++v) words[g] |= vals[v] << (8 * v);
    } else if (kRun == 1 || first + kGroup * (g + 1) <= total) {
      store_words<4 * kGroup>(static_cast<uint32_t*>(out) + first + kGroup * g, vals);
    } else {
#pragma unroll
      for (int v = 0; v < kGroup; ++v) {
        const int64_t at = first + kGroup * g + v;
        if (at < total) static_cast<uint32_t*>(out)[at] = vals[v];
      }
    }
  }
  if constexpr (kMode == 2) {
    uint8_t* bytes = static_cast<uint8_t*>(out) + first;
    if (kRun == 1 || first + kRun <= total) {
      store_words<kRun>(bytes, words);
    } else {
#pragma unroll
      for (int v = 0; v < kRun; ++v) {
        if (first + v < total) bytes[v] = static_cast<uint8_t>(words[v / 4] >> (8 * (v % 4)));
      }
    }
  }
}

namespace {

// The threads a draw's run must leave: kFillPerSM times the SMs of the
// current device, read once a device; -1 without a device.
long long fill_threads() {
  static std::atomic<long long> cached[kMaxDevices];  // 0: not read yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  long long n = dev < kMaxDevices ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (n != 0) return n;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return -1;
  }
  n = static_cast<long long>(sms) * kFillPerSM;
  if (dev < kMaxDevices) cached[dev].store(n, std::memory_order_relaxed);
  return n;
}

// The run a draw of `total` values takes: the mode's longest (kRunMask or
// kRunWord), halved while it would leave fewer than fill_threads() threads,
// down to one value a thread (a small draw needs threads more than it
// needs its row searches shared); -1 without a device.
template <int kMode>
int run_for(long long total) {
  const long long fill = fill_threads();
  if (fill < 0) return -1;
  int run = run_of<kMode>();
  while (run > 1 && total < run * fill) run /= 2;
  return run;
}

template <int kMode, int kRun = run_of<kMode>()>
void launch(int run, const uint32_t* keys, const int64_t* offsets, void* out, int k,
            long long total, float a, float b, float c, float d, unsigned threshold,
            cudaStream_t stream) {
  if constexpr (kRun > 1) {
    if (run < kRun) {
      launch<kMode, kRun / 2>(run, keys, offsets, out, k, total, a, b, c, d, threshold, stream);
      return;
    }
  }
  const dim3 grid(static_cast<unsigned>((total + kThreads * kRun - 1) / (kThreads * kRun)));
  threefry_kernel<kMode, kRun><<<grid, kThreads, 0, stream>>>(keys, offsets, out, k, total, a, b,
                                                              c, d, threshold);
}

}  // namespace

extern "C" {

// Values a thread draws in a draw of `total` values in `mode` (its run) on
// the current device; -1 for a mode the kernel does not have, or no device.
int threefry_values_per_thread(int mode, long long total) {
  switch (mode) {
    case 0: return run_for<0>(total);
    case 1: return run_for<1>(total);
    case 2: return run_for<2>(total);
    case 3: return run_for<3>(total);
    case 4: return run_for<4>(total);
    default: return -1;
  }
}

// keys (k, 2) uint32 and offsets (k + 1,) int64 (row starts, the total
// last) on the current device, out of `total` elements of the mode's type
// (uint32, float32, uint8, float32, float32), 256-byte aligned; the
// Bernoulli mode reads p (as a) at one value a thread and `threshold`
// (utils/prng.bernoulli_threshold of p) in runs. Returns the launch's
// cudaError_t.
int threefry_draw(const void* keys, const void* offsets, void* out, int k, long long total,
                  int mode, float a, float b, float c, float d, unsigned threshold,
                  void* stream) {
  const int run = threefry_values_per_thread(mode, total);
  if (run < 0 || k < 1 || total < 1 || threshold > (1u << 23)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((total + kThreads * run - 1) / (kThreads * run) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto* kp = static_cast<const uint32_t*>(keys);
  const auto* op = static_cast<const int64_t*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch<0>(run, kp, op, out, k, total, a, b, c, d, threshold, s); break;
    case 1: launch<1>(run, kp, op, out, k, total, a, b, c, d, threshold, s); break;
    case 2: launch<2>(run, kp, op, out, k, total, a, b, c, d, threshold, s); break;
    case 3: launch<3>(run, kp, op, out, k, total, a, b, c, d, threshold, s); break;
    default: launch<4>(run, kp, op, out, k, total, a, b, c, d, threshold, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

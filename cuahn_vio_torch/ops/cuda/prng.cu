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
//   mode 2, bernoulli: f < a (uint8), a = p
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
// draw is bound by the ALUs, not memory, and at the network's 4 masks
// (327,680 values) by the launch.
//
// What the design does about it: one thread a value, the rounds unrolled
// with the rotations as immediates (SHF.L.W), no shared memory and no
// divergence but the normal's branch-free select. The keys and the row
// offsets are read from device memory (a CUDA graph can replay a launch
// with new keys written there); a thread finds its row by binary search
// over the K + 1 offsets, which stay in L1.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kNormalLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421354f;      // float32(sqrt(2))

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

// x0 ^ x1 of threefry2x32((k0, k1), (x0, x1))
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
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

}  // namespace

template <int kMode>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint32_t* __restrict__ keys, const int64_t* __restrict__ offsets,
                void* __restrict__ out, int k, int64_t total, float a, float b, float c,
                float d) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  int lo = 0, hi = k - 1;  // the row: the last i with offsets[i] <= idx
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offsets + mid) <= idx) lo = mid; else hi = mid - 1;
  }
  const uint64_t j = static_cast<uint64_t>(idx - __ldg(offsets + lo));
  const uint32_t bits = threefry_bits(__ldg(keys + 2 * lo), __ldg(keys + 2 * lo + 1),
                                      static_cast<uint32_t>(j >> 32),
                                      static_cast<uint32_t>(j));
  if (kMode == 0) {
    static_cast<uint32_t*>(out)[idx] = bits;
  } else if (kMode == 1) {
    static_cast<float*>(out)[idx] = fmaxf(a, __fmaf_rn(unit_float(bits), b - a, a));
  } else if (kMode == 2) {
    static_cast<uint8_t*>(out)[idx] = unit_float(bits) < a ? 1 : 0;
  } else if (kMode == 3) {
    const float u = fmaxf(kNormalLo, __fmaf_rn(unit_float(bits), 1.0f - kNormalLo, kNormalLo));
    static_cast<float*>(out)[idx] = kSqrt2 * erf_inv_f32(u);
  } else {
    const float u = fmaxf(a, __fmaf_rn(unit_float(bits), b - a, a));
    static_cast<float*>(out)[idx] = fminf(fmaxf(kSqrt2 * erf_inv_f32(u), c), d);
  }
}

extern "C" {

// keys (k, 2) uint32 and offsets (k + 1,) int64 (row starts, the total
// last) on the current device, out of `total` elements of the mode's type
// (uint32, float32, uint8, float32, float32); returns the launch's
// cudaError_t.
int threefry_draw(const void* keys, const void* offsets, void* out, int k, long long total,
                  int mode, float a, float b, float c, float d, void* stream) {
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const auto* kp = static_cast<const uint32_t*>(keys);
  const auto* op = static_cast<const int64_t*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      threefry_kernel<0><<<blocks, kThreads, 0, s>>>(kp, op, out, k, total, a, b, c, d);
      break;
    case 1:
      threefry_kernel<1><<<blocks, kThreads, 0, s>>>(kp, op, out, k, total, a, b, c, d);
      break;
    case 2:
      threefry_kernel<2><<<blocks, kThreads, 0, s>>>(kp, op, out, k, total, a, b, c, d);
      break;
    case 3:
      threefry_kernel<3><<<blocks, kThreads, 0, s>>>(kp, op, out, k, total, a, b, c, d);
      break;
    case 4:
      threefry_kernel<4><<<blocks, kThreads, 0, s>>>(kp, op, out, k, total, a, b, c, d);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

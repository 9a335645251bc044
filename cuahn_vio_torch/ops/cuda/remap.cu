// Bilinear remap of uint8 frames through a float32 map, for Hopper (sm_90a):
// the undistortion of raw camera frames into the 224x320 virtual camera.
//
// Replaces the JAX package's native host runtime, not a TPU kernel:
// remap_u8 / remap_u8_batch of cuahn_vio/runtime/undistort.cpp:92-139 (the
// OpenCV-free cv::remap INTER_LINEAR, border 0, of CamBase.h:165-186), the
// per-frame "image load" stage of the reference.
//
// What it computes, per frame n and output pixel i: x0 = floor(map_x[i]),
// wx = map_x[i] - x0 in float32 (the same for y); the taps (y0,x0),
// (y0,x0+1), (y0+1,x0), (y0+1,x0+1) added in that order as
// acc = fmaf(wy_k * wx_k, src, acc), a tap outside the image left out;
// then acc + 0.5f clamped to [0, 255] and truncated to uint8. That is the
// C++ as the JAX package builds it (g++ -O3 -march=native -std=c++17
// contracts acc += w * src into an fma; GCC's ISO-mode contraction rule is
// for C only). Built with -fmad=false, the only fma here is that explicit
// one, which the plain version (ops/remap.py) computes exactly too, so the
// three agree bit for bit. Where the C++ is undefined, the kernel
// gives 0: a NaN coordinate samples nothing, and coordinates are clipped to
// +-1e6 first, beyond which every tap is off any image the wrapper takes.
//
// What bounds it: the bytes. A frame's output is 71,680 B written; its taps
// read the raw pixels under the map's footprint (about the 307,200 B of a
// 640x480 frame, each read by ~1-4 taps); the 573,440 B map is read once per
// thread. A 640x480 -> 224x320 frame is then ~0.4 MB, ~0.12 us at 3.35
// TB/s: one frame is bound by the launch and one chain of dependent loads
// (map, then taps), a sequence of ~150 frames by the bytes.
//
// What the design does about it: one thread per output pixel and chunk of
// kFramesPerThread frames. The thread loads its map entry once, computes
// the four tap offsets, their in-image predicates and weights once, and
// then reuses them for every frame of its chunk, so the map crosses memory
// once per chunk, not once per frame. Taps are byte loads through the
// read-only path (__ldg): neighbouring output pixels read neighbouring raw
// pixels, so a warp's taps fall on a few cache lines that L1/L2 serve.
// Stores are one byte a thread, 32 adjacent bytes a warp. The grid is
// (pixel blocks, frame chunks): one launch for the whole batch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFramesPerThread = 8;
constexpr float kCoordClip = 1e6f;

}  // namespace

__global__ void __launch_bounds__(kThreads)
remap_kernel(const uint8_t* __restrict__ src, const float* __restrict__ map_x,
             const float* __restrict__ map_y, uint8_t* __restrict__ dst, int n,
             int src_h, int src_w, int out_pix) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= out_pix) return;
  float sx = __ldg(map_x + i);
  float sy = __ldg(map_y + i);
  const bool is_nan = isnan(sx) || isnan(sy);
  sx = fminf(fmaxf(sx, -kCoordClip), kCoordClip);
  sy = fminf(fmaxf(sy, -kCoordClip), kCoordClip);
  const float fx0 = floorf(sx);
  const float fy0 = floorf(sy);
  const int x0 = static_cast<int>(fx0);
  const int y0 = static_cast<int>(fy0);
  const float wx = sx - fx0;
  const float wy = sy - fy0;
  const float wxs[2] = {1.0f - wx, wx};
  const float wys[2] = {1.0f - wy, wy};
  float w[4];
  int off[4];
  bool in[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const int xi = x0 + dx, yi = y0 + dy;
    in[k] = !is_nan && xi >= 0 && xi < src_w && yi >= 0 && yi < src_h;
    off[k] = in[k] ? yi * src_w + xi : 0;
    w[k] = wys[dy] * wxs[dx];
  }
  const size_t frame_bytes = static_cast<size_t>(src_h) * src_w;
  const int f0 = blockIdx.y * kFramesPerThread;
  const int f1 = min(n, f0 + kFramesPerThread);
  for (int f = f0; f < f1; ++f) {
    const uint8_t* img = src + f * frame_bytes;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (in[k]) acc = __fmaf_rn(w[k], static_cast<float>(__ldg(img + off[k])), acc);
    }
    const float r = acc + 0.5f;
    dst[static_cast<size_t>(f) * out_pix + i] =
        static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
  }
}

extern "C" {

// frames (n, src_h, src_w) uint8, maps (out_pix,) float32, out (n, out_pix)
// uint8, all contiguous on the current device; returns the launch's
// cudaError_t (0 on success).
int remap_u8_batch(const void* src, const void* map_x, const void* map_y, void* dst, int n,
                   int src_h, int src_w, int out_pix, void* stream) {
  const dim3 grid((out_pix + kThreads - 1) / kThreads,
                  (n + kFramesPerThread - 1) / kFramesPerThread);
  remap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(map_x),
      static_cast<const float*>(map_y), static_cast<uint8_t*>(dst), n, src_h, src_w, out_pix);
  return static_cast<int>(cudaGetLastError());
}

int remap_frames_per_thread() { return kFramesPerThread; }

}  // extern "C"

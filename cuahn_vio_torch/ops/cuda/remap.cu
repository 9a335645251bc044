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
// read the raw pixels under the map's footprint (~134 KB of a 640x480
// fisheye frame); the 573,440 B map is read once. A sequence of ~165
// frames is then ~34 MB, ~10 us at 3.35 TB/s; one frame is bound by the
// launch and the chain of dependent reads (map, then taps).
//
// What the design does about it: the card must keep enough bytes in flight
// to reach that rate, and a thread that loads its taps frame after frame
// does not (one chain of four dependent-address byte loads at a time). So
// a block takes a tile of kTileRows x kTileCols output pixels and a chunk
// of frames (the grid is (tiles, frame chunks): as many blocks as fit on
// the card at once, one launch for the batch). A warp's lanes are 32
// adjacent columns of one output row, so each tap load of a warp reads a
// short stretch of one or two raw rows; a thread owns kPixels pixels of
// its column, kWarps rows apart. The block reads its tile's map once,
// keeps each pixel's four tap weights and offsets in registers for all its
// frames, and finds by a block reduction the box of raw rows and columns
// that its in-image taps touch (columns widened to whole kChunk-byte
// chunks). It then streams its frames' boxes through a ring of kStages
// shared-memory stages: while it blends frame i from one stage, the copies
// of frames i+1 .. i+kStages-2 are in flight (cp.async, kChunk bytes each,
// one commit group a frame). An off-image tap has weight +0 and reads the
// stage's (or frame's) first byte: fmaf(+0, src, acc) = acc exactly, as
// leaving the tap out does, so there is no branch a tap. The byte-to-float
// and float-to-byte conversions are done exactly on the float pipe (see
// blend_store), not on the card's 16-lane conversion pipe. Raw frames
// whose rows are not 16-byte aligned (a width that is not a multiple of
// 16, or an offset base pointer) fill the same stages byte by byte with
// ordinary loads, past-the-row bytes left out. A tile whose box exceeds
// kStageBytes (a map that spreads a tile over the raw frame) reads its taps
// from global memory through the read-only path, all 16 of a thread's taps
// of a frame at once; a tile with no in-image tap copies nothing.
// ops/remap.py tile_boxes states the same box rule.
//
// What is left in the way (measured on the H100 with tune_remap.py's
// probes, PERF.md): the blend's 16 one-byte shared-memory loads a thread
// and frame, which cost more than the rest of the blend, and the 16-byte
// copies, which alone run at ~60 % of the byte rate. The tile, the ring's
// depth and the stage size were chosen there by timing alternatives
// (tune_remap.py builds copies of this file with other constants).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kPixels = 4;  // output pixels a thread: one column, kPixels rows kWarps apart
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = kWarps * kPixels;
constexpr int kTileCols = 32;      // a warp's lanes, one output column each
constexpr int kStages = 4;         // frame boxes in the shared ring
constexpr int kStageBytes = 6144;  // the largest box a tile streams
constexpr int kChunk = 16;         // bytes of one asynchronous copy
constexpr int kChunksPerThread = kStageBytes / kChunk / kThreads;
constexpr int kMinBlocks = 8;  // blocks an SM the registers must allow
constexpr float kCoordClip = 1e6f;
constexpr float kOff = -2.0f;       // a coordinate whose four taps are all off any image
constexpr float kTwo23 = 8388608.0f;  // 2^23: the floats from here to 2^24 are the integers

static_assert(kStageBytes % (kChunk * kThreads) == 0, "a stage is whole chunks of every thread");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_chunk(void* to, const void* from) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(to)), "l"(from)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's newest commit groups are
// still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Every tap of the thread's pixels, loaded at once (a pixel past the map
// has offsets 0 and weights 0).
template <typename Load>
__device__ __forceinline__ void load_taps(const int (&off)[kPixels][4], Load load,
                                          uint32_t (&tap)[kPixels][4]) {
#pragma unroll
  for (int p = 0; p < kPixels; ++p) {
#pragma unroll
    for (int k = 0; k < 4; ++k) tap[p][k] = load(off[p][k]);
  }
}

// Each pixel's taps blended in order, rounded, clamped and truncated, into
// out (a pixel past the map stores nothing); the four sums run side by
// side. Both conversions are exact and keep off the card's slow
// conversion pipe: a byte v is 2^23 + v less 2^23, and r in [0, 255]
// truncates to the low byte of 2^23 + r rounded toward zero.
__device__ __forceinline__ void blend_store(const float (&w)[kPixels][4],
                                            const uint32_t (&tap)[kPixels][4], uint8_t* out,
                                            int out_w, int live) {
#pragma unroll
  for (int p = 0; p < kPixels; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = __fsub_rn(__uint_as_float(0x4B000000u | tap[p][k]), kTwo23);
      acc = __fmaf_rn(w[p][k], v, acc);
    }
    const float r = fminf(fmaxf(__fadd_rn(acc, 0.5f), 0.0f), 255.0f);
    const uint8_t b = static_cast<uint8_t>(__float_as_uint(__fadd_rz(r, kTwo23)));
    if (p < live) out[p * kWarps * out_w] = b;
  }
}

}  // namespace

// Frames [blockIdx.z * frames_per_block, +frames_per_block) of (n, src_h,
// src_w) uint8 `src` through the (out_h, out_w) maps into (n, out_h, out_w)
// `dst`, for the output tile (blockIdx.y, blockIdx.x). async_copy: every
// raw row starts 16-byte aligned. tile_paths, when not null, counts the
// tiles by path ([0] shared ring, [1] global taps), once a tile.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
remap_kernel(const uint8_t* __restrict__ src, const float* __restrict__ map_x,
             const float* __restrict__ map_y, uint8_t* __restrict__ dst, int n, int src_h,
             int src_w, int out_h, int out_w, int frames_per_block, bool async_copy,
             int* __restrict__ tile_paths) {
  __shared__ __align__(128) unsigned char ring[kStages][kStageBytes];
  __shared__ int s_box[4][kWarps];

  const int warp = threadIdx.x / 32;
  const int row = blockIdx.y * kTileRows + warp;  // the thread's first pixel; then kWarps down
  const int col = blockIdx.x * kTileCols + threadIdx.x % 32;
  // the thread's pixels in the map: the first `live`
  const int live = col < out_w ? min(kPixels, (out_h - row + kWarps - 1) / kWarps) : 0;

  // each pixel's top-left tap and weights (an off-image tap weighs +0), and
  // the box of raw rows [rlo, rhi] and columns [clo, chi] of in-image taps
  int x0[kPixels], y0[kPixels];
  float w[kPixels][4];
  int rlo = INT_MAX, rhi = -1, clo = INT_MAX, chi = -1;
#pragma unroll
  for (int p = 0; p < kPixels; ++p) {
    float sx = kOff, sy = kOff;
    if (p < live) {
      sx = __ldg(map_x + (row + p * kWarps) * out_w + col);
      sy = __ldg(map_y + (row + p * kWarps) * out_w + col);
    }
    if (isnan(sx) || isnan(sy)) sx = sy = kOff;
    sx = fminf(fmaxf(sx, -kCoordClip), kCoordClip);
    sy = fminf(fmaxf(sy, -kCoordClip), kCoordClip);
    const float fx0 = floorf(sx);
    const float fy0 = floorf(sy);
    x0[p] = static_cast<int>(fx0);
    y0[p] = static_cast<int>(fy0);
    const float wx = __fsub_rn(sx, fx0);
    const float wy = __fsub_rn(sy, fy0);
    const float wxs[2] = {__fsub_rn(1.0f, wx), wx};
    const float wys[2] = {__fsub_rn(1.0f, wy), wy};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = x0[p] + (k & 1), yi = y0[p] + (k >> 1);
      const bool in = xi >= 0 && xi < src_w && yi >= 0 && yi < src_h;
      w[p][k] = in ? __fmul_rn(wys[k >> 1], wxs[k & 1]) : 0.0f;
    }
    const int cl = max(x0[p], 0), ch = min(x0[p] + 1, src_w - 1);
    const int rl = max(y0[p], 0), rh = min(y0[p] + 1, src_h - 1);
    if (cl <= ch && rl <= rh) {
      rlo = min(rlo, rl);
      rhi = max(rhi, rh);
      clo = min(clo, cl);
      chi = max(chi, ch);
    }
  }
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);
  if (threadIdx.x % 32 == 0) {
    s_box[0][warp] = rlo;
    s_box[1][warp] = rhi;
    s_box[2][warp] = clo;
    s_box[3][warp] = chi;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    rlo = min(rlo, s_box[0][i]);
    rhi = max(rhi, s_box[1][i]);
    clo = min(clo, s_box[2][i]);
    chi = max(chi, s_box[3][i]);
  }
  // the box: rows [rlo, rlo + rows), columns [a0, a0 + pitch) in whole chunks
  const int rows = rhi >= rlo ? rhi - rlo + 1 : 0;
  const int a0 = rows ? clo & ~(kChunk - 1) : 0;
  const int pitch = rows ? (chi & ~(kChunk - 1)) + kChunk - a0 : 0;
  const bool shared = static_cast<long long>(rows) * pitch <= kStageBytes;
  if (tile_paths != nullptr && blockIdx.z == 0 && threadIdx.x == 0) {
    atomicAdd(tile_paths + (shared ? 0 : 1), 1);
  }

  // each tap's offset in the stage (shared) or in the frame (global)
  int off[kPixels][4];
#pragma unroll
  for (int p = 0; p < kPixels; ++p) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = x0[p] + (k & 1), yi = y0[p] + (k >> 1);
      const bool in = xi >= 0 && xi < src_w && yi >= 0 && yi < src_h;
      off[p][k] = !in ? 0 : (shared ? (yi - rlo) * pitch + xi - a0 : yi * src_w + xi);
    }
  }

  const size_t frame_bytes = static_cast<size_t>(src_h) * src_w;
  const size_t out_pix = static_cast<size_t>(out_h) * out_w;
  const int f0 = blockIdx.z * frames_per_block;
  const int nf = min(n - f0, frames_per_block);
  const uint8_t* first = src + f0 * frame_bytes;
  uint8_t* out = dst + f0 * out_pix + row * out_w + col;

  if (!shared) {
    for (int i = 0; i < nf; ++i, out += out_pix) {
      const uint8_t* img = first + i * frame_bytes;
      uint32_t tap[kPixels][4];
      load_taps(off, [img](int o) -> uint32_t { return __ldg(img + o); }, tap);
      blend_store(w, tap, out, out_w, live);
    }
    return;
  }

  // the box's chunks, row-major, are the stage's bytes in order; this
  // thread copies chunks threadIdx.x + k * kThreads, which start at
  // chunk[k] in a frame (-1: none)
  const int cpr = rows ? pitch / kChunk : 1;
  int chunk[kChunksPerThread];
  int r = threadIdx.x / cpr, cc = threadIdx.x - r * cpr;  // chunk (row, column)
  const int dq = kThreads / cpr, dr = kThreads - dq * cpr;  // kThreads chunks on
#pragma unroll
  for (int k = 0; k < kChunksPerThread; ++k) {
    chunk[k] = r < rows ? (rlo + r) * src_w + a0 + cc * kChunk : -1;
    cc += dr;
    r += dq;
    if (cc >= cpr) {
      cc -= cpr;
      ++r;
    }
  }
  auto fill = [&](int i) {
    const uint8_t* from = first + i * frame_bytes;
    unsigned char* to = ring[i % kStages] + threadIdx.x * kChunk;
    if (async_copy) {
#pragma unroll
      for (int k = 0; k < kChunksPerThread; ++k) {
        if (chunk[k] >= 0) cp_async_chunk(to + k * kThreads * kChunk, from + chunk[k]);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kChunksPerThread; ++k) {  // rows off 16-byte boundaries: bytes
      if (chunk[k] < 0) break;
      const int c = threadIdx.x + k * kThreads;
      const int left = src_w - (a0 + (c - c / cpr * cpr) * kChunk);  // the row's bytes from here
#pragma unroll 1
      for (int j = 0; j < min(left, kChunk); ++j) to[k * kThreads * kChunk + j] = __ldg(from + chunk[k] + j);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nf) fill(i);
    cp_async_commit();
  }
  for (int i = 0; i < nf; ++i, out += out_pix) {
    cp_async_wait<kStages - 2>();  // frame i's copies (this thread's) have landed
    __syncthreads();               // everyone's; and frame i-1's stage is free
    if (i + kStages - 1 < nf) fill(i + kStages - 1);
    cp_async_commit();
    const unsigned char* stage = ring[i % kStages];
    uint32_t tap[kPixels][4];
    load_taps(off, [stage](int o) -> uint32_t { return stage[o]; }, tap);
    blend_store(w, tap, out, out_w, live);
  }
}

namespace {

// Resident blocks of the kernel an SM, into *blocks (queried once: the same
// for every launch); returns a cudaError_t.
cudaError_t blocks_per_sm(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, remap_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  *blocks = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch's grid for n frames to (out_h, out_w): grid[0..2] = tiles
// across, tiles down, frame chunks; grid[3] = frames a block. As many
// blocks as fit on the card at once, each streaming its chunk of frames.
// Returns a cudaError_t (0 on success).
int remap_grid(int n, int out_h, int out_w, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_x = (out_w + kTileCols - 1) / kTileCols;
  const long long tiles_y = (out_h + kTileRows - 1) / kTileRows;
  if (n <= 0 || tiles_x == 0 || tiles_y == 0 || tiles_y > 65535 || tiles_x > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long chunks = static_cast<long long>(sms) * per_sm / (tiles_x * tiles_y);
  chunks = chunks < 1 ? 1 : (chunks > n ? n : chunks);
  int per_block = static_cast<int>((n + chunks - 1) / chunks);
  if ((n + per_block - 1) / per_block > 65535) per_block = (n + 65534) / 65535;
  grid[0] = static_cast<int>(tiles_x);
  grid[1] = static_cast<int>(tiles_y);
  grid[2] = (n + per_block - 1) / per_block;
  grid[3] = per_block;
  return 0;
}

// frames (n, src_h, src_w) uint8, maps (out_h, out_w) float32, out (n,
// out_h, out_w) uint8, all contiguous on the current device; tile_paths
// null or two zeroed ints there; returns the launch's cudaError_t (0 on
// success).
int remap_u8_batch(const void* src, const void* map_x, const void* map_y, void* dst, int n,
                   int src_h, int src_w, int out_h, int out_w, void* tile_paths, void* stream) {
  int grid[4];
  const int err = remap_grid(n, out_h, out_w, grid);
  if (err != 0) return err;
  const bool async_copy = reinterpret_cast<uintptr_t>(src) % kChunk == 0 && src_w % kChunk == 0;
  remap_kernel<<<dim3(grid[0], grid[1], grid[2]), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(map_x),
      static_cast<const float*>(map_y), static_cast<uint8_t*>(dst), n, src_h, src_w, out_h,
      out_w, grid[3], async_copy, static_cast<int*>(tile_paths));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's constants: tile rows, tile columns, threads a block, ring
// stages, bytes a stage, bytes a copy (ops/remap.py mirrors them).
void remap_layout(int* out) {
  out[0] = kTileRows;
  out[1] = kTileCols;
  out[2] = kThreads;
  out[3] = kStages;
  out[4] = kStageBytes;
  out[5] = kChunk;
}

}  // extern "C"

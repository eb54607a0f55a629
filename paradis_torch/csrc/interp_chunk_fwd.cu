// Row-chunked forward gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_fwd_kernel_chunked.
// That kernel zero-pads the field's rows to a multiple of rw, reduces
// floor(py) over its whole position block to a row range (_tap_row_range),
// and contracts dense weight matrices over each static rw-row chunk that
// meets the range, guarded by pl.when.  Here the chunk is a row window the
// data chooses, over the unpadded field:
//
//   out[b,p,v] = sum_r K(py - r) * sum_c K(px - c) * f[b,r,c,v]
//
// Design: one block per (b, tile of consecutive positions, group of vg
// channels).  A tile holds kTile (position, channel) items, so kTile / vg
// positions: whole arrival rows of the flattened [H, W] grid or a few of
// them, whose departure rows lie within a few pixels of each other on the
// model path.  The block reduces floor(py) over its finite positions to the
// tap rows [lo + kFirst, hi + kFirst + kN - 1] (non-finite positions have no
// taps and are left out: an inf would widen the window to every chunk).  It
// then walks, in increasing order, the chunks [k*rw, k*rw + rw) that meet
// that window: it stages the chunk's rows, rows x C cells of vg channels, in
// dynamic shared memory (the last chunk may be shorter than rw; nothing is
// padded), and each thread adds, for each of its kItems items, the taps
// whose rows lie in the chunk.  The items' float32 sums stay in registers
// across the chunks and the output is written once, in the field's type.
//
// Float order: over a tap row's columns first, then the rows in increasing
// order, carried across chunks in increasing order: the order of
// interp_fwd.cu, so the result is bitwise equal to it on any positions.
// Taps outside [0,R) x [0,C) are dropped and a non-finite position has no
// taps, per position.  (The Pallas kernel takes the min and max over its
// whole block, so one NaN position there zeroes its whole block.)  There is
// no clamp: a tile whose positions spread over the field stages every chunk,
// which is correct and slow.
//
// vg is the largest channel count, at most 16 bytes a cell, whose chunk fits
// the card's opt-in shared memory (rw = 32 at 1.40625 deg: 32 x 260 cells of
// 4 fp32 or 8 bf16 channels, 133 KB); a chunk that does not fit one channel
// is refused (the C entry point returns the error and the wrapper raises).
//
// What bounds it: memory, as interp_fwd.cu.  At 1.40625 deg (field
// 1x132x260x768, P = 32768, V = 768, fp32) a launch must read the field
// (105 MB) and both positions (201 MB) and write the output (101 MB):
// 0.12 ms at 3.35 TB/s.  Staging reads each chunk once for each tile whose
// window meets it, through L2, and a block's staging and its gathers do not
// overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "interp_taps.cuh"

namespace {

using namespace paradis_interp;

constexpr int kThreads = 512;
constexpr int kItems = 8;                   // (position, channel) items a thread
constexpr int kTile = kThreads * kItems;    // items a block

template <bool kBicubic, typename T>
__global__ void __launch_bounds__(kThreads)
interp_chunk_fwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                        const float* __restrict__ pos_x, T* __restrict__ out, int64_t P,
                        int R, int C, int V, int rw, int n_tiles, int n_groups, int vg) {
  using K = Taps<kBicubic>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [rows of the chunk, C, vg]
  __shared__ int window[2];

  const int t = blockIdx.x % n_tiles;
  const int group = (blockIdx.x / n_tiles) % n_groups;
  const int64_t b = blockIdx.x / (n_tiles * n_groups);
  const int v0 = group * vg;
  const int64_t p0 = static_cast<int64_t>(t) * (kTile / vg);
  const int n_items = static_cast<int>(P - p0 < kTile / vg ? P - p0 : kTile / vg) * vg;
  if (threadIdx.x == 0) {
    window[0] = INT_MAX;
    window[1] = INT_MIN;
  }

  float y[kItems], x[kItems], acc[kItems];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = threadIdx.x + j * kThreads;
    y[j] = x[j] = __int_as_float(0x7fc00000);  // NaN: no taps
    acc[j] = 0.0f;
    if (i < n_items && v0 + i % vg < V) {
      const int64_t at = (b * P + p0 + i / vg) * V + v0 + i % vg;
      y[j] = pos_y[at];
      x[j] = pos_x[at];
      if (isfinite(y[j])) {
        // clamped before the conversion; rows beyond the field add nothing
        const int r = static_cast<int>(fminf(fmaxf(floorf(y[j]), -8.0f),
                                             static_cast<float>(R) + 8.0f));
        lo = min(lo, r);
        hi = max(hi, r);
      }
    }
  }
  __syncthreads();
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&window[0], lo);
    atomicMax(&window[1], hi);
  }
  __syncthreads();
  const int row_lo = max(window[0] + K::kFirst, 0);
  const int row_hi = min(window[1] + K::kFirst + K::kN - 1, R - 1);

  for (int k = row_lo / rw; row_lo <= row_hi && k <= row_hi / rw; ++k) {
    const int r0 = k * rw;
    const int rows = min(rw, R - r0);
    const int n_cells = rows * C;
    __syncthreads();  // every thread is done with the previous chunk
    const T* src = field + (b * R + r0) * static_cast<int64_t>(C) * V + v0;
    for (int i = threadIdx.x; i < n_cells * vg; i += kThreads) {
      const int cell = i / vg, ch = i % vg;
      tile[i] = v0 + ch < V ? src[static_cast<int64_t>(cell) * V + ch] : from_float<T>(0.0f);
    }
    __syncthreads();

    const float first = static_cast<float>(r0);
    const float last = static_cast<float>(r0 + rows - 1);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const float fy = floorf(y[j]);
      // no tap row in this chunk (NaN and inf too)
      if (!(fy + static_cast<float>(K::kFirst) <= last &&
            fy + static_cast<float>(K::kFirst + K::kN - 1) >= first))
        continue;
      const int ch = (threadIdx.x + j * kThreads) % vg;
      const float fx = floorf(x[j]);
      float wy[K::kN], wx[K::kN];
      K::weights(y[j] - fy, wy);
      K::weights(x[j] - fx, wx);
#pragma unroll
      for (int ty = 0; ty < K::kN; ++ty) {
        const float rf = fy + static_cast<float>(K::kFirst + ty);
        if (!(rf >= first && rf <= last)) continue;  // another chunk's row
        const int row = (static_cast<int>(rf) - r0) * C;
        float row_acc = 0.0f;
#pragma unroll
        for (int tx = 0; tx < K::kN; ++tx) {
          const float cf = fx + static_cast<float>(K::kFirst + tx);
          if (!(cf >= 0.0f && cf <= static_cast<float>(C - 1))) continue;
          row_acc += wx[tx] * to_float(tile[(row + static_cast<int>(cf)) * vg + ch]);
        }
        acc[j] += wy[ty] * row_acc;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < n_items && v0 + i % vg < V)
      out[(b * P + p0 + i / vg) * V + v0 + i % vg] = from_float<T>(acc[j]);
  }
}

template <bool kBicubic, typename T>
int launch(const void* field, const float* py, const float* px, void* out, int64_t B,
           int64_t P, int R, int C, int V, int rw, cudaStream_t stream) {
  auto kernel = interp_chunk_fwd_kernel<kBicubic, T>;
  int device = 0, max_smem = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t avail = max_smem - static_cast<int64_t>(attr.sharedSizeBytes);
  const int64_t cell_bytes = static_cast<int64_t>(std::min(rw, R)) * C * sizeof(T);
  int vg = std::min(16 / static_cast<int>(sizeof(T)), V);
  while (vg > 1 && cell_bytes * vg > avail) --vg;
  const int64_t smem = cell_bytes * vg;
  if (smem > avail) return cudaErrorInvalidValue;  // one channel's chunk does not fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (P + kTile / vg - 1) / (kTile / vg);
  const int64_t n_groups = (V + vg - 1) / vg;
  const int64_t blocks = B * n_groups * n_tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(field), py, px, static_cast<T*>(out), P, R, C, V, rw,
      static_cast<int>(n_tiles), static_cast<int>(n_groups), vg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 bilinear, 1 bicubic.  dtype: 0 float32, 1 bfloat16 (field and out).
// rw > 0 rows a chunk.  Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue where one channel's chunk does not fit in shared
// memory.
extern "C" int paradis_interp_chunk_fwd(const void* field, const void* pos_y,
                                        const void* pos_x, void* out, long long B, long long P,
                                        int R, int C, int V, int rw, int mode, int dtype,
                                        void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0 || rw <= 0) return cudaErrorInvalidValue;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0) return launch<true, float>(field, py, px, out, B, P, R, C, V, rw, s);
  if (mode == 1 && dtype == 1) return launch<true, __nv_bfloat16>(field, py, px, out, B, P, R, C, V, rw, s);
  if (mode == 0 && dtype == 0) return launch<false, float>(field, py, px, out, B, P, R, C, V, rw, s);
  if (mode == 0 && dtype == 1) return launch<false, __nv_bfloat16>(field, py, px, out, B, P, R, C, V, rw, s);
  return cudaErrorInvalidValue;
}

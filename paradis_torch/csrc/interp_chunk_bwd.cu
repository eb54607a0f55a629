// Backward of the row-chunked gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_bwd_kernel_chunked,
// which contracts dense weight and derivative matrices over each static
// rw-row chunk of the zero-padded field that meets its block's row range and
// adds each chunk's d_field rows into a d_field block revisited across the
// position blocks.  This kernel walks the same data-chosen row window as
// interp_chunk_fwd.cu over the unpadded field and computes, per position,
//
//   d_field[b,r,c,v] += g * K(py - r) * K(px - c)
//   d_py[b,p,v]       = g * sum_r K'(py - r) * sum_c K(px - c)  * f[b,r,c,v]
//   d_px[b,p,v]       = g * sum_r K(py - r)  * sum_c K'(px - c) * f[b,r,c,v]
//
// K' follows paradis_tpu/ops/interp.py:_dense_kernel_derivative (zero at the
// bilinear kinks), as in interp_bwd.cu.  A tap outside [0,R) x [0,C)
// contributes to none of the three outputs and a non-finite position has no
// taps.  g is read in its own type (fp32 or bf16).  d_field is a float32
// [B,R,C,V] buffer the caller zeroes (and casts to bf16 after, for a bf16
// field); d_py and d_px are float32 [B,P,V].
//
// Design: the blocks, tiles and row window of the forward.  For each chunk
// that meets the window the block stages the chunk's field rows in dynamic
// shared memory and beside them a zeroed float32 accumulator of the chunk's
// d_field; each item's taps in the chunk read the staged field and add
// g*K*K into the accumulator with shared-memory atomics.  When the chunk is
// done, every cell of the accumulator that is not zero is added into d_field
// with one float32 atomicAdd (tiles whose windows meet one chunk each add
// theirs).  d_py and d_px accumulate in registers across the chunks and are
// written once.  vg is the largest channel count whose field chunk and
// accumulator fit the card's opt-in shared memory (rw = 32 at 1.40625 deg:
// 3 fp32 or 4 bf16 channels of 32 x 260 cells, 200 KB).
//
// Float order: d_py and d_px sum over a tap row's columns first, then over
// the rows in increasing order, carried across chunks: the order of
// interp_bwd.cu, so they are bitwise equal to it.  d_field is not bitwise
// reproducible: the shared and global float32 atomics land in an order that
// changes from run to run (a bf16 d_field may round to the neighbouring bf16
// value), as in interp_bwd.cu.
//
// What bounds it: memory.  At 1.40625 deg (fp32) a launch must read the field
// (105 MB), both positions and g (302 MB) and write d_field (105 MB) and
// d_py, d_px (201 MB): ~713 MB, 0.21 ms at 3.35 TB/s.  The staging reads each
// chunk once per tile whose window meets it, through L2.

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

// Bytes of the staged field, rounded up so the float32 accumulator after it
// is 16-byte aligned.
__host__ __device__ __forceinline__ int64_t field_bytes(int64_t n, int64_t elem) {
  return (n * elem + 15) / 16 * 16;
}

template <bool kBicubic, typename T, typename TG>
__global__ void __launch_bounds__(kThreads)
interp_chunk_bwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                        const float* __restrict__ pos_x, const TG* __restrict__ grad,
                        float* __restrict__ d_field, float* __restrict__ d_py,
                        float* __restrict__ d_px, int64_t P, int R, int C, int V, int rw,
                        int n_tiles, int n_groups, int vg) {
  using K = Taps<kBicubic>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t max_cells = static_cast<int64_t>(min(rw, R)) * C * vg;
  T* tile = reinterpret_cast<T*>(smem);                                         // [rows, C, vg]
  float* acc_tile = reinterpret_cast<float*>(smem + field_bytes(max_cells, sizeof(T)));
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

  float y[kItems], x[kItems], g[kItems], acc_y[kItems], acc_x[kItems];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = threadIdx.x + j * kThreads;
    y[j] = x[j] = __int_as_float(0x7fc00000);  // NaN: no taps
    g[j] = acc_y[j] = acc_x[j] = 0.0f;
    if (i < n_items && v0 + i % vg < V) {
      const int64_t at = (b * P + p0 + i / vg) * V + v0 + i % vg;
      y[j] = pos_y[at];
      x[j] = pos_x[at];
      g[j] = to_float(grad[at]);
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
    const int64_t base = (b * R + r0) * static_cast<int64_t>(C) * V + v0;
    __syncthreads();  // every thread is done with the previous chunk and its flush
    const T* src = field + base;
    for (int i = threadIdx.x; i < n_cells * vg; i += kThreads) {
      const int cell = i / vg, ch = i % vg;
      tile[i] = v0 + ch < V ? src[static_cast<int64_t>(cell) * V + ch] : from_float<T>(0.0f);
      acc_tile[i] = 0.0f;
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
      float wy[K::kN], wx[K::kN], dwy[K::kN], dwx[K::kN];
      K::weights(y[j] - fy, wy, dwy);
      K::weights(x[j] - fx, wx, dwx);
#pragma unroll
      for (int ty = 0; ty < K::kN; ++ty) {
        const float rf = fy + static_cast<float>(K::kFirst + ty);
        if (!(rf >= first && rf <= last)) continue;  // another chunk's row
        const int row = (static_cast<int>(rf) - r0) * C;
        const float g_row = g[j] * wy[ty];
        float row_w = 0.0f, row_dw = 0.0f;
#pragma unroll
        for (int tx = 0; tx < K::kN; ++tx) {
          const float cf = fx + static_cast<float>(K::kFirst + tx);
          if (!(cf >= 0.0f && cf <= static_cast<float>(C - 1))) continue;
          const int s = (row + static_cast<int>(cf)) * vg + ch;
          const float f = to_float(tile[s]);
          row_w += wx[tx] * f;
          row_dw += dwx[tx] * f;
          atomicAdd(acc_tile + s, g_row * wx[tx]);
        }
        acc_y[j] += dwy[ty] * row_w;
        acc_x[j] += wy[ty] * row_dw;
      }
    }
    __syncthreads();

    float* dst = d_field + base;
    for (int i = threadIdx.x; i < n_cells * vg; i += kThreads) {
      const int cell = i / vg, ch = i % vg;
      const float val = acc_tile[i];
      if (v0 + ch < V && val != 0.0f) atomicAdd(dst + static_cast<int64_t>(cell) * V + ch, val);
    }
  }

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < n_items && v0 + i % vg < V) {
      const int64_t at = (b * P + p0 + i / vg) * V + v0 + i % vg;
      d_py[at] = g[j] * acc_y[j];
      d_px[at] = g[j] * acc_x[j];
    }
  }
}

template <bool kBicubic, typename T, typename TG>
int launch(const void* field, const float* py, const float* px, const void* grad,
           float* d_field, float* d_py, float* d_px, int64_t B, int64_t P, int R, int C,
           int V, int rw, cudaStream_t stream) {
  auto kernel = interp_chunk_bwd_kernel<kBicubic, T, TG>;
  int device = 0, max_smem = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t avail = max_smem - static_cast<int64_t>(attr.sharedSizeBytes);
  const int64_t n_cells = static_cast<int64_t>(std::min(rw, R)) * C;
  auto smem_of = [&](int vg) {
    return field_bytes(n_cells * vg, sizeof(T)) + n_cells * vg * 4;
  };
  int vg = std::min(16 / static_cast<int>(sizeof(T)), V);
  while (vg > 1 && smem_of(vg) > avail) --vg;
  const int64_t smem = smem_of(vg);
  if (smem > avail) return cudaErrorInvalidValue;  // one channel's chunk does not fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (P + kTile / vg - 1) / (kTile / vg);
  const int64_t n_groups = (V + vg - 1) / vg;
  const int64_t blocks = B * n_groups * n_tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(field), py, px, static_cast<const TG*>(grad), d_field, d_py, d_px,
      P, R, C, V, rw, static_cast<int>(n_tiles), static_cast<int>(n_groups), vg);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBicubic, typename T>
int dispatch_grad(const void* field, const float* py, const float* px, const void* grad,
                  float* d_field, float* d_py, float* d_px, int64_t B, int64_t P, int R,
                  int C, int V, int rw, int grad_dtype, cudaStream_t s) {
  if (grad_dtype == 0)
    return launch<kBicubic, T, float>(field, py, px, grad, d_field, d_py, d_px, B, P, R, C,
                                      V, rw, s);
  if (grad_dtype == 1)
    return launch<kBicubic, T, __nv_bfloat16>(field, py, px, grad, d_field, d_py, d_px, B, P,
                                              R, C, V, rw, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 bilinear, 1 bicubic.  dtype (field), grad_dtype (g): 0 float32,
// 1 bfloat16.  d_field is float32 [B,R,C,V], zeroed by the caller; d_py and
// d_px are float32 [B,P,V].  rw > 0 rows a chunk.  Returns the CUDA error of
// the launch (0 on success); cudaErrorInvalidValue where one channel's chunk
// and its accumulator do not fit in shared memory.
extern "C" int paradis_interp_chunk_bwd(const void* field, const void* pos_y,
                                        const void* pos_x, const void* grad, void* d_field,
                                        void* d_py, void* d_px, long long B, long long P, int R,
                                        int C, int V, int rw, int mode, int dtype,
                                        int grad_dtype, void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0 || rw <= 0) return cudaErrorInvalidValue;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  float* df = static_cast<float*>(d_field);
  float* dy = static_cast<float*>(d_py);
  float* dx = static_cast<float*>(d_px);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0)
    return dispatch_grad<true, float>(field, py, px, grad, df, dy, dx, B, P, R, C, V, rw, grad_dtype, s);
  if (mode == 1 && dtype == 1)
    return dispatch_grad<true, __nv_bfloat16>(field, py, px, grad, df, dy, dx, B, P, R, C, V, rw, grad_dtype, s);
  if (mode == 0 && dtype == 0)
    return dispatch_grad<false, float>(field, py, px, grad, df, dy, dx, B, P, R, C, V, rw, grad_dtype, s);
  if (mode == 0 && dtype == 1)
    return dispatch_grad<false, __nv_bfloat16>(field, py, px, grad, df, dy, dx, B, P, R, C, V, rw, grad_dtype, s);
  return cudaErrorInvalidValue;
}

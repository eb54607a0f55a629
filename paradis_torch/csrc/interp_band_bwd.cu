// Backward of the row-banded gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_bwd_kernel_banded.
// That kernel reads the banded field copy [B,V,n_bands,band_rows,C], writes a
// per-band d_field [B,V,n_bands,band_rows,C] in float32 (511 MB at 1.40625
// deg) and leaves the overlap-add of the bands into [B,V,R,C] to XLA.  This
// kernel takes the unbanded field in place and the band plan of
// interp_band_fwd.cu, and computes for the positions of each band, over the
// band's rows only,
//
//   d_field[b,r,c,v] += g * K(py - r) * K(px - c)
//   d_py[b,p,v]       = g * sum_r K'(py - r) * sum_c K(px - c)  * f[b,r,c,v]
//   d_px[b,p,v]       = g * sum_r K(py - r)  * sum_c K'(px - c) * f[b,r,c,v]
//
// K' follows paradis_tpu/ops/interp.py:_dense_kernel_derivative (zero at the
// bilinear kinks), as in interp_bwd.cu.  A tap outside the position's band or
// outside [0,C) contributes to none of the three outputs, and a position that
// is not finite has no taps.  g is read in its own type (fp32 or bf16); all
// sums are float32, over a tap row's columns first, then over rows.  d_field
// is a float32 [B,R,C,V] buffer the caller zeroes (and casts to bf16 after,
// for a bf16 field); d_py and d_px are float32 [B,P,V].
//
// Design: one block per (b, band, group of vg channels), as in the forward.
// The block stages its band's field rows in dynamic shared memory, and beside
// them a float32 accumulator of the band's d_field.  Each output's taps read
// the staged field and add g*K*K into the accumulator with shared-memory
// atomics; when the band is done, every cell of the accumulator that is not
// zero is added into d_field with one float32 atomicAdd (bands overlap, so a
// row takes the sums of up to band_rows / rpb bands; under the clamp most of
// a band's rows get no tap, and their zero cells cost no atomic).  vg is the
// largest channel count whose field and accumulator fit the card's opt-in
// shared memory (at 1.40625 deg: 2 fp32 or 3 bf16 channels of 40 x 260
// cells, 166 KB / 187 KB).
//
// Determinism: d_py and d_px are bitwise reproducible (one thread each, fixed
// order).  d_field is not: the shared and global float32 atomics land in an
// order that changes from run to run, so d_field varies in its last bits (and
// a bf16 d_field may round to the neighbouring bf16 value), as in interp_bwd.cu.
//
// What bounds it: memory.  At 1.40625 deg (fp32) a launch must read the field
// (105 MB), both positions and g (302 MB) and write d_field (105 MB) and
// d_py, d_px (201 MB): ~713 MB, 0.21 ms at 3.35 TB/s.  The staging reads each
// field row for every band that covers it, and runs of 8 or 6 bytes a cell use
// a quarter of a sector at a time, through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "interp_taps.cuh"

namespace {

using namespace paradis_interp;

constexpr int kThreads = 512;

struct Plan {
  int rpb, band_rows, halo_lo, pad;
};

// Bytes of the staged field, rounded up so the float32 accumulator after it
// is 16-byte aligned.
__host__ __device__ __forceinline__ int64_t field_bytes(int64_t n, int64_t elem) {
  return (n * elem + 15) / 16 * 16;
}

template <bool kBicubic, typename T, typename TG>
__global__ void __launch_bounds__(kThreads)
interp_band_bwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                       const float* __restrict__ pos_x, const TG* __restrict__ grad,
                       float* __restrict__ d_field, float* __restrict__ d_py,
                       float* __restrict__ d_px, int64_t P, int R, int C, int V, int W,
                       int n_bands, int n_groups, int vg, Plan plan) {
  using K = Taps<kBicubic>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_cells = plan.band_rows * C;
  T* tile = reinterpret_cast<T*>(smem);                     // [band_rows, C, vg]
  float* acc_tile = reinterpret_cast<float*>(               // [band_rows, C, vg]
      smem + field_bytes(static_cast<int64_t>(n_cells) * vg, sizeof(T)));

  const int band = blockIdx.x % n_bands;
  const int group = (blockIdx.x / n_bands) % n_groups;
  const int64_t b = blockIdx.x / (n_bands * n_groups);
  const int v0 = group * vg;
  const int r0 = min(max(band * plan.rpb + plan.pad - plan.halo_lo, 0), R - plan.band_rows);
  const int64_t base = (b * R + r0) * static_cast<int64_t>(C) * V + v0;

  const T* src = field + base;
  for (int i = threadIdx.x; i < n_cells * vg; i += blockDim.x) {
    const int cell = i / vg, ch = i % vg;
    tile[i] = v0 + ch < V ? src[static_cast<int64_t>(cell) * V + ch] : from_float<T>(0.0f);
    acc_tile[i] = 0.0f;
  }
  __syncthreads();

  const float lo = static_cast<float>(r0);
  const float hi = static_cast<float>(r0 + plan.band_rows - 1);
  const int n_pos = plan.rpb * W;
  const int64_t first = (b * P + static_cast<int64_t>(band) * n_pos) * V;
  for (int i = threadIdx.x; i < n_pos * vg; i += blockDim.x) {
    const int p = i / vg, ch = i % vg;
    if (v0 + ch >= V) continue;
    const int64_t at = first + static_cast<int64_t>(p) * V + v0 + ch;
    const float y = pos_y[at];
    const float x = pos_x[at];
    const float g = to_float(grad[at]);
    const float fy = floorf(y);
    const float fx = floorf(x);
    float wy[K::kN], wx[K::kN], dwy[K::kN], dwx[K::kN];
    K::weights(y - fy, wy, dwy);
    K::weights(x - fx, wx, dwx);

    float acc_y = 0.0f, acc_x = 0.0f;
#pragma unroll
    for (int ty = 0; ty < K::kN; ++ty) {
      const float rf = fy + static_cast<float>(K::kFirst + ty);
      if (!(rf >= lo && rf <= hi)) continue;  // outside the band; NaN too
      const int row = (static_cast<int>(rf) - r0) * C;
      const float g_row = g * wy[ty];
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
      acc_y += dwy[ty] * row_w;
      acc_x += wy[ty] * row_dw;
    }
    d_py[at] = g * acc_y;
    d_px[at] = g * acc_x;
  }
  __syncthreads();

  float* dst = d_field + base;
  for (int i = threadIdx.x; i < n_cells * vg; i += blockDim.x) {
    const int cell = i / vg, ch = i % vg;
    const float val = acc_tile[i];
    if (v0 + ch < V && val != 0.0f) atomicAdd(dst + static_cast<int64_t>(cell) * V + ch, val);
  }
}

template <bool kBicubic, typename T, typename TG>
int launch(const void* field, const float* py, const float* px, const void* grad,
           float* d_field, float* d_py, float* d_px, int64_t B, int64_t P, int R, int C,
           int V, int W, Plan plan, cudaStream_t stream) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_cells = static_cast<int64_t>(plan.band_rows) * C;
  auto smem_of = [&](int vg) {
    return field_bytes(n_cells * vg, sizeof(T)) + n_cells * vg * 4;
  };
  int vg = 16 / static_cast<int>(sizeof(T));
  while (vg > 1 && smem_of(vg) > max_smem) --vg;
  const int64_t smem = smem_of(vg);
  if (smem > max_smem) return cudaErrorInvalidValue;  // one channel's band does not fit
  auto kernel = interp_band_bwd_kernel<kBicubic, T, TG>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bands = static_cast<int>(P / W) / plan.rpb;
  const int n_groups = (V + vg - 1) / vg;
  const int64_t blocks = B * n_bands * n_groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(field), py, px, static_cast<const TG*>(grad), d_field, d_py, d_px,
      P, R, C, V, W, n_bands, n_groups, vg, plan);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBicubic, typename T>
int dispatch_grad(const void* field, const float* py, const float* px, const void* grad,
                  float* d_field, float* d_py, float* d_px, int64_t B, int64_t P, int R,
                  int C, int V, int W, Plan plan, int grad_dtype, cudaStream_t s) {
  if (grad_dtype == 0)
    return launch<kBicubic, T, float>(field, py, px, grad, d_field, d_py, d_px, B, P, R, C,
                                      V, W, plan, s);
  if (grad_dtype == 1)
    return launch<kBicubic, T, __nv_bfloat16>(field, py, px, grad, d_field, d_py, d_px, B, P,
                                              R, C, V, W, plan, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 bilinear, 1 bicubic.  dtype (field), grad_dtype (g): 0 float32,
// 1 bfloat16.  d_field is float32 [B,R,C,V], zeroed by the caller; d_py and
// d_px are float32 [B,P,V].  P = H*W with H a multiple of rpb; 0 < band_rows
// <= R.  Returns the CUDA error of the launch (0 on success).
extern "C" int paradis_interp_band_bwd(const void* field, const void* pos_y,
                                       const void* pos_x, const void* grad, void* d_field,
                                       void* d_py, void* d_px, long long B, long long P, int R,
                                       int C, int V, int W, int rpb, int band_rows,
                                       int halo_lo, int pad, int mode, int dtype,
                                       int grad_dtype, void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0 || W <= 0 || rpb <= 0 ||
      band_rows <= 0 || band_rows > R || P % W != 0 || (P / W) % rpb != 0)
    return cudaErrorInvalidValue;
  const Plan plan{rpb, band_rows, halo_lo, pad};
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  float* df = static_cast<float*>(d_field);
  float* dy = static_cast<float*>(d_py);
  float* dx = static_cast<float*>(d_px);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0)
    return dispatch_grad<true, float>(field, py, px, grad, df, dy, dx, B, P, R, C, V, W, plan, grad_dtype, s);
  if (mode == 1 && dtype == 1)
    return dispatch_grad<true, __nv_bfloat16>(field, py, px, grad, df, dy, dx, B, P, R, C, V, W, plan, grad_dtype, s);
  if (mode == 0 && dtype == 0)
    return dispatch_grad<false, float>(field, py, px, grad, df, dy, dx, B, P, R, C, V, W, plan, grad_dtype, s);
  if (mode == 0 && dtype == 1)
    return dispatch_grad<false, __nv_bfloat16>(field, py, px, grad, df, dy, dx, B, P, R, C, V, W, plan, grad_dtype, s);
  return cudaErrorInvalidValue;
}

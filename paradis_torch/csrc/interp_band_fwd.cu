// Row-banded forward gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_fwd_kernel_banded.
// That kernel receives a copy of the field cut into overlapping bands,
// [B,V,n_bands,band_rows,C], and contracts dense weight matrices over the
// band's rows on the MXU.  This kernel takes the unbanded field in place and
// the band plan (rpb, band_rows, halo_lo, pad; paradis_torch/ops/interp_band.py):
//
//   band b covers the positions of arrival rows [b*rpb, (b+1)*rpb) and the
//   padded field rows [r0, r0 + band_rows), r0 = clip(b*rpb + pad - halo_lo,
//   0, R - band_rows);
//   out[b,p,v] = sum_{r in band} K(py - r) * sum_c K(px - c) * f[b,r,c,v]
//
// A tap outside the position's band or outside [0,C) is dropped, and a
// position that is not finite has no taps, as in the Pallas kernel.  Under
// the caller's clamp (|py - arrival row - pad| <= max_dy_pix) no tap lies
// outside the band, so the result equals interp_fwd.cu's on the same
// clamped positions.  Sums are float32, over a tap row's columns first and
// then over rows (the order of interp_plain); the output is written in the
// field's type.
//
// Design: one block per (b, band, group of vg channels).  The block stages
// its band's rows of the field, band_rows x C cells of vg channels, in
// dynamic shared memory, then computes the rpb*W*vg outputs of its band from
// there: each of the 16 (bicubic) or 4 (bilinear) taps of an output is a
// shared-memory read, not a load through L2.  vg is the largest count of
// channels, at most 16 bytes a cell, whose band fits the card's opt-in shared
// memory (at 1.40625 deg: 40 x 260 cells, 4 fp32 or 8 bf16 channels, 166 KB).
// Threads walk (position, channel) with the channel fastest, so each staging
// load and each position load or output store of a thread group is one
// contiguous run of vg channels.  The blocks of one channel group's bands are
// adjacent in launch order, so their overlapping rows are served from L2.
//
// What bounds it: memory.  At 1.40625 deg (field 1x132x260x768, P = 32768,
// V = 768, fp32) a launch must read the field (105 MB) and both positions
// (201 MB) and write the output (101 MB): 0.12 ms at 3.35 TB/s.  Staging
// reads each field row once for each band that covers it (band_rows / rpb =
// 5 times at 1.40625 deg) through L2, and a 16-byte run of channels uses half
// a 32-byte sector at a time: that traffic, and the serial stage-then-compute
// of one block per SM, keep it above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "interp_taps.cuh"

namespace {

using namespace paradis_interp;

constexpr int kThreads = 1024;

struct Plan {
  int rpb, band_rows, halo_lo, pad;
};

template <bool kBicubic, typename T>
__global__ void __launch_bounds__(kThreads)
interp_band_fwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                       const float* __restrict__ pos_x, T* __restrict__ out, int64_t P,
                       int R, int C, int V, int W, int n_bands, int n_groups, int vg,
                       Plan plan) {
  using K = Taps<kBicubic>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [band_rows, C, vg]

  const int band = blockIdx.x % n_bands;
  const int group = (blockIdx.x / n_bands) % n_groups;
  const int64_t b = blockIdx.x / (n_bands * n_groups);
  const int v0 = group * vg;
  const int r0 = min(max(band * plan.rpb + plan.pad - plan.halo_lo, 0), R - plan.band_rows);
  const int n_cells = plan.band_rows * C;

  const T* src = field + (b * R + r0) * static_cast<int64_t>(C) * V + v0;
  for (int i = threadIdx.x; i < n_cells * vg; i += blockDim.x) {
    const int cell = i / vg, ch = i % vg;
    tile[i] = v0 + ch < V ? src[static_cast<int64_t>(cell) * V + ch] : from_float<T>(0.0f);
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
    const float fy = floorf(y);
    const float fx = floorf(x);
    float wy[K::kN], wx[K::kN];
    K::weights(y - fy, wy);
    K::weights(x - fx, wx);

    float acc = 0.0f;
#pragma unroll
    for (int ty = 0; ty < K::kN; ++ty) {
      const float rf = fy + static_cast<float>(K::kFirst + ty);
      if (!(rf >= lo && rf <= hi)) continue;  // outside the band; NaN too
      const int row = (static_cast<int>(rf) - r0) * C;
      float row_acc = 0.0f;
#pragma unroll
      for (int tx = 0; tx < K::kN; ++tx) {
        const float cf = fx + static_cast<float>(K::kFirst + tx);
        if (!(cf >= 0.0f && cf <= static_cast<float>(C - 1))) continue;
        row_acc += wx[tx] * to_float(tile[(row + static_cast<int>(cf)) * vg + ch]);
      }
      acc += wy[ty] * row_acc;
    }
    out[at] = from_float<T>(acc);
  }
}

template <bool kBicubic, typename T>
int launch(const void* field, const float* py, const float* px, void* out, int64_t B,
           int64_t P, int R, int C, int V, int W, Plan plan, cudaStream_t stream) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cell_bytes = static_cast<int64_t>(plan.band_rows) * C * sizeof(T);
  int vg = 16 / static_cast<int>(sizeof(T));
  while (vg > 1 && cell_bytes * vg > max_smem) --vg;
  const int64_t smem = cell_bytes * vg;
  if (smem > max_smem) return cudaErrorInvalidValue;  // one channel's band does not fit
  auto kernel = interp_band_fwd_kernel<kBicubic, T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_bands = static_cast<int>(P / W) / plan.rpb;
  const int n_groups = (V + vg - 1) / vg;
  const int64_t blocks = B * n_bands * n_groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(field), py, px, static_cast<T*>(out), P, R, C, V, W, n_bands,
      n_groups, vg, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 bilinear, 1 bicubic.  dtype: 0 float32, 1 bfloat16 (field and out).
// P = H*W with H a multiple of rpb; 0 < band_rows <= R.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int paradis_interp_band_fwd(const void* field, const void* pos_y,
                                       const void* pos_x, void* out, long long B, long long P,
                                       int R, int C, int V, int W, int rpb, int band_rows,
                                       int halo_lo, int pad, int mode, int dtype,
                                       void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0 || W <= 0 || rpb <= 0 ||
      band_rows <= 0 || band_rows > R || P % W != 0 || (P / W) % rpb != 0)
    return cudaErrorInvalidValue;
  const Plan plan{rpb, band_rows, halo_lo, pad};
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0) return launch<true, float>(field, py, px, out, B, P, R, C, V, W, plan, s);
  if (mode == 1 && dtype == 1) return launch<true, __nv_bfloat16>(field, py, px, out, B, P, R, C, V, W, plan, s);
  if (mode == 0 && dtype == 0) return launch<false, float>(field, py, px, out, B, P, R, C, V, W, plan, s);
  if (mode == 0 && dtype == 1) return launch<false, __nv_bfloat16>(field, py, px, out, B, P, R, C, V, W, plan, s);
  return cudaErrorInvalidValue;
}

// Forward gather-interpolation at departure points, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_fwd_kernel, which
// generates dense separable weights K(pos - i) over every padded row and
// column and contracts them on the MXU.  On this card the direct form is
// cheaper: each output reads its 4x4 (bicubic) or 2x2 (bilinear) taps.
//
//   out[b,p,v] = sum_r K(py[b,p,v] - r) * sum_c K(px[b,p,v] - c) * f[b,r,c,v]
//
// Layouts are channels-last, as the port's tensors: field [B,R,C,V], positions
// and output [B,P,V] with P = H*W.  One thread computes one (b,p,v) output,
// v fastest, so the position loads, each tap load f[b,r,c,v] and the store
// coalesce across a warp.  Taps with r outside [0,R) or c outside [0,C) are
// dropped (contribute zero), as in the Pallas kernel, and a position that is
// not finite has no taps.  Weights come from floor(pos) (ATen cubic
// convolution, a = -0.75; or 1-t, t).  Sums are float32, over a tap row's
// columns first and then over rows; the output is written in the field's
// type.  The grid-stride loop masks the tail: B*P*V need not be a multiple of
// the block.
//
// What bounds it: memory.  At the 5.625 deg flagship shape (field 1x36x68x768,
// P = 2048, V = 768) one fp32 launch must read the field once (7.5 MB) and
// both position arrays (12.6 MB) and write the output (6.3 MB): ~26 MB, about
// 8 us at 3.35 TB/s; bf16 ~19.5 MB.  It does ~70 flops per output, ~0.1
// GFLOP per launch, far below the compute roof.  The field fits in the 50 MB
// L2, so the up to 16 re-reads of each field element by neighbouring
// positions are served from L2, not device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "interp_taps.cuh"

namespace {

using namespace paradis_interp;

constexpr int kThreads = 256;

template <bool kBicubic, typename T>
__global__ void __launch_bounds__(kThreads)
interp_fwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                  const float* __restrict__ pos_x, T* __restrict__ out,
                  int64_t total, int64_t P, int R, int C, int V) {
  using K = Taps<kBicubic>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t v = i % V;
    const int64_t b = i / (P * V);
    const float y = pos_y[i];
    const float x = pos_x[i];
    const float fy = floorf(y);
    const float fx = floorf(x);
    float wy[K::kN], wx[K::kN];
    K::weights(y - fy, wy);
    K::weights(x - fx, wx);
    const T* plane = field + b * R * static_cast<int64_t>(C) * V + v;

    float acc = 0.0f;
#pragma unroll
    for (int ty = 0; ty < K::kN; ++ty) {
      const float rf = fy + static_cast<float>(K::kFirst + ty);
      if (!(rf >= 0.0f && rf <= static_cast<float>(R - 1))) continue;  // NaN too
      const int64_t row = static_cast<int64_t>(rf) * C;
      float row_acc = 0.0f;
#pragma unroll
      for (int tx = 0; tx < K::kN; ++tx) {
        const float cf = fx + static_cast<float>(K::kFirst + tx);
        if (!(cf >= 0.0f && cf <= static_cast<float>(C - 1))) continue;
        const int64_t c = static_cast<int64_t>(cf);
        row_acc += wx[tx] * to_float(plane[(row + c) * V]);
      }
      acc += wy[ty] * row_acc;
    }
    out[i] = from_float<T>(acc);
  }
}

template <bool kBicubic, typename T>
void launch(const void* field, const float* py, const float* px, void* out,
            int64_t total, int64_t P, int R, int C, int V, cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  interp_fwd_kernel<kBicubic, T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(field), py, px, static_cast<T*>(out), total, P, R, C, V);
}

}  // namespace

// mode: 0 bilinear, 1 bicubic.  dtype: 0 float32, 1 bfloat16 (field and out).
// Returns the CUDA error of the launch (0 on success).
extern "C" int paradis_interp_fwd(const void* field, const void* pos_y, const void* pos_x,
                                  void* out, long long B, long long P, int R, int C, int V,
                                  int mode, int dtype, void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(B) * P * V;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0) launch<true, float>(field, py, px, out, total, P, R, C, V, s);
  else if (mode == 1 && dtype == 1) launch<true, __nv_bfloat16>(field, py, px, out, total, P, R, C, V, s);
  else if (mode == 0 && dtype == 0) launch<false, float>(field, py, px, out, total, P, R, C, V, s);
  else if (mode == 0 && dtype == 1) launch<false, __nv_bfloat16>(field, py, px, out, total, P, R, C, V, s);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

// Tap-weight generation alone, for Hopper (sm_90a): the weight phase of the
// gather-interpolation kernels, isolated for the interpolation microbenchmark
// (paradis_torch/tools/bench_interp.py).
//
// Replaces the TPU microbenchmark kernels genonly_kernel and bwd_gen_kernel
// of scripts/bench_interp.py, which build the dense positions-last weight
// matrices K(pos - i) over every padded column and row (_weights_T) and sum
// them, to time the VPU's share of the Pallas kernel apart from the MXU's.
// Per element of the positions:
//
//   gen:     out = sum_{c in [0,C)} K(px - c) + sum_{r in [0,R)} K(py - r)
//   bwd_gen: out = ((sum_c K(px - c) + sum_c K'(px - c)) + sum_r K(py - r))
//                  + sum_r K'(py - r)
//
// with the weights and K' of interp_taps.cuh, the code the gather kernels
// run (K' as paradis_tpu/ops/interp.py:_dense_kernel_derivative).  Only the
// 4 (bicubic) or 2 (bilinear) taps along each axis are non-zero; a tap
// outside [0,C) or [0,R) and a non-finite position contribute nothing, as the
// false rel comparisons of NaN do in _weights_T.  Sums are float32, in tap
// order along each axis.
//
// Design: one thread per (b,p,v) element of the channels-last positions
// [B,H,W,V] fp32, v fastest, a grid-stride loop over the tail; no field read.
//
// What bounds it: memory.  It reads 8 bytes and writes 4 per element: at the
// microbenchmark's shapes (1x32x64x768) 18.9 MB, 5.6 us at 3.35 TB/s; its
// ~60 (gen) or ~130 (bwd_gen) flops per element are ~0.2 GFLOP, 3 us at the
// fp32 rate.  Its time beside interp_fwd.cu's splits the gather kernel into
// weight arithmetic and memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "interp_taps.cuh"

namespace {

using namespace paradis_interp;

constexpr int kThreads = 256;

// The sums of K and, with kDerivative, K' over the taps of one axis that lie
// in [0, size).
template <bool kBicubic, bool kDerivative>
__device__ __forceinline__ void axis_sums(float pos, int size, float& s, float& ds) {
  using K = Taps<kBicubic>;
  const float f = floorf(pos);
  float w[K::kN], dw[K::kN];
  if constexpr (kDerivative) {
    K::weights(pos - f, w, dw);
  } else {
    K::weights(pos - f, w);
  }
  s = 0.0f;
  ds = 0.0f;
#pragma unroll
  for (int k = 0; k < K::kN; ++k) {
    const float idx = f + static_cast<float>(K::kFirst + k);
    if (!(idx >= 0.0f && idx <= static_cast<float>(size - 1))) continue;  // NaN too
    s += w[k];
    if constexpr (kDerivative) ds += dw[k];
  }
}

template <bool kBicubic, bool kDerivative>
__global__ void __launch_bounds__(kThreads)
interp_gen_kernel(const float* __restrict__ pos_y, const float* __restrict__ pos_x,
                  float* __restrict__ out, int64_t total, int R, int C) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    float sx, dsx, sy, dsy;
    axis_sums<kBicubic, kDerivative>(pos_x[i], C, sx, dsx);
    axis_sums<kBicubic, kDerivative>(pos_y[i], R, sy, dsy);
    if constexpr (kDerivative) {
      out[i] = ((sx + dsx) + sy) + dsy;
    } else {
      out[i] = sx + sy;
    }
  }
}

template <bool kDerivative>
int launch(const void* pos_y, const void* pos_x, void* out, long long total, int R, int C,
           int mode, void* stream) {
  if (total <= 0 || R <= 0 || C <= 0) return cudaErrorInvalidValue;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (mode == 1)
    interp_gen_kernel<true, kDerivative><<<grid, kThreads, 0, s>>>(py, px, o, total, R, C);
  else if (mode == 0)
    interp_gen_kernel<false, kDerivative><<<grid, kThreads, 0, s>>>(py, px, o, total, R, C);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Positions and out: float32, total elements each.  R, C: the support along
// y and x.  mode: 0 bilinear, 1 bicubic.  Return the CUDA error of the
// launch (0 on success).
extern "C" int paradis_interp_gen(const void* pos_y, const void* pos_x, void* out,
                                  long long total, int R, int C, int mode, void* stream) {
  return launch<false>(pos_y, pos_x, out, total, R, C, mode, stream);
}

extern "C" int paradis_interp_bwd_gen(const void* pos_y, const void* pos_x, void* out,
                                      long long total, int R, int C, int mode, void* stream) {
  return launch<true>(pos_y, pos_x, out, total, R, C, mode, stream);
}

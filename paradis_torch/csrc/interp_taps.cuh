// Shared by the interpolation kernels (interp_fwd.cu, interp_bwd.cu,
// interp_band_fwd.cu, interp_band_bwd.cu): element conversions and the
// separable tap weights.
//
// Taps<kBicubic> gives, for the fractional coordinate t = pos - floor(pos),
// the weights of the taps at offsets kFirst .. kFirst + kN - 1 from
// floor(pos): ATen's cubic convolution (a = -0.75, 4 taps) or bilinear
// (1 - t, t).  The derivative K'(d) at d = t - offset follows
// paradis_tpu/ops/interp.py:_dense_kernel_derivative: sign(0) = 0 and the
// open support |d| < 1 make it zero at the bilinear kinks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paradis_interp {

constexpr float kCubicA = -0.75f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sign_of(float d) {
  return static_cast<float>((d > 0.0f) - (d < 0.0f));
}

template <bool kBicubic> struct Taps;

template <> struct Taps<true> {
  static constexpr int kN = 4;
  static constexpr int kFirst = -1;
  __device__ __forceinline__ static void weights(float t, float w[4]) {
    const float a = kCubicA;
    // far(x) for 1 < |x| < 2, near(x) for |x| <= 1 (ATen's cubic convolution)
    float x = t + 1.0f;
    w[0] = ((a * x - 5.0f * a) * x + 8.0f * a) * x - 4.0f * a;
    x = t;
    w[1] = ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
    x = 1.0f - t;
    w[2] = ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
    x = 2.0f - t;
    w[3] = ((a * x - 5.0f * a) * x + 8.0f * a) * x - 4.0f * a;
  }
  __device__ __forceinline__ static void weights(float t, float w[4], float dw[4]) {
    weights(t, w);
    const float a = kCubicA;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dist = t - static_cast<float>(kFirst + k);
      const float d = fabsf(dist);
      const float near = (3.0f * (a + 2.0f) * d - 2.0f * (a + 3.0f)) * d;
      const float far = (3.0f * a * d - 10.0f * a) * d + 8.0f * a;
      dw[k] = sign_of(dist) * (d <= 1.0f ? near : (d < 2.0f ? far : 0.0f));
    }
  }
};

template <> struct Taps<false> {
  static constexpr int kN = 2;
  static constexpr int kFirst = 0;
  __device__ __forceinline__ static void weights(float t, float w[2]) {
    w[0] = 1.0f - t;
    w[1] = t;
  }
  __device__ __forceinline__ static void weights(float t, float w[2], float dw[2]) {
    weights(t, w);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float dist = t - static_cast<float>(k);
      dw[k] = fabsf(dist) < 1.0f ? -sign_of(dist) : 0.0f;
    }
  }
};

}  // namespace paradis_interp

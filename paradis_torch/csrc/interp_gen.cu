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
// K is ATen's cubic convolution (a = -0.75) or bilinear, K' follows
// paradis_tpu/ops/interp.py:_dense_kernel_derivative (sign(0) = 0, open
// support at the bilinear kinks).  Only the 4 (bicubic) or 2 (bilinear) taps
// along each axis are non-zero; a tap outside [0,C) or [0,R) and a
// non-finite position contribute nothing, as the false rel comparisons of
// NaN do in _weights_T.  Sums are float32, in tap order along each axis.
// Every tap's K and K' is evaluated: an interior position's sums are not
// replaced by their closed forms (sum K = 1, sum K' = 0), since this kernel
// exists to time the weight arithmetic.
//
// What bounded the first design: the issue slots, not the bytes (one thread
// an element, the piecewise K' of interp_taps.cuh evaluated for any distance
// with fabsf, sign and two selects a tap, a float add, two compares and a
// predicated add a tap for the support): 214 instructions an element
// (cuobjdump -sass), 15.0 us against the 5.63 us that its 12 bytes an element
// (18.9 MB at the microbenchmark's 1x32x64x768) take at 3.35 TB/s.
//
// Design (the tap-specialised weights are local to this file; the gather
// kernels keep interp_taps.cuh):
// - For t = pos - floor(pos) in [0,1) each tap lies on a known lobe with a
//   known sign, so each K' is one polynomial in t (two FMAs), and the
//   weights share t^2, (t-1) and (t-1)^2 (the far lobe factors as
//   a (x-1)(x-2)^2).
// - The support: one test per position and axis whether all its taps lie
//   inside, voted over the warp; a warp whose positions all pass sums its
//   taps without masks, any other evaluates every tap's mask.  The two paths
//   give the same bits.
// - Four elements a thread through 16-byte loads and stores, a grid of as
//   many blocks as fit on the card at once striding over the elements; a
//   scalar loop where a pointer is not 16-byte aligned, and for the
//   total % 4 elements after the last whole four.
//
// What bounds it now (bicubic, from cuobjdump -sass of the loop bodies):
// bwd_gen 86.75 instructions an element on the masked path, 65.5 unmasked,
// 95 on the scalar route (gen 61.0 / 41.75), below the ~115 at which the
// bytes would bound it again.  Reached on an H100 80GB HBM3 at 700 W, at the
// microbenchmark's shapes: bwd_gen 0.0073-0.0075 ms on positions spread over
// and beyond the grid (the masked path), 0.0061 on the microbenchmark's
// in-field ones; gen 0.0061-0.0062 / 0.0049.  Timed back to back, the 18.9
// MB stay in the 50 MB L2, so the HBM bound does not hold these times; the
// masked path's issue and the warp vote are what is left.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kA = -0.75f;  // ATen's cubic convolution constant (interp_taps.cuh kCubicA)

// The weights w[k] = K(t - kFirst - k) and derivatives dw[k] = K'(t - kFirst
// - k) of the taps at kFirst + k from floor(pos), for t in [0, 1).
template <bool kBicubic> struct AxisTaps;

template <> struct AxisTaps<true> {
  static constexpr int kN = 4;
  static constexpr int kFirst = -1;
  __device__ __forceinline__ static void weights(float t, float w[4]) {
    const float tm1 = t - 1.0f;
    const float t2 = t * t;
    const float tm1sq = tm1 * tm1;
    w[0] = kA * t * tm1sq;                                      // far(1 + t)
    w[1] = ((kA + 2.0f) * t - (kA + 3.0f)) * t2 + 1.0f;         // near(t)
    w[2] = (-(kA + 2.0f) * tm1 - (kA + 3.0f)) * tm1sq + 1.0f;   // near(1 - t)
    w[3] = -kA * t2 * tm1;                                      // far(2 - t)
  }
  // far'(d) = a (d - 2)(3d - 4) on 1 < |d| < 2, near'(d) = 3(a+2) d^2 -
  // 2(a+3) d on |d| <= 1, times sign(d): taps 0 and 1 have d >= 0, taps 2
  // and 3 d < 0.  Both lobes meet at the joins (far'(1) = near'(1) = a,
  // far'(2) = 0), so the polynomials hold at t = 0 too.
  __device__ __forceinline__ static void derivatives(float t, float dw[4]) {
    dw[0] = (3.0f * kA * t - 4.0f * kA) * t + kA;                          //  far'(1 + t)
    dw[1] = (3.0f * (kA + 2.0f) * t - 2.0f * (kA + 3.0f)) * t;             //  near'(t)
    dw[2] = (-3.0f * (kA + 2.0f) * t + (4.0f * kA + 6.0f)) * t - kA;       // -near'(1 - t)
    dw[3] = (-3.0f * kA * t + 2.0f * kA) * t;                              // -far'(2 - t)
  }
};

template <> struct AxisTaps<false> {
  static constexpr int kN = 2;
  static constexpr int kFirst = 0;
  __device__ __forceinline__ static void weights(float t, float w[2]) {
    w[0] = 1.0f - t;
    w[1] = t;
  }
  // -sign(d) on |d| < 1: zero at the kinks, where t = 0
  __device__ __forceinline__ static void derivatives(float t, float dw[2]) {
    const bool off_kink = t > 0.0f;
    dw[0] = off_kink ? -1.0f : 0.0f;
    dw[1] = off_kink ? 1.0f : 0.0f;
  }
};

// Whether every tap of ``pos`` lies in [0, last]: floor(pos) >= -kFirst and
// floor(pos) + kFirst + kN - 1 <= last.  False for a non-finite position.
template <bool kBicubic>
__device__ __forceinline__ bool all_taps_inside(float pos, float last) {
  using K = AxisTaps<kBicubic>;
  return pos >= static_cast<float>(-K::kFirst) &&
         pos < last - static_cast<float>(K::kFirst + K::kN - 2);
}

// The sums of K and, with kDerivative, K' over the taps of one axis that lie
// in [0, last]; kMasked tests each tap, else all are taken to lie inside.
template <bool kBicubic, bool kDerivative, bool kMasked>
__device__ __forceinline__ void axis_sums(float pos, float last, float& s, float& ds) {
  using K = AxisTaps<kBicubic>;
  const float f = floorf(pos);
  const float t = pos - f;
  float w[K::kN], dw[K::kN];
  K::weights(t, w);
  if constexpr (kDerivative) K::derivatives(t, dw);
  s = 0.0f;
  ds = 0.0f;
#pragma unroll
  for (int k = 0; k < K::kN; ++k) {
    const float o = static_cast<float>(K::kFirst + k);
    if constexpr (kMasked) {
      if (!(f >= -o && f <= last - o)) continue;  // NaN too
    }
    s += w[k];
    if constexpr (kDerivative) ds += dw[k];
  }
}

template <bool kBicubic, bool kDerivative, bool kMasked>
__device__ __forceinline__ float element(float py, float px, float last_r, float last_c) {
  float sx, dsx, sy, dsy;
  axis_sums<kBicubic, kDerivative, kMasked>(px, last_c, sx, dsx);
  axis_sums<kBicubic, kDerivative, kMasked>(py, last_r, sy, dsy);
  if constexpr (kDerivative) return ((sx + dsx) + sy) + dsy;
  return sx + sy;
}

// kVec: the elements in whole fours through 16-byte loads and stores (every
// pointer 16-byte aligned), then the total % 4 after them one a thread;
// else every element one a thread.
template <bool kBicubic, bool kDerivative, bool kVec>
__global__ void __launch_bounds__(kThreads)
interp_gen_kernel(const float* __restrict__ pos_y, const float* __restrict__ pos_x,
                  float* __restrict__ out, int64_t total, int R, int C) {
  const float last_r = static_cast<float>(R - 1);
  const float last_c = static_cast<float>(C - 1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if constexpr (kVec) {
    const int64_t n4 = total >> 2;
    const float4* py4 = reinterpret_cast<const float4*>(pos_y);
    const float4* px4 = reinterpret_cast<const float4*>(pos_x);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int64_t i = first; i < n4; i += stride) {
      const float4 y4 = py4[i];
      const float4 x4 = px4[i];
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      bool inside = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        inside &= all_taps_inside<kBicubic>(y[j], last_r) &
                  all_taps_inside<kBicubic>(x[j], last_c);
      }
      float o[4];
      if (__all_sync(__activemask(), inside)) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = element<kBicubic, kDerivative, false>(y[j], x[j], last_r, last_c);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = element<kBicubic, kDerivative, true>(y[j], x[j], last_r, last_c);
      }
      out4[i] = make_float4(o[0], o[1], o[2], o[3]);
    }
    done = n4 << 2;
  }
  for (int64_t i = done + first; i < total; i += stride)
    out[i] = element<kBicubic, kDerivative, true>(pos_y[i], pos_x[i], last_r, last_c);
}

// Blocks of the kernel that fit on the current device at once (cached per
// device and instantiation), at least 1.
template <bool kBicubic, bool kDerivative, bool kVec>
int resident_blocks() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, interp_gen_kernel<kBicubic, kDerivative, kVec>, kThreads, 0);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < kMaxDevices) cached[dev] = blocks;
  return blocks;
}

template <bool kBicubic, bool kDerivative, bool kVec>
int launch_one(const float* py, const float* px, float* o, int64_t total, int R, int C,
               cudaStream_t s) {
  const int64_t work = kVec ? (total >> 2 > 0 ? total >> 2 : 1) : total;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int cap = resident_blocks<kBicubic, kDerivative, kVec>();
  if (blocks > cap) blocks = cap;  // the strided loop covers the rest
  interp_gen_kernel<kBicubic, kDerivative, kVec>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(py, px, o, total, R, C);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDerivative>
int launch(const void* pos_y, const void* pos_x, void* out, long long total, int R, int C,
           int mode, void* stream) {
  if (total <= 0 || R <= 0 || C <= 0) return cudaErrorInvalidValue;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(pos_y) | reinterpret_cast<uintptr_t>(pos_x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (mode == 1)
    return vec ? launch_one<true, kDerivative, true>(py, px, o, total, R, C, s)
               : launch_one<true, kDerivative, false>(py, px, o, total, R, C, s);
  if (mode == 0)
    return vec ? launch_one<false, kDerivative, true>(py, px, o, total, R, C, s)
               : launch_one<false, kDerivative, false>(py, px, o, total, R, C, s);
  return cudaErrorInvalidValue;
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

// Backward of the gather-interpolation at departure points, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_bwd_kernel, which
// regenerates dense separable weights K and K' over every padded row and
// column and contracts them on the MXU.  As in interp_fwd.cu, the direct form
// is cheaper here: each (b,p,v) reads its 4x4 (bicubic) or 2x2 (bilinear)
// taps once and computes, in one pass,
//
//   d_field[b,r,c,v] += g * K(py - r) * K(px - c)                 (atomicAdd)
//   d_py[b,p,v]       = g * sum_r K'(py - r) * sum_c K(px - c)  * f[b,r,c,v]
//   d_px[b,p,v]       = g * sum_r K(py - r)  * sum_c K'(px - c) * f[b,r,c,v]
//
// K' follows paradis_tpu/ops/interp.py:_dense_kernel_derivative: sign(0) = 0
// and the open support |d| < 1 make it zero at the bilinear kinks.  Layouts
// are channels-last: field and d_field [B,R,C,V], positions, g, d_py and d_px
// [B,P,V] with P = H*W.  One thread per (b,p,v), v fastest, so the loads, the
// stores and the atomics of a warp touch consecutive channels of one cell.
// Taps outside the field contribute to none of the three outputs and a
// position that is not finite has no taps, as in the Pallas kernel.  g is
// read in its own type (fp32 or bf16); all sums are float32, over a tap row's
// columns first, then over rows.  d_field is a float32 buffer the caller
// zeroes beforehand (and casts to bf16 afterwards for a bf16 field).  The
// grid-stride loop masks the tail: B*P*V need not be a multiple of the block.
//
// Determinism: d_py and d_px are bitwise reproducible (one thread each, fixed
// order).  d_field is not: the float32 atomicAdds of the up to 16 positions
// per channel that share a cell land in an order that changes from run to
// run, so d_field varies in its last bits (and a bf16 d_field may round to
// the neighbouring bf16 value).
//
// What bounds it: memory.  At the 5.625 deg flagship shape (field 1x36x68x768,
// P = 2048, V = 768, fp32) one launch must read the field (7.5 MB), both
// position arrays and g (18.9 MB), and write d_field (7.5 MB) and d_py, d_px
// (12.6 MB): ~46 MB, about 14 us at 3.35 TB/s.  The field and d_field fit in
// the 50 MB L2, so the re-reads of a cell by neighbouring positions and the
// atomics are served by L2.  Making it fast (per-plane accumulation in shared
// memory, fewer atomics) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kCubicA = -0.75f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sign_of(float d) {
  return static_cast<float>((d > 0.0f) - (d < 0.0f));
}

// Tap offsets start at kFirst; weights and their derivatives for the
// fractional coordinate t = pos - floor(pos).
template <bool kBicubic> struct Taps;

template <> struct Taps<true> {
  static constexpr int kN = 4;
  static constexpr int kFirst = -1;
  __device__ __forceinline__ static void weights(float t, float w[4], float dw[4]) {
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
  __device__ __forceinline__ static void weights(float t, float w[2], float dw[2]) {
    w[0] = 1.0f - t;
    w[1] = t;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float dist = t - static_cast<float>(k);
      dw[k] = fabsf(dist) < 1.0f ? -sign_of(dist) : 0.0f;
    }
  }
};

template <bool kBicubic, typename T, typename TG>
__global__ void __launch_bounds__(kThreads)
interp_bwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                  const float* __restrict__ pos_x, const TG* __restrict__ grad,
                  float* __restrict__ d_field, float* __restrict__ d_py,
                  float* __restrict__ d_px, int64_t total, int64_t P, int R, int C,
                  int V) {
  using K = Taps<kBicubic>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t v = i % V;
    const int64_t b = i / (P * V);
    const float y = pos_y[i];
    const float x = pos_x[i];
    const float g = to_float(grad[i]);
    const float fy = floorf(y);
    const float fx = floorf(x);
    float wy[K::kN], wx[K::kN], dwy[K::kN], dwx[K::kN];
    K::weights(y - fy, wy, dwy);
    K::weights(x - fx, wx, dwx);
    const int64_t base = b * R * static_cast<int64_t>(C) * V + v;
    const T* plane = field + base;
    float* d_plane = d_field + base;

    float acc_y = 0.0f, acc_x = 0.0f;
#pragma unroll
    for (int ty = 0; ty < K::kN; ++ty) {
      const float rf = fy + static_cast<float>(K::kFirst + ty);
      if (!(rf >= 0.0f && rf <= static_cast<float>(R - 1))) continue;  // NaN too
      const int64_t row = static_cast<int64_t>(rf) * C;
      const float g_row = g * wy[ty];
      float row_w = 0.0f, row_dw = 0.0f;
#pragma unroll
      for (int tx = 0; tx < K::kN; ++tx) {
        const float cf = fx + static_cast<float>(K::kFirst + tx);
        if (!(cf >= 0.0f && cf <= static_cast<float>(C - 1))) continue;
        const int64_t off = (row + static_cast<int64_t>(cf)) * V;
        const float f = to_float(plane[off]);
        row_w += wx[tx] * f;
        row_dw += dwx[tx] * f;
        atomicAdd(d_plane + off, g_row * wx[tx]);
      }
      acc_y += dwy[ty] * row_w;
      acc_x += wy[ty] * row_dw;
    }
    d_py[i] = g * acc_y;
    d_px[i] = g * acc_x;
  }
}

template <bool kBicubic, typename T, typename TG>
void launch(const void* field, const float* py, const float* px, const void* grad,
            float* d_field, float* d_py, float* d_px, int64_t total, int64_t P, int R,
            int C, int V, cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  interp_bwd_kernel<kBicubic, T, TG><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(field), py, px, static_cast<const TG*>(grad), d_field, d_py,
      d_px, total, P, R, C, V);
}

template <bool kBicubic, typename T>
int dispatch_grad(const void* field, const float* py, const float* px, const void* grad,
                  float* d_field, float* d_py, float* d_px, int64_t total, int64_t P,
                  int R, int C, int V, int grad_dtype, cudaStream_t s) {
  if (grad_dtype == 0) {
    launch<kBicubic, T, float>(field, py, px, grad, d_field, d_py, d_px, total, P, R, C, V, s);
  } else if (grad_dtype == 1) {
    launch<kBicubic, T, __nv_bfloat16>(field, py, px, grad, d_field, d_py, d_px, total, P,
                                       R, C, V, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// mode: 0 bilinear, 1 bicubic.  dtype (field), grad_dtype (g): 0 float32,
// 1 bfloat16.  d_field is float32 [B,R,C,V], zeroed by the caller; d_py and
// d_px are float32 [B,P,V].  Returns the CUDA error of the launch (0 on
// success).
extern "C" int paradis_interp_bwd(const void* field, const void* pos_y, const void* pos_x,
                                  const void* grad, void* d_field, void* d_py, void* d_px,
                                  long long B, long long P, int R, int C, int V, int mode,
                                  int dtype, int grad_dtype, void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(B) * P * V;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  float* df = static_cast<float*>(d_field);
  float* dy = static_cast<float*>(d_py);
  float* dx = static_cast<float*>(d_px);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (mode == 1 && dtype == 0)
    err = dispatch_grad<true, float>(field, py, px, grad, df, dy, dx, total, P, R, C, V, grad_dtype, s);
  else if (mode == 1 && dtype == 1)
    err = dispatch_grad<true, __nv_bfloat16>(field, py, px, grad, df, dy, dx, total, P, R, C, V, grad_dtype, s);
  else if (mode == 0 && dtype == 0)
    err = dispatch_grad<false, float>(field, py, px, grad, df, dy, dx, total, P, R, C, V, grad_dtype, s);
  else if (mode == 0 && dtype == 1)
    err = dispatch_grad<false, __nv_bfloat16>(field, py, px, grad, df, dy, dx, total, P, R, C, V, grad_dtype, s);
  else
    return cudaErrorInvalidValue;
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

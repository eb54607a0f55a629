// Row-banded forward gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_fwd_kernel_banded.
// That kernel receives a copy of the field cut into overlapping bands,
// [B,V,n_bands,band_rows,C], and contracts dense weight matrices over its
// band's rows on the MXU, so each position's taps are limited to the band of
// its arrival row.  Here the field is taken in place with the band plan
// (rpb, band_rows, halo_lo, pad; paradis_torch/ops/interp_band.py), and the
// kernel is the window forward of interp_stage.cuh, which the unbanded and
// row-chunked forwards launch too (a bilinear field: the tiled forward of
// interp_bilinear.cuh, theirs too), with the Band filter:
//
//   position p (within its batch) lies in band b = (p / W) / rpb, whose rows
//   are [lo, lo + band_rows), lo = clip(b*rpb + pad - halo_lo, 0,
//   R - band_rows);
//   out[b,p,v] = sum_{r in band} K(py - r) * sum_c K(px - c) * f[b,r,c,v]
//
// The window kernel's tiles are aligned to bands, and each tile stages only
// rows of its band, so a tap row outside the position's band, a column
// outside [0,C), and every tap of a position that is not finite add
// nothing: the Pallas kernel's function on any positions, clamped or not.
// Under the caller's clamp (|py - arrival row - pad| <= max_dy_pix) the band
// holds every tap row in the field, and add_taps() sums in one float order
// whatever the slabs, so the result is bitwise equal to interp_fwd.cu's on
// the same clamped positions.  The design, what bounds it and its times are
// described in interp_stage.cuh and PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "interp_bilinear.cuh"
#include "interp_stage.cuh"

// mode: 0 bilinear, 1 bicubic.  dtype: 0 float32, 1 bfloat16 (field and out).
// P = H*W <= INT_MAX with H a multiple of rpb; 0 < band_rows <= R.  Returns
// the CUDA error of the launch (0 on success); cudaErrorInvalidValue where one
// field row of one channel does not fit in shared memory.
extern "C" int paradis_interp_band_fwd(const void* field, const void* pos_y,
                                       const void* pos_x, void* out, long long B, long long P,
                                       int R, int C, int V, int W, int rpb, int band_rows,
                                       int halo_lo, int pad, int mode, int dtype,
                                       void* stream) {
  if (B <= 0 || P <= 0 || P > INT_MAX || R <= 0 || C <= 0 || V <= 0 || W <= 0 || rpb <= 0 ||
      band_rows <= 0 || band_rows > R || P % W != 0 || (P / W) % rpb != 0)
    return cudaErrorInvalidValue;
  const Band band{W * rpb, rpb, band_rows, halo_lo, pad};
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0)
    return launch_window<float>(field, py, px, out, B, P, R, C, V, s, band);
  if (mode == 1 && dtype == 1)
    return launch_window<__nv_bfloat16>(field, py, px, out, B, P, R, C, V, s, band);
  if (mode == 0) return launch_bilinear_fwd(field, py, px, out, B, P, R, C, V, W, dtype, s, band);
  return cudaErrorInvalidValue;
}

// Backward of the row-banded gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_bwd_kernel_banded.
// That kernel reads the banded field copy [B,V,n_bands,band_rows,C], writes a
// per-band float32 d_field [B,V,n_bands,band_rows,C] and leaves the
// overlap-add of the bands into [B,V,R,C] to XLA; each position's taps are
// limited to the band of its arrival row.  Here the field is taken in place
// with the band plan of interp_band_fwd.cu, and the kernel is the row-slab
// backward of interp_stage_bwd.cuh, which the unbanded and row-chunked
// backwards launch too (a bilinear field: the tiled backward of
// interp_bilinear.cuh, theirs too), with the Band filter of interp_stage.cuh:
//
//   d_field[b,r,c,v] = sum_p g * K(py - r) * K(px - c)
//   d_py[b,p,v]      = g * sum_r K'(py - r) * sum_c K(px - c)  * f[b,r,c,v]
//   d_px[b,p,v]      = g * sum_r K(py - r)  * sum_c K'(px - c) * f[b,r,c,v]
//
// with r over the rows of the position's band only.  A tap row outside the
// band, a column outside [0,C), and every tap of a position that is not
// finite add to none of the three outputs: the Pallas kernel's function on
// any positions, clamped or not (the span pre-pass writes the zero d_py and
// d_px of an item none of whose taps is kept).  Under the caller's clamp the
// filter removes no tap, and one thread sums an item's d_py and d_px whole in
// add_bwd_taps()'s order, so they are bitwise equal to interp_bwd.cu's on the
// same clamped positions.  d_field is written once, in the field's type, with
// no global atomic; it is not bitwise reproducible (shared-memory float
// atomics).  The design, what bounds it and its times are described in
// interp_stage_bwd.cuh and PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "interp_bilinear.cuh"
#include "interp_stage_bwd.cuh"

// mode: 0 bilinear, 1 bicubic.  dtype (field and d_field), grad_dtype (g):
// 0 float32, 1 bfloat16.  d_field is [B,R,C,V] in the field's type, written
// whole; d_py and d_px are float32 [B,P,V]; scratch as for
// paradis_interp_bwd (interp_bwd.cu).  P = H*W <= INT_MAX with H a multiple
// of rpb; 0 < band_rows <= R.  Returns the CUDA error of the launch (0 on
// success); cudaErrorInvalidValue where a bicubic slab of one row (and its
// taps' halo) of one channel does not fit in shared memory.
extern "C" int paradis_interp_band_bwd(const void* field, const void* pos_y,
                                       const void* pos_x, const void* grad, void* d_field,
                                       void* d_py, void* d_px, void* scratch, long long B,
                                       long long P, int R, int C, int V, int W, int rpb,
                                       int band_rows, int halo_lo, int pad, int mode, int dtype,
                                       int grad_dtype, void* stream) {
  if (B <= 0 || P <= 0 || P > INT_MAX || R <= 0 || C <= 0 || V <= 0 || W <= 0 || rpb <= 0 ||
      band_rows <= 0 || band_rows > R || P % W != 0 || (P / W) % rpb != 0)
    return cudaErrorInvalidValue;
  const Band band{W * rpb, rpb, band_rows, halo_lo, pad};
  if (mode == 0)
    return launch_bilinear_bwd(field, pos_y, pos_x, grad, d_field, d_py, d_px, scratch, B, P, R,
                               C, V, W, dtype, grad_dtype, stream, band);
  return launch_slab_bwd(field, pos_y, pos_x, grad, d_field, d_py, d_px, scratch, B, P, R, C, V,
                         mode, dtype, grad_dtype, stream, band);
}

// Backward of the gather-interpolation at departure points, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_bwd_kernel, which
// regenerates dense separable weights K and K' over every padded row and
// column and contracts them on the MXU.  Here the direct tap form, about 230
// flops a bicubic output and no tensor-core work, runs as the row-slab
// backward of interp_stage_bwd.cuh, which the row-chunked backward
// (interp_chunk_bwd.cu) launches too: a block owns a slab of rows of one
// channel group's d_field, accumulates it in shared memory over every
// position of the group, and writes it once in the field's type, with no
// global atomic.  Its design, its float order (d_py and d_px bitwise equal
// to interp_chunk_bwd.cu's on any positions), what bounds it and its
// measured times are described there and in PERF.md.
//
// Taps outside [0,R) x [0,C) add to none of the three outputs and a
// position that is not finite has no taps, as in the Pallas kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "interp_stage_bwd.cuh"

// mode: 0 bilinear, 1 bicubic.  dtype (field and d_field), grad_dtype (g):
// 0 float32, 1 bfloat16.  d_field is [B,R,C,V] in the field's type, written
// whole (the caller need not zero it); d_py and d_px are float32 [B,P,V];
// span is int32 scratch of 2 * B * ceil(V / 2) * ceil(P / 32) elements.
// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// where a slab of one row (and its taps' halo) of one channel does not fit
// in shared memory.
extern "C" int paradis_interp_bwd(const void* field, const void* pos_y, const void* pos_x,
                                  const void* grad, void* d_field, void* d_py, void* d_px,
                                  void* span, long long B, long long P, int R, int C, int V,
                                  int mode, int dtype, int grad_dtype, void* stream) {
  return launch_slab_bwd(field, pos_y, pos_x, grad, d_field, d_py, d_px, span, B, P, R, C, V,
                         mode, dtype, grad_dtype, stream);
}

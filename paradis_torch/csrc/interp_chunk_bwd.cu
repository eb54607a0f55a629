// Backward of the row-chunked gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_bwd_kernel_chunked,
// which contracts dense weight and derivative matrices over each static
// rw-row chunk of the zero-padded field that meets its block's row range and
// adds each chunk's d_field rows into a d_field block revisited across the
// position blocks.  Here the rows a block stages are a slab of the rows of
// d_field it owns, over the unpadded field: the row-slab backward of
// interp_stage_bwd.cuh, which the unchunked backward (interp_bwd.cu) also
// launches, so d_py and d_px are bitwise equal to it on any positions.  Its
// design, its float order and what bounds it are described there.
//
// rw is taken and checked (PARADIS_INTERP_CHUNK still selects this kernel)
// but does not shape the staging: the result never depended on it.
//
// Taps outside [0,R) x [0,C) add to none of the three outputs and a
// non-finite position has no taps, per position.  (The Pallas kernel takes
// the min and max over its whole block, so one NaN position there zeroes its
// whole block.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "interp_stage_bwd.cuh"

// mode: 0 bilinear, 1 bicubic.  dtype (field and d_field), grad_dtype (g):
// 0 float32, 1 bfloat16.  d_field is [B,R,C,V] in the field's type, written
// whole; d_py and d_px are float32 [B,P,V]; span is int32
// scratch of 2 * B * ceil(V / 2) * ceil(P / 32) elements.  rw > 0 rows a chunk of the TPU
// kernel; the staging here does not depend on it.  Returns the CUDA error of
// the launch (0 on success); cudaErrorInvalidValue where a slab of one row
// (and its taps' halo) of one channel does not fit in shared memory.
extern "C" int paradis_interp_chunk_bwd(const void* field, const void* pos_y,
                                        const void* pos_x, const void* grad, void* d_field,
                                        void* d_py, void* d_px, void* span, long long B,
                                        long long P, int R, int C, int V, int rw, int mode,
                                        int dtype, int grad_dtype, void* stream) {
  if (rw <= 0) return cudaErrorInvalidValue;
  return launch_slab_bwd(field, pos_y, pos_x, grad, d_field, d_py, d_px, span, B, P, R, C, V,
                         mode, dtype, grad_dtype, stream);
}

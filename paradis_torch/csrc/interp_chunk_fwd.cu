// Row-chunked forward gather-interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_fwd_kernel_chunked.
// That kernel zero-pads the field's rows to a multiple of rw, reduces
// floor(py) over its whole position block to a row range (_tap_row_range),
// and contracts dense weight matrices over each static rw-row chunk that
// meets the range, guarded by pl.when.  Here the rows a block stages are the
// window its own positions' taps touch, over the unpadded field: the window
// kernel of interp_stage.cuh, which the unchunked forward (interp_fwd.cu)
// also launches for fields too large to hold in shared memory.  Its design,
// its float order and what bounds it are described there.
//
// rw is taken and checked (PARADIS_INTERP_CHUNK still selects this kernel)
// but does not shape the staging: the result never depended on it, and the
// window of a block is usually far narrower than the rw-aligned chunks that
// cover it (two 32-row chunks for a ~31-row window at 1.40625 deg).
//
// Taps outside [0,R) x [0,C) are dropped and a non-finite position has no
// taps, per position.  (The Pallas kernel takes the min and max over its
// whole block, so one NaN position there zeroes its whole block.)  The
// result is bitwise equal to interp_fwd.cu's on any positions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "interp_stage.cuh"

// mode: 0 bilinear, 1 bicubic.  dtype: 0 float32, 1 bfloat16 (field and out).
// rw > 0 rows a chunk of the TPU kernel; the staging here does not depend on
// it.  Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue where one field row of one channel does not fit in
// shared memory.
extern "C" int paradis_interp_chunk_fwd(const void* field, const void* pos_y,
                                        const void* pos_x, void* out, long long B, long long P,
                                        int R, int C, int V, int rw, int mode, int dtype,
                                        void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0 || rw <= 0) return cudaErrorInvalidValue;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0) return launch_window<true, float>(field, py, px, out, B, P, R, C, V, s);
  if (mode == 1 && dtype == 1)
    return launch_window<true, __nv_bfloat16>(field, py, px, out, B, P, R, C, V, s);
  if (mode == 0 && dtype == 0) return launch_window<false, float>(field, py, px, out, B, P, R, C, V, s);
  if (mode == 0 && dtype == 1)
    return launch_window<false, __nv_bfloat16>(field, py, px, out, B, P, R, C, V, s);
  return cudaErrorInvalidValue;
}

// Forward gather-interpolation at departure points, for Hopper (sm_90a).
//
// Replaces the TPU kernel paradis_tpu/ops/interp_pallas.py:_fwd_kernel, which
// generates dense separable weights K(pos - i) over every padded row and
// column and contracts them on the MXU.  On this card the direct form is
// cheaper: each output reads its 4x4 (bicubic) taps, about 70 flops an
// output, no tensor-core work.  A bilinear field (2x2 taps) takes the
// bilinear route of interp_bilinear.cuh instead (route 2 below); what
// follows is bicubic's.
//
//   out[b,p,v] = sum_r K(py[b,p,v] - r) * sum_c K(px[b,p,v] - c) * f[b,r,c,v]
//
// Layouts are channels-last, as the port's tensors: field [B,R,C,V], positions
// and output [B,P,V] with P = H*W.  Every (p, v) has its own departure point,
// so the taps of neighbouring outputs lie at unrelated cells: a direct gather
// from device memory reads a 4- or 2-byte tap from its own 32-byte sector.
// So the field is read from shared memory, by one of two routes:
//
// The resident route, where two slabs of a channel group's whole R x C field
// fit in shared memory (5.625 deg: 36 x 68, 78 KB a slab).  A work unit is (b,
// group of kVg channels, position); kVg channels are 32 bytes (8 fp32, 16
// bf16), so a position's reads of py and px and its store fill whole 32-byte
// sectors.  A persistent grid, one 1024-thread block an SM, gives each block
// one contiguous run of units, group-major, so a block stages each group it
// meets once; there is no window, so the spread of the positions costs nothing.
// A ring of two slabs: the block's next group is copied (16-byte cp.async from
// every thread, each cell's channels contiguous in shared memory) while the
// current one is gathered, and a pass's positions are loaded before the block
// waits for its slab.  A warp holds 4 (fp32) or 2 (bf16) consecutive positions
// of its group, each thread one channel, and adds its taps from shared memory.
// Where V is no multiple of kVg or the field is not 16-byte aligned the slabs
// are staged with plain loads, zero-filling channels >= V.
//
// The window route, for larger fields (1.40625 deg: 132 x 260, over 1 MB a
// group): the row-chunked forward's window kernel (interp_stage.cuh), which
// stages each tile's own row window.  It refuses only a field whose one row
// of one channel does not fit in shared memory.
//
// Both routes sum through add_taps() of interp_stage.cuh: over a tap row's
// columns first, then the rows in increasing order, in float32, the output
// written in the field's type; so the result is bitwise equal to
// interp_chunk_fwd.cu's on any positions.  Taps outside [0,R) x [0,C) are
// dropped (contribute zero), as in the Pallas kernel, and a position that is
// not finite has no taps.  Weights come from floor(pos) (ATen cubic
// convolution, a = -0.75).
//
// What bounds it: memory.  At the 5.625 deg flagship shape (field
// 1x36x68x768, P = 2048, V = 768) one fp32 launch must read the field once
// (7.5 MB) and both position arrays (12.6 MB) and write the output (6.3 MB):
// ~26 MB, 7.9 us at 3.35 TB/s; bf16 ~19.5 MB, 5.8 us.  Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6): bicubic 0.0306 /
// 0.0295 ms fp32 / bf16, 3.9x / 5.1x the bound (F.grid_sample 0.0500 /
// 0.0710; the direct per-output gather from device memory that this kernel
// replaced, 0.088 / 0.054), 0.0332 / 0.0318 on the rollout's
// own departure points; the window route 0.707 / 0.715 ms at 1.40625 deg.
// What holds it back: the gathers, about half the time (PERF.md section 6):
// the taps are data-dependent shared-memory reads, and the 4 (2) positions
// of a warp collide on a bank when their cells agree mod 4; and the stream
// of positions and outputs, with one block an SM, at ~1.9x its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

#include "interp_bilinear.cuh"
#include "interp_stage.cuh"

namespace {

using namespace paradis_interp;

constexpr int kThreads = 1024;  // one block an SM: its two slabs take the shared memory
constexpr int kItems = 2;       // (position, channel) items a thread holds at once
constexpr int kStages = 2;      // slabs in the ring
constexpr int kCellBytes = 32;  // bytes of channels a cell: 8 fp32 or 16 bf16

template <typename T>
__host__ __device__ constexpr int group_of() {
  return kCellBytes / static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
resident_fwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                    const float* __restrict__ pos_x, T* __restrict__ out, int64_t P, int R,
                    int C, int V, int n_groups, int64_t units, bool vec) {
  constexpr int kVg = group_of<T>();
  constexpr int kRow = kThreads / kVg;  // positions of one item of every thread
  constexpr int kPass = kRow * kItems;  // positions a pass
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = R * C;
  // this block's units [lo, hi) of the B * n_groups * P, group-major: groups
  // g = b * n_groups + group, positions of a group consecutive
  const int64_t lo = units * blockIdx.x / gridDim.x;
  const int64_t hi = units * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int64_t g_first = lo / P;
  const int64_t g_last = (hi - 1) / P;
  const int ch = static_cast<int>(threadIdx.x % kVg);
  const int row_pos = static_cast<int>(threadIdx.x / kVg);

  // group g's slab: stage (g - g_first) % kStages of the ring
  auto slab_of = [&](int64_t g) {
    return reinterpret_cast<T*>(smem) + static_cast<int>((g - g_first) % kStages) * cells * kVg;
  };
  // one commit group a slab, empty past the block's last group, so that the
  // slab of the (k+1)th group has landed once at most kStages - 1 are in flight
  auto stage = [&](int64_t g) {
    if (g <= g_last) {
      const int64_t b = g / n_groups;
      const int v0 = static_cast<int>(g % n_groups) * kVg;
      stage_cells<T, kVg>(slab_of(g), field + b * cells * V + v0, cells, V, v0, vec);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages; ++s) stage(g_first + s);

  for (int64_t g = g_first; g <= g_last; ++g) {
    const T* slab = slab_of(g);
    const int64_t b = g / n_groups;
    const int v0 = static_cast<int>(g % n_groups) * kVg;
    const bool ch_ok = v0 + ch < V;
    const int64_t p_lo = (lo > g * P ? lo : g * P) - g * P;
    const int64_t p_hi = (hi < (g + 1) * P ? hi : (g + 1) * P) - g * P;
    bool landed = false;
    for (int64_t p0 = p_lo; p0 < p_hi; p0 += kPass) {
      float y[kItems], x[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int64_t p = p0 + row_pos + j * kRow;
        y[j] = x[j] = __int_as_float(0x7fc00000);  // NaN: no taps
        if (p < p_hi && ch_ok) {
          const int64_t at = (b * P + p) * V + v0 + ch;
          y[j] = pos_y[at];
          x[j] = pos_x[at];
        }
      }
      if (!landed) {  // the first pass of the group: its positions are on their way
        cp_async_wait<kStages - 1>();
        __syncthreads();  // every thread's copies of this slab have landed
        landed = true;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int64_t p = p0 + row_pos + j * kRow;
        if (p < p_hi && ch_ok)
          out[(b * P + p) * V + v0 + ch] =
              from_float<T>(add_taps<T, kVg>(0.0f, y[j], x[j], slab, ch, 0, R, C));
      }
    }
    __syncthreads();  // every thread is done with the slab
    stage(g + kStages);
  }
}

// What the resident route needs of the card, read once a device: its SM
// count and the dynamic shared memory a block may have (the kernel opted in
// to all of it).
struct Card {
  int sms;
  int64_t avail;
};

template <typename T>
cudaError_t card_of(Card* card) {
  static std::mutex mu;
  static std::map<int, Card> cards;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto known = cards.find(device);
  if (known != cards.end()) {
    *card = known->second;
    return cudaSuccess;
  }
  auto kernel = resident_fwd_kernel<T>;
  int smem_block = 0;
  Card c;
  err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  c.avail = smem_block - static_cast<int64_t>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(c.avail));
  if (err != cudaSuccess) return err;
  cards[device] = c;
  *card = c;
  return cudaSuccess;
}

// The shared memory of the resident route's ring for an R x C field.
int64_t ring_bytes(int R, int C) { return static_cast<int64_t>(kStages) * R * C * kCellBytes; }

// Whether the resident route takes an R x C field: its ring fits in the
// shared memory a block may have.
bool resident(int R, int C, const Card& card) { return ring_bytes(R, C) <= card.avail; }

template <typename T>
int launch(const void* field, const float* py, const float* px, void* out, int64_t B, int64_t P,
           int R, int C, int V, cudaStream_t stream) {
  constexpr int kVg = group_of<T>();
  Card card;
  const cudaError_t err = card_of<T>(&card);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!resident(R, C, card))
    return launch_window<T>(field, py, px, out, B, P, R, C, V, stream);
  const int64_t smem = ring_bytes(R, C);
  const int64_t n_groups = (V + kVg - 1) / kVg;
  const int64_t units = B * n_groups * P;
  // one block an SM, at least a row of positions a block
  const int64_t blocks =
      std::min<int64_t>(card.sms, std::max<int64_t>(units / (kThreads / kVg), 1));
  const bool vec = V % kVg == 0 && reinterpret_cast<uintptr_t>(field) % kCopyBytes == 0;
  resident_fwd_kernel<T>
      <<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
          static_cast<const T*>(field), py, px, static_cast<T*>(out), P, R, C, V,
          static_cast<int>(n_groups), units, vec);
  return static_cast<int>(cudaGetLastError());
}

// 0: the resident route takes an R x C field, 1: the window route; or a
// negative CUDA error.
template <typename T>
int route(int R, int C) {
  Card card;
  const cudaError_t err = card_of<T>(&card);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return resident(R, C, card) ? 0 : 1;
}

}  // namespace

// mode: 0 bilinear, 1 bicubic.  dtype: 0 float32, 1 bfloat16 (field and out).
// P = H*W positions, W > 0 of them an arrival row (the bilinear route's
// tiles; the bicubic routes do not use it).  Returns the CUDA error of the
// launch (0 on success); cudaErrorInvalidValue where a bicubic field takes
// the window route and one of its rows of one channel does not fit in shared
// memory.
extern "C" int paradis_interp_fwd(const void* field, const void* pos_y, const void* pos_x,
                                  void* out, long long B, long long P, int R, int C, int V,
                                  int W, int mode, int dtype, void* stream) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0) return cudaErrorInvalidValue;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_bilinear_fwd(field, py, px, out, B, P, R, C, V, W, dtype, s);
  if (mode == 1 && dtype == 0) return launch<float>(field, py, px, out, B, P, R, C, V, s);
  if (mode == 1 && dtype == 1) return launch<__nv_bfloat16>(field, py, px, out, B, P, R, C, V, s);
  return cudaErrorInvalidValue;
}

// The route paradis_interp_fwd takes for an R x C field on the current
// device: 0 resident, 1 window (bicubic), 2 bilinear (every bilinear field);
// a negative CUDA error, or -cudaErrorInvalidValue for arguments it does not
// take.  Launches nothing; the stream is not used.
extern "C" int paradis_interp_fwd_route(int R, int C, int mode, int dtype, void* stream) {
  (void)stream;
  if (R <= 0 || C <= 0 || (dtype != 0 && dtype != 1))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) return 2;
  if (mode == 1 && dtype == 0) return route<float>(R, C);
  if (mode == 1 && dtype == 1) return route<__nv_bfloat16>(R, C);
  return -static_cast<int>(cudaErrorInvalidValue);
}

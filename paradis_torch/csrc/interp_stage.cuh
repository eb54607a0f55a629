// Staging a field's channel groups in shared memory, and the gather over a
// staged slab; shared by the forward kernels interp_fwd.cu,
// interp_chunk_fwd.cu and interp_band_fwd.cu, so that all three sum every
// position's taps in one float order and give the same bits.
//
//   out[b,p,v] = sum_r K(py - r) * sum_c K(px - c) * f[b,r,c,v]
//
// A slab holds rows [r0, r1) of one batch's field for one group of kVg
// channels, as [r1 - r0, C, kVg]: each cell's channels contiguous.
// stage_cells() copies it; add_taps() adds one position's taps that lie in
// it.  Float order (add_taps): over a tap row's columns first, then the rows
// in increasing order, carried across slabs in increasing order.  Taps
// outside [0,R) x [0,C) are dropped and a non-finite position has no taps,
// per position.
//
// The band filter (NoBand, Band below) is a compile-time policy of the
// window kernel and of the backward of interp_stage_bwd.cuh: the rows a
// position's taps may use.  NoBand, the unbanded and row-chunked entry
// points', is the field's rows and compiles to the filter-free code.  Band,
// the row-banded entry points' (interp_band_fwd.cu, interp_band_bwd.cu), is
// the rows of the position's band in the plan of ops/interp_band.py; a tap
// row outside them adds to no output, as in the Pallas banded kernels, whose
// blocks contract over their band's rows only.
//
// The window kernel (window_fwd_kernel, launched by launch_window()) is the
// row-chunked forward's design: one block per (b, tile of consecutive
// positions, group of vg channels), the tiles of one channel group adjacent
// in launch order.  vg is 16 bytes of channels a cell (4 fp32, 8 bf16), or 1
// where V has fewer channels or one row of 16-byte cells does not fit.  A
// thread holds kItems (position, channel) items, all of its channel, so a
// block of 1024 threads tiles 2048 positions in both dtypes: 8 arrival rows
// of the 1.40625 deg grid, whose departure rows spread over a window of ~36
// rows.  The launcher halves the block (down to 64 threads) while the launch
// would give an SM fewer than 8 blocks, so a small grid still spreads over
// the card.
//
//   1. Each thread loads its items' positions; the block reduces floor(py)
//      over its finite positions to the tap rows [row_lo, row_hi] (a
//      non-finite position has no taps and is left out: an inf would widen
//      the window to the whole field).  With a band, the window is cut to
//      the tile's band, which all of its positions share (below): no row
//      outside it is staged, so no item adds a tap outside its band, and
//      the filter costs the gather nothing.
//   2. The window's rows, rows x C cells of vg channels, are staged in
//      dynamic shared memory, each cell's vg channels as one 16-byte
//      cp.async (bypassing the registers), all of a slab's copies in flight
//      at once.  The launcher sizes the slab from the shared memory one
//      block may use at the occupancy its registers allow (55 rows at
//      1.40625 deg with 1024 threads, so the ~36-row window is one slab).
//      Where V is no multiple of vg, vg is 1, or the field is not 16-byte
//      aligned, the cells are staged with plain loads, zero-filling
//      channels >= V.
//   3. After the copies land, each thread adds, for each of its items, the
//      taps whose rows lie in the slab.  A window taller than the slab is
//      walked slab by slab in increasing row order, so no window is
//      refused: only a field whose one row of one channel does not fit in
//      shared memory is.
//   4. The items' float32 sums stay in registers across the slabs and the
//      output is written once, in the field's type.
//
// With a band, tiles are aligned to bands: each band's positions are tiled
// from a tile of their own on, the last one partial where the tile does not
// divide the band (at 1.40625 deg a 1024-thread block's 2,048 positions are
// one band of 8 arrival rows of 256, so none is).  Unaligned tiles, each
// item's taps held to its own band in add_taps() where a tile spanned two
// bands, measured slower there, even where no tile spanned two: the
// per-item code spilled registers (PERF.md).
//
// A slab is staged, then gathered: row groups whose copies overlap the
// gathers of the group before, two blocks an SM (512 threads) and 8-byte
// cells all measured slower on an H100 (PERF.md).  With row groups a
// warp revisits each of its items once for every group its 32 items' rows
// touch, which costs more than the overlap gains.  There is no clamp: a tile
// whose positions spread over the field walks every row, which is correct
// and slow.
//
// What bounds it: memory.  At 1.40625 deg (field 1x132x260x768, P = 32768,
// V = 768, fp32) a launch must read the field (105 MB) and both positions
// (201 MB) and write the output (101 MB): 0.12 ms at 3.35 TB/s.  Staging
// reads each field row once for each tile whose window holds it (~36 / 8 =
// 4.5 times at 1.40625 deg), through L2, 16 bytes of each 32-byte sector at
// a time; the taps are 4-byte (fp32) or 2-byte (bf16) shared-memory reads at
// data-dependent cells, 16 per bicubic output; and with one block an SM the
// copies and the gathers do not overlap: ~6x the bound on an H100 80GB HBM3
// at 700 W (0.720 / 0.723 ms fp32 / bf16, PERF.md, PR 7).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>

#include "interp_taps.cuh"

// Internal linkage, in the including file's own unnamed namespace: each
// library that includes this header keeps its own kernels' launch
// attributes.  (A static local of a template with external linkage is one
// object for the whole process, shared by every library that instantiates
// it, and would cache one library's shared-memory opt-in for another's
// kernel.)  Not nested in a named namespace: nvcc's registration stub names
// a kernel by the file's unnamed namespace, which a second, nested one of the
// same name makes ambiguous.
namespace {

using paradis_interp::from_float;
using paradis_interp::Taps;
using paradis_interp::to_float;

constexpr int kCopyBytes = 16;  // one cp.async

// A 16-byte copy from device to shared memory that bypasses the registers
// and L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Close this thread's group of copies issued since the last commit (an
// empty group where there were none).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Whether a cell of kVg channels of T is a whole number of 16-byte copies.
template <typename T, int kVg>
__host__ __device__ constexpr bool wide_cell() {
  return (kVg * static_cast<int>(sizeof(T))) % kCopyBytes == 0;
}

// Stage n_cells consecutive cells of one channel group into slab [n_cells,
// kVg]: src points at the group's first channel (v0) of the first cell, a
// cell's channels lie V apart from the next cell's.  With vec (16-byte
// cells copies, V a multiple of kVg, src 16-byte aligned) the copies are
// cp.async, in flight until the caller waits; else plain loads, zero-filling
// channels v0 + q >= V.  Every thread of the block takes part.
template <typename T, int kVg>
__device__ __forceinline__ void stage_cells(T* slab, const T* src, int n_cells, int V, int v0,
                                            bool vec) {
  const int threads = blockDim.x;
  if constexpr (wide_cell<T, kVg>()) {
    if (vec) {
      constexpr int kPer = kCopyBytes / static_cast<int>(sizeof(T));  // channels a copy
      constexpr int kCopies = kVg / kPer;                              // copies a cell
      for (int e = threadIdx.x; e < n_cells * kCopies; e += threads) {
        const int c = e / kCopies, part = e % kCopies;
        cp_async16(slab + e * kPer, src + static_cast<int64_t>(c) * V + part * kPer);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < n_cells * kVg; e += threads) {
    const int c = e / kVg, q = e % kVg;
    slab[e] = v0 + q < V ? src[static_cast<int64_t>(c) * V + q] : from_float<T>(0.0f);
  }
}

// The band filter: rows(p, R) is [x, y), the rows that the taps of position
// p (counted within its batch) may use; tiles(P, tile) is the count of the
// window kernel's tiles of tile positions, none of which straddles two sets
// of rows.  NoBand: the field's rows, for every position.
struct NoBand {
  static constexpr bool kOn = false;
  __device__ __forceinline__ int2 rows(int64_t, int R) const { return make_int2(0, R); }
  int64_t tiles(int64_t P, int tile) const { return (P + tile - 1) / tile; }
};

// The band of position p in the row-banded plan (ops/interp_band.py,
// paradis_tpu/ops/interp_pallas.py:_band_r0): band p / (W * rpb), rows
// [lo, lo + band_rows) with lo = clip(band * rpb + pad - halo_lo, 0, R -
// band_rows), inside the field since 0 < band_rows <= R.  The entry points
// check P <= INT_MAX, so the band is a 32-bit division.
struct Band {
  static constexpr bool kOn = true;
  int per_band;  // positions a band: W * rpb
  int rpb, band_rows, halo_lo, pad;
  __device__ __forceinline__ int2 rows(int64_t p, int R) const {
    const int band = static_cast<int>(p) / per_band;
    const int lo = min(max(band * rpb + pad - halo_lo, 0), R - band_rows);
    return make_int2(lo, lo + band_rows);
  }
  // each band's positions from a tile of their own on (P is a whole number
  // of bands)
  int64_t tiles(int64_t P, int tile) const { return P / per_band * ((per_band + tile - 1) / tile); }
};

// acc plus the taps of the position (y, x) whose rows lie in [r0, r1), read
// at channel ch of the slab [r1 - r0, C, kVg] that holds those rows.
template <bool kBicubic, typename T, int kVg>
__device__ __forceinline__ float add_taps(float acc, float y, float x, const T* slab, int ch,
                                          int r0, int r1, int C) {
  using K = Taps<kBicubic>;
  const float first = static_cast<float>(r0);
  const float last = static_cast<float>(r1 - 1);
  const float fy = floorf(y);
  // no tap row in this slab (NaN and inf too)
  if (!(fy + static_cast<float>(K::kFirst) <= last &&
        fy + static_cast<float>(K::kFirst + K::kN - 1) >= first))
    return acc;
  const float fx = floorf(x);
  float wy[K::kN], wx[K::kN];
  K::weights(y - fy, wy);
  K::weights(x - fx, wx);
#pragma unroll
  for (int ty = 0; ty < K::kN; ++ty) {
    const float rf = fy + static_cast<float>(K::kFirst + ty);
    if (!(rf >= first && rf <= last)) continue;  // another slab's row
    const T* row = slab + ch + (static_cast<int>(rf) - r0) * C * kVg;
    float row_acc = 0.0f;
#pragma unroll
    for (int tx = 0; tx < K::kN; ++tx) {
      const float cf = fx + static_cast<float>(K::kFirst + tx);
      if (!(cf >= 0.0f && cf <= static_cast<float>(C - 1))) continue;
      row_acc += wx[tx] * to_float(row[static_cast<int>(cf) * kVg]);
    }
    acc += wy[ty] * row_acc;
  }
  return acc;
}

namespace window {

constexpr int kMaxThreads = 1024;  // threads a block at most (64 registers a thread)
constexpr int kMinThreads = 64;
constexpr int kSizes = 5;          // block sizes kMaxThreads >> i, down to kMinThreads
constexpr int kNoFit = -1;         // launch_groups(): one row of the channel group does not fit
static_assert((kMaxThreads >> (kSizes - 1)) == kMinThreads, "kSizes block sizes");

// (position, channel) items a thread
template <typename T>
__host__ __device__ constexpr int items_of() {
  return 32 / static_cast<int>(sizeof(T));
}

template <bool kBicubic, typename T, int kVg, typename Rows>
__global__ void __launch_bounds__(kMaxThreads, 1024 / kMaxThreads)
window_fwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                  const float* __restrict__ pos_x, T* __restrict__ out, int64_t P, int R, int C,
                  int V, int n_tiles, int n_groups, int slab_rows, bool vec, Rows rows) {
  using K = Taps<kBicubic>;
  constexpr int kItems = items_of<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);  // [slab_rows, C, kVg]
  __shared__ int window[2];

  const int threads = blockDim.x;  // a multiple of 32, so of kVg
  const int t = blockIdx.x % n_tiles;
  const int group = (blockIdx.x / n_tiles) % n_groups;
  const int64_t b = blockIdx.x / (n_tiles * n_groups);
  const int v0 = group * kVg;
  const int tile_pos = threads / kVg * kItems;
  int64_t p0 = static_cast<int64_t>(t) * tile_pos;
  int64_t end = P;  // one past the last position of the tile's set of rows
  if constexpr (Rows::kOn) {
    // tile t is tile t % k of band t / k: no tile straddles two bands
    const int k = (rows.per_band + tile_pos - 1) / tile_pos;
    p0 = static_cast<int64_t>(t / k) * rows.per_band + static_cast<int64_t>(t % k) * tile_pos;
    end = static_cast<int64_t>(t / k + 1) * rows.per_band;
  }
  const int n_pos = static_cast<int>(end - p0 < tile_pos ? end - p0 : tile_pos);
  // with a band, the tile's start and size wait in shared memory across the
  // slabs for the stores: held in registers through the gathers (the start
  // is a division, not recomputed) they spilled, 2% slower in fp32 and 3% in
  // bf16 at 1.40625 deg (PERF.md)
  __shared__ int64_t tile_p0;
  __shared__ int tile_n;
  if constexpr (Rows::kOn) {
    if (threadIdx.x == 0) {
      tile_p0 = p0;
      tile_n = n_pos;
    }
  }
  // item j of this thread: position threadIdx.x / kVg + j * threads / kVg,
  // channel v0 + ch
  const int ch = static_cast<int>(threadIdx.x % kVg);
  const bool ch_ok = v0 + ch < V;
  if (threadIdx.x == 0) {
    window[0] = INT_MAX;
    window[1] = INT_MIN;
  }

  float y[kItems], x[kItems], acc[kItems];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = static_cast<int>(threadIdx.x / kVg) + j * (threads / kVg);
    y[j] = x[j] = __int_as_float(0x7fc00000);  // NaN: no taps
    acc[j] = 0.0f;
    if (p < n_pos && ch_ok) {
      const int64_t at = (b * P + p0 + p) * V + v0 + ch;
      y[j] = pos_y[at];
      x[j] = pos_x[at];
      if (isfinite(y[j])) {
        // clamped before the conversion; rows beyond the field add nothing
        const int r = static_cast<int>(fminf(fmaxf(floorf(y[j]), -8.0f),
                                             static_cast<float>(R) + 8.0f));
        lo = min(lo, r);
        hi = max(hi, r);
      }
    }
  }
  __syncthreads();
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&window[0], lo);
    atomicMax(&window[1], hi);
  }
  __syncthreads();
  int row_lo = max(window[0] + K::kFirst, 0);
  int row_hi = min(window[1] + K::kFirst + K::kN - 1, R - 1);
  if constexpr (Rows::kOn) {
    // the tile's band, which all of its positions share: no other row is
    // staged, so no item adds a tap outside its band
    const int2 band = rows.rows(p0, R);
    row_lo = max(row_lo, band.x);
    row_hi = min(row_hi, band.y - 1);
  }
  // the channel group of the batch's first cell
  const T* plane = field + b * R * static_cast<int64_t>(C) * V + v0;

  for (int r0 = row_lo; r0 <= row_hi; r0 += slab_rows) {
    const int r1 = min(r0 + slab_rows, row_hi + 1);  // one past the slab's last row
    // rows [r0, r1) are contiguous in the field: (r1 - r0) * C consecutive cells
    stage_cells<T, kVg>(slab, plane + static_cast<int64_t>(r0) * C * V, (r1 - r0) * C, V, v0,
                        vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      acc[j] = add_taps<kBicubic, T, kVg>(acc[j], y[j], x[j], slab, ch, r0, r1, C);
    __syncthreads();  // every thread is done with the slab
  }

  int64_t out_p0 = p0;
  int out_n = n_pos;
  if constexpr (Rows::kOn) {
    out_p0 = tile_p0;
    out_n = tile_n;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = static_cast<int>(threadIdx.x / kVg) + j * (threads / kVg);
    if (p < out_n && ch_ok) out[(b * P + out_p0 + p) * V + v0 + ch] = from_float<T>(acc[j]);
  }
}

// What a launch needs of the card and of one instantiation of the kernel.
struct Fit {
  int sms;
  int64_t avail;            // dynamic shared memory a block may have
  int64_t share[kSizes];    // ... that it gets at the occupancy its registers
                            // allow, with kMaxThreads >> i threads
};

// The Fit of the current device, read once a device (the kernel opted in
// to avail bytes of dynamic shared memory and to the largest carveout).
template <bool kBicubic, typename T, int kVg, typename Rows>
cudaError_t fit_of(Fit* fit) {
  static std::mutex mu;
  static std::map<int, Fit> fits;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto known = fits.find(device);
  if (known != fits.end()) {
    *fit = known->second;
    return cudaSuccess;
  }
  auto kernel = window_fwd_kernel<kBicubic, T, kVg, Rows>;
  int smem_block = 0, smem_sm = 0, smem_reserved = 0;
  Fit f;
  err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int64_t own = static_cast<int64_t>(attr.sharedSizeBytes);
  f.avail = smem_block - own;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(f.avail));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  for (int i = 0; i < kSizes && err == cudaSuccess; ++i) {
    int resident = 1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kMaxThreads >> i, 0);
    f.share[i] = smem_sm / std::max(resident, 1) - smem_reserved - own;
  }
  if (err != cudaSuccess) return err;
  fits[device] = f;
  *fit = f;
  return cudaSuccess;
}

template <bool kBicubic, typename T, int kVg, typename Rows>
int launch_groups(const void* field, const float* py, const float* px, void* out, int64_t B,
                  int64_t P, int R, int C, int V, cudaStream_t stream, Rows rows) {
  constexpr int kItems = items_of<T>();
  Fit fit;
  const cudaError_t err = fit_of<kBicubic, T, kVg, Rows>(&fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t row_bytes = static_cast<int64_t>(C) * kVg * sizeof(T);
  if (row_bytes > fit.avail) return kNoFit;
  const int64_t n_groups = (V + kVg - 1) / kVg;
  auto n_tiles = [&](int threads) { return rows.tiles(P, threads / kVg * kItems); };
  int size = 0;  // the block: kMaxThreads >> size threads
  while ((kMaxThreads >> size) > kMinThreads &&
         B * n_groups * n_tiles(kMaxThreads >> size) < 8LL * fit.sms)
    ++size;
  const int threads = kMaxThreads >> size;
  const int64_t blocks = B * n_groups * n_tiles(threads);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // the slab: the shared memory one block gets at the occupancy its
  // registers allow, at least a row, at most the field's rows
  const int64_t budget = std::min(fit.avail, std::max(fit.share[size], row_bytes));
  const int slab_rows = static_cast<int>(std::min<int64_t>(budget / row_bytes, R));
  const int64_t smem = slab_rows * row_bytes;
  const bool vec = wide_cell<T, kVg>() && V % kVg == 0 &&
                   reinterpret_cast<uintptr_t>(field) % kCopyBytes == 0;
  window_fwd_kernel<kBicubic, T, kVg, Rows>
      <<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem), stream>>>(
          static_cast<const T*>(field), py, px, static_cast<T*>(out), P, R, C, V,
          static_cast<int>(n_tiles(threads)), static_cast<int>(n_groups), slab_rows, vec, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace window

// Launch the window kernel with the widest channel group whose row fits:
// 16 bytes of channels a cell where V has that many, else one channel; each
// position's taps held to rows.rows(p, R).  Returns the CUDA error of the
// launch (0 on success), cudaErrorInvalidValue where one field row of one
// channel does not fit in shared memory.
template <bool kBicubic, typename T, typename Rows = NoBand>
int launch_window(const void* field, const float* py, const float* px, void* out, int64_t B,
                  int64_t P, int R, int C, int V, cudaStream_t stream, Rows rows = Rows{}) {
  constexpr int kWide = kCopyBytes / static_cast<int>(sizeof(T));
  if (V >= kWide) {
    const int res = window::launch_groups<kBicubic, T, kWide, Rows>(field, py, px, out, B, P, R,
                                                                    C, V, stream, rows);
    if (res != window::kNoFit) return res;
  }
  const int res = window::launch_groups<kBicubic, T, 1, Rows>(field, py, px, out, B, P, R, C, V,
                                                              stream, rows);
  return res == window::kNoFit ? static_cast<int>(cudaErrorInvalidValue) : res;
}

}  // namespace

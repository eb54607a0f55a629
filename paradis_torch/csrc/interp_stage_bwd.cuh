// The backward of the gather-interpolation, for Hopper (sm_90a): one kernel,
// launched by the three backward entry points (interp_bwd.cu, the
// counterpart of paradis_tpu/ops/interp_pallas.py:_bwd_kernel,
// interp_chunk_bwd.cu, of _bwd_kernel_chunked, and interp_band_bwd.cu, of
// _bwd_kernel_banded), so that all three give the same bits of d_py and d_px.
//
//   d_field[b,r,c,v] = sum_p g[b,p,v] * K(py - r) * K(px - c)
//   d_py[b,p,v]      = g * sum_r K'(py - r) * sum_c K(px - c)  * f[b,r,c,v]
//   d_px[b,p,v]      = g * sum_r K(py - r)  * sum_c K'(px - c) * f[b,r,c,v]
//
// K' follows paradis_tpu/ops/interp.py:_dense_kernel_derivative: sign(0) = 0
// and the open support |d| < 1 make it zero at the bilinear kinks.  Layouts
// are channels-last: field and d_field [B,R,C,V], positions, g, d_py and
// d_px [B,P,V].  g is read in its own type (fp32 or bf16); d_field is
// written in the field's type, d_py and d_px in float32.  Taps outside
// [0,R) x [0,C) add to none of the three outputs, and a non-finite position
// has no taps, per position.
//
// The band filter of interp_stage.cuh (NoBand, Band) is a compile-time
// policy here too: a tap row outside rows.rows(p, R), the position's band
// for the row-banded entry point, adds to none of the three outputs.  An
// item's kept rows are its tap rows in [lo, hi) (the field's rows with
// NoBand): from its head row, max(top, lo), to min(top + kN - 1, hi - 1).
//
// Design: the block that owns a cell of d_field computes it.  A block owns
// (b, a group of kVg channels, a slab of rows [r0, r1)): it keeps a zeroed
// float32 accumulator of its slab's d_field in shared memory, stages the
// field's rows [r0, r1 + kN - 1) of its group beside it (the taps' halo
// below the slab), walks the positions of its group, and adds g*K*K of each
// tap in its rows into the accumulator with shared-memory atomics.  The
// slab's d_field is then written once, with plain stores in the field's
// type: no global atomic, no zeroed buffer and no cast pass, and every cell
// of d_field is written by exactly one block.  A (position, channel) item
// belongs to the slab that holds its first kept tap row (its head row):
// that block, whose halo holds all of the item's kept rows, computes d_py
// and d_px whole, in the order of add_bwd_taps() below; a slab that holds
// only the item's later kept rows adds their d_field taps and reads no
// field.  The slabs of a group are adjacent in launch order, so they read
// its positions while these are in L2.
//
// So that a slab does not load every position of its group, a pre-pass
// (span_kernel) reads py once, with whole warps on consecutive channels, and
// writes for each chunk of kSpanPos positions and kWide channels the least
// and greatest head row of its items (its span); a warp of a slab block
// loads the items of a chunk only where the span reaches the slab.  The
// pre-pass also writes the zero d_py and d_px of an item with no kept row
// (NaN and inf too, and with a band an item whose taps all leave it), which
// no slab visits.  The band only removes rows, so spans of the filtered head
// rows still never miss a slab.
//
// kVg is kWide = 2 channels (8-byte fp32 or 4-byte bf16 field cells, 8-byte
// accumulator cells), or 1 where V is 1 or one row of two does not fit.  A
// block has 1024 threads and, its registers allowing one block an SM, all of
// an SM's shared memory: 54 rows at 1.40625 deg in fp32 (3 slabs of 44
// rows, 1,152 blocks), 73 in bf16 (2 slabs of 66, 768 blocks), the whole
// 36-row field at 5.625 deg (384 blocks); slabs are cut shorter only where
// the card would otherwise hold fewer than kWaves blocks a slot.  The
// field's cells are staged with 4-, 8- or 16-byte cp.async where V is a
// multiple of kVg and the field aligned to a cell, else with plain loads
// that zero-fill channels >= V.  Only a field whose slab of one row (and its
// halo) of one channel does not fit in shared memory is refused.
//
// Float order: add_bwd_taps() sums d_py and d_px over a tap row's columns
// first (row_w += wx*f, row_dw += dwx*f), then over the rows in increasing
// order (acc_y += dwy*row_w, acc_x += wy*row_dw), in float32, then
// multiplies by g; one thread computes an item whole, so d_py and d_px are
// bitwise reproducible and the same for both entry points on any positions.
// d_field is not bitwise reproducible: the shared-memory float atomics of
// the up to 16 taps a cell receives land in an order that changes from run
// to run (a bf16 d_field may round to the neighbouring bf16 value).
//
// What bounds it: memory.  At 1.40625 deg (field 1x132x260x768, P = 32768,
// fp32) a launch must read the field (105 MB), both positions and g (302 MB)
// and write d_field (105 MB) and d_py, d_px (201 MB): ~713 MB, 0.21 ms at
// 3.35 TB/s (0.17 ms bf16).  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py; PERF.md section 6), bicubic, fp32 / bf16: 2.19 / 1.97 ms
// there on departure-like positions (the kernels this one replaced, timed
// in turns with it: 4.99 / 4.85 unchunked, 5.04 / 4.93 chunked), ~10x the
// bound; 0.160 / 0.149 at 5.625 deg (0.319 / 0.313), and 0.141 / 0.137 on
// the 5.625 deg train step's own inputs (0.190 / 0.191).  Bilinear it is
// slower than the unchunked one-thread-per-output kernel it replaced (1.89 /
// 1.60 against 1.42 / 1.41 ms at 1.40625 deg): its 4 taps leave the fixed
// costs below in front.  What holds
// it back, from ablations in one call (outputs wrong, times only; ms of the
// 2.19): the pre-pass, staging and stores 0.51, the loads of the visited
// chunks' positions 0.54 (a channel pair is 8 bytes of each 32-byte sector
// of the channels-last arrays; co-scheduling the four blocks that share a
// sector, as a cluster, changed nothing), the taps 0.87 (16 data-dependent
// shared-memory reads an item, serial per thread, one 1024-thread block an
// SM), the atomics 0.27 (a float atomicAdd to shared memory is a
// compare-and-swap loop, ATOMS.CAST.SPIN, on sm_90).  Groups of 4 or 8
// channels, 512-thread blocks two an SM, and loads issued ahead measured no
// faster; a warp-uniform loop over the visited chunks (ballot and ffs) made
// the compare-and-swap loops 3-6x slower.

#pragma once

#include "interp_stage.cuh"

namespace {

namespace slab_bwd {

constexpr int kThreads = 1024;    // threads a block
constexpr int kBlocksPerSm = 1;   // blocks an SM that the registers must allow
constexpr int kWaves = 2;         // blocks a slot (kBlocksPerSm an SM) at least, where rows allow
constexpr int kWide = 2;          // channels a group where V has them, and a span
constexpr int kSpanPos = 32;      // positions a span summarises (a chunk)
constexpr int kSpanThreads = 256;
constexpr int kNoFit = -1;        // plan_of(): one row of the channel group does not fit
static_assert(32 % kWide == 0, "a lane keeps one channel of its group across a chunk's items");

// The span scratch of launch_slab_bwd(): int32 [B, ceil(V / kWide), ceil(P /
// kSpanPos), 2], the (first, last) head row of a chunk's items.
__host__ __device__ constexpr int64_t span_ints(int64_t B, int64_t P, int64_t V) {
  return 2 * B * ((V + kWide - 1) / kWide) * ((P + kSpanPos - 1) / kSpanPos);
}

// The span pre-pass: one thread a (b, chunk of kSpanPos positions, group of
// kWide channels), groups fastest so that a warp's loads of py are
// contiguous.  It writes the least and the greatest head row (the first kept
// tap row) of the chunk's items of the group, (INT_MAX, INT_MIN) where none
// has a kept row; and the zero sums of d_py and d_px of each item without
// one (NaN and inf too), which no slab visits.
template <bool kBicubic, typename TG, typename Rows>
__global__ void __launch_bounds__(kSpanThreads)
span_kernel(const float* __restrict__ pos_y, const TG* __restrict__ grad,
            float* __restrict__ d_py, float* __restrict__ d_px, int2* __restrict__ span,
            int64_t B, int64_t P, int R, int V, Rows rows) {
  using K = Taps<kBicubic>;
  const int64_t n_groups = (V + kWide - 1) / kWide;
  const int64_t n_chunks = (P + kSpanPos - 1) / kSpanPos;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kSpanThreads + threadIdx.x;
  if (idx >= B * n_chunks * n_groups) return;
  const int64_t group = idx % n_groups;
  const int64_t chunk = (idx / n_groups) % n_chunks;
  const int64_t b = idx / (n_groups * n_chunks);
  int lo = INT_MAX, hi = INT_MIN;
  const int64_t p0 = chunk * kSpanPos;
  const int n_pos = static_cast<int>(P - p0 < kSpanPos ? P - p0 : kSpanPos);
#pragma unroll 8
  for (int j = 0; j < n_pos; ++j) {
    const int2 keep = rows.rows(p0 + j, R);  // the rows its taps may use
    const float keep_lo = static_cast<float>(keep.x);
    const float keep_hi = static_cast<float>(keep.y - 1);
#pragma unroll
    for (int q = 0; q < kWide; ++q) {
      const int64_t v = kWide * group + q;
      if (v >= V) continue;
      const int64_t at = (b * P + p0 + j) * V + v;
      const float top = floorf(pos_y[at]) + static_cast<float>(K::kFirst);  // first tap row
      if (top <= keep_hi && top + static_cast<float>(K::kN - 1) >= keep_lo) {
        const int head = static_cast<int>(fmaxf(top, keep_lo));
        lo = min(lo, head);
        hi = max(hi, head);
      } else {
        // no kept tap row: the sums are zero, in the same product as any
        // other item's
        const float g = to_float(grad[at]);
        d_py[at] = g * 0.0f;
        d_px[at] = g * 0.0f;
      }
    }
  }
  span[(b * n_groups + group) * n_chunks + chunk] = make_int2(lo, hi);
}

// A cp.async of 4 or 8 bytes, through L1 (cp.async.cg takes 16 bytes only).
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(kBytes)
               : "memory");
}

template <typename T, int kVg>
__host__ __device__ constexpr int cell_bytes() {
  return kVg * static_cast<int>(sizeof(T));
}

// Whether a cell of kVg channels of T is one cp.async.
template <typename T, int kVg>
__host__ __device__ constexpr bool copy_cell() {
  return cell_bytes<T, kVg>() == 4 || cell_bytes<T, kVg>() == 8 || cell_bytes<T, kVg>() == 16;
}

// A cell's channels, stored as one access.
template <typename T, int kVg>
struct alignas(cell_bytes<T, kVg>()) Cell {
  T v[kVg];
};

// Stage n_cells consecutive cells of one channel group into slab [n_cells,
// kVg]: src points at the group's first channel (v0) of the first cell, a
// cell's channels lie V apart from the next cell's.  With vec (V a multiple
// of kVg, src aligned to a cell) each cell is one cp.async, in flight until
// the caller waits; else plain loads, zero-filling channels v0 + q >= V.
template <typename T, int kVg>
__device__ __forceinline__ void stage_group(T* slab, const T* src, int n_cells, int V, int v0,
                                            bool vec) {
  if constexpr (copy_cell<T, kVg>()) {
    if (vec) {
      for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
        if constexpr (cell_bytes<T, kVg>() == kCopyBytes)
          cp_async16(slab + c * kVg, src + static_cast<int64_t>(c) * V);
        else
          cp_async_ca<cell_bytes<T, kVg>()>(slab + c * kVg, src + static_cast<int64_t>(c) * V);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < n_cells * kVg; e += blockDim.x) {
    const int c = e / kVg, q = e % kVg;
    slab[e] = v0 + q < V ? src[static_cast<int64_t>(c) * V + q] : from_float<T>(0.0f);
  }
}

// The taps of the item (y, x, g) at channel ch of slab rows [r0, r1), whose
// kept tap rows (those in [keep_lo, keep_hi], inside the field) all lie in
// the staged rows f [r0, r1 + kN - 1) when kSums: g*K*K of each kept tap in
// a row of [r0, r1) is added into the accumulator acc [r1 - r0, C, kVg];
// with kSums, the sums of d_py and d_px (without the factor g) are returned
// in *sum_y, *sum_x.  Their float order: over a tap row's columns first, then
// the rows in increasing order.  Other rows, and columns outside the field,
// are skipped (NaN and inf too).
template <bool kBicubic, bool kSums, typename T, int kVg>
__device__ __forceinline__ void add_bwd_taps(float y, float x, float g, const T* f, float* acc,
                                             int ch, int r0, int r1, float keep_lo,
                                             float keep_hi, int C, float* sum_y, float* sum_x) {
  using K = Taps<kBicubic>;
  const float fy = floorf(y);
  const float fx = floorf(x);
  float wy[K::kN], wx[K::kN], dwy[K::kN], dwx[K::kN];
  if constexpr (kSums) {
    K::weights(y - fy, wy, dwy);
    K::weights(x - fx, wx, dwx);
  } else {
    K::weights(y - fy, wy);
    K::weights(x - fx, wx);
  }
  float acc_y = 0.0f, acc_x = 0.0f;
#pragma unroll
  for (int ty = 0; ty < K::kN; ++ty) {
    const float rf = fy + static_cast<float>(K::kFirst + ty);
    if (!(rf >= keep_lo && rf <= keep_hi)) continue;  // outside the field or the band
    const int r = static_cast<int>(rf);
    if (!kSums && r < r0) continue;  // another slab's row
    const bool own = r < r1;
    const int row = (r - r0) * C;
    const float g_row = g * wy[ty];
    float row_w = 0.0f, row_dw = 0.0f;
#pragma unroll
    for (int tx = 0; tx < K::kN; ++tx) {
      const float cf = fx + static_cast<float>(K::kFirst + tx);
      if (!(cf >= 0.0f && cf <= static_cast<float>(C - 1))) continue;
      const int s = (row + static_cast<int>(cf)) * kVg + ch;
      if constexpr (kSums) {
        const float fv = to_float(f[s]);
        row_w += wx[tx] * fv;
        row_dw += dwx[tx] * fv;
      }
      if (own) atomicAdd(acc + s, g_row * wx[tx]);
    }
    if constexpr (kSums) {
      acc_y += dwy[ty] * row_w;
      acc_x += wy[ty] * row_dw;
    }
  }
  if constexpr (kSums) {
    *sum_y = acc_y;
    *sum_x = acc_x;
  }
}

template <bool kBicubic, typename T, typename TG, int kVg, typename Rows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
slab_bwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                const float* __restrict__ pos_x, const TG* __restrict__ grad,
                T* __restrict__ d_field, float* __restrict__ d_py, float* __restrict__ d_px,
                const int2* __restrict__ span, int64_t P, int R, int C, int V, int n_slabs,
                int n_groups, int slab_rows, int64_t acc_at, bool vec_in, bool vec_out,
                Rows rows) {
  using K = Taps<kBicubic>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* f = reinterpret_cast<T*>(smem);                         // [f1 - r0, C, kVg]
  float* acc = reinterpret_cast<float*>(smem + acc_at);      // [r1 - r0, C, kVg]

  const int s = static_cast<int>(blockIdx.x % n_slabs);
  const int group = static_cast<int>((blockIdx.x / n_slabs) % n_groups);
  const int64_t b = blockIdx.x / (static_cast<int64_t>(n_slabs) * n_groups);
  const int v0 = group * kVg;
  const int r0 = s * slab_rows;
  const int r1 = min(r0 + slab_rows, R);         // the rows this block owns
  const int f1 = min(r1 + K::kN - 1, R);         // the rows it stages
  const int a_cells = (r1 - r0) * C;
  // the group's first channel of the batch's first cell
  const int64_t plane = b * R * static_cast<int64_t>(C) * V + v0;

  stage_group<T, kVg>(f, field + plane + static_cast<int64_t>(r0) * C * V, (f1 - r0) * C, V,
                      v0, vec_in);
  cp_async_commit();
  for (int e = threadIdx.x; e < a_cells * kVg; e += kThreads) acc[e] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();  // the field's rows have landed, the accumulator is zero

  // a warp takes the chunks of kSpanPos positions in turn, and skips one
  // whose items' head rows (its span) cannot reach rows [r0, r1); a lane
  // takes items lane, lane + 32, ... of the chunk: position item / kVg,
  // channel v0 + ch (32 is a multiple of kVg, so a lane keeps its channel)
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int ch = lane % kVg;
  const bool ch_ok = v0 + ch < V;
  const int64_t n_chunks = (P + kSpanPos - 1) / kSpanPos;
  const int2* spans = span + (b * ((V + kWide - 1) / kWide) + v0 / kWide) * n_chunks;
  const float first = static_cast<float>(r0);
  const float last = static_cast<float>(r1 - 1);
  for (int64_t c = threadIdx.x / 32; c < n_chunks; c += kThreads / 32) {
    const int2 reach = spans[c];
    if (!(reach.x <= r1 - 1 && reach.y + (K::kN - 1) >= r0)) continue;
    for (int item = lane; item < kSpanPos * kVg; item += 32) {
      const int64_t p = c * kSpanPos + item / kVg;
      if (!(p < P && ch_ok)) continue;
      const int64_t at = (b * P + p) * V + v0 + ch;
      const float y = pos_y[at];
      const int2 keep = rows.rows(p, R);  // the rows its taps may use
      const float keep_lo = static_cast<float>(keep.x);
      const float keep_hi = static_cast<float>(keep.y - 1);
      const float top = floorf(y) + static_cast<float>(K::kFirst);  // first tap row
      float bottom = top + static_cast<float>(K::kN - 1);            // last tap row
      // no kept tap row (NaN and inf too; the span pre-pass wrote its
      // sums), or none in this slab
      if (!(top <= keep_hi && bottom >= keep_lo)) continue;
      const float head = fmaxf(top, keep_lo);  // the first kept tap row
      if constexpr (Rows::kOn) bottom = fminf(bottom, keep_hi);  // the last kept one
      if (!(head <= last && bottom >= first)) continue;
      const float g = to_float(grad[at]);
      const float x = pos_x[at];
      if (head >= first) {  // the item's own slab: its sums, and its taps in [r0, r1)
        float sum_y, sum_x;
        add_bwd_taps<kBicubic, true, T, kVg>(y, x, g, f, acc, ch, r0, r1, keep_lo, keep_hi, C,
                                             &sum_y, &sum_x);
        d_py[at] = g * sum_y;
        d_px[at] = g * sum_x;
      } else {  // a later slab of its kept rows: their d_field taps only
        add_bwd_taps<kBicubic, false, T, kVg>(y, x, g, f, acc, ch, r0, r1, keep_lo, keep_hi, C,
                                              nullptr, nullptr);
      }
    }
  }
  __syncthreads();  // every tap of the slab is in the accumulator

  T* dst = d_field + plane + static_cast<int64_t>(r0) * C * V;
  if (vec_out) {
    for (int c = threadIdx.x; c < a_cells; c += kThreads) {
      Cell<T, kVg> cell;
#pragma unroll
      for (int q = 0; q < kVg; ++q) cell.v[q] = from_float<T>(acc[c * kVg + q]);
      *reinterpret_cast<Cell<T, kVg>*>(dst + static_cast<int64_t>(c) * V) = cell;
    }
  } else {
    for (int e = threadIdx.x; e < a_cells * kVg; e += kThreads) {
      const int c = e / kVg, q = e % kVg;
      if (v0 + q < V) dst[static_cast<int64_t>(c) * V + q] = from_float<T>(acc[e]);
    }
  }
}

// What a launch needs of the card, read once a device (the kernel opted in
// to avail bytes of dynamic shared memory and to the largest carveout):
// its SM count, and the dynamic shared memory a block may have alone
// (avail) and with kBlocksPerSm blocks an SM (share).
struct Fit {
  int sms;
  int64_t avail;
  int64_t share;
};

template <bool kBicubic, typename T, typename TG, int kVg, typename Rows>
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
  auto kernel = slab_bwd_kernel<kBicubic, T, TG, kVg, Rows>;
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
  f.share = std::min<int64_t>(f.avail, smem_sm / kBlocksPerSm - smem_reserved - own);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(f.avail));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  fits[device] = f;
  *fit = f;
  return cudaSuccess;
}

// The launch of one channel group's slabs.
struct Plan {
  int n_groups, n_slabs, slab_rows;
  int64_t acc_at, smem, blocks;
};

// The plan of a launch with groups of kVg channels: cudaSuccess, kNoFit
// where a slab of one row (and its halo) does not fit in shared memory, or
// a CUDA error.
template <bool kBicubic, typename T, typename TG, int kVg, typename Rows>
int plan_of(int64_t B, int R, int C, int V, Plan* plan) {
  constexpr int kHalo = Taps<kBicubic>::kN - 1;
  Fit fit;
  const cudaError_t err = fit_of<kBicubic, T, TG, kVg, Rows>(&fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t f_row = static_cast<int64_t>(C) * cell_bytes<T, kVg>();  // a staged row
  const int64_t a_row = static_cast<int64_t>(C) * kVg * 4;               // an accumulator row
  // the accumulator after the staged rows, 16-byte aligned
  auto acc_at = [&](int64_t rows) { return ((rows + kHalo) * f_row + 15) / 16 * 16; };
  auto smem_of = [&](int64_t rows) { return acc_at(rows) + rows * a_row; };
  if (smem_of(1) > fit.avail) return kNoFit;
  // the rows of a slab: as many as the share of kBlocksPerSm blocks an SM
  // holds (at least one), fewer where the card would hold fewer than kWaves
  // blocks a slot
  const int64_t n_groups = (V + kVg - 1) / kVg;
  int64_t rows = 1;
  while (rows < R && smem_of(rows + 1) <= fit.share) ++rows;
  const int64_t slots = static_cast<int64_t>(fit.sms) * kBlocksPerSm;
  int64_t n_slabs = std::max<int64_t>((R + rows - 1) / rows,
                                      (kWaves * slots + B * n_groups - 1) / (B * n_groups));
  n_slabs = std::min<int64_t>(n_slabs, R);
  const int64_t slab_rows = (R + n_slabs - 1) / n_slabs;
  n_slabs = (R + slab_rows - 1) / slab_rows;
  plan->n_groups = static_cast<int>(n_groups);
  plan->n_slabs = static_cast<int>(n_slabs);
  plan->slab_rows = static_cast<int>(slab_rows);
  plan->acc_at = acc_at(slab_rows);
  plan->smem = smem_of(slab_rows);
  plan->blocks = B * n_groups * n_slabs;
  return plan->blocks > 0x7fffffff ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <bool kBicubic, typename T, typename TG, int kVg, typename Rows>
int launch_slabs(const Plan& plan, const void* field, const float* py, const float* px,
                 const void* grad, void* d_field, float* d_py, float* d_px, const int2* span,
                 int64_t P, int R, int C, int V, cudaStream_t stream, Rows rows) {
  const bool vec_in = copy_cell<T, kVg>() && V % kVg == 0 &&
                      reinterpret_cast<uintptr_t>(field) % cell_bytes<T, kVg>() == 0;
  const bool vec_out = V % kVg == 0 &&
                       reinterpret_cast<uintptr_t>(d_field) % cell_bytes<T, kVg>() == 0;
  slab_bwd_kernel<kBicubic, T, TG, kVg, Rows>
      <<<static_cast<unsigned>(plan.blocks), kThreads, static_cast<size_t>(plan.smem),
         stream>>>(static_cast<const T*>(field), py, px, static_cast<const TG*>(grad),
                   static_cast<T*>(d_field), d_py, d_px, span, P, R, C, V, plan.n_slabs,
                   plan.n_groups, plan.slab_rows, plan.acc_at, vec_in, vec_out, rows);
  return static_cast<int>(cudaGetLastError());
}

// The span pre-pass, then the slabs of the widest channel group whose row
// fits: kWide channels where V has them, else one.  Where neither fits,
// nothing is launched.
template <bool kBicubic, typename T, typename TG, typename Rows>
int launch(const void* field, const float* py, const float* px, const void* grad,
           void* d_field, float* d_py, float* d_px, int2* span, int64_t B, int64_t P, int R,
           int C, int V, cudaStream_t stream, Rows rows) {
  Plan plan;
  int res = V >= kWide ? plan_of<kBicubic, T, TG, kWide, Rows>(B, R, C, V, &plan) : kNoFit;
  const bool wide = res == 0;
  if (res == kNoFit) res = plan_of<kBicubic, T, TG, 1, Rows>(B, R, C, V, &plan);
  if (res == kNoFit) return cudaErrorInvalidValue;
  if (res != 0) return res;
  const int64_t threads = span_ints(B, P, V) / 2;
  span_kernel<kBicubic, TG, Rows>
      <<<static_cast<unsigned>((threads + kSpanThreads - 1) / kSpanThreads), kSpanThreads, 0,
         stream>>>(py, static_cast<const TG*>(grad), d_py, d_px, span, B, P, R, V, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wide ? launch_slabs<kBicubic, T, TG, kWide, Rows>(plan, field, py, px, grad, d_field,
                                                           d_py, d_px, span, P, R, C, V, stream,
                                                           rows)
              : launch_slabs<kBicubic, T, TG, 1, Rows>(plan, field, py, px, grad, d_field, d_py,
                                                       d_px, span, P, R, C, V, stream, rows);
}

template <bool kBicubic, typename T, typename Rows>
int launch_grad(const void* field, const float* py, const float* px, const void* grad,
                void* d_field, float* d_py, float* d_px, int2* span, int64_t B, int64_t P, int R,
                int C, int V, int grad_dtype, cudaStream_t stream, Rows rows) {
  if (grad_dtype == 0)
    return launch<kBicubic, T, float, Rows>(field, py, px, grad, d_field, d_py, d_px, span, B,
                                            P, R, C, V, stream, rows);
  if (grad_dtype == 1)
    return launch<kBicubic, T, __nv_bfloat16, Rows>(field, py, px, grad, d_field, d_py, d_px,
                                                    span, B, P, R, C, V, stream, rows);
  return cudaErrorInvalidValue;
}

}  // namespace slab_bwd

// Launch the backward on the stream: the span pre-pass, then the slabs.
// mode: 0 bilinear, 1 bicubic; dtype (field and d_field), grad_dtype (g):
// 0 float32, 1 bfloat16.  d_field is [B,R,C,V] in the field's type, written
// whole; d_py and d_px are float32 [B,P,V]; span is int32 scratch of
// span_ints(B, P, V) elements (2 * B * ceil(V / 2) * ceil(P / 32)); each
// position's taps are held to rows.rows(p, R).  Returns the CUDA error of
// the launch (0 on success), cudaErrorInvalidValue, with nothing launched,
// for arguments it does not take or where a slab of one row (and its halo)
// of one channel does not fit in shared memory.
template <typename Rows = NoBand>
int launch_slab_bwd(const void* field, const void* pos_y, const void* pos_x, const void* grad,
                    void* d_field, void* d_py, void* d_px, void* span, int64_t B, int64_t P,
                    int R, int C, int V, int mode, int dtype, int grad_dtype, void* stream,
                    Rows rows = Rows{}) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0) return cudaErrorInvalidValue;
  if (grad_dtype != 0 && grad_dtype != 1) return cudaErrorInvalidValue;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  float* dy = static_cast<float*>(d_py);
  float* dx = static_cast<float*>(d_px);
  int2* sp = static_cast<int2*>(span);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && dtype == 0)
    return slab_bwd::launch_grad<true, float, Rows>(field, py, px, grad, d_field, dy, dx, sp, B,
                                                    P, R, C, V, grad_dtype, s, rows);
  if (mode == 1 && dtype == 1)
    return slab_bwd::launch_grad<true, __nv_bfloat16, Rows>(field, py, px, grad, d_field, dy, dx,
                                                            sp, B, P, R, C, V, grad_dtype, s,
                                                            rows);
  if (mode == 0 && dtype == 0)
    return slab_bwd::launch_grad<false, float, Rows>(field, py, px, grad, d_field, dy, dx, sp, B,
                                                     P, R, C, V, grad_dtype, s, rows);
  if (mode == 0 && dtype == 1)
    return slab_bwd::launch_grad<false, __nv_bfloat16, Rows>(field, py, px, grad, d_field, dy,
                                                             dx, sp, B, P, R, C, V, grad_dtype,
                                                             s, rows);
  return cudaErrorInvalidValue;
}

}  // namespace

// The bilinear route of the gather-interpolation, for Hopper (sm_90a): the
// forward and the backward that every entry point launches for mode 0
// (bilinear): the forwards interp_fwd.cu, interp_chunk_fwd.cu and
// interp_band_fwd.cu, counterparts of paradis_tpu/ops/interp_pallas.py's
// _fwd_kernel, _fwd_kernel_chunked and _fwd_kernel_banded, and the backwards
// interp_bwd.cu, interp_chunk_bwd.cu and interp_band_bwd.cu, of _bwd_kernel,
// _bwd_kernel_chunked and _bwd_kernel_banded.  Bicubic keeps the window
// forward of interp_stage.cuh and the row-slab backward of
// interp_stage_bwd.cuh, whose staging was designed around its 16 taps.
//
//   out[b,p,v]       = sum_r K(py - r) * sum_c K(px - c) * f[b,r,c,v]
//   d_field[b,r,c,v] = sum_p g[b,p,v] * K(py - r) * K(px - c)
//   d_py[b,p,v]      = g * sum_r K'(py - r) * sum_c K(px - c)  * f[b,r,c,v]
//   d_px[b,p,v]      = g * sum_r K(py - r)  * sum_c K'(px - c) * f[b,r,c,v]
//
// with K(d) = 1 - |d| on the taps floor(pos) and floor(pos) + 1 (K' as in
// interp_taps.cuh: zero at the kinks).  Layouts are channels-last: field and
// d_field [B,R,C,V], positions, out, g, d_py and d_px [B,H,W,V].  A tap
// outside [0,R) x [0,C), a tap row outside rows.rows(p, R) (the position's
// band, with the Band filter of interp_stage.cuh), and every tap of a
// position that is not finite add to no output.
//
// Design.  Every (position, channel) item has its own departure point, so the
// 32 channels of a position tap 32 unrelated cells: read from device memory,
// each 4- or 2-byte tap costs its own 32-byte sector and an L1 wavefront of its
// own.  So the taps are read from shared memory, where a lane a channel of a
// channels-last window puts the 32 lanes in 32 banks whatever their cells.  A
// block of 256 threads owns (b, a group of 32 channels, a tile of th x tw
// arrival positions) and stages the tile's window of the field, 32 channels a
// cell, 16-byte cp.async: the cells within `halo` of its arrival points,
// shifted to where its first position's taps lie (the median over its 32
// channels; with none finite, the padded arrival point, pad = (R - H) / 2, (C -
// W) / 2), so that a rank's block of positions in the gathered field of the
// spatial layouts, off the field's centre, finds its window too.  Each warp
// sums a run of the tile's positions, a position's 32 channels at a time, so
// that the loads of py, px and g and the stores of out, d_py and d_px are whole
// lines.  An item whose taps leave the window (a position displaced further, or
// not finite, or at the field's or the band's edge) is deferred to a queue and
// summed after the others, its taps from the window where it holds them, else
// from device memory; the window is a guess that costs time, never bits.  The
// backward keeps a float32 accumulator of the window's d_field in shared
// memory, adds each tap's g*K*K there (shared-memory atomics; a deferred tap
// outside the window goes to d_field with a native red.global.add.f32), and
// adds the window's nonzero cells into d_field once at the end, a warp a cell's
// 32 channels: whole lines, not a sector a tap.  d_field is zeroed on the
// stream first; a bf16 d_field is accumulated in a float32 scratch and cast
// after.  Where a channel group's whole field fits in shared memory with
// 64-byte cells (16 fp32 or 32 bf16 channels; 5.625 deg: 144 KB), the forward
// is the resident kernel instead: a block an SM stages the group's whole field
// once and sums a run of its positions with no tap from device memory.
//
// Float order: one thread computes an item whole, over a tap row's columns
// first, then the rows in increasing order, in float32 (acc += wy * (wx0 *
// f0 + wx1 * f1); d_py, d_px as add_bwd_taps() of interp_stage_bwd.cuh), so
// the forward and d_py, d_px are bitwise reproducible, the same on every
// path and from every entry point (a filter that removes no tap changes no
// bit), and those of the window and row-slab kernels bilinear took before.
// d_field is not bitwise reproducible: the atomics land in an order that
// changes from run to run (a bf16 d_field may round to the neighbouring bf16
// value).
//
// What bounds it: memory.  At 1.40625 deg (field 1x130x258x768, P = 32768, V =
// 768) the forward must read the field (103 MB fp32) and both positions (201
// MB) and write the output (101 MB): 0.121 ms at 3.35 TB/s (bf16 0.0905); the
// backward must also read g and write d_field, d_py and d_px: 0.212 / 0.166 ms.
// Measured on an H100 80GB HBM3 at 700 W on the smoke's positions, fp32 / bf16,
// in turns with the kernels this route replaced (tools/bench_bilinear.py;
// PERF.md section 6): the forward 0.276 / 0.234 ms, banded 0.286 / 0.237 (those
// kernels 0.541 / 0.405; F.grid_sample on planes 0.181 / 0.303), resident at
// 5.625 deg 0.0134 / 0.0121 (0.0178 / 0.0161; 0.0104 / 0.0200); the backward
// 0.622 / 0.757, banded 0.635 / 0.774 (1.882 / 1.612; 1.046 / 1.365), at 5.625
// deg 0.048 / 0.058 (0.132 / 0.120; 0.074 / 0.088).  On one rank's block of the
// spatial layouts (rows 64-127 of the whole field) 0.149 / 0.124 forward and
// 0.346 / 0.444 backward, where a window placed at the centred pad gave 0.292 /
// 0.261 and 0.745 / 0.800.  The anchor's load before the staging costs the
// forward 6% in fp32 (0.261 with the window at the centred pad); without the
// launch bounds below, the placement's registers cost a block an SM (the
// forward 0.281-0.331, the banded bf16 backward 0.983).  What holds the forward
// back: the deferred items, the 5% of the smoke's positions drawn anywhere in
// the row, whose taps each cost a 32-byte sector, then restaging the window
// (each field cell ~4 times at 8 x 8 positions, halo 4). A forward reading
// every tap from device memory, larger tiles, a pipelined ring of rows, the
// deferred items' taps prefetched into the queue, and 512-thread blocks were
// tried and were slower.

#pragma once

#include <type_traits>

#include "interp_stage.cuh"

namespace {

namespace bilinear {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;    // channels a block: one a lane
constexpr int kUnroll = 4;    // positions a warp holds at once
constexpr int kQueue = 1024;  // items a block defers to its second pass at most
// blocks an SM the tiled kernels' registers must allow (at most 64 and 80 a
// thread): without these bounds ptxas gave the window's placement code 74
// and 102 registers, 3 and 2 blocks an SM (PERF.md section 6)
constexpr int kFwdBlocks = 4;
constexpr int kBwdBlocks = 3;
constexpr int kResThreads = 1024;  // the resident forward's block: one an SM
constexpr int kResCellBytes = 64;  // and its cell: 16 fp32 or 32 bf16 channels

// The tile of a launch: th x tw arrival positions, the window `halo` cells
// beyond them on every side.
struct Tile {
  int th, tw, halo;
};

__device__ __forceinline__ float load_tap(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_tap(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// A tile's window and where its cells lie: rows [r0, r1), columns [c0, c1)
// of the field, inside it; cell (r, c) at ((r - r0) * (c1 - c0) + c - c0) * 32.
struct Window {
  int r0, r1, c0, c1;
  __device__ __forceinline__ bool holds(int r, int c) const {
    return r >= r0 && r < r1 && c >= c0 && c < c1;
  }
  __device__ __forceinline__ int at(int r, int c) const {
    return ((r - r0) * (c1 - c0) + c - c0) * kLanes;
  }
  __device__ __forceinline__ int cells() const { return (r1 - r0) * (c1 - c0); }
};

// The median of v over the warp's lanes with `valid` (a bitonic sort across
// the lanes), or `none` where no lane has it.
__device__ __forceinline__ int warp_median(int v, bool valid, int none) {
  const unsigned all = 0xffffffffu;
  const int n = __popc(__ballot_sync(all, valid));
  if (n == 0) return none;
  const int lane = static_cast<int>(threadIdx.x % 32);
  int key = valid ? v : INT_MAX;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(all, key, j);
      key = ((lane & j) == 0) == ((lane & k) == 0) ? min(key, other) : max(key, other);
    }
  return __shfl_sync(all, key, n / 2);
}

// Where the taps of a tile's first position (i0, j0) lie, called by a whole
// warp with the lane's channel of it at (y, x), NaN for a lane without one:
// the median over the lanes of round(pos) - (i0, j0) added to (i0, j0), each
// axis over its finite lanes, else `centre` (its padded arrival point).  The
// median holds against the few positions displaced far.
__device__ __forceinline__ int2 anchor_of(float y, float x, int i0, int j0, int2 centre) {
  // clamped before the conversion; a median this far out leaves the window
  // empty, which costs time, never bits
  const auto cell = [](float v) { return static_cast<int>(rintf(fminf(fmaxf(v, -1e7f), 1e7f))); };
  return make_int2(i0 + warp_median(cell(y) - i0, isfinite(y), centre.x - i0),
                   j0 + warp_median(cell(x) - j0, isfinite(x), centre.y - j0));
}

// The window of the tile at arrival rows [i0, i0 + ni) and columns [j0, j0 +
// nj), its first position's taps at anchor: the cells their bilinear taps
// touch when displaced by less than halo from the anchor's offset.
__device__ __forceinline__ Window window_of(int2 anchor, int ni, int nj, int R, int C,
                                            int halo) {
  Window w;
  w.r0 = min(max(anchor.x - halo, 0), R);
  w.r1 = max(min(anchor.x + ni + halo + 1, R), w.r0);
  w.c0 = min(max(anchor.y - halo, 0), C);
  w.c1 = max(min(anchor.y + nj + halo + 1, C), w.c0);
  return w;
}

// Stage the window's cells, channels [v0, v0 + 32) inside V, into win
// [cells, 32]: 16-byte cp.async with vec (V * sizeof(T) a multiple of 16, the
// field 16-byte aligned), else plain loads.  Channels >= V are not written
// (no lane reads them).  Every thread of the block takes part, walking the
// window's copies (its rows' cells' 16-byte parts) kThreads apart without a
// division; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* win, const T* plane, const Window& w, int C, int V,
                                      int v0, bool vec) {
  constexpr int kPer = kCopyBytes / static_cast<int>(sizeof(T));  // channels a copy
  constexpr int kCopies = kLanes / kPer;                           // copies a cell
  const int wc = w.c1 - w.c0;
  const int rows = w.r1 - w.r0;
  if (wc <= 0 || rows <= 0) return;
  if (vec) {
    const int copies = min(kCopies, (V - v0) / kPer);  // V is a multiple of kPer
    const int row_len = wc * kCopies;
    int row = 0, rem = threadIdx.x;
    while (rem >= row_len) {
      rem -= row_len;
      ++row;
    }
    const T* src = plane + (static_cast<int64_t>(w.r0 + row) * C + w.c0) * V;
    T* dst = win + row * wc * kLanes;
    while (row < rows) {
      const int cell = rem / kCopies, part = rem % kCopies;
      if (part < copies)
        cp_async16(dst + cell * kLanes + part * kPer,
                   src + static_cast<int64_t>(cell) * V + part * kPer);
      rem += kThreads;
      while (rem >= row_len) {
        rem -= row_len;
        ++row;
        src += static_cast<int64_t>(C) * V;
        dst += wc * kLanes;
      }
    }
    return;
  }
  const int chans = min(kLanes, V - v0);
  for (int e = threadIdx.x; e < rows * wc * kLanes; e += kThreads) {
    const int cell = e / kLanes, q = e % kLanes;
    if (q >= chans) continue;
    const int r = w.r0 + cell / wc, c = w.c0 + cell % wc;
    win[e] = plane[(static_cast<int64_t>(r) * C + c) * V + q];
  }
}

// Block -> (b, channel group, tile row, tile column), tile columns fastest,
// so that the tiles sharing a window's edge run together and the group's
// field stays in L2 between them.
struct Place {
  int64_t b;
  int v0, i0, ni, j0, nj;
};

__device__ __forceinline__ Place place_of(int H, int W, int n_groups, int tiles_y, int tiles_x,
                                          const Tile& tile) {
  Place pl;
  const int64_t id = blockIdx.x;
  const int tx = static_cast<int>(id % tiles_x);
  const int ty = static_cast<int>((id / tiles_x) % tiles_y);
  const int group = static_cast<int>((id / (static_cast<int64_t>(tiles_x) * tiles_y)) % n_groups);
  pl.b = id / (static_cast<int64_t>(tiles_x) * tiles_y * n_groups);
  pl.v0 = group * kLanes;
  pl.i0 = ty * tile.th;
  pl.ni = min(tile.th, H - pl.i0);
  pl.j0 = tx * tile.tw;
  pl.nj = min(tile.tw, W - pl.j0);
  return pl;
}

// The rows an item's taps may use, [lo, hi] as floats: the field's, or with
// a band the position's band.
template <typename Rows>
__device__ __forceinline__ float2 keep_of(const Rows& rows, int64_t p, int R) {
  const int2 keep = rows.rows(p, R);
  return make_float2(static_cast<float>(keep.x), static_cast<float>(keep.y - 1));
}

// A warp's walk over its run of the tile's positions, row-major: the
// position (i, j) of the tile, p its index in the batch's H x W, `at` the
// element of channel v0 at it in [B,P,V] (the lane adds its channel), and
// keep the rows its taps may use (a band's rows depend on the row alone).
template <typename Rows>
struct Cursor {
  int i, j;
  int64_t p, at;
  float2 keep;
  __device__ __forceinline__ Cursor(const Place& pl, int k, int W, int V, int64_t P,
                                    const Rows& rows, int R) {
    i = k / pl.nj;
    j = k - i * pl.nj;
    p = static_cast<int64_t>(pl.i0 + i) * W + pl.j0 + j;
    at = (pl.b * P + p) * V + pl.v0;
    keep = keep_of(rows, p - j, R);
  }
  __device__ __forceinline__ void next(const Place& pl, int W, int V, const Rows& rows, int R) {
    ++p;
    at += V;
    if (++j == pl.nj) {
      j = 0;
      ++i;
      p += W - pl.nj;
      at += static_cast<int64_t>(W - pl.nj) * V;
      keep = keep_of(rows, p, R);
    }
  }
};

// The forward sum of one item at any position, over its taps in the field
// and in rows keep; tap(r, c) gives the field's value at row r, column c.
// The float order of every path: over a tap row's columns, then the rows.
template <typename Tap>
__device__ __forceinline__ float fwd_sum(float y, float x, float2 keep, float last_c, Tap tap) {
  const float fy = floorf(y), fx = floorf(x);
  const float ty = y - fy, tx = x - fx;
  const float wy[2] = {1.0f - ty, ty}, wx[2] = {1.0f - tx, tx};
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float rf = fy + static_cast<float>(a);
    if (!(rf >= keep.x && rf <= keep.y)) continue;  // outside the field or band, NaN
    const int r = static_cast<int>(rf);
    float row = 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cf = fx + static_cast<float>(e);
      if (!(cf >= 0.0f && cf <= last_c)) continue;
      row += wx[e] * tap(r, static_cast<int>(cf));
    }
    acc += wy[a] * row;
  }
  return acc;
}

// fwd_sum() for an item whose four taps all lie in the staged window (and in
// its rows keep), the first row's two at win[base0], win[base0 + kCol], the
// second's at win[base1], win[base1 + kCol]: the same operations in the same
// order, without a test.
template <int kCol = kLanes, typename T>
__device__ __forceinline__ float fwd_fast(float y, float x, float fy, float fx, const T* win,
                                          int base0, int base1) {
  const float ty = y - fy, tx = x - fx;
  const float wy0 = 1.0f - ty, wx0 = 1.0f - tx;
  float acc = 0.0f;
  float row = 0.0f;
  row += wx0 * to_float(win[base0]);
  row += tx * to_float(win[base0 + kCol]);
  acc += wy0 * row;
  row = 0.0f;
  row += wx0 * to_float(win[base1]);
  row += tx * to_float(win[base1 + kCol]);
  acc += ty * row;
  return acc;
}

// The backward sums of one item (those of d_py and d_px, without the factor
// g), as fwd_sum(); add(r, c, v) adds v, g*K*K of a tap, to d_field at (r,
// c).  The float order of every path.
template <typename Tap, typename Add>
__device__ __forceinline__ float2 bwd_sum(float y, float x, float g, float2 keep, float last_c,
                                          Tap tap, Add add) {
  const float fy = floorf(y), fx = floorf(x);
  float wy[2], wx[2], dwy[2], dwx[2];
  Taps<false>::weights(y - fy, wy, dwy);
  Taps<false>::weights(x - fx, wx, dwx);
  float acc_y = 0.0f, acc_x = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float rf = fy + static_cast<float>(a);
    if (!(rf >= keep.x && rf <= keep.y)) continue;  // outside the field or band, NaN
    const int r = static_cast<int>(rf);
    const float g_row = g * wy[a];
    float row_w = 0.0f, row_dw = 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cf = fx + static_cast<float>(e);
      if (!(cf >= 0.0f && cf <= last_c)) continue;
      const int c = static_cast<int>(cf);
      const float f = tap(r, c);
      add(r, c, g_row * wx[e]);
      row_w += wx[e] * f;
      row_dw += dwx[e] * f;
    }
    acc_y += dwy[a] * row_w;
    acc_x += wy[a] * row_dw;
  }
  return make_float2(acc_y, acc_x);
}

// bwd_sum() for an item whose four taps all lie in the window (and in its
// rows): the same operations in the same order, without a test, d_field
// into the window's accumulator acc.
template <typename T>
__device__ __forceinline__ float2 bwd_fast(float y, float x, float fy, float fx, float g,
                                           const T* win, float* acc, int base, int step) {
  float wy[2], wx[2], dwy[2], dwx[2];
  Taps<false>::weights(y - fy, wy, dwy);
  Taps<false>::weights(x - fx, wx, dwx);
  float acc_y = 0.0f, acc_x = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int s = base + a * step;
    const float g_row = g * wy[a];
    float row_w = 0.0f, row_dw = 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float f = to_float(win[s + e * kLanes]);
      atomicAdd(acc + s + e * kLanes, g_row * wx[e]);
      row_w += wx[e] * f;
      row_dw += dwx[e] * f;
    }
    acc_y += dwy[a] * row_w;
    acc_x += wy[a] * row_dw;
  }
  return make_float2(acc_y, acc_x);
}

// The slots of a warp's deferred items: each lane with `slow` gets the next
// free one of the block's queue (a slot >= kQueue: none left).
__device__ __forceinline__ int queue_slot(bool slow, int* n_slow) {
  const unsigned mask = __ballot_sync(0xffffffffu, slow);
  if (!mask) return -1;
  const int lane = static_cast<int>(threadIdx.x % 32);
  int first = 0;
  if (lane == 0) first = atomicAdd(n_slow, __popc(mask));
  first = __shfl_sync(0xffffffffu, first, 0);
  return slow ? first + __popc(mask & ((1u << lane) - 1u)) : -1;
}

// The forward: a block stages its tile's window, then each warp sums a run
// of the tile's positions, kUnroll at a time, an item (a position and a
// lane's channel) a thread.  An item whose four taps lie in the window (and
// its band) reads them there; any other (a position displaced further, not
// finite, or with a tap at the field's or the band's edge) is deferred to a
// queue in shared memory and summed after the others, a thread an item,
// each tap from the window where it holds it, else from device memory, so
// that a warp's fast items do not wait on its few slow ones.
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
fwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
           const float* __restrict__ pos_x, T* __restrict__ out, int H, int W, int R, int C,
           int V, int n_groups, int tiles_y, int tiles_x, Tile tile, int queue_at, bool vec,
           Rows rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);                    // [cells, 32] of the field
  int* queue = reinterpret_cast<int*>(smem + queue_at);  // deferred items: k * 32 + lane
  __shared__ int n_slow;
  __shared__ int2 anchor;  // where the tile's first position's taps lie
  const Place pl = place_of(H, W, n_groups, tiles_y, tiles_x, tile);
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
  const bool ch_ok = pl.v0 + lane < V;
  const int64_t P = static_cast<int64_t>(H) * W;
  const T* plane = field + pl.b * R * static_cast<int64_t>(C) * V + pl.v0;  // channel v0 of cell 0
  // each warp a run of consecutive positions of the tile, warp 0's from the
  // tile's first, which places the window
  const int n = pl.ni * pl.nj;
  const int per = (n + kWarps - 1) / kWarps;
  const int k_lo = min(n, warp * per), k_hi = min(n, k_lo + per);
  Cursor<Rows> cur(pl, k_lo, W, V, P, rows, R);
  float y[kUnroll], x[kUnroll];
  int64_t at[kUnroll];
  float2 kp[kUnroll];
  auto load = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = cur.at + lane;
      kp[u] = cur.keep;
      y[u] = x[u] = __int_as_float(0x7fc00000);  // NaN: no taps
      if (kb + u < k_hi) {
        if (ch_ok) {
          y[u] = pos_y[at[u]];
          x[u] = pos_x[at[u]];
        }
        cur.next(pl, W, V, rows, R);
      }
    }
  };
  // the window where the tile's first position's taps lie
  const int2 centre = make_int2(pl.i0 + (R - H) / 2, pl.j0 + (C - W) / 2);
  if (threadIdx.x == 0) n_slow = 0;
  load(k_lo);
  if (warp == 0) {
    const int2 a = anchor_of(y[0], x[0], pl.i0, pl.j0, centre);
    if (lane == 0) anchor = a;
  }
  __syncthreads();
  const Window w = window_of(anchor, pl.ni, pl.nj, R, C, tile.halo);
  stage<T>(win, plane, w, C, V, pl.v0, vec);
  cp_async_commit();
  const int wc = w.c1 - w.c0;
  const float r0 = static_cast<float>(w.r0), c0 = static_cast<float>(w.c0);
  const float last_r = static_cast<float>(w.r1 - w.r0 - 2);  // a fast item's first tap row
  const float last_c = static_cast<float>(wc - 2);           // and column, in the window
  const float field_c = static_cast<float>(C - 1);
  // a deferred item's taps: from the window where it holds them, else from
  // device memory
  auto tap_of = [&](int ln) {
    return [=, &w](int r, int c) {
      return w.holds(r, c) ? to_float(win[w.at(r, c) + ln])
                           : load_tap(plane + (static_cast<int64_t>(r) * C + c) * V + ln);
    };
  };
  cp_async_wait<0>();
  __syncthreads();
  for (int kb = k_lo; kb < k_hi; kb += kUnroll) {
    if (kb != k_lo) load(kb);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kb + u >= k_hi) break;  // the same for the whole warp
      const float fy = floorf(y[u]), fx = floorf(x[u]);
      const float ly = fy - r0, lx = fx - c0;
      bool fast = ch_ok && ly >= 0.0f && ly <= last_r && lx >= 0.0f && lx <= last_c;
      if constexpr (Rows::kOn) fast = fast && fy >= kp[u].x && fy + 1.0f <= kp[u].y;
      if (fast) {
        const int base = (static_cast<int>(ly) * wc + static_cast<int>(lx)) * kLanes + lane;
        out[at[u]] =
            from_float<T>(fwd_fast(y[u], x[u], fy, fx, win, base, base + wc * kLanes));
      }
      const int slot = queue_slot(ch_ok && !fast, &n_slow);
      if (slot >= kQueue)  // the queue is full: this item now
        out[at[u]] = from_float<T>(fwd_sum(y[u], x[u], kp[u], field_c, tap_of(lane)));
      else if (slot >= 0)
        queue[slot] = (kb + u) * kLanes + lane;
    }
  }
  __syncthreads();
  const int n_q = min(n_slow, kQueue);
  for (int q = threadIdx.x; q < n_q; q += kThreads) {
    const int ln = queue[q] % kLanes;
    const Cursor<Rows> c(pl, queue[q] / kLanes, W, V, P, rows, R);
    const int64_t a = c.at + ln;
    out[a] = from_float<T>(fwd_sum(pos_y[a], pos_x[a], c.keep, field_c, tap_of(ln)));
  }
}

// The forward for a field whose every cell, 64 bytes of channels (16 fp32 or
// 32 bf16), fits in shared memory with a block's: a block of kResThreads
// owns (b, a channel group, a run of positions), stages the group's whole
// field with 16-byte cp.async, and sums its items from it, a warp 32 / kG
// positions of kG channels at a time, with no tap from device memory (taps
// outside the field or the band are dropped).  At 5.625 deg the field is
// 34 x 66 cells: 144 KB a group, one block an SM.
template <typename T, typename Rows>
__global__ void __launch_bounds__(kResThreads, 1)
resident_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
                const float* __restrict__ pos_x, T* __restrict__ out, int64_t P, int R, int C,
                int V, int n_groups, int n_runs, int64_t run, bool vec, Rows rows) {
  constexpr int kG = kResCellBytes / static_cast<int>(sizeof(T));  // channels a cell
  constexpr int kSub = 32 / kG;                                     // positions a warp step
  constexpr int kStep = kResThreads / kG;                           // positions a block step
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);  // [R * C, kG]
  const int64_t id = blockIdx.x;
  const int64_t p_lo = (id % n_runs) * run;
  const int group = static_cast<int>((id / n_runs) % n_groups);
  const int64_t b = id / (static_cast<int64_t>(n_runs) * n_groups);
  const int64_t p_hi = min(P, p_lo + run);
  const int v0 = group * kG;
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int ch = lane % kG;
  const bool ch_ok = v0 + ch < V;
  const T* plane = field + b * R * static_cast<int64_t>(C) * V + v0;
  stage_cells<T, kG>(slab, plane, R * C, V, v0, vec);
  cp_async_commit();
  const float last_c = static_cast<float>(C - 1);
  const float2 whole = make_float2(0.0f, static_cast<float>(R - 1));
  // item u of this thread: position first + u * kStep, channel v0 + ch
  const int64_t first = p_lo + static_cast<int64_t>(threadIdx.x / 32) * kSub + lane / kG;
  float y[kUnroll], x[kUnroll];
  auto load = [&](int64_t p0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + static_cast<int64_t>(u) * kStep;
      y[u] = x[u] = __int_as_float(0x7fc00000);  // NaN: no taps
      if (p < p_hi && ch_ok) {
        const int64_t at = (b * P + p) * V + v0 + ch;
        y[u] = pos_y[at];
        x[u] = pos_x[at];
      }
    }
  };
  load(first);  // the first positions are on their way while the field lands
  cp_async_wait<0>();
  __syncthreads();
  for (int64_t p0 = first; p0 < p_hi; p0 += static_cast<int64_t>(kUnroll) * kStep) {
    if (p0 != first) load(p0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + static_cast<int64_t>(u) * kStep;
      if (!(p < p_hi && ch_ok)) continue;
      float2 keep = whole;
      if constexpr (Rows::kOn) keep = keep_of(rows, p, R);
      const float fy = floorf(y[u]), fx = floorf(x[u]);
      float acc;
      if (fy >= keep.x && fy + 1.0f <= keep.y && fx >= 0.0f && fx + 1.0f <= last_c) {
        const int base = (static_cast<int>(fy) * C + static_cast<int>(fx)) * kG + ch;
        acc = fwd_fast<kG>(y[u], x[u], fy, fx, slab, base, base + C * kG);
      } else {
        acc = fwd_sum(y[u], x[u], keep, last_c,
                      [&](int r, int c) { return to_float(slab[(r * C + c) * kG + ch]); });
      }
      out[(b * P + p) * V + v0 + ch] = from_float<T>(acc);
    }
  }
}

// The backward: as the forward, d_field added into a float32 accumulator of
// the window in shared memory, which the block adds into d_field once at
// the end (a warp a cell: its 32 channels are one line of d_field); a
// deferred item's d_field goes to the accumulator where the window holds
// the tap, else to d_field itself.  d_field is float32 (the d_field itself,
// or a scratch for a bf16 field), zeroed before the launch.
template <typename T, typename TG, typename Rows>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
bwd_kernel(const T* __restrict__ field, const float* __restrict__ pos_y,
           const float* __restrict__ pos_x, const TG* __restrict__ grad,
           float* __restrict__ d_field, float* __restrict__ d_py, float* __restrict__ d_px,
           int H, int W, int R, int C, int V, int n_groups, int tiles_y, int tiles_x, Tile tile,
           int acc_at, int queue_at, bool vec, Rows rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);                   // [cells, 32] of the field
  float* acc = reinterpret_cast<float*>(smem + acc_at);  // [cells, 32] of d_field
  int* queue = reinterpret_cast<int*>(smem + queue_at);  // deferred items: k * 32 + lane
  __shared__ int n_slow;
  __shared__ int2 anchor;  // where the tile's first position's taps lie
  const Place pl = place_of(H, W, n_groups, tiles_y, tiles_x, tile);
  const int lane = static_cast<int>(threadIdx.x % 32), warp = static_cast<int>(threadIdx.x / 32);
  const bool ch_ok = pl.v0 + lane < V;
  const int64_t P = static_cast<int64_t>(H) * W;
  const int64_t base_at = pl.b * R * static_cast<int64_t>(C) * V + pl.v0;  // channel v0 of cell 0
  const T* plane = field + base_at;
  float* d_plane = d_field + base_at;
  const int n = pl.ni * pl.nj;
  const int per = (n + kWarps - 1) / kWarps;
  const int k_lo = min(n, warp * per), k_hi = min(n, k_lo + per);
  Cursor<Rows> cur(pl, k_lo, W, V, P, rows, R);
  float y[kUnroll], x[kUnroll], g[kUnroll];
  int64_t at[kUnroll];
  float2 kp[kUnroll];
  auto load = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = cur.at + lane;
      kp[u] = cur.keep;
      y[u] = x[u] = __int_as_float(0x7fc00000);  // NaN: no taps
      g[u] = 0.0f;
      if (kb + u < k_hi) {
        if (ch_ok) {
          y[u] = pos_y[at[u]];
          x[u] = pos_x[at[u]];
          g[u] = to_float(grad[at[u]]);
        }
        cur.next(pl, W, V, rows, R);
      }
    }
  };
  // the window where the tile's first position's taps lie
  const int2 centre = make_int2(pl.i0 + (R - H) / 2, pl.j0 + (C - W) / 2);
  if (threadIdx.x == 0) n_slow = 0;
  load(k_lo);
  if (warp == 0) {
    const int2 a = anchor_of(y[0], x[0], pl.i0, pl.j0, centre);
    if (lane == 0) anchor = a;
  }
  __syncthreads();
  const Window w = window_of(anchor, pl.ni, pl.nj, R, C, tile.halo);
  stage<T>(win, plane, w, C, V, pl.v0, vec);
  cp_async_commit();
  for (int e = threadIdx.x; e < w.cells() * (kLanes / 4); e += kThreads)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int wc = w.c1 - w.c0;
  const float r0 = static_cast<float>(w.r0), c0 = static_cast<float>(w.c0);
  const float last_r = static_cast<float>(w.r1 - w.r0 - 2);  // a fast item's first tap row
  const float last_c = static_cast<float>(wc - 2);           // and column, in the window
  const float field_c = static_cast<float>(C - 1);
  // a deferred item's taps, and its d_field: the window and its accumulator
  // where the window holds the tap, else device memory (d_field with a
  // native red.global.add.f32)
  auto tap_of = [&](int ln) {
    return [=, &w](int r, int c) {
      return w.holds(r, c) ? to_float(win[w.at(r, c) + ln])
                           : load_tap(plane + (static_cast<int64_t>(r) * C + c) * V + ln);
    };
  };
  auto add_for = [&](int ln) {
    return [=, &w](int r, int c, float v) {
      if (w.holds(r, c))
        atomicAdd(acc + w.at(r, c) + ln, v);
      else
        atomicAdd(d_plane + (static_cast<int64_t>(r) * C + c) * V + ln, v);
    };
  };
  cp_async_wait<0>();
  __syncthreads();  // the window has landed and its accumulator is zero
  for (int kb = k_lo; kb < k_hi; kb += kUnroll) {
    if (kb != k_lo) load(kb);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kb + u >= k_hi) break;  // the same for the whole warp
      const float fy = floorf(y[u]), fx = floorf(x[u]);
      const float ly = fy - r0, lx = fx - c0;
      bool fast = ch_ok && ly >= 0.0f && ly <= last_r && lx >= 0.0f && lx <= last_c;
      if constexpr (Rows::kOn) fast = fast && fy >= kp[u].x && fy + 1.0f <= kp[u].y;
      if (fast) {
        const int base = (static_cast<int>(ly) * wc + static_cast<int>(lx)) * kLanes + lane;
        const float2 sums = bwd_fast(y[u], x[u], fy, fx, g[u], win, acc, base, wc * kLanes);
        d_py[at[u]] = g[u] * sums.x;
        d_px[at[u]] = g[u] * sums.y;
      }
      const int slot = queue_slot(ch_ok && !fast, &n_slow);
      if (slot >= kQueue) {  // the queue is full: this item now
        const float2 sums =
            bwd_sum(y[u], x[u], g[u], kp[u], field_c, tap_of(lane), add_for(lane));
        d_py[at[u]] = g[u] * sums.x;
        d_px[at[u]] = g[u] * sums.y;
      } else if (slot >= 0) {
        queue[slot] = (kb + u) * kLanes + lane;
      }
    }
  }
  __syncthreads();
  const int n_q = min(n_slow, kQueue);
  for (int q = threadIdx.x; q < n_q; q += kThreads) {
    const int ln = queue[q] % kLanes;
    const Cursor<Rows> c(pl, queue[q] / kLanes, W, V, P, rows, R);
    const int64_t a = c.at + ln;
    const float gv = to_float(grad[a]);
    const float2 sums =
        bwd_sum(pos_y[a], pos_x[a], gv, c.keep, field_c, tap_of(ln), add_for(ln));
    d_py[a] = gv * sums.x;
    d_px[a] = gv * sums.y;
  }
  __syncthreads();  // every tap of the window is in the accumulator
  for (int cell = warp; cell < w.cells(); cell += kWarps) {
    const float val = acc[cell * kLanes + lane];
    if (ch_ok && val != 0.0f)
      atomicAdd(d_plane + (static_cast<int64_t>(w.r0 + cell / wc) * C + w.c0 + cell % wc) * V +
                    lane,
                val);
  }
}

// d_field in bf16 from its float32 scratch.
__global__ void __launch_bounds__(kThreads)
cast_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

// What a launch needs of the card, read once a device and kernel (the
// kernel opted in to avail bytes of dynamic shared memory and to the
// largest carveout): its SM count and the dynamic shared memory a block may
// have.
struct Fit {
  int sms;
  int64_t avail;
};

template <typename Kernel>
cudaError_t fit_of(Kernel kernel, std::map<int, Fit>* fits, std::mutex* mu, Fit* fit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(*mu);
  const auto known = fits->find(device);
  if (known != fits->end()) {
    *fit = known->second;
    return cudaSuccess;
  }
  int smem_block = 0;
  Fit f;
  err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  f.avail = smem_block - static_cast<int64_t>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(f.avail));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  (*fits)[device] = f;
  *fit = f;
  return cudaSuccess;
}

// A launch: its tile, grid and shared memory (the field's window, the
// backward's accumulator, then the queue).
struct Plan {
  Tile tile;
  int n_groups, tiles_y, tiles_x;
  int64_t blocks;
  int acc_at, queue_at, smem;
};

// the forward's tile: 8 x 8 positions in fp32, 8 x 16 in bf16 (a window of
// half the bytes), 4 cells beyond
template <typename T>
constexpr Tile kFwdTile = {8, sizeof(T) == 4 ? 8 : 16, 4};
constexpr Tile kBwdTile = {8, 8, 2};  // the backward's: 8 x 8 positions, 2 cells beyond

// The plan of the tile t for B x (H x W) positions of V channels, with
// `field_cell` bytes of shared memory a window cell for the field and
// `acc_cell` for an accumulator: t cut to the grid.  Returns cudaErrorInvalidValue where
// its shared memory does not fit, or the grid is too large.
inline int plan_of(int64_t B, int H, int W, int V, int64_t field_cell, int64_t acc_cell,
                   const Fit& fit, Tile t, Plan* plan) {
  const int th = std::max(1, std::min(t.th, H)), tw = std::max(1, std::min(t.tw, W));
  plan->tile = {th, tw, t.halo};
  plan->n_groups = (V + kLanes - 1) / kLanes;
  plan->tiles_y = (H + th - 1) / th;
  plan->tiles_x = (W + tw - 1) / tw;
  plan->blocks = B * plan->n_groups * plan->tiles_y * plan->tiles_x;
  const int64_t cells = static_cast<int64_t>(th + 2 * t.halo + 1) * (tw + 2 * t.halo + 1);
  plan->acc_at = static_cast<int>((cells * field_cell + 15) / 16 * 16);
  plan->queue_at = static_cast<int>(plan->acc_at + cells * acc_cell);
  const int64_t smem = static_cast<int64_t>(plan->queue_at) + kQueue * 4;
  if (smem > fit.avail || plan->blocks > 0x7fffffff) return cudaErrorInvalidValue;
  plan->smem = static_cast<int>(smem);
  return 0;
}

// The resident forward where a group's whole field fits in shared memory,
// its runs of positions as many as give each SM one block; 1 where it
// launched, 0 where the field does not fit, or a CUDA error.
template <typename T, typename Rows>
int launch_resident(const void* field, const float* py, const float* px, void* out, int64_t B,
                    int64_t P, int R, int C, int V, cudaStream_t stream, Rows rows) {
  constexpr int kG = kResCellBytes / static_cast<int>(sizeof(T));
  static std::mutex mu;
  static std::map<int, Fit> fits;
  auto kernel = resident_kernel<T, Rows>;
  Fit fit;
  const cudaError_t err = fit_of(kernel, &fits, &mu, &fit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int64_t smem = static_cast<int64_t>(R) * C * kResCellBytes;
  if (smem > fit.avail) return 0;
  const int64_t combos = B * ((V + kG - 1) / kG);
  const int64_t runs = std::max<int64_t>(1, std::min<int64_t>(fit.sms / combos, P));
  const int64_t run = (P + runs - 1) / runs;
  const int64_t blocks = combos * ((P + run - 1) / run);
  if (blocks > 0x7fffffff) return -static_cast<int>(cudaErrorInvalidValue);
  const bool vec = V % kG == 0 && reinterpret_cast<uintptr_t>(field) % kCopyBytes == 0;
  kernel<<<static_cast<unsigned>(blocks), kResThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(field), py, px, static_cast<T*>(out), P, R, C, V,
      static_cast<int>((V + kG - 1) / kG), static_cast<int>((P + run - 1) / run), run, vec,
      rows);
  const cudaError_t launched = cudaGetLastError();
  return launched == cudaSuccess ? 1 : -static_cast<int>(launched);
}

template <typename T, typename Rows>
int launch_fwd(const void* field, const float* py, const float* px, void* out, int64_t B, int H,
               int W, int R, int C, int V, cudaStream_t stream, Rows rows) {
  // the resident kernel where the field fits
  const int resident = launch_resident<T, Rows>(field, py, px, out, B,
                                                static_cast<int64_t>(H) * W, R, C, V, stream, rows);
  if (resident != 0) return resident > 0 ? 0 : -resident;
  static std::mutex mu;
  static std::map<int, Fit> fits;
  auto kernel = fwd_kernel<T, Rows>;
  Fit fit;
  const cudaError_t err = fit_of(kernel, &fits, &mu, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  const int res = plan_of(B, H, W, V, kLanes * sizeof(T), 0, fit, kFwdTile<T>, &plan);
  if (res != 0) return res;
  const bool vec = (static_cast<int64_t>(V) * sizeof(T)) % kCopyBytes == 0 &&
                   reinterpret_cast<uintptr_t>(field) % kCopyBytes == 0;
  kernel<<<static_cast<unsigned>(plan.blocks), kThreads, static_cast<size_t>(plan.smem),
           stream>>>(static_cast<const T*>(field), py, px, static_cast<T*>(out), H, W, R, C, V,
                     plan.n_groups, plan.tiles_y, plan.tiles_x, plan.tile, plan.queue_at, vec,
                     rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TG, typename Rows>
int launch_bwd(const void* field, const float* py, const float* px, const void* grad,
               void* d_field, float* d_py, float* d_px, float* scratch, int64_t B, int H, int W,
               int R, int C, int V, cudaStream_t stream, Rows rows) {
  static std::mutex mu;
  static std::map<int, Fit> fits;
  auto kernel = bwd_kernel<T, TG, Rows>;
  Fit fit;
  cudaError_t err = fit_of(kernel, &fits, &mu, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  const int res = plan_of(B, H, W, V, kLanes * sizeof(T), kLanes * 4, fit, kBwdTile, &plan);
  if (res != 0) return res;
  // a float32 d_field accumulates in place; a bf16 one in the scratch
  constexpr bool kCast = !std::is_same<T, float>::value;
  float* acc = kCast ? scratch : static_cast<float*>(d_field);
  const int64_t n = B * R * static_cast<int64_t>(C) * V;
  err = cudaMemsetAsync(acc, 0, static_cast<size_t>(n) * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (static_cast<int64_t>(V) * sizeof(T)) % kCopyBytes == 0 &&
                   reinterpret_cast<uintptr_t>(field) % kCopyBytes == 0;
  kernel<<<static_cast<unsigned>(plan.blocks), kThreads, static_cast<size_t>(plan.smem),
           stream>>>(static_cast<const T*>(field), py, px, static_cast<const TG*>(grad), acc,
                     d_py, d_px, H, W, R, C, V, plan.n_groups, plan.tiles_y, plan.tiles_x,
                     plan.tile, plan.acc_at, plan.queue_at, vec, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kCast) return static_cast<int>(err);
  const int64_t blocks = std::min<int64_t>((n + kThreads - 1) / kThreads, 8LL * 1024);
  cast_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      acc, static_cast<__nv_bfloat16*>(d_field), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bilinear

// The bilinear forward on the stream: field [B,R,C,V] (dtype 0 float32, 1
// bfloat16), positions [B,P,V] float32 with P = H*W (W > 0 columns an
// arrival row), out [B,P,V] in the field's type; each position's taps held
// to rows.rows(p, R).  Any field and any V are taken.  Returns the CUDA
// error of the launch (0 on success), cudaErrorInvalidValue for arguments it
// does not take.
template <typename Rows = NoBand>
int launch_bilinear_fwd(const void* field, const float* py, const float* px, void* out,
                        int64_t B, int64_t P, int R, int C, int V, int W, int dtype,
                        cudaStream_t stream, Rows rows = Rows{}) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0 || W <= 0 || P % W != 0 ||
      P / W > INT_MAX)
    return cudaErrorInvalidValue;
  const int H = static_cast<int>(P / W);
  if (dtype == 0)
    return bilinear::launch_fwd<float, Rows>(field, py, px, out, B, H, W, R, C, V,
                                                   stream, rows);
  if (dtype == 1)
    return bilinear::launch_fwd<__nv_bfloat16, Rows>(field, py, px, out, B, H, W, R, C,
                                                           V, stream, rows);
  return cudaErrorInvalidValue;
}

// The bilinear backward on the stream: d_field [B,R,C,V] in the field's type
// (written whole), d_py and d_px [B,P,V] float32; g in grad_dtype (0
// float32, 1 bfloat16); scratch a float32 [B,R,C,V] where the field is
// bf16 (unused for a float32 field).  Arguments otherwise as
// launch_bilinear_fwd.
template <typename Rows = NoBand>
int launch_bilinear_bwd(const void* field, const void* pos_y, const void* pos_x,
                        const void* grad, void* d_field, void* d_py, void* d_px, void* scratch,
                        int64_t B, int64_t P, int R, int C, int V, int W, int dtype,
                        int grad_dtype, void* stream, Rows rows = Rows{}) {
  if (B <= 0 || P <= 0 || R <= 0 || C <= 0 || V <= 0 || W <= 0 || P % W != 0 ||
      P / W > INT_MAX || (dtype == 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  const int H = static_cast<int>(P / W);
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  float* dy = static_cast<float*>(d_py);
  float* dx = static_cast<float*>(d_px);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bilinear::launch_bwd;
  if (dtype == 0 && grad_dtype == 0)
    return launch_bwd<float, float, Rows>(field, py, px, grad, d_field, dy, dx, sc, B, H,
                                                W, R, C, V, s, rows);
  if (dtype == 0 && grad_dtype == 1)
    return launch_bwd<float, __nv_bfloat16, Rows>(field, py, px, grad, d_field, dy, dx,
                                                        sc, B, H, W, R, C, V, s, rows);
  if (dtype == 1 && grad_dtype == 0)
    return launch_bwd<__nv_bfloat16, float, Rows>(field, py, px, grad, d_field, dy, dx,
                                                        sc, B, H, W, R, C, V, s, rows);
  if (dtype == 1 && grad_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16, Rows>(
        field, py, px, grad, d_field, dy, dx, sc, B, H, W, R, C, V, s, rows);
  return cudaErrorInvalidValue;
}

}  // namespace

// The contraction kernels of the interpolation microbenchmark, for Hopper
// (sm_90a): the matrix-unit phase of the dense interpolation, isolated
// (paradis_torch/tools/bench_interp.py).
//
// Replaces the TPU microbenchmark kernels of scripts/bench_interp.py:
//
//   mm_kernel      out[p]  = sum_r sum_c cdt(wx[p,c]) * cdt(f[r,c])
//                  wx [BV, P, C] float32, f [BV, R, C] float32
//   mmT_kernel     the same function with wx stored transposed, wxT [BV, C, P]
//   bwd_mm_kernel  the dense backward body with stand-in weights, per plane:
//                    wy[r,p] = py[p]*r, dwy = 0.5*wy              (float32)
//                    wx2     = cdt(concat_p(px[p]*c, 0.5*px[p]*c))  [C, 2P]
//                    tt      = f @ wx2                             [R, 2P]
//                    d_py    = g * sum_r dwy * tt[:, :P]
//                    d_px    = g * sum_r wy  * tt[:, P:]
//                    d_field = sum_p cdt(wy*g)[r,p] * wx2[c,p]      (p < P)
//
// cdt is float32 or bfloat16: a bfloat16 operand is the float32 value
// rounded to nearest even, and every product and sum is float32 (the product
// of two bfloat16 values is exact in float32), as the TPU's bf16 x bf16 ->
// f32 dots.  Every one of the R*C products of each position is formed: the
// kernels never sum f over r first (out = wx . sum_r f would time nothing of
// the contraction the variants exist to time), and bwd_mm forms both halves
// of tt with their own products.
//
// Design.
// - mm and mmT share one kernel and its grid, the card's, not the TPU's.  A
//   work item is one plane and a tile of kMmTile = 128 positions: mm's one
//   contiguous run of 128 * C floats of wx, mmT's C rows of 128 contiguous
//   floats of wxT, P floats apart.  Persistent blocks, as many as fit (the
//   occupancy query, read once a device: two an SM at the bench's R 36,
//   C 68, for both layouts and operand types), each take one contiguous
//   range of items in plane-major order, so f is staged again only when the
//   plane changes.  vb and pb are checked positive and not used: every
//   blocking runs the same launch, to the same bits.  A ring of kMmStages = 3
//   tiles in shared memory is filled by 1-D TMA bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx) as soon as the block is done
//   with a stage, so two tiles are in flight while one is contracted: mm's
//   tile is one copy, issued by thread 0; mmT's is one copy of 512 bytes a
//   row, into rows of cs floats, issued by all eight warps (a bulk copy is a
//   uniform instruction: the copies of a warp's lanes issue one at a time,
//   and 68 of them from one warp held every tile up by ~25%).
//   Where the rows are not 16-byte aligned (mm: C no multiple of 4; mmT: P
//   no multiple of 4; or wx itself), each tile is copied with plain loads
//   into the same layout instead (mm: rows padded to an odd count of
//   float4s; mmT: zero past the tile's end).
//   bf16 operands run on the tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
//   f32): a warp takes 16 positions (the A rows), K = C and N = R are padded
//   with zeros to multiples of 16 and 8, and f's B fragments are staged once
//   a plane, rounded, in fragment order.  Each thread rounds its A values to
//   bf16 in registers.  mm reads them as float4s: the four k of a thread's
//   fragment are four adjacent columns (the same permutation of k in A and
//   B), and A row g is position (g >> 1) + 4 (g & 1), so that the unpadded
//   rows (68 floats) are read without bank conflicts.  mmT's k are in their
//   own order, and A rows g and g + 8 are the adjacent positions 2g, 2g + 1,
//   so a k-step reads four float2s, each one column for both rows: column
//   c = 2t + {0, 1, 8, 9} and position 2g fall in banks 8t + 2g (+1) + const
//   with the row stride cs = 132 = 4 mod 32, so no read conflicts (stride
//   136 would cost the third ring stage of the second block an SM; float32
//   reads rows across the lanes and takes cs = 128).  Only the last,
//   partial k-step masks columns past C.  Four accumulator tiles (by n-tile
//   mod 4) are summed at the end, then across the thread's quad by
//   shuffles.  (f as the A operand, R the M rows and the positions the N
//   columns, pads R to 48 in place of 40 and sums over the M rows across
//   the warp: 240 mma.sync a tile against 200.)
//   float32 operands use the same grid and ring with FMAs on the CUDA cores
//   (no TF32): a warp takes an eighth of the (column float4, row) pairs for
//   4 positions a lane, one broadcast float4 of f feeding 16 FMAs, and the
//   eight partial sums of a position are added in a fixed order in the
//   stage just read.  Every output is formed in one fixed order:
//   deterministic.
// - bwd_mm, bf16 operands: one block of kBwdWarps = 4 warps owns a plane over
//   all P, and each warp takes every fourth tile of 16 positions, whose py,
//   px, g lanes 0-15 load one tile ahead and leave in the warp's own shared
//   memory.  The block first copies the plane's field into shared memory
//   (16-byte loads, all in flight at once) and turns it into f's fragments.
//   Both products run on mma.sync, with A and B generated in registers from
//   the positions (every fragment element once a warp):
//   (1) tt = f @ wx2: the 16 positions are the M rows (row g position 2g,
//       row g + 8 position 2g + 1), R the N columns, C the depth, f's B
//       fragments staged once a plane as in mm (the field rounded to bf16
//       whether it comes as float32 or bf16), each half's A = cdt(px*c) and
//       cdt(0.5*px*c) with mm's k permutation, k-steps unrolled five deep
//       (3% faster).  No column is masked: f's fragments are zero past C.
//       The epilogue weights column
//       r by wy = py*r and sums over the thread's n-tiles, then its quad:
//       d_py = g * 0.5 * sum_r wy*tt1 (0.5 * wy is exact, so this is the
//       same sum of the same products as sum_r dwy*tt1), d_px = g * sum_r
//       wy*tt2.
//   (2) d_field transposed, [C, R] = wx1 [C, P] @ cdt(wy*g) [P, R]: C the M
//       rows (5 m-tiles at C 68), R the N columns (5 n-tiles at R 36), the
//       tile's 16 positions the depth, k 2t, 2t+1, 2t+8, 2t+9 positions 4t ..
//       4t+3 (one float4 of each of py, px, g).  25 tiles where [R, C] takes
//       27.  Each warp keeps its 100 accumulators over its share of P;
//       at the end of the plane each warp leaves its sums in shared memory
//       as [r][c] rows, the four are added in a fixed order and d_field is
//       written once, row by row, in float32: no atomics, the same bits
//       every run.  Cells past R or C are computed and not written.  Where
//       C > 80 or R > 40, the block makes one pass over P for each group of
//       5 m-tiles x kGN n-tiles (phase 1 in the first), and phase 1 loops
//       over the groups of n-tiles; kGN (R 36: 5) is a template parameter,
//       so that no loop over tiles has a runtime count or a predicate.
//   219 registers a thread (ptxas -v, no spills), 62 KB of shared memory:
//   the occupancy query gives two blocks an SM, so the 768 planes run as
//   three rounds of two blocks on each SM (24 SMs take five).  Forcing a
//   third block (168 registers) spilled and ran 9% slower.
// - bwd_mm, float32 operands (never timed by the microbenchmark): the same
//   one block a plane on the CUDA cores, no TF32 (the float32 sums must stay
//   within 2e-5 of the plain version's).  Per tile of 128 positions, (1) a
//   thread per position forms its tt rows (both halves) in registers, 12
//   rows at a time, and its d_py, d_px, and leaves px*c [C] and py*r*g [R]
//   for the tile in shared memory; (2) each thread takes blocks of 4 x 4
//   (r, c) cells and adds the tile's sum_p into its cells of a shared float32
//   d_field.
//
// What bounds them: at the microbenchmark's shapes (BV 768, P 2048, R 36,
// C 68) mm and mmT read 428 MB of wx: 0.13 ms at 3.35 TB/s against 7.7 GFLOP,
// 8 us on the bf16 tensor cores and 0.115 ms at the float32 rate.  So bf16 mm
// and mmT stream wx (their tensor-core work is small beside the copy, hence
// mma.sync and not wgmma's 64-row tiles), and float32 is bound by its FMAs
// about as much as by the stream.  bwd_mm moves 43 MB but does 23 GFLOP
// (30 with its padding: 9,600 mma.sync a plane), 0.023 ms on the bf16 tensor
// cores at their dense peak; float32 is ~0.35 ms of FMAs at the float32 rate.
// What holds them back (H100, bf16, the microbenchmark's shapes): mm runs
// at ~1.3x its bound; mmT at ~1.3x, its 68 row copies a tile streaming ~7%
// slower than mm's one; bwd_mm at ~6x, latency-bound with eight warps an
// SM: a warp issues about half the cycles, phase 1 (tt, 50 mma.sync a tile
// and its epilogue) takes 57% of a block's time, phase 2 17%, the field's
// staging 7% and the per-tile position loads and the final sums the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kThreads = 128;                // bwd_mm float32
constexpr int kBwdTile = kThreads;           // positions per tile, bwd_mm float32
constexpr int kBwdStride = kBwdTile + 4;     // odd count of float4s a row
constexpr int kRowGroup = 12;                // tt rows held in registers, bwd_mm float32

constexpr int kMmTile = 128;                 // positions a work item of mm and mmT
constexpr int kMmThreads = 2 * kMmTile;      // bf16: a warp a block of 16 positions
constexpr int kMmWarps = kMmThreads / 32;
constexpr int kMmLanePos = kMmTile / 32;     // float32: positions a lane
constexpr int kMmStages = 3;                 // the ring of wx tiles
constexpr int kMmSlack = 16;                 // floats past an mm tile that fragment reads touch
constexpr int kMmTStride = kMmTile + 4;      // floats a row of a bf16 mmT tile: 4 mod 32 banks

constexpr int kBwdWarps = 4;                 // bwd_mm bf16: warps a block (a plane)
constexpr int kBwdMmaThreads = 32 * kBwdWarps;
constexpr int kBwdGroup = 5;                 // m-tiles (c) and n-tiles (r) a warp holds
constexpr int kBwdRow = 16 * kBwdGroup + 4;  // floats a row of a warp's d_field sums (4 mod 16)
constexpr int kBwdSums = 8 * kBwdGroup * kBwdRow;  // a warp's d_field sums, [r][c] of a group

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Shared-memory row length for C columns: whole float4s, an odd count of them.
__host__ __device__ __forceinline__ int padded_cols(int C) {
  int c4 = (C + 3) / 4;
  if (c4 % 2 == 0) ++c4;
  return 4 * c4;
}

// Stage one plane of f [R, C] as float32 into f_s [R, cs], zero-padded.
template <typename TF>
__device__ __forceinline__ void stage_plane(const TF* __restrict__ f, float* f_s, int R, int C,
                                            int cs) {
  for (int i = threadIdx.x; i < R * cs; i += blockDim.x) {
    const int r = i / cs, c = i - r * cs;
    f_s[i] = c < C ? load_as_float(f + static_cast<int64_t>(r) * C + c) : 0.0f;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive on `bar` once, and have its current phase wait for `bytes` more.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device to shared memory, counted against the bytes `bar` waits for.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Two float32 values rounded to nearest even as bf16, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a b: A 16 x 16 (row), B 16 x 8 (col) in bf16, d 16 x 8 in float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// Stage one plane of f [R, C] as mma B fragments b_s [KS][NT][32 lanes] of
// uint2 (NT n-tiles, at least (R + 7) / 8): lane (g, t) of n-tile nt and
// k-step kk holds f[8 nt + g] at the columns of its k 2t, 2t+1, 2t+8, 2t+9,
// rounded to bf16 (zero outside R x C): with kAdjacent (mm, bwd_mm) columns
// 16 kk + 4 t + 0..3, else (mmT) the k themselves, 16 kk + 2 t + {0, 1, 8, 9}.
template <bool kAdjacent, typename TF>
__device__ __forceinline__ void stage_fragments(const TF* __restrict__ f, uint2* b_s, int R, int C,
                                                int NT) {
  const int KS = (C + 15) / 16;
#pragma unroll 4
  for (int i = threadIdx.x; i < KS * NT * 32; i += blockDim.x) {
    const int lane = i & 31, blk = i >> 5, kk = blk / NT, tq = lane & 3;
    const int r = 8 * (blk - kk * NT) + (lane >> 2);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = kAdjacent ? 16 * kk + 4 * tq + j : 16 * kk + 2 * tq + (j & 1) + 8 * (j >> 1);
      v[j] = r < R && c < C ? load_as_float(f + static_cast<int64_t>(r) * C + c) : 0.0f;
    }
    b_s[i] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

// Shared memory of one mm / mmT block: the ring's barriers, the ring of
// kMmStages tiles (mm [kMmTile][cs] + slack, mmT [C][cs]; float32
// sums its partial sums [kMmWarps][kMmTile] in the stage it has just read),
// then the plane's f.
__host__ __device__ __forceinline__ int64_t mm_bar_bytes() {
  return 16 * ((kMmStages * 8 + 15) / 16);
}
template <bool kT>
__host__ __device__ __forceinline__ int64_t mm_stage_floats(int C, int cs) {
  if (kT) {
    const int64_t tile = static_cast<int64_t>(C) * cs;
    return tile > kMmWarps * kMmTile ? tile : kMmWarps * kMmTile;
  }
  return static_cast<int64_t>(kMmTile) * (cs > kMmWarps ? cs : kMmWarps) + kMmSlack;
}
template <bool kBf16, bool kT>
int64_t mm_smem(int R, int C, int cs) {
  const int64_t plane = kBf16 ? static_cast<int64_t>((C + 15) / 16) * ((R + 7) / 8) * 32 * 8
                              : static_cast<int64_t>(R) * 16 * ((C + 3) / 4);
  return mm_bar_bytes() + kMmStages * mm_stage_floats<kT>(C, cs) * 4 + plane;
}

// out[plane, p] = sum_r sum_c cdt(w[plane, p, c]) cdt(f[plane, r, c]) (kT:
// w[plane, c, p]) over `items` = BV * tiles work items (plane, tile of
// kMmTile positions), each block one contiguous range of them.  A stage
// holds mm's tile in rows of cs floats a position, mmT's in rows of cs
// floats a column.  bulk: tiles are copied as they are by TMA (mm: cs == C,
// C % 4 == 0; mmT: P % 4 == 0; w 16-byte aligned); else by plain loads into
// the same layout, zero-padded.
template <bool kBf16, bool kT>
__global__ void __launch_bounds__(kMmThreads)
mm_kernel(const float* __restrict__ wx, const float* __restrict__ f, float* __restrict__ out,
          int64_t P, int R, int C, int cs, int64_t tiles, int64_t items, bool bulk) {
  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float* ring = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + mm_bar_bytes());
  const int64_t stage = mm_stage_floats<kT>(C, cs);
  float* plane_s = ring + kMmStages * stage;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int64_t first = items * blockIdx.x / gridDim.x;
  const int64_t count = items * (blockIdx.x + 1) / gridDim.x - first;

  // the tile of the block's i-th item: its plane, first position and length
  auto tile_of = [&](int64_t i, int64_t& plane, int64_t& t0) {
    plane = (first + i) / tiles;
    t0 = (first + i - plane * tiles) * kMmTile;
    return static_cast<int>(min64(kMmTile, P - t0));
  };
  // mmT, thread 0: the i-th item's stage waits for its tile's bytes
  auto arm = [&](int64_t i) {
    int64_t plane, t0;
    const int n = tile_of(i, plane, t0);
    expect_bytes(bars + i % kMmStages, static_cast<unsigned>(n * C * 4));
  };
  // the i-th item's tile into its stage: mm one copy by thread 0, which arms
  // the stage; mmT, once armed, a copy a row, row c by warp c % kMmWarps (a
  // bulk copy is a uniform instruction: a warp issues its lanes' one by one)
  auto fetch = [&](int64_t i) {
    int64_t plane, t0;
    const int n = tile_of(i, plane, t0);
    float* dst = ring + (i % kMmStages) * stage;
    uint64_t* bar = bars + i % kMmStages;
    if constexpr (kT) {
      const float* src = wx + plane * C * P + t0;
      for (int c = lane * kMmWarps + warp; c < C; c += kMmThreads)
        bulk_copy(dst + c * cs, src + c * P, static_cast<unsigned>(n * 4), bar);
    } else {
      expect_bytes(bar, static_cast<unsigned>(n * C * 4));
      bulk_copy(dst, wx + (plane * P + t0) * C, static_cast<unsigned>(n * C * 4), bar);
    }
  };
  const int64_t first_fetches = min64(kMmStages, count);
  if (bulk && t == 0) {
    for (int s = 0; s < kMmStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int64_t i = 0; i < first_fetches; ++i) {
      if constexpr (kT)
        arm(i);
      else
        fetch(i);
    }
  }
  if constexpr (kT) {
    if (bulk) {
      __syncthreads();  // the barriers are armed
      for (int64_t i = 0; i < first_fetches; ++i) fetch(i);
    }
  }

  const int KS = (C + 15) / 16, NT = (R + 7) / 8;  // bf16: k-steps over c, n-tiles over r
  int64_t staged = -1;
  for (int64_t i = 0; i < count; ++i) {
    int64_t plane, t0;
    const int n = tile_of(i, plane, t0);
    float* w_s = ring + (i % kMmStages) * stage;
    const bool restage = plane != staged;  // uniform over the block
    if (restage) {  // bf16: B fragments; float32: f [R][C4] float4s
      if constexpr (kBf16)
        stage_fragments<!kT>(f + plane * R * C, reinterpret_cast<uint2*>(plane_s), R, C, NT);
      else
        stage_plane(f + plane * R * C, plane_s, R, C, 4 * ((C + 3) / 4));
      staged = plane;
    }
    if (!bulk) {
      if constexpr (kT) {
        const float* src = wx + plane * C * P + t0;
        for (int k = t; k < C * kMmTile; k += kMmThreads) {
          const int c = k / kMmTile, q = k - c * kMmTile;
          w_s[c * cs + q] = q < n ? src[static_cast<int64_t>(c) * P + q] : 0.0f;
        }
      } else {
        const float* src = wx + (plane * P + t0) * C;
        for (int k = t; k < n * cs; k += kMmThreads) {
          const int q = k / cs, c = k - q * cs;
          w_s[k] = c < C ? src[static_cast<int64_t>(q) * C + c] : 0.0f;
        }
      }
    }
    if (restage || !bulk) __syncthreads();
    if (bulk) mbar_wait(bars + i % kMmStages, static_cast<unsigned>((i / kMmStages) & 1));
    float* o = out + plane * P + t0;

    if constexpr (kBf16) {
      const uint2* b_s = reinterpret_cast<const uint2*>(plane_s);
      const int g = lane >> 2, tq = lane & 3;
      // A rows g and g + 8: positions row and row + rstep of the tile
      const int row = kT ? 16 * warp + 2 * g : 16 * warp + (g >> 1) + 4 * (g & 1);
      const int rstep = kT ? 1 : 8;
      if (16 * warp < n) {  // uniform over the warp
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
        auto products = [&](int kk, const uint4& a) {  // acc += A B over n-tiles
          const uint2* b = b_s + kk * NT * 32 + lane;
          for (int nt = 0; nt < NT; nt += 4) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (nt + j < NT) mma_bf16(acc[j], a, b[(nt + j) * 32]);
          }
        };
        if constexpr (kT) {
          // k 2t, 2t+1, 2t+8, 2t+9 are columns c, c+1, c+8, c+9 (cs == kMmTStride),
          // each read for both rows as one float2
          auto a_of = [&](int kk, bool masked) {
            const int c = 16 * kk + 2 * tq;
            const float* a_s = w_s + c * kMmTStride + row;
            auto at = [&](int dc) {
              return !masked || c + dc < C
                         ? *reinterpret_cast<const float2*>(a_s + dc * kMmTStride)
                         : make_float2(0.0f, 0.0f);
            };
            const float2 w0 = at(0), w1 = at(1), w8 = at(8), w9 = at(9);
            return make_uint4(pack_bf16(w0.x, w1.x), pack_bf16(w0.y, w1.y), pack_bf16(w8.x, w9.x),
                              pack_bf16(w8.y, w9.y));
          };
          for (int kk = 0; kk < C / 16; ++kk) products(kk, a_of(kk, false));
          if (C % 16) products(C / 16, a_of(C / 16, true));
        } else {
          for (int kk = 0; kk < KS; ++kk) {
            // k 2t, 2t+1, 2t+8, 2t+9 are columns c .. c+3
            const float* a_s = w_s + row * cs + 4 * tq;
            const float4 lo = *reinterpret_cast<const float4*>(a_s + 16 * kk);
            const float4 hi = *reinterpret_cast<const float4*>(a_s + rstep * cs + 16 * kk);
            const int c = 16 * kk + 4 * tq;
            const bool v0 = c < C, v1 = c + 1 < C, v2 = c + 2 < C, v3 = c + 3 < C;
            uint4 a;
            a.x = pack_bf16(v0 ? lo.x : 0.0f, v1 ? lo.y : 0.0f);
            a.y = pack_bf16(v0 ? hi.x : 0.0f, v1 ? hi.y : 0.0f);
            a.z = pack_bf16(v2 ? lo.z : 0.0f, v3 ? lo.w : 0.0f);
            a.w = pack_bf16(v2 ? hi.z : 0.0f, v3 ? hi.w : 0.0f);
            products(kk, a);
          }
        }
        float s_lo = 0.0f, s_hi = 0.0f;  // rows g and g + 8
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_lo += acc[j][0] + acc[j][1];
          s_hi += acc[j][2] + acc[j][3];
        }
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          s_lo += __shfl_xor_sync(0xffffffffu, s_lo, m);
          s_hi += __shfl_xor_sync(0xffffffffu, s_hi, m);
        }
        if (tq == 0 && row < n) o[row] = s_lo;
        if (tq == 1 && row + rstep < n) o[row + rstep] = s_hi;
      }
    } else {
      const int C4 = (C + 3) / 4, Q = C4 * R;
      const float4* w4 = reinterpret_cast<const float4*>(w_s);
      const float4* f4 = reinterpret_cast<const float4*>(plane_s);
      float acc[kMmLanePos][4];
#pragma unroll
      for (int j = 0; j < kMmLanePos; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
      // this warp's share of the (column float4, row) pairs, column-major
      const int qb = Q * (warp + 1) / kMmWarps;
      for (int q = Q * warp / kMmWarps; q < qb;) {
        const int c4 = q / R, r0 = q - c4 * R, r1 = min(R, r0 + qb - q);
        float4 w[kMmLanePos];
#pragma unroll
        for (int j = 0; j < kMmLanePos; ++j) {
          if constexpr (kT) {  // columns 4 c4 .. 4 c4 + 3 of position lane + 32 j
            const float* col = w_s + 4 * c4 * cs + lane + 32 * j;
            const int c = 4 * c4;
            w[j] = make_float4(col[0], c + 1 < C ? col[cs] : 0.0f, c + 2 < C ? col[2 * cs] : 0.0f,
                               c + 3 < C ? col[3 * cs] : 0.0f);
          } else {
            w[j] = w4[(lane + 32 * j) * (cs / 4) + c4];
          }
        }
        for (int r = r0; r < r1; ++r) {
          const float4 fv = f4[r * C4 + c4];
#pragma unroll
          for (int j = 0; j < kMmLanePos; ++j) {
            acc[j][0] = fmaf(w[j].x, fv.x, acc[j][0]);
            acc[j][1] = fmaf(w[j].y, fv.y, acc[j][1]);
            acc[j][2] = fmaf(w[j].z, fv.z, acc[j][2]);
            acc[j][3] = fmaf(w[j].w, fv.w, acc[j][3]);
          }
        }
        q += r1 - r0;
      }
      __syncthreads();  // every warp has read the stage: it takes the partial sums
      float* red = w_s;  // [kMmWarps][kMmTile]
#pragma unroll
      for (int j = 0; j < kMmLanePos; ++j)
        red[warp * kMmTile + lane + 32 * j] = (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
      __syncthreads();
      if (t < n) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < kMmWarps; ++k) sum += red[k * kMmTile + t];
        o[t] = sum;
      }
      // these writes and reads come before the stage's next bulk copy
      if (bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    const bool refill = bulk && i + kMmStages < count;
    if (kT && refill && t == 0) arm(i + kMmStages);
    __syncthreads();  // the block is done with this stage and the plane's f
    if (refill && (kT || t == 0)) fetch(i + kMmStages);
  }
}

// The n-tiles (of 8 rows r) of one group of a bf16 bwd_mm block: the fewest
// groups of at most kBwdGroup, as even as they go (R 36: one group of 5).
int bwd_group_n(int R) {
  const int NT = (R + 7) / 8, groups = (NT + kBwdGroup - 1) / kBwdGroup;
  return (NT + groups - 1) / groups;
}

// Shared memory of one bf16 bwd_mm block, in floats: each warp's d_field sums
// [kBwdWarps][kBwdSums] (first the plane's field [R][C], staged there),
// each warp's py, px, g of a tile [kBwdWarps][3][16], then f's B fragments
// [KS][NT rounded up to groups of gn][32] uint2.
__host__ __device__ __forceinline__ int64_t bwd_mma_pos_offset(int R, int C) {
  const int64_t sums = static_cast<int64_t>(kBwdWarps) * kBwdSums, plane = (R * C + 3) / 4 * 4;
  return sums > plane ? sums : plane;
}
__host__ __device__ __forceinline__ int64_t bwd_mma_frag_offset(int R, int C) {
  return bwd_mma_pos_offset(R, C) + kBwdWarps * 48;
}
int64_t bwd_mma_smem(int R, int C, int gn) {
  const int64_t nt = static_cast<int64_t>(((R + 7) / 8 + gn - 1) / gn) * gn;
  return bwd_mma_frag_offset(R, C) * 4 + static_cast<int64_t>((C + 15) / 16) * nt * 32 * 8;
}

// bwd_mm with bf16 operands on the tensor cores: one block a plane, each warp
// every kBwdWarps-th tile of 16 positions (phase 1: tt and d_py, d_px;
// phase 2: its share of d_field, summed across the warps in a fixed order).
// kGN n-tiles a group: every loop over tiles has a compile-time count and no
// predicate; f's fragments are staged with zero n-tiles up to whole groups,
// so tt is zero past R, and products past C (zero B, or d_field cells not
// written) need no mask either.
template <typename TF, int kGN>
__global__ void __launch_bounds__(kBwdMmaThreads)
bwd_mm_mma_kernel(const TF* __restrict__ field, const float* __restrict__ pos_y,
                  const float* __restrict__ pos_x, const float* __restrict__ grad,
                  float* __restrict__ d_field, float* __restrict__ d_py,
                  float* __restrict__ d_px, int64_t P, int R, int C) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  float* pos_s = red + bwd_mma_pos_offset(R, C) + warp * 48;  // this warp's py, px, g [16] each
  uint2* b_s = reinterpret_cast<uint2*>(red + bwd_mma_frag_offset(R, C));
  const int KS = (C + 15) / 16;                                   // k-steps (m-tiles) over c
  const int groups_n = ((R + 7) / 8 + kGN - 1) / kGN, NT = groups_n * kGN;  // n-tiles over r
  const int groups = (KS + kBwdGroup - 1) / kBwdGroup * groups_n;
  const int64_t plane = blockIdx.x, tiles = (P + 15) / 16;
  const float* py_p = pos_y + plane * P;
  const float* px_p = pos_x + plane * P;
  const float* g_p = grad + plane * P;

  // lanes 0-15: position `lane` of tile `tile`, zero past P
  auto fetch = [&](int64_t tile, float& y, float& x, float& w) {
    const int64_t p = 16 * tile + lane;
    const bool ok = lane < 16 && p < P;
    y = ok ? py_p[p] : 0.0f;
    x = ok ? px_p[p] : 0.0f;
    w = ok ? g_p[p] : 0.0f;
  };
  float ny, nx, ng;  // the warp's next tile (its first loads while the field is staged)
  fetch(warp, ny, nx, ng);

  // the plane's field as it is, into the sums' space, every load in flight at
  // once (16 bytes each where the planes are: field is 16-byte aligned), then
  // its fragments
  const TF* f_p = field + plane * R * C;
  TF* raw = reinterpret_cast<TF*>(red);
  const int bytes = R * C * static_cast<int>(sizeof(TF));
  if (bytes % 16 == 0) {
#pragma unroll 8
    for (int i = t; i < bytes / 16; i += kBwdMmaThreads)
      reinterpret_cast<uint4*>(raw)[i] = reinterpret_cast<const uint4*>(f_p)[i];
  } else {
#pragma unroll 8
    for (int i = t; i < R * C; i += kBwdMmaThreads) raw[i] = f_p[i];
  }
  __syncthreads();
  stage_fragments<true>(raw, b_s, R, C, NT);
  __syncthreads();
  for (int grp = 0; grp < groups; ++grp) {
    const int mt0 = kBwdGroup * (grp / groups_n), nt0 = kGN * (grp % groups_n);
    const float cg = static_cast<float>(16 * mt0 + g), rg = static_cast<float>(8 * nt0 + g);
    // d_field transposed: tile (mt, nt) holds c 16 (mt0 + mt) + g (+ 8), r 8 (nt0 + nt) + 2t (+ 1)
    float acc[kBwdGroup][kGN][4];
#pragma unroll
    for (int mt = 0; mt < kBwdGroup; ++mt)
#pragma unroll
      for (int nt = 0; nt < kGN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    if (grp > 0) fetch(warp, ny, nx, ng);
    // the group's pass over the warp's tiles, with phase 1 in the first
    auto pass = [&](auto with_phase1) {
      for (int64_t tile = warp; tile < tiles; tile += kBwdWarps) {
        __syncwarp();  // every lane has read the last tile's values
        if (lane < 16) {
          pos_s[lane] = ny;
          pos_s[16 + lane] = nx;
          pos_s[32 + lane] = ng;
        }
        __syncwarp();
        fetch(tile + kBwdWarps, ny, nx, ng);

        // phase 1: tt for rows g (position 2g) and g + 8 (2g + 1)
        if constexpr (decltype(with_phase1)::value) {
          const float2 y2 = *reinterpret_cast<const float2*>(pos_s + 2 * g);
          const float2 x2 = *reinterpret_cast<const float2*>(pos_s + 16 + 2 * g);
          const float2 w2 = *reinterpret_cast<const float2*>(pos_s + 32 + 2 * g);
          float sy_lo = 0.0f, sy_hi = 0.0f, sx_lo = 0.0f, sx_hi = 0.0f;
          for (int n0 = 0; n0 < NT; n0 += kGN) {
            float tt1[kGN][4], tt2[kGN][4];
#pragma unroll
            for (int nt = 0; nt < kGN; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) tt1[nt][e] = tt2[nt][e] = 0.0f;
            // k-step kk: k 2t, 2t+1, 2t+8, 2t+9 are columns c0 .. c0 + 3, c0 = 16 kk + 4t
            float c0 = static_cast<float>(4 * tq);
#pragma unroll 5
            for (int kk = 0; kk < KS; ++kk, c0 += 16.0f) {
              float lo[4], hi[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                lo[j] = x2.x * (c0 + static_cast<float>(j));
                hi[j] = x2.y * (c0 + static_cast<float>(j));
              }
              const uint4 a1 = make_uint4(pack_bf16(lo[0], lo[1]), pack_bf16(hi[0], hi[1]),
                                          pack_bf16(lo[2], lo[3]), pack_bf16(hi[2], hi[3]));
              const uint4 a2 = make_uint4(
                  pack_bf16(lo[0] * 0.5f, lo[1] * 0.5f), pack_bf16(hi[0] * 0.5f, hi[1] * 0.5f),
                  pack_bf16(lo[2] * 0.5f, lo[3] * 0.5f), pack_bf16(hi[2] * 0.5f, hi[3] * 0.5f));
              const uint2* b = b_s + (kk * NT + n0) * 32 + lane;
#pragma unroll
              for (int nt = 0; nt < kGN; ++nt) {
                const uint2 bf = b[nt * 32];
                mma_bf16(tt1[nt], a1, bf);
                mma_bf16(tt2[nt], a2, bf);
              }
            }
            const float rn = static_cast<float>(8 * n0 + 2 * tq);
#pragma unroll
            for (int nt = 0; nt < kGN; ++nt) {  // columns r0, r0 + 1 (zero past R)
              const float r0 = rn + static_cast<float>(8 * nt), r1 = r0 + 1.0f;
              const float wl0 = y2.x * r0, wl1 = y2.x * r1, wh0 = y2.y * r0, wh1 = y2.y * r1;
              sy_lo = fmaf(wl1, tt1[nt][1], fmaf(wl0, tt1[nt][0], sy_lo));
              sx_lo = fmaf(wl1, tt2[nt][1], fmaf(wl0, tt2[nt][0], sx_lo));
              sy_hi = fmaf(wh1, tt1[nt][3], fmaf(wh0, tt1[nt][2], sy_hi));
              sx_hi = fmaf(wh1, tt2[nt][3], fmaf(wh0, tt2[nt][2], sx_hi));
            }
          }
#pragma unroll
          for (int m = 1; m <= 2; m <<= 1) {
            sy_lo += __shfl_xor_sync(0xffffffffu, sy_lo, m);
            sy_hi += __shfl_xor_sync(0xffffffffu, sy_hi, m);
            sx_lo += __shfl_xor_sync(0xffffffffu, sx_lo, m);
            sx_hi += __shfl_xor_sync(0xffffffffu, sx_hi, m);
          }
          const int64_t p = 16 * tile + 2 * g;
          if (tq == 0 && p < P) {
            d_py[plane * P + p] = w2.x * (0.5f * sy_lo);
            d_px[plane * P + p] = w2.x * sx_lo;
          }
          if (tq == 1 && p + 1 < P) {
            d_py[plane * P + p + 1] = w2.y * (0.5f * sy_hi);
            d_px[plane * P + p + 1] = w2.y * sx_hi;
          }
        }

        // phase 2: k 2t, 2t+1, 2t+8, 2t+9 are the tile's positions 4t .. 4t+3
        const float4 y4 = *reinterpret_cast<const float4*>(pos_s + 4 * tq);
        const float4 x4 = *reinterpret_cast<const float4*>(pos_s + 16 + 4 * tq);
        const float4 w4 = *reinterpret_cast<const float4*>(pos_s + 32 + 4 * tq);
        uint2 b[kGN];  // cdt(py*r*g), r = 8 (nt0 + nt) + g
#pragma unroll
        for (int nt = 0; nt < kGN; ++nt) {
          const float rf = rg + static_cast<float>(8 * nt);
          b[nt] = make_uint2(pack_bf16((y4.x * rf) * w4.x, (y4.y * rf) * w4.y),
                             pack_bf16((y4.z * rf) * w4.z, (y4.w * rf) * w4.w));
        }
#pragma unroll
        for (int mt = 0; mt < kBwdGroup; ++mt) {  // cdt(px*c), c = 16 (mt0 + mt) + g (+ 8)
          const float c0 = cg + static_cast<float>(16 * mt), c1 = c0 + 8.0f;
          const uint4 a =
              make_uint4(pack_bf16(x4.x * c0, x4.y * c0), pack_bf16(x4.x * c1, x4.y * c1),
                         pack_bf16(x4.z * c0, x4.w * c0), pack_bf16(x4.z * c1, x4.w * c1));
#pragma unroll
          for (int nt = 0; nt < kGN; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
      }
    };
    if (grp == 0)
      pass(std::true_type());
    else
      pass(std::false_type());

    // each warp's sums as the group's [r][c] (rows 2t, 2t+1 and columns g of a
    // tile are banks 8t + g: no conflicts), then the four added in one fixed
    // order, d_field written once, row by row
    float* mine = red + warp * kBwdSums + (2 * tq) * kBwdRow + g;
#pragma unroll
    for (int mt = 0; mt < kBwdGroup; ++mt)
#pragma unroll
      for (int nt = 0; nt < kGN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(8 * nt + (e & 1)) * kBwdRow + 16 * mt + 8 * (e >> 1)] = acc[mt][nt][e];
    __syncthreads();
    const int rows = min(8 * kGN, R - 8 * nt0), cols = min(16 * kBwdGroup, C - 16 * mt0);
    float* out = d_field + (plane * R + 8 * nt0) * C + 16 * mt0;
    int r = t / cols, c = t - r * cols;  // cell t, then steps of kBwdMmaThreads cells
    const int step_r = kBwdMmaThreads / cols, step_c = kBwdMmaThreads - step_r * cols;
    for (; r < rows; r += step_r) {
      float v = red[r * kBwdRow + c];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) v += red[w * kBwdSums + r * kBwdRow + c];
      out[r * C + c] = v;
      c += step_c;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
    __syncthreads();  // the sums are read before the next group writes its own
  }
}

// bwd_mm with float32 operands on the CUDA cores: one block a plane, tiles of
// kBwdTile positions, d_field summed in the block's shared memory.
template <typename TF>
__global__ void __launch_bounds__(kThreads)
bwd_mm_f32_kernel(const TF* __restrict__ field, const float* __restrict__ pos_y,
                  const float* __restrict__ pos_x, const float* __restrict__ grad,
                  float* __restrict__ d_field, float* __restrict__ d_py, float* __restrict__ d_px,
                  int64_t P, int R, int C, int cs) {
  extern __shared__ float4 smem4[];
  const int RB = (R + 3) / 4, CB = (C + 3) / 4;  // 4 x 4 cell blocks: rows rb + i*RB
  float* f_s = reinterpret_cast<float*>(smem4);  // [R, cs]
  float* wx_s = f_s + R * cs;                    // [4*CB, kBwdStride]: px*c
  float* wyg_s = wx_s + 4 * CB * kBwdStride;     // [4*RB, kBwdStride]: py*r*g
  float* df_s = wyg_s + 4 * RB * kBwdStride;     // [R, C] float32 d_field
  const float4* f_s4 = reinterpret_cast<const float4*>(f_s);
  const int c4n = cs / 4;
  const int64_t plane = blockIdx.x;
  const int t = threadIdx.x;

  stage_plane(field + plane * R * C, f_s, R, C, cs);
  for (int i = t; i < R * C; i += kThreads) df_s[i] = 0.0f;

  for (int64_t t0 = 0; t0 < P; t0 += kBwdTile) {
    const int64_t p = t0 + t;
    const bool valid = p < P;
    const float py = valid ? pos_y[plane * P + p] : 0.0f;
    const float px = valid ? pos_x[plane * P + p] : 0.0f;
    const float g = valid ? grad[plane * P + p] : 0.0f;
    __syncthreads();  // f_s and df_s ready; the previous tile's phase 2 is done
    for (int c = 0; c < 4 * CB; ++c)
      wx_s[c * kBwdStride + t] = c < C ? px * static_cast<float>(c) : 0.0f;
    for (int r = 0; r < 4 * RB; ++r)
      wyg_s[r * kBwdStride + t] = r < R ? (py * static_cast<float>(r)) * g : 0.0f;

    // phase 1: tt = f @ wx2 for this position, both halves, and d_py, d_px
    float acc_y = 0.0f, acc_x = 0.0f;
    for (int r0 = 0; r0 < R; r0 += kRowGroup) {
      float t1[kRowGroup], t2[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) t1[i] = t2[i] = 0.0f;
      for (int c4 = 0; c4 < CB; ++c4) {
        float w1[4], w2[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * c4 + k;
          const float wxa = px * static_cast<float>(c);
          w1[k] = c < C ? wxa : 0.0f;
          w2[k] = c < C ? wxa * 0.5f : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
          if (r0 + i < R) {  // uniform over the block
            const float4 fv = f_s4[(r0 + i) * c4n + c4];
            t1[i] = fmaf(fv.x, w1[0], t1[i]);
            t1[i] = fmaf(fv.y, w1[1], t1[i]);
            t1[i] = fmaf(fv.z, w1[2], t1[i]);
            t1[i] = fmaf(fv.w, w1[3], t1[i]);
            t2[i] = fmaf(fv.x, w2[0], t2[i]);
            t2[i] = fmaf(fv.y, w2[1], t2[i]);
            t2[i] = fmaf(fv.z, w2[2], t2[i]);
            t2[i] = fmaf(fv.w, w2[3], t2[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        if (r0 + i < R) {
          const float wy = py * static_cast<float>(r0 + i);
          acc_y = fmaf(wy * 0.5f, t1[i], acc_y);
          acc_x = fmaf(wy, t2[i], acc_x);
        }
      }
    }
    if (valid) {
      d_py[plane * P + p] = g * acc_y;
      d_px[plane * P + p] = g * acc_x;
    }
    __syncthreads();  // wx_s and wyg_s hold the whole tile

    // phase 2: d_field[r,c] += sum_p wyg[r,p] * wx[c,p] over the tile
    for (int b = t; b < RB * CB; b += kThreads) {
      const int rb = b / CB, cb = b - rb * CB;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
      for (int q = 0; q < kBwdTile; q += 4) {
        float4 a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(wyg_s + (rb + i * RB) * kBwdStride + q);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = *reinterpret_cast<const float4*>(wx_s + (cb + k * CB) * kBwdStride + q);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[i][k] = fmaf(a[i].x, w[k].x, acc[i][k]);
            acc[i][k] = fmaf(a[i].y, w[k].y, acc[i][k]);
            acc[i][k] = fmaf(a[i].z, w[k].z, acc[i][k]);
            acc[i][k] = fmaf(a[i].w, w[k].w, acc[i][k]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = rb + i * RB, c = cb + k * CB;
          if (r < R && c < C) df_s[r * C + c] += acc[i][k];  // this thread's cell alone
        }
    }
  }
  __syncthreads();
  for (int i = t; i < R * C; i += kThreads) d_field[plane * R * C + i] = df_s[i];
}

// Opt the kernel into `smem` bytes of dynamic shared memory, or refuse.
template <typename Kernel>
int set_smem(Kernel kernel, int64_t smem) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return cudaErrorInvalidValue;  // R x C too large for one block
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

// What an mm launch needs of the card and of one instantiation of mm_kernel.
struct MmFit {
  int sms;
  int smem_block;     // dynamic shared memory a block may have (opted in)
  int smem_sm;        // shared memory of an SM
  int smem_reserved;  // ... of it that the system keeps for each block
  int resident;       // blocks an SM as the registers and threads allow
};

// The MmFit of the current device, read once a device.
template <bool kBf16, bool kT>
cudaError_t mm_fit(MmFit* fit) {
  static std::mutex mu;
  static std::map<int, MmFit> fits;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto known = fits.find(device);
  if (known != fits.end()) {
    *fit = known->second;
    return cudaSuccess;
  }
  auto kernel = mm_kernel<kBf16, kT>;
  MmFit m;
  err = cudaDeviceGetAttribute(&m.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&m.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&m.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&m.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, m.smem_block);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m.resident, kernel, kMmThreads, 0);
  if (err != cudaSuccess) return err;
  fits[device] = m;
  *fit = m;
  return cudaSuccess;
}

// mm (kT: mmT) on a persistent grid: as many blocks as fit on the card, or
// one an item.
template <bool kBf16, bool kT>
int launch_mm(const float* wx, const float* f, float* out, int64_t BV, int64_t P, int R, int C,
              cudaStream_t stream) {
  MmFit fit;
  const cudaError_t err = mm_fit<kBf16, kT>(&fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bulk = (kT ? P % 4 == 0 : C % 4 == 0) && reinterpret_cast<uintptr_t>(wx) % 16 == 0;
  // mmT: a row of C; bf16 reads it in column pairs, unpadded float32 in rows
  const int cs = kT ? (kBf16 ? kMmTStride : kMmTile) : bulk ? C : padded_cols(C);
  const int64_t smem = mm_smem<kBf16, kT>(R, C, cs);
  if (smem > fit.smem_block) return cudaErrorInvalidValue;  // R x C too large for one block
  const int64_t tiles = (P + kMmTile - 1) / kMmTile, items = BV * tiles;
  const int64_t resident = std::max<int64_t>(
      1, std::min<int64_t>(fit.resident, fit.smem_sm / (smem + fit.smem_reserved)));
  const int64_t grid = std::min<int64_t>(items, fit.sms * resident);
  mm_kernel<kBf16, kT><<<static_cast<unsigned>(grid), kMmThreads, static_cast<size_t>(smem),
                         stream>>>(wx, f, out, P, R, C, cs, tiles, items, bulk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TF, bool kBf16>
int launch_bwd(const void* field, const float* py, const float* px, const float* g,
               float* d_field, float* d_py, float* d_px, int64_t BV, int64_t P, int R, int C,
               cudaStream_t stream) {
  if (BV > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(BV);
  if constexpr (kBf16) {
    const int gn = bwd_group_n(R);
    const int64_t smem = bwd_mma_smem(R, C, gn);
    auto kernel = gn == 5   ? bwd_mm_mma_kernel<TF, 5>
                  : gn == 4 ? bwd_mm_mma_kernel<TF, 4>
                  : gn == 3 ? bwd_mm_mma_kernel<TF, 3>
                  : gn == 2 ? bwd_mm_mma_kernel<TF, 2>
                            : bwd_mm_mma_kernel<TF, 1>;
    const int err = set_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, kBwdMmaThreads, static_cast<size_t>(smem), stream>>>(
        static_cast<const TF*>(field), py, px, g, d_field, d_py, d_px, P, R, C);
  } else {
    const int cs = padded_cols(C);
    const int RB = (R + 3) / 4, CB = (C + 3) / 4;
    const int64_t smem = (static_cast<int64_t>(R) * cs + 4 * (RB + CB) * kBwdStride +
                          static_cast<int64_t>(R) * C) * 4;
    auto kernel = bwd_mm_f32_kernel<TF>;
    const int err = set_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
        static_cast<const TF*>(field), py, px, g, d_field, d_py, d_px, P, R, C, cs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kT>
int dispatch_mm(const void* w, const void* f, void* out, long long BV, long long P, int R, int C,
                int vb, int pb, int cdt, void* stream) {
  if (BV <= 0 || P <= 0 || R <= 0 || C <= 0 || vb <= 0 || pb <= 0) return cudaErrorInvalidValue;
  if (cdt != 0 && cdt != 1) return cudaErrorInvalidValue;
  const float* wp = static_cast<const float*>(w);
  const float* fp = static_cast<const float*>(f);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cdt == 1 ? launch_mm<true, kT>(wp, fp, o, BV, P, R, C, s)
                  : launch_mm<false, kT>(wp, fp, o, BV, P, R, C, s);
}

}  // namespace

// wx [BV, P, C] float32, f [BV, R, C] float32, out [BV, P] float32, all
// contiguous.  vb, pb (the TPU's channel and position blocks) must be
// positive and shape nothing: the grid is mm's own.  cdt: 0 float32, 1
// bfloat16 operands.  Returns the CUDA error of the launch (0 on success).
extern "C" int paradis_interp_mm(const void* wx, const void* f, void* out, long long BV,
                                 long long P, int R, int C, int vb, int pb, int cdt,
                                 void* stream) {
  return dispatch_mm<false>(wx, f, out, BV, P, R, C, vb, pb, cdt, stream);
}

// The same function with wxT [BV, C, P], on the same persistent grid; vb, pb
// as for mm.
extern "C" int paradis_interp_mmT(const void* wxT, const void* f, void* out, long long BV,
                                  long long P, int R, int C, int vb, int pb, int cdt,
                                  void* stream) {
  return dispatch_mm<true>(wxT, f, out, BV, P, R, C, vb, pb, cdt, stream);
}

// field [BV, R, C] float32 (field_dtype 0) or bfloat16 (1); py, px, g, d_py,
// d_px [BV, P] float32; d_field [BV, R, C] float32, written whole.  cdt: 0
// float32, 1 bfloat16 operands.  Returns the CUDA error of the launch.
extern "C" int paradis_interp_bwd_mm(const void* field, const void* pos_y, const void* pos_x,
                                     const void* grad, void* d_field, void* d_py, void* d_px,
                                     long long BV, long long P, int R, int C, int field_dtype,
                                     int cdt, void* stream) {
  if (BV <= 0 || P <= 0 || R <= 0 || C <= 0) return cudaErrorInvalidValue;
  const float* py = static_cast<const float*>(pos_y);
  const float* px = static_cast<const float*>(pos_x);
  const float* g = static_cast<const float*>(grad);
  float* df = static_cast<float*>(d_field);
  float* dy = static_cast<float*>(d_py);
  float* dx = static_cast<float*>(d_px);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (field_dtype == 0 && cdt == 0)
    return launch_bwd<float, false>(field, py, px, g, df, dy, dx, BV, P, R, C, s);
  if (field_dtype == 0 && cdt == 1)
    return launch_bwd<float, true>(field, py, px, g, df, dy, dx, BV, P, R, C, s);
  if (field_dtype == 1 && cdt == 0)
    return launch_bwd<__nv_bfloat16, false>(field, py, px, g, df, dy, dx, BV, P, R, C, s);
  if (field_dtype == 1 && cdt == 1)
    return launch_bwd<__nv_bfloat16, true>(field, py, px, g, df, dy, dx, BV, P, R, C, s);
  return cudaErrorInvalidValue;
}

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
// the contraction the variants exist to time).
//
// Design.
// - mm (since its Hopper redesign): the grid is the card's, not the TPU's.
//   A work item is one plane and a tile of kMmTile = 128 positions, i.e. one
//   contiguous run of 128 * C floats of wx.  Persistent blocks, as many as
//   fit (the occupancy query, read once a device: two an SM at the bench's
//   R 36, C 68), each take one contiguous range of items in plane-major
//   order, so f is staged again only when the plane changes.  vb and pb are
//   checked positive and not used: every blocking runs the same launch, to
//   the same bits.  A ring of kMmStages = 3 tiles in shared memory: thread 0
//   fills a stage with one 1-D TMA bulk copy (cp.async.bulk ...
//   mbarrier::complete_tx) as soon as the block is done with it, so two
//   tiles are in flight while one is contracted.  Where C is no multiple of
//   4 (rows not 16-byte aligned), each tile is copied with plain loads into
//   rows padded to an odd count of float4s instead.
//   bf16 operands run on the tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
//   f32): a warp takes 16 positions (the A rows), K = C and N = R are padded
//   with zeros to multiples of 16 and 8, and f's B fragments are staged once
//   a plane, rounded, in fragment order.  Each thread reads A as float4s and
//   rounds them to bf16 in registers: the four k of a thread's fragment are
//   four adjacent columns (the same permutation of k in A and B), and A row g
//   is position (g >> 1) + 4 (g & 1), so that the unpadded rows (68 floats)
//   are read without bank conflicts.  Four accumulator tiles (by n-tile mod
//   4) are summed at the end, then across the thread's quad by shuffles.
//   float32 operands use the same grid and ring with FMAs on the CUDA cores
//   (no TF32): a warp takes an eighth of the (column float4, row) pairs for
//   4 positions a lane, one broadcast float4 of f feeding 16 FMAs, and the
//   eight partial sums of a position are added in a fixed order in the
//   stage just read.  Every output is formed in one fixed order:
//   deterministic.  What holds mm back now (H100): bf16 runs at ~1.3x its
//   bound, ~1.1x the time torch takes to sum wx once; float32 at ~2x, its
//   FMAs and the stream only partly overlapped.
// - mmT: a block takes vb (b,v) planes and a block of pb positions (the
//   variant's channel and position blocks) and stages f a plane in shared
//   memory; wxT's [C, P] layout is coalesced across threads as it stands,
//   so each thread reads 4 columns of its 4 positions straight from device
//   memory, the next 4 columns while these run over the rows,
//   and one broadcast float4 of f feeds 16 FMAs into 16 partial sums.
// - bwd_mm: one block owns a plane over all P, so d_field is summed in the
//   block's shared memory in a fixed order, with no atomics (deterministic).
//   Per tile of 128 positions, (1) a thread per position forms its tt rows
//   (both halves) in registers, 12 rows at a time, and its d_py, d_px, and
//   leaves cdt(wy*g) [R] and wx2's first half [C] for the tile in shared
//   memory; (2) each thread takes blocks of 4 x 4 (r, c) cells and adds the
//   tile's sum_p into its cells of a shared float32 d_field.  (A block of a
//   thread per cell block, 160 at R 36, C 68, ran slower: two blocks an SM in
//   place of three.)
//
// What bounds them: at the microbenchmark's shapes (BV 768, P 2048, R 36,
// C 68) mm and mmT read 428 MB of wx: 0.13 ms at 3.35 TB/s against 7.7 GFLOP,
// 8 us on the bf16 tensor cores and 0.115 ms at the float32 rate.  So bf16 mm
// streams wx (its tensor-core work is small beside the copy, hence mma.sync
// and not wgmma's 64-row tiles), and float32 mm is bound by its FMAs about
// as much as by the stream.  bwd_mm moves 43 MB but does 23 GFLOP, which on
// the CUDA cores is ~0.35 ms at the float32 rate against 0.023 ms on the
// tensor cores; mmT and bwd_mm are still CUDA-core kernels in the TPU's
// blocking.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>

namespace {

constexpr int kThreads = 128;                // mmT, bwd_mm
constexpr int kMmTPos = 4;                   // positions per thread, mmT
constexpr int kMmTTile = kThreads * kMmTPos;
constexpr int kBwdTile = kThreads;           // positions per tile, bwd_mm
constexpr int kBwdStride = kBwdTile + 4;     // odd count of float4s a row
constexpr int kRowGroup = 12;                // tt rows held in registers, bwd_mm

constexpr int kMmTile = 128;                 // positions a work item of mm
constexpr int kMmThreads = 2 * kMmTile;      // bf16: a warp a block of 16 positions
constexpr int kMmWarps = kMmThreads / 32;
constexpr int kMmLanePos = kMmTile / 32;     // float32: positions a lane
constexpr int kMmStages = 3;                 // the ring of wx tiles
constexpr int kMmSlack = 16;                 // floats past a tile that fragment reads touch

template <bool kBf16>
__device__ __forceinline__ float round_cdt(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

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

// Stage one plane of f [R, C] as cdt values into f_s [R, cs], zero-padded.
template <bool kBf16, typename TF>
__device__ __forceinline__ void stage_plane(const TF* __restrict__ f, float* f_s, int R, int C,
                                            int cs) {
  for (int i = threadIdx.x; i < R * cs; i += blockDim.x) {
    const int r = i / cs, c = i - r * cs;
    f_s[i] = c < C ? round_cdt<kBf16>(load_as_float(f + static_cast<int64_t>(r) * C + c)) : 0.0f;
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

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device to shared memory; the phase of `bar` completes when it lands.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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
// uint2: lane (g, t) of n-tile nt and k-step kk holds f[8 nt + g]
// [16 kk + 4 t + 0..3] rounded to bf16 (zero outside R x C).
__device__ __forceinline__ void stage_fragments(const float* __restrict__ f, uint2* b_s, int R,
                                                int C) {
  const int KS = (C + 15) / 16, NT = (R + 7) / 8;
  for (int i = threadIdx.x; i < KS * NT * 32; i += blockDim.x) {
    const int lane = i & 31, blk = i >> 5, kk = blk / NT;
    const int r = 8 * (blk - kk * NT) + (lane >> 2), c = 16 * kk + 4 * (lane & 3);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = r < R && c + j < C ? f[static_cast<int64_t>(r) * C + c + j] : 0.0f;
    b_s[i] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

// Shared memory of one mm block: the ring's barriers, the ring of kMmStages
// tiles [kMmTile][cs] (+ slack; float32 sums its partial sums [kMmWarps]
// [kMmTile] in the stage it has just read), then the plane's f.
__host__ __device__ __forceinline__ int64_t mm_bar_bytes() {
  return 16 * ((kMmStages * 8 + 15) / 16);
}
__host__ __device__ __forceinline__ int64_t mm_stage_floats(int cs) {
  return static_cast<int64_t>(kMmTile) * (cs > kMmWarps ? cs : kMmWarps) + kMmSlack;
}
template <bool kBf16>
int64_t mm_smem(int R, int C, int cs) {
  const int64_t plane = kBf16 ? static_cast<int64_t>((C + 15) / 16) * ((R + 7) / 8) * 32 * 8
                              : static_cast<int64_t>(R) * 16 * ((C + 3) / 4);
  return mm_bar_bytes() + kMmStages * mm_stage_floats(cs) * 4 + plane;
}

// out[plane, p] = sum_r sum_c cdt(wx[plane, p, c]) cdt(f[plane, r, c]) over
// `items` = BV * tiles work items (plane, tile of kMmTile positions), each
// block one contiguous range of them.  bulk: rows are copied as they are
// (cs == C, C % 4 == 0, wx 16-byte aligned) by TMA; else by plain loads into
// rows of cs floats, zero-padded.
template <bool kBf16>
__global__ void __launch_bounds__(kMmThreads)
mm_kernel(const float* __restrict__ wx, const float* __restrict__ f, float* __restrict__ out,
          int64_t P, int R, int C, int cs, int64_t tiles, int64_t items, bool bulk) {
  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float* ring = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + mm_bar_bytes());
  const int64_t stage = mm_stage_floats(cs);
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
  auto fetch = [&](int64_t i) {  // thread 0: the i-th item's tile into its stage
    int64_t plane, t0;
    const int n = tile_of(i, plane, t0);
    bulk_load(ring + (i % kMmStages) * stage, wx + (plane * P + t0) * C,
              static_cast<unsigned>(n * C * 4), bars + i % kMmStages);
  };
  if (bulk && t == 0) {
    for (int s = 0; s < kMmStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int64_t i = 0; i < min64(kMmStages, count); ++i) fetch(i);
  }

  int64_t staged = -1;
  for (int64_t i = 0; i < count; ++i) {
    int64_t plane, t0;
    const int n = tile_of(i, plane, t0);
    float* w_s = ring + (i % kMmStages) * stage;
    const bool restage = plane != staged;  // uniform over the block
    if (restage) {  // bf16: B fragments; float32: f [R][C4] float4s
      if constexpr (kBf16)
        stage_fragments(f + plane * R * C, reinterpret_cast<uint2*>(plane_s), R, C);
      else
        stage_plane<false>(f + plane * R * C, plane_s, R, C, 4 * ((C + 3) / 4));
      staged = plane;
    }
    if (!bulk) {
      const float* src = wx + (plane * P + t0) * C;
      for (int k = t; k < n * cs; k += kMmThreads) {
        const int q = k / cs, c = k - q * cs;
        w_s[k] = c < C ? src[static_cast<int64_t>(q) * C + c] : 0.0f;
      }
    }
    if (restage || !bulk) __syncthreads();
    if (bulk) mbar_wait(bars + i % kMmStages, static_cast<unsigned>((i / kMmStages) & 1));
    float* o = out + plane * P + t0;

    if constexpr (kBf16) {
      const int KS = (C + 15) / 16, NT = (R + 7) / 8;
      const uint2* b_s = reinterpret_cast<const uint2*>(plane_s);
      const int g = lane >> 2, tq = lane & 3;
      const int row = 16 * warp + (g >> 1) + 4 * (g & 1);  // A rows g and g + 8
      if (16 * warp < n) {  // uniform over the warp
        const float* a_s = w_s + row * cs + 4 * tq;
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
        for (int kk = 0; kk < KS; ++kk) {
          const float4 lo = *reinterpret_cast<const float4*>(a_s + 16 * kk);
          const float4 hi = *reinterpret_cast<const float4*>(a_s + 8 * cs + 16 * kk);
          const int c = 16 * kk + 4 * tq;  // k 2t, 2t+1, 2t+8, 2t+9 are columns c .. c+3
          const bool v0 = c < C, v1 = c + 1 < C, v2 = c + 2 < C, v3 = c + 3 < C;
          uint4 a;
          a.x = pack_bf16(v0 ? lo.x : 0.0f, v1 ? lo.y : 0.0f);
          a.y = pack_bf16(v0 ? hi.x : 0.0f, v1 ? hi.y : 0.0f);
          a.z = pack_bf16(v2 ? lo.z : 0.0f, v3 ? lo.w : 0.0f);
          a.w = pack_bf16(v2 ? hi.z : 0.0f, v3 ? hi.w : 0.0f);
          const uint2* b = b_s + kk * NT * 32 + lane;
          for (int nt = 0; nt < NT; nt += 4) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (nt + j < NT) mma_bf16(acc[j], a, b[(nt + j) * 32]);
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
        if (tq == 1 && row + 8 < n) o[row + 8] = s_hi;
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
        for (int j = 0; j < kMmLanePos; ++j) w[j] = w4[(lane + 32 * j) * (cs / 4) + c4];
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
    __syncthreads();  // the block is done with this stage and the plane's f
    if (bulk && t == 0 && i + kMmStages < count) fetch(i + kMmStages);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mmT_kernel(const float* __restrict__ wxT, const float* __restrict__ f, float* __restrict__ out,
           int64_t BV, int64_t P, int R, int C, int vb, int pb, int cs) {
  extern __shared__ float4 smem4[];
  float* f_s = reinterpret_cast<float*>(smem4);
  const float4* f_s4 = reinterpret_cast<const float4*>(f_s);
  const int c4n = cs / 4, c4used = (C + 3) / 4;
  const int64_t plane_end = min64(static_cast<int64_t>(blockIdx.y) * vb + vb, BV);
  const int64_t pos0 = static_cast<int64_t>(blockIdx.x) * pb;
  const int64_t pos_end = min64(pos0 + pb, P);
  const int t = threadIdx.x;

  for (int64_t plane = static_cast<int64_t>(blockIdx.y) * vb; plane < plane_end; ++plane) {
    __syncthreads();
    stage_plane<kBf16>(f + plane * R * C, f_s, R, C, cs);
    __syncthreads();
    const float* w = wxT + plane * C * P;
    for (int64_t t0 = pos0; t0 < pos_end; t0 += kMmTTile) {
      const int n = static_cast<int>(min64(kMmTTile, pos_end - t0));
      // wv[k][j]: column 4*c4 + k of position t + j*kThreads; the next
      // chunk's columns are loaded while this chunk's rows run
      float wv[4][kMmTPos], acc[kMmTPos][4];
      auto load = [&](int c4, float (&dst)[4][kMmTPos]) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * c4 + k;
#pragma unroll
          for (int j = 0; j < kMmTPos; ++j) {
            const int q = t + j * kThreads;
            dst[k][j] = c < C && q < n ? w[static_cast<int64_t>(c) * P + t0 + q] : 0.0f;
          }
        }
      };
#pragma unroll
      for (int j = 0; j < kMmTPos; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
      load(0, wv);
      for (int c4 = 0; c4 < c4used; ++c4) {
        float next[4][kMmTPos];
        if (c4 + 1 < c4used) load(c4 + 1, next);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < kMmTPos; ++j) wv[k][j] = round_cdt<kBf16>(wv[k][j]);
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
          const float4 fv = f_s4[r * c4n + c4];
#pragma unroll
          for (int j = 0; j < kMmTPos; ++j) {
            if (j * kThreads < n) {  // uniform over the block
              acc[j][0] = fmaf(wv[0][j], fv.x, acc[j][0]);
              acc[j][1] = fmaf(wv[1][j], fv.y, acc[j][1]);
              acc[j][2] = fmaf(wv[2][j], fv.z, acc[j][2]);
              acc[j][3] = fmaf(wv[3][j], fv.w, acc[j][3]);
            }
          }
        }
        if (c4 + 1 < c4used) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < kMmTPos; ++j) wv[k][j] = next[k][j];
        }
      }
#pragma unroll
      for (int j = 0; j < kMmTPos; ++j) {
        const int q = t + j * kThreads;
        if (q < n) out[plane * P + t0 + q] = (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
      }
    }
  }
}

template <typename TF, bool kBf16>
__global__ void __launch_bounds__(kThreads)
bwd_mm_kernel(const TF* __restrict__ field, const float* __restrict__ pos_y,
              const float* __restrict__ pos_x, const float* __restrict__ grad,
              float* __restrict__ d_field, float* __restrict__ d_py, float* __restrict__ d_px,
              int64_t P, int R, int C, int cs) {
  extern __shared__ float4 smem4[];
  const int RB = (R + 3) / 4, CB = (C + 3) / 4;  // 4 x 4 cell blocks: rows rb + i*RB
  float* f_s = reinterpret_cast<float*>(smem4);  // [R, cs]
  float* wx_s = f_s + R * cs;                    // [4*CB, kBwdStride]: cdt(px*c)
  float* wyg_s = wx_s + 4 * CB * kBwdStride;     // [4*RB, kBwdStride]: cdt(py*r*g)
  float* df_s = wyg_s + 4 * RB * kBwdStride;     // [R, C] float32 d_field
  const float4* f_s4 = reinterpret_cast<const float4*>(f_s);
  const int c4n = cs / 4;
  const int64_t plane = blockIdx.x;
  const int t = threadIdx.x;

  stage_plane<kBf16>(field + plane * R * C, f_s, R, C, cs);
  for (int i = t; i < R * C; i += kThreads) df_s[i] = 0.0f;

  for (int64_t t0 = 0; t0 < P; t0 += kBwdTile) {
    const int64_t p = t0 + t;
    const bool valid = p < P;
    const float py = valid ? pos_y[plane * P + p] : 0.0f;
    const float px = valid ? pos_x[plane * P + p] : 0.0f;
    const float g = valid ? grad[plane * P + p] : 0.0f;
    __syncthreads();  // f_s and df_s ready; the previous tile's phase 2 is done
    for (int c = 0; c < 4 * CB; ++c)
      wx_s[c * kBwdStride + t] = c < C ? round_cdt<kBf16>(px * static_cast<float>(c)) : 0.0f;
    for (int r = 0; r < 4 * RB; ++r)
      wyg_s[r * kBwdStride + t] =
          r < R ? round_cdt<kBf16>((py * static_cast<float>(r)) * g) : 0.0f;

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
          w1[k] = c < C ? round_cdt<kBf16>(wxa) : 0.0f;
          w2[k] = c < C ? round_cdt<kBf16>(wxa * 0.5f) : 0.0f;
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

int launch_mmT(const float* w, const float* f, float* out, int64_t BV, int64_t P, int R, int C,
               int vb, int pb, bool bf16, cudaStream_t stream) {
  const int cs = padded_cols(C);
  const int64_t smem = static_cast<int64_t>(R) * cs * 4;
  auto kernel = bf16 ? mmT_kernel<true> : mmT_kernel<false>;
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const int64_t gx = (P + pb - 1) / pb, gy = (BV + vb - 1) / vb;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(w, f, out, BV, P, R, C, vb, pb, cs);
  return static_cast<int>(cudaGetLastError());
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
template <bool kBf16>
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
  auto kernel = mm_kernel<kBf16>;
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

// mm on a persistent grid: as many blocks as fit on the card, or one an item.
template <bool kBf16>
int launch_mm(const float* wx, const float* f, float* out, int64_t BV, int64_t P, int R, int C,
              cudaStream_t stream) {
  MmFit fit;
  const cudaError_t err = mm_fit<kBf16>(&fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bulk = C % 4 == 0 && reinterpret_cast<uintptr_t>(wx) % 16 == 0;
  const int cs = bulk ? C : padded_cols(C);
  const int64_t smem = mm_smem<kBf16>(R, C, cs);
  if (smem > fit.smem_block) return cudaErrorInvalidValue;  // R x C too large for one block
  const int64_t tiles = (P + kMmTile - 1) / kMmTile, items = BV * tiles;
  const int64_t resident = std::max<int64_t>(
      1, std::min<int64_t>(fit.resident, fit.smem_sm / (smem + fit.smem_reserved)));
  const int64_t grid = std::min<int64_t>(items, fit.sms * resident);
  mm_kernel<kBf16><<<static_cast<unsigned>(grid), kMmThreads, static_cast<size_t>(smem), stream>>>(
      wx, f, out, P, R, C, cs, tiles, items, bulk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TF, bool kBf16>
int launch_bwd(const void* field, const float* py, const float* px, const float* g,
               float* d_field, float* d_py, float* d_px, int64_t BV, int64_t P, int R, int C,
               cudaStream_t stream) {
  const int cs = padded_cols(C);
  const int RB = (R + 3) / 4, CB = (C + 3) / 4;
  const int64_t smem =
      (static_cast<int64_t>(R) * cs + 4 * (RB + CB) * kBwdStride + static_cast<int64_t>(R) * C) * 4;
  auto kernel = bwd_mm_kernel<TF, kBf16>;
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  if (BV > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(BV), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const TF*>(field), py, px, g, d_field, d_py, d_px, P, R, C, cs);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTransposed>
int dispatch_mm(const void* w, const void* f, void* out, long long BV, long long P, int R, int C,
                int vb, int pb, int cdt, void* stream) {
  if (BV <= 0 || P <= 0 || R <= 0 || C <= 0 || vb <= 0 || pb <= 0) return cudaErrorInvalidValue;
  if (cdt != 0 && cdt != 1) return cudaErrorInvalidValue;
  const float* wp = static_cast<const float*>(w);
  const float* fp = static_cast<const float*>(f);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kTransposed) return launch_mmT(wp, fp, o, BV, P, R, C, vb, pb, cdt == 1, s);
  return cdt == 1 ? launch_mm<true>(wp, fp, o, BV, P, R, C, s)
                  : launch_mm<false>(wp, fp, o, BV, P, R, C, s);
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

// The same function with wxT [BV, C, P]; vb: planes a block, pb: positions
// a block.
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

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
// Design, all on the CUDA cores (fp32 FMAs; no TF32, no tensor cores):
// - mm: a block takes vb (b,v) planes and a block of pb positions (the
//   variant's channel and position blocks).  For each plane it stages f
//   (R x C) in shared memory, then tiles of 256 positions of wx, copied with
//   16-byte cp.async (every copy of the tile in flight at once; plain loads
//   where C % 4 != 0) into rows padded to an odd number of float4s, so that
//   each thread reads its own rows as float4s without bank conflicts.  Each
//   thread holds 4 columns of 2 positions in registers and runs over the
//   rows: one broadcast float4 of f feeds 8 FMAs, into 8 partial sums (one
//   per position and column of the float4) added at the end.
// - mmT: the same blocking; wxT's [C, P] layout is coalesced across threads
//   as it stands, so each thread reads 4 columns of its 4 positions straight
//   from device memory, the next 4 columns while these run over the rows,
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
// C 68) mm and mmT read 428 MB of wx: 0.13 ms at 3.35 TB/s against 7.7 GFLOP
// (0.115 ms at the float32 rate); bwd_mm moves 43 MB but does 23 GFLOP, which
// on the CUDA cores is ~0.35 ms at the float32 rate against 0.023 ms on the
// tensor cores.  These first versions are CUDA-core kernels; the tensor cores
// (mma.sync / wgmma on bf16) are the next step for all three.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMmPos = 2;                    // positions per thread, mm
constexpr int kMmTile = kThreads * kMmPos;   // positions per staged tile, mm
constexpr int kMmTPos = 4;                   // positions per thread, mmT
constexpr int kMmTTile = kThreads * kMmTPos;
constexpr int kBwdTile = kThreads;           // positions per tile, bwd_mm
constexpr int kBwdStride = kBwdTile + 4;     // odd count of float4s a row
constexpr int kRowGroup = 12;                // tt rows held in registers, bwd_mm

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

// A 16-byte copy from device to shared memory that bypasses the registers
// (cp.async): a thread issues all of its tile's copies before waiting.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 round4(float4 v, bool bf16) {
  if (bf16) {
    v.x = round_cdt<true>(v.x);
    v.y = round_cdt<true>(v.y);
    v.z = round_cdt<true>(v.z);
    v.w = round_cdt<true>(v.w);
  }
  return v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const float* __restrict__ wx, const float* __restrict__ f, float* __restrict__ out,
          int64_t BV, int64_t P, int R, int C, int vb, int pb, int cs) {
  extern __shared__ float4 smem4[];
  float* f_s = reinterpret_cast<float*>(smem4);
  float* w_s = f_s + R * cs;
  const float4* f_s4 = reinterpret_cast<const float4*>(f_s);
  const float4* w_s4 = reinterpret_cast<const float4*>(w_s);
  const int c4n = cs / 4, c4used = (C + 3) / 4;
  const int64_t plane_end = min64(static_cast<int64_t>(blockIdx.y) * vb + vb, BV);
  const int64_t pos0 = static_cast<int64_t>(blockIdx.x) * pb;
  const int64_t pos_end = min64(pos0 + pb, P);
  const int t = threadIdx.x;

  for (int64_t plane = static_cast<int64_t>(blockIdx.y) * vb; plane < plane_end; ++plane) {
    __syncthreads();  // the previous plane's readers are done with f_s, w_s
    stage_plane<kBf16>(f + plane * R * C, f_s, R, C, cs);
    for (int64_t t0 = pos0; t0 < pos_end; t0 += kMmTile) {
      const int n = static_cast<int>(min64(kMmTile, pos_end - t0));
      const float* src = wx + (plane * P + t0) * C;  // n*C contiguous values
      __syncthreads();  // the previous tile's readers are done with w_s
      // the tile as it is in memory (rounded to cdt when read below)
      if (C % 4 == 0) {
        for (int i = t; i < n * C / 4; i += kThreads) {
          const int q = (4 * i) / C;
          cp_async16(w_s + q * cs + (4 * i - q * C), src + 4 * i);
        }
      } else {
        for (int i = t; i < n * C; i += kThreads) {
          const int q = i / C;
          w_s[q * cs + (i - q * C)] = src[i];
        }
      }
      for (int i = t; i < n * (cs - C); i += kThreads) {
        const int q = i / (cs - C);
        w_s[q * cs + C + (i - q * (cs - C))] = 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();

      // four partial sums per position (one per column of a float4), so that
      // eight FMA chains run side by side
      float acc[kMmPos][4];
#pragma unroll
      for (int j = 0; j < kMmPos; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
      for (int c4 = 0; c4 < c4used; ++c4) {
        float4 w[kMmPos];
#pragma unroll
        for (int j = 0; j < kMmPos; ++j)
          w[j] = j * kThreads < n ? round4(w_s4[(t + j * kThreads) * c4n + c4], kBf16)
                                  : make_float4(0, 0, 0, 0);
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
          const float4 fv = f_s4[r * c4n + c4];
#pragma unroll
          for (int j = 0; j < kMmPos; ++j) {
            if (j * kThreads < n) {  // uniform over the block
              acc[j][0] = fmaf(w[j].x, fv.x, acc[j][0]);
              acc[j][1] = fmaf(w[j].y, fv.y, acc[j][1]);
              acc[j][2] = fmaf(w[j].z, fv.z, acc[j][2]);
              acc[j][3] = fmaf(w[j].w, fv.w, acc[j][3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMmPos; ++j) {
        const int q = t + j * kThreads;
        if (q < n) out[plane * P + t0 + q] = (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
      }
    }
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

template <bool kTransposed, bool kBf16>
int launch_mm(const float* w, const float* f, float* out, int64_t BV, int64_t P, int R, int C,
              int vb, int pb, cudaStream_t stream) {
  const int cs = padded_cols(C);
  const int64_t smem = static_cast<int64_t>(R + (kTransposed ? 0 : kMmTile)) * cs * 4;
  auto kernel = kTransposed ? mmT_kernel<kBf16> : mm_kernel<kBf16>;
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const int64_t gx = (P + pb - 1) / pb, gy = (BV + vb - 1) / vb;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(w, f, out, BV, P, R, C, vb, pb, cs);
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
  const float* wp = static_cast<const float*>(w);
  const float* fp = static_cast<const float*>(f);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt == 0) return launch_mm<kTransposed, false>(wp, fp, o, BV, P, R, C, vb, pb, s);
  if (cdt == 1) return launch_mm<kTransposed, true>(wp, fp, o, BV, P, R, C, vb, pb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// wx [BV, P, C] float32, f [BV, R, C] float32, out [BV, P] float32, all
// contiguous.  vb: planes a block; pb: positions a block.  cdt: 0 float32,
// 1 bfloat16 operands.  Returns the CUDA error of the launch (0 on success).
extern "C" int paradis_interp_mm(const void* wx, const void* f, void* out, long long BV,
                                 long long P, int R, int C, int vb, int pb, int cdt,
                                 void* stream) {
  return dispatch_mm<false>(wx, f, out, BV, P, R, C, vb, pb, cdt, stream);
}

// The same with wxT [BV, C, P].
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

// The 64 x 64 (and, above D = 288, 32 x 32) tile machinery shared by the
// flash and the quantized attention kernels (csrc/flash_attention.cu,
// csrc/quantized_attention.cu, csrc/quantized_attention_bwd.cu): 256
// threads per CTA, 16 x 16, each thread 4 rows x 4 columns of a tile;
// operands staged in shared memory as fp32, transposed ([D][64 + 4]), so a
// thread's four rows and four columns are 16-byte vectors; every mask is
// an int32 [Sq, 2] table of per-row [start, end) key ranges.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace mfa {

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16; each thread 4 rows x 4 columns
constexpr int LD = BM + 4;     // padded row of a transposed [D][64] tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Stage rows [row0, row0 + 64) of a [rows, D] matrix of T transposed into
// dst[d * LD + r] as fp32, zeros past `limit`; SCALE rounds x*scale to T.
template <typename T, int D, bool SCALE>
__device__ __forceinline__ void stage_t(const T* __restrict__ src, int row0,
                                        int limit, float* dst, float scale) {
  using E = Elem<T>;
  constexpr int VPR = D / E::VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = i % VPR;
    float f[E::VEC];
    if (row0 + r < limit) {
      E::unpack(*reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D +
                                                c * E::VEC),
                f);
      if (SCALE) {
#pragma unroll
        for (int e = 0; e < E::VEC; ++e) f[e] = E::round(f[e] * scale);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E::VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E::VEC; ++e) dst[(c * E::VEC + e) * LD + r] = f[e];
  }
}

// acc[i][j] = sum_d a[d][ay*4 + i] * b[d][bx*4 + j] over transposed tiles.
template <int D>
__device__ __forceinline__ void tile_product(const float* a, int ay,
                                             const float* b, int bx,
                                             float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * LD + ay * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + d * LD + bx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// acc[i][e] += sum_c p[c][py*4 + i] * m[(tx + 16e) * LD + c]: a [64 x 64]
// tile p (stored [c][row], transposed) times a transposed [D][64] tile.
template <int D>
__device__ __forceinline__ void accumulate_pm(const float* p, int py,
                                              const float* m, int tx,
                                              float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    const float4 pv = *reinterpret_cast<const float4*>(p + c * LD + py * 4);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      const float me = m[(tx + 16 * e) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pr[i], me, acc[i][e]);
    }
  }
}

// Store v[i][j] (row ty*4+i, column tx*4+j) transposed: dst[col][row].
__device__ __forceinline__ void store_t(float* dst, int ty, int tx,
                                        const float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (tx * 4 + j) * LD + ty * 4) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// The 32-row layouts of the scalar bodies above D = 288 (attention_bwd.cuh's
// dq_body32 / dkv_body32, flash_attention.cu's fwd_body32,
// quantized_attention.cu's qattn_body32): the 256 threads are 8 x 32,
// thread (ty, tx) rows 4 ty + [0, 4) of a tile, column tx, lanes tx + 32 e.
// scalar32: whether a scalar body at head dim D takes them, above 288,
// where two [D][64] fp32 tiles alone pass 227 KB of shared memory.
template <int D>
__host__ __device__ constexpr bool scalar32() {
  return D > 288;
}

constexpr int T32 = 32;        // rows, and keys, a tile
constexpr int LD32 = T32 + 4;  // a transposed [D][32] tile's row

template <int D>
__host__ __device__ constexpr int ld_rows32() {
  return D + 1;
}

template <int D>
constexpr size_t smem32_bytes() {
  return sizeof(float) * ((size_t)D * LD32 + (size_t)T32 * ld_rows32<D>() +
                          (size_t)T32 * LD32);
}

// Rows [row0, row0 + 32) of an fp32 [rows, D] matrix, times `scale` where
// SCALE, zeros from `limit`: transposed into dst[d * LD32 + r] (ROWS false;
// consecutive threads take consecutive rows, so the stores fill 32 banks)
// or as rows dst[r * (D + 1) + d] (ROWS true).
template <int D, bool SCALE, bool ROWS>
__device__ __forceinline__ void stage32(const float* __restrict__ src,
                                        int row0, int limit, float* dst,
                                        float scale) {
  static_assert(D % 32 == 0, "a thread's lanes are tx + 32 e");
  constexpr int VPR = D / 4;  // float4 loads a row
  for (int i = threadIdx.x; i < T32 * VPR; i += THREADS) {
    const int r = ROWS ? i / VPR : i % T32;
    const int c = ROWS ? i % VPR : i / T32;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit)
      f = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D +
                                           4 * c);
    if (SCALE) {
      f.x *= scale;
      f.y *= scale;
      f.z *= scale;
      f.w *= scale;
    }
    const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ROWS)
        dst[r * ld_rows32<D>() + 4 * c + e] = fv[e];
      else
        dst[(4 * c + e) * LD32 + r] = fv[e];
    }
  }
}

// acc[i] = sum_d a[d][4 ay + i] * b[bx][d]: four rows of a transposed tile
// against one row of a row tile.
template <int D>
__device__ __forceinline__ void tile_product32(const float* a, int ay,
                                               const float* b, int bx,
                                               float (&acc)[4]) {
  const float* brow = b + bx * ld_rows32<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * LD32 + ay * 4);
    const float y = brow[d];
    acc[0] = fmaf(x.x, y, acc[0]);
    acc[1] = fmaf(x.y, y, acc[1]);
    acc[2] = fmaf(x.z, y, acc[2]);
    acc[3] = fmaf(x.w, y, acc[3]);
  }
}

// acc[i][e] += sum_c p[c * LD32 + 4 py + i] * m[c][tx + 32 e]: a [32][32]
// score tile stored [c][row] times the lanes of a row tile.
template <int D>
__device__ __forceinline__ void accumulate_pm32(const float* p, int py,
                                                const float* m, int tx,
                                                float (&acc)[4][D / 32]) {
#pragma unroll 4
  for (int c = 0; c < T32; ++c) {
    const float4 pv = *reinterpret_cast<const float4*>(p + c * LD32 + py * 4);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
    const float* mrow = m + c * ld_rows32<D>() + tx;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      const float me = mrow[32 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pr[i], me, acc[i][e]);
    }
  }
}

__device__ __forceinline__ void row_range(const int32_t* ranges, int r,
                                          int Sq, int Skv, int& st, int& en) {
  if (r < Sq) {
    st = max(ranges[2 * r], 0);
    en = min(ranges[2 * r + 1], Skv);
  } else {
    st = en = 0;
  }
}

// The live key span [lo, hi) of rows [r0, r0 + ROWS): min start and max
// end over the rows whose range is not empty; lo >= hi when none is live.
template <int ROWS = BM>
__device__ __forceinline__ void key_span(const int32_t* ranges, int r0,
                                         int Sq, int Skv, int* s_lo,
                                         int* s_hi) {
  if (threadIdx.x == 0) {
    *s_lo = INT_MAX;
    *s_hi = 0;
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    int st, en;
    row_range(ranges, r0 + threadIdx.x, Sq, Skv, st, en);
    if (en > st) {
      atomicMin(s_lo, st);
      atomicMax(s_hi, en);
    }
  }
  __syncthreads();
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// kern<<<grid, threads, smem, stream>>>(args...) with its dynamic shared
// memory allowed; returns the launch's cudaError_t.
template <typename K, typename... Args>
int launch_with_smem(K kern, dim3 grid, int threads, size_t smem,
                     cudaStream_t stream, const Args&... args) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace mfa

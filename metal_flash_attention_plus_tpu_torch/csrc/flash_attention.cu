// Flash attention for Hopper (sm_90a): the forward, the dQ backward and the
// dK/dV backward, each one CUDA kernel over BHSD tensors.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/flash_attention.py::_fwd_kernel         -> flash_fwd_kernel
//   - ops/flash_attention_bwd.py::_dq_kernel      -> flash_dq_kernel
//   - ops/flash_attention_bwd.py::_dkv_kernel     -> flash_dkv_kernel
//
// Layouts: q/dO [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] of T (float or bf16),
// contiguous; L and D (= rowsum(dO*O)) fp32 [B, Hq, Sq]; O, dQ fp32
// [B, Hq, Sq, D]; dK, dV fp32 [B, Hkv, Skv, D].  GQA: q head h reads kv
// head h / (Hq/Hkv), or h % Hkv when interleaved.  Every mask arrives as
// one int32 [Sq, 2] table of per-row [start, end) key ranges
// (ops/flash_attention.py::compute_row_ranges); a row with end <= start
// is empty.  The optional additive bias is fp32 [Bb, Hb, Sq, Skv] with
// batch/head strides (0 where broadcast); the dQ kernel can also write
// dbias = dS, fp32 [B, Hq, Sq, Skv].
//
// Numerics, shared with the plain PyTorch versions in ops/flash_attention.py
// and ops/flash_attention_bwd.py so the two can be held to a tight
// tolerance:
//   - forward: q pre-scaled by scale*log2(e) and rounded back to T; base-2
//     online softmax in fp32; bias*log2(e) added, then masked scores set to
//     mask_value; P rounded to T before P.V; l sums the unrounded p;
//     O = acc / l, L = m*ln2 + log(l); an empty row gives O = 0, L = -inf;
//   - backward: q pre-scaled by scale (natural base) and rounded to T;
//     L = -inf read as 0; P = exp(S + bias - L), 0 where masked;
//     dP = dO.V^T; dS = P*(dP - D); dQ = scale * round_T(dS).K;
//     dV = round_T(P)^T.dO; dK = round_T(dS)^T.Q_s.
//
// What bounds them on the H100, and the design.
//   At the training shapes (B=4, Hq=16, Hkv=4, S=2048, D=64, causal) each
//   kernel does 2-4 products of 64x64 tiles per KV tile with D = 64 deep:
//   ~70 GFLOP for the forward, i.e. compute bound on the tensor cores
//   (989 TFLOP/s bf16) by a wide margin over the ~40 MB of bytes.  These
//   first versions do the products with scalar fp32 FMAs (67 TFLOP/s peak),
//   so they cannot reach that bound; they are the right-and-simple step
//   before mma/wgmma, TMA and warp specialisation.  All three use 256
//   threads on a 64 x 64 tile, 4 x 4 scores per thread; operands are staged
//   in shared memory as fp32, transposed ([D][64 + 4]) so a thread's four
//   rows and four columns are 16-byte vectors and the products read two
//   vectors per 16 FMAs.
//   - forward: one CTA per (64 query rows, b, q head).  The TPU's sequential
//     grid carried m, l and the accumulator from KV block to KV block; here
//     one CTA loops over its KV tiles and keeps them in registers.  The CTA
//     reduces its rows' ranges to the live key span [min start, max end)
//     and visits only the tiles in it (causal: about half), so no padded
//     copy is made and dead tiles cost nothing.
//   - dQ: one CTA per (64 query rows, b, q head); Q_s^T and dO^T stay in
//     shared memory; per KV tile V^T then K^T are staged in one buffer, and
//     K^T serves both S = Q_s.K^T and dQ += dS.K.
//   - dK/dV: one CTA per (64 keys, b, kv head) owns its tile's dK and dV,
//     looping over the GQA group's q heads x the live query rows (the span
//     of rows whose range meets the tile), so the group reduction needs no
//     atomics and no second pass.  K^T and V^T stay resident for D <= 128;
//     at D = 256 they share one buffer, restaged per query tile, to keep
//     shared memory under 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "common.cuh"

namespace {

using mfa::BM;
using mfa::BN;
using mfa::Elem;
using mfa::LD;
using mfa::LN2;
using mfa::LOG2E;
using mfa::THREADS;
using mfa::accumulate_pm;
using mfa::key_span;
using mfa::row_range;
using mfa::set_smem;
using mfa::store_t;
using mfa::tile_product;

// Stage rows [row0, row0 + 64) of a [rows, D] matrix transposed into
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

template <int D>
constexpr size_t fwd_smem_floats() {
  return 2 * (size_t)D * LD + (size_t)BN * LD;  // Q^T, K^T|V^T, P^T
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 3 * (size_t)D * LD + (size_t)BN * LD;  // Q^T, dO^T, K^T|V^T, dS^T
}

template <int D>
__host__ __device__ constexpr bool dkv_resident() {
  return D <= 128;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // Q^T, dO^T, K^T and V^T (one shared buffer at D = 256), P^T|dS^T
  return (dkv_resident<D>() ? 4 : 3) * (size_t)D * LD + (size_t)BM * LD;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention.py::_fwd_kernel.  Bound: tensor-core
// operations (4*D per live query-key pair), not bytes; this scalar-FMA
// version runs at a fraction of it.  One CTA per 64 query rows loops over
// the live key tiles with m, l and the accumulator in registers.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ ranges,
                 const float* __restrict__ bias, long long bias_sb,
                 long long bias_sh, float* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 int interleaved, float qscale, float mask_value) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;          // [D][LD]  Q_s^T
  float* kvt = qt + D * LD;  // [D][LD]  K^T, then V^T
  float* pt = kvt + D * LD;  // [BN][LD] P^T
  __shared__ int s_lo, s_hi;

  const int r0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int hk = interleaved ? h % Hkv : h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = (size_t)b * Hq + h;
  const T* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  const float* bh_bias =
      bias ? bias + b * bias_sb + h * bias_sh : nullptr;

  stage_t<T, D, true>(q + bh * Sq * D, r0, Sq, qt, qscale);
  key_span(ranges, r0, Sq, Skv, &s_lo, &s_hi);  // syncs: Q^T staged too
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_range(ranges, r0 + ty * 4 + i, Sq, Skv, rs[i], re[i]);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += BN) {
    stage_t<T, D, false>(kh, t0, c_hi, kvt, 0.f);
    __syncthreads();
    float s[4][4];
    tile_product<D>(qt, ty, kvt, tx, s);
    __syncthreads();  // every thread is done with K^T
    stage_t<T, D, false>(vh, t0, c_hi, kvt, 0.f);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx * 4 + j;
        if (bh_bias && row < Sq && col < c_hi)
          s[i][j] += bh_bias[(size_t)row * Skv + col] * LOG2E;
        if (col < rs[i] || col >= re[i]) s[i][j] = mask_value;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are the 16 lanes sharing ty in one warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            (s[i][j] == -INFINITY) ? 0.f : exp2f(s[i][j] - m_next);
        sum += p;
        s[i][j] = Elem<T>::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[i][e] *= alpha;
    }
    store_t(pt, ty, tx, s);
    __syncthreads();  // V^T and P^T staged
    accumulate_pm<D>(pt, ty, kvt, tx, acc);
    __syncthreads();  // before the next tile overwrites them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    float* orow = o + (bh * Sq + r) * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) orow[tx + 16 * e] = acc[i][e] * inv;
    if (tx == 0) lse[bh * Sq + r] = live ? m[i] * LN2 + logf(l[i]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention_bwd.py::_dq_kernel.  Bound: operations
// (6*D per live pair: S, dP, dQ).  One CTA per 64 query rows keeps Q_s^T
// and dO^T resident and loops over the live key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                const int32_t* __restrict__ ranges,
                const float* __restrict__ bias, long long bias_sb,
                long long bias_sh, float* __restrict__ dq,
                float* __restrict__ dbias, int Hq, int Hkv, int Sq, int Skv,
                int interleaved, float scale) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;           // [D][LD]  Q_s^T
  float* dot = qt + D * LD;   // [D][LD]  dO^T
  float* kvt = dot + D * LD;  // [D][LD]  V^T, then K^T
  float* dst = kvt + D * LD;  // [BN][LD] dS^T
  __shared__ int s_lo, s_hi;

  const int r0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int hk = interleaved ? h % Hkv : h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = (size_t)b * Hq + h;
  const T* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  const float* bh_bias =
      bias ? bias + b * bias_sb + h * bias_sh : nullptr;

  stage_t<T, D, true>(q + bh * Sq * D, r0, Sq, qt, scale);
  stage_t<T, D, false>(dout + bh * Sq * D, r0, Sq, dot, 0.f);
  key_span(ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float lrow[4], drow[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_range(ranges, r, Sq, Skv, rs[i], re[i]);
    const float lv = r < Sq ? lse[bh * Sq + r] : 0.f;
    lrow[i] = (lv == -INFINITY) ? 0.f : lv;
    drow[i] = r < Sq ? di[bh * Sq + r] : 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += BN) {
    stage_t<T, D, false>(vh, t0, c_hi, kvt, 0.f);
    __syncthreads();
    float dp[4][4];
    tile_product<D>(dot, ty, kvt, tx, dp);
    __syncthreads();  // every thread is done with V^T
    stage_t<T, D, false>(kh, t0, c_hi, kvt, 0.f);
    __syncthreads();
    float s[4][4];
    tile_product<D>(qt, ty, kvt, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx * 4 + j;
        if (bh_bias && row < Sq && col < c_hi)
          s[i][j] += bh_bias[(size_t)row * Skv + col];
        const float p = (col < rs[i] || col >= re[i])
                            ? 0.f
                            : expf(s[i][j] - lrow[i]);
        const float ds = p * (dp[i][j] - drow[i]);
        if (dbias && row < Sq && col < Skv)
          dbias[(bh * Sq + row) * Skv + col] = ds;
        s[i][j] = Elem<T>::round(ds);
      }
    }
    store_t(dst, ty, tx, s);
    __syncthreads();  // dS^T staged
    accumulate_pm<D>(dst, ty, kvt, tx, acc);
    __syncthreads();  // before the next tile overwrites K^T and dS^T
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    float* drow_out = dq + (bh * Sq + r) * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) drow_out[tx + 16 * e] = acc[i][e] * scale;
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention_bwd.py::_dkv_kernel.  Bound: operations
// (8*D per live pair: S, dP, dV, dK).  One CTA per 64 keys owns their dK
// and dV and walks the GQA group x the query rows that meet its tile.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 const int32_t* __restrict__ ranges,
                 const float* __restrict__ bias, long long bias_sb,
                 long long bias_sh, float* __restrict__ dk,
                 float* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                 int interleaved, float scale) {
  constexpr int DV = D / 16;
  constexpr bool RESIDENT = dkv_resident<D>();
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                           // [D][LD]  Q_s^T
  float* dot = qt + D * LD;                   // [D][LD]  dO^T
  float* kt = dot + D * LD;                   // [D][LD]  K^T
  float* vt = RESIDENT ? kt + D * LD : kt;    // [D][LD]  V^T
  float* ps = vt + D * LD;                    // [BM][LD] P, then dS (q-major)
  __shared__ int s_rmin, s_rmax;

  const int c0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query columns tx*4 + j
  const int ty = tid / 16;  // key rows ty*4 + i
  const size_t bkv = (size_t)b * Hkv + hk;
  const T* kh = k + bkv * Skv * D;
  const T* vh = v + bkv * Skv * D;
  const int c_end = min(c0 + BN, Skv);

  // The span of query rows whose range meets this key tile.
  if (tid == 0) {
    s_rmin = INT_MAX;
    s_rmax = -1;
  }
  __syncthreads();
  {
    int rmin = INT_MAX, rmax = -1;
    for (int r = tid; r < Sq; r += THREADS) {
      int st, en;
      row_range(ranges, r, Sq, Skv, st, en);
      if (en > st && st < c_end && en > c0) {
        rmin = min(rmin, r);
        rmax = max(rmax, r);
      }
    }
    if (rmax >= 0) {
      atomicMin(&s_rmin, rmin);
      atomicMax(&s_rmax, rmax);
    }
  }
  if (RESIDENT) {
    stage_t<T, D, false>(kh, c0, Skv, kt, 0.f);
    stage_t<T, D, false>(vh, c0, Skv, vt, 0.f);
  }
  __syncthreads();
  const int row_lo = s_rmin;
  const int row_hi = s_rmax + 1;

  float dk_acc[4][DV], dv_acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DV; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = interleaved ? g * Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * Hq + h;
    const float* bh_bias =
        bias ? bias + b * bias_sb + h * bias_sh : nullptr;
    for (int r0 = row_lo; r0 < row_hi; r0 += BM) {
      stage_t<T, D, true>(q + bh * Sq * D, r0, row_hi, qt, scale);
      stage_t<T, D, false>(dout + bh * Sq * D, r0, row_hi, dot, 0.f);
      if (!RESIDENT) stage_t<T, D, false>(kh, c0, Skv, kt, 0.f);
      int rs[4], re[4];
      float lcol[4], dcol[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + tx * 4 + j;
        row_range(ranges, r < row_hi ? r : Sq, Sq, Skv, rs[j], re[j]);
        const float lv = r < row_hi ? lse[bh * Sq + r] : 0.f;
        lcol[j] = (lv == -INFINITY) ? 0.f : lv;
        dcol[j] = r < row_hi ? di[bh * Sq + r] : 0.f;
      }
      __syncthreads();
      float pt[4][4];  // [key i][query j]
      tile_product<D>(kt, ty, qt, tx, pt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + tx * 4 + j;
          float s = pt[i][j];
          if (bh_bias && row < row_hi && col < Skv)
            s += bh_bias[(size_t)row * Skv + col];
          pt[i][j] =
              (col < rs[j] || col >= re[j]) ? 0.f : expf(s - lcol[j]);
        }
      }
      if (!RESIDENT) {
        __syncthreads();  // every thread is done with K^T
        stage_t<T, D, false>(vh, c0, Skv, vt, 0.f);
        __syncthreads();
      }
      float dpt[4][4];
      tile_product<D>(vt, ty, dot, tx, dpt);
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dpt[i][j] = pt[i][j] * (dpt[i][j] - dcol[j]);  // dS^T
          pr[i][j] = Elem<T>::round(pt[i][j]);
        }
      // P, q-major: ps[q * LD + key], the layout accumulate_pm reads.
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(ps + (tx * 4 + j) * LD + ty * 4) =
            make_float4(pr[0][j], pr[1][j], pr[2][j], pr[3][j]);
      __syncthreads();
      accumulate_pm<D>(ps, ty, dot, tx, dv_acc);  // dV += P^T.dO
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(ps + (tx * 4 + j) * LD + ty * 4) =
            make_float4(Elem<T>::round(dpt[0][j]), Elem<T>::round(dpt[1][j]),
                        Elem<T>::round(dpt[2][j]), Elem<T>::round(dpt[3][j]));
      __syncthreads();
      accumulate_pm<D>(ps, ty, qt, tx, dk_acc);  // dK += dS^T.Q_s
      __syncthreads();  // before the next tile restages
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty * 4 + i;
    if (key >= Skv) continue;
    float* dkr = dk + (bkv * Skv + key) * D;
    float* dvr = dv + (bkv * Skv + key) * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      dkr[tx + 16 * e] = dk_acc[i][e];
      dvr[tx + 16 * e] = dv_acc[i][e];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Shape {
  int B, Hq, Hkv, Sq, Skv, interleaved;
};

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* ranges, const void* bias, long long sb,
               long long sh, void* o, void* lse, Shape sp, float qscale,
               float mask_value, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((sp.Sq + BM - 1) / BM, sp.Hq, sp.B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(ranges),
      static_cast<const float*>(bias), sb, sh, static_cast<float*>(o),
      static_cast<float*>(lse), sp.Hq, sp.Hkv, sp.Sq, sp.Skv, sp.interleaved,
      qscale, mask_value);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, const void* ranges,
              const void* bias, long long sb, long long sh, void* dq,
              void* dbias, Shape sp, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((sp.Sq + BM - 1) / BM, sp.Hq, sp.B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int32_t*>(ranges), static_cast<const float*>(bias),
      sb, sh, static_cast<float*>(dq), static_cast<float*>(dbias), sp.Hq,
      sp.Hkv, sp.Sq, sp.Skv, sp.interleaved, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* di,
               const void* ranges, const void* bias, long long sb,
               long long sh, void* dk, void* dv, Shape sp, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  auto kern = flash_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((sp.Skv + BN - 1) / BN, sp.Hkv, sp.B), THREADS, smem,
         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int32_t*>(ranges), static_cast<const float*>(bias),
      sb, sh, static_cast<float*>(dk), static_cast<float*>(dv), sp.Hq,
      sp.Hkv, sp.Sq, sp.Skv, sp.interleaved, scale);
  return (int)cudaGetLastError();
}

// Returns LAUNCH<T, D>(args...) for the runtime dtype (0 = float32,
// 1 = bfloat16) and head dim (32, 64, 128, 256).
#define MFA_DISPATCH(LAUNCH, ...)                                  \
  if (dtype == 0) {                                                \
    if (D == 32) return LAUNCH<float, 32>(__VA_ARGS__);            \
    if (D == 64) return LAUNCH<float, 64>(__VA_ARGS__);            \
    if (D == 128) return LAUNCH<float, 128>(__VA_ARGS__);          \
    if (D == 256) return LAUNCH<float, 256>(__VA_ARGS__);          \
  } else if (dtype == 1) {                                         \
    if (D == 32) return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);    \
    if (D == 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);    \
    if (D == 128) return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);  \
    if (D == 256) return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__);  \
  }                                                                \
  return (int)cudaErrorInvalidValue

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported dtype or head dim,
// or a group that does not divide Hq.
extern "C" {

int mfa_flash_fwd(const void* q, const void* k, const void* v,
                  const void* ranges, const void* bias, long long bias_sb,
                  long long bias_sh, void* o, void* lse, int dtype, int B,
                  int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                  float qscale, float mask_value, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_fwd, q, k, v, ranges, bias, bias_sb, bias_sh, o, lse,
               sp, qscale, mask_value, s);
}

int mfa_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* di,
                 const void* ranges, const void* bias, long long bias_sb,
                 long long bias_sh, void* dq, void* dbias, int dtype, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                 float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_dq, q, k, v, dout, lse, di, ranges, bias, bias_sb,
               bias_sh, dq, dbias, sp, scale, s);
}

int mfa_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di,
                  const void* ranges, const void* bias, long long bias_sb,
                  long long bias_sh, void* dk, void* dv, int dtype, int B,
                  int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                  float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_dkv, q, k, v, dout, lse, di, ranges, bias, bias_sb,
               bias_sh, dk, dv, sp, scale, s);
}

}  // extern "C"

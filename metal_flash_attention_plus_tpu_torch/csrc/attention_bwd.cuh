// The dQ and dK/dV bodies shared by the flash backward kernels (float K/V,
// csrc/flash_attention.cu) and the exact quantized backward kernels (int8 /
// int4 K/V, csrc/quantized_attention_bwd.cu).  The two differ in how a K or
// V tile is staged, which the KV policy decides (its stage(is_v, kv head,
// t0, limit, dst) fills a transposed [D][LD] fp32 tile), and in the folded
// scales the quantized dQ takes: per-token column scales on S and dS (ksr)
// and on dP (vsr), and per-channel store multipliers (dqsc).
//
// Numerics (the plain versions in ops/flash_attention_bwd.py round at the
// same places): L = -inf read as 0; S = Q_s.K^T (x ksr), + bias;
// P = exp(S - L), 0 where masked; dP = dO.V^T (x vsr); dS = P*(dP - D);
// dbias = dS; dQ = round_T(dS (x ksr)).K x (dqsc or scale);
// dV = round_T(P)^T.dO; dK = round_T(dS)^T.Q_s.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "common.cuh"

namespace mfa {

struct BwdArgs {
  const void* q;     // T [B, Hq, Sq, D]
  const void* dout;  // T [B, Hq, Sq, D]
  const float* lse;  // [B, Hq, Sq]
  const float* di;   // D = rowsum(dO * O), [B, Hq, Sq]
  const int32_t* ranges;
  const float* bias;  // [Bb, Hb, Sq, Skv] with batch / head strides, or null
  long long bias_sb, bias_sh;
  const float* ksr;   // dQ: per-token K scales [B, Hkv, Skv], or null
  const float* vsr;   // dQ: per-token V scales [B, Hkv, Skv], or null
  const float* dqsc;  // dQ: store multipliers [B, Hkv, D], or null: scale
  float* out0;        // dQ [B, Hq, Sq, D] | dK [B, Hkv, Skv, D]
  float* out1;        // dbias [B, Hq, Sq, Skv] or null | dV
  int Hq, Hkv, Sq, Skv, interleaved;
  float scale;  // Q's pre-scale where the body scales Q, dQ's store scale
};

// Above D = 256 three [D][LD] tiles no longer fit in 227 KB beside a
// [64][LD] one, so the dQ and dK/dV bodies keep two: Q_s^T and dO^T take
// turns in one buffer, K^T and V^T in the other, each restaged per tile.
template <int D>
__host__ __device__ constexpr bool dq_do_resident() {
  return D <= 256;
}

template <int D>
constexpr size_t dq_smem_floats() {
  // Q^T, dO^T (Q^T's buffer above D = 256), K^T|V^T, dS^T
  return (dq_do_resident<D>() ? 3 : 2) * (size_t)D * LD + (size_t)BN * LD;
}

// [D][LD] buffers of the dK/dV body: Q^T, dO^T, K^T, V^T up to D = 128;
// K^T and V^T share one up to D = 256; Q^T and dO^T one more above.
template <int D>
__host__ __device__ constexpr int dkv_buffers() {
  return D <= 128 ? 4 : (D <= 256 ? 3 : 2);
}

template <int D>
__host__ __device__ constexpr bool dkv_resident() {
  return dkv_buffers<D>() == 4;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return dkv_buffers<D>() * (size_t)D * LD + (size_t)BM * LD;  // + P^T|dS^T
}

// dQ for one (64 query rows, b, q head): Q_s^T and dO^T stay in shared
// memory (above D = 256 they take turns in one buffer, restaged per key
// tile), the CTA loops over the live key tiles; per tile V^T then K^T are
// staged in one buffer and K^T serves both S = Q_s.K^T and dQ += dS.K.
// SCALE_Q: Q is scaled by a.scale and rounded to T here (else the caller
// passed it pre-scaled).
template <typename T, int D, bool SCALE_Q, typename KV>
__device__ __forceinline__ void dq_body(const BwdArgs& a, const KV& kv) {
  constexpr int DV = D / 16;
  constexpr bool RESIDENT = dq_do_resident<D>();
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                          // [D][LD]  Q_s^T
  float* dot = RESIDENT ? qt + D * LD : qt;  // [D][LD]  dO^T
  float* kvt = dot + D * LD;                 // [D][LD]  V^T, then K^T
  float* dst = kvt + D * LD;                 // [BN][LD] dS^T
  __shared__ int s_lo, s_hi;

  const int Sq = a.Sq, Skv = a.Skv;
  const int r0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int hk = a.interleaved ? h % a.Hkv : h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  const float* ksr = a.ksr ? a.ksr + bk * Skv : nullptr;
  const float* vsr = a.vsr ? a.vsr + bk * Skv : nullptr;

  const T* qh = static_cast<const T*>(a.q) + bh * Sq * D;
  const T* doh = static_cast<const T*>(a.dout) + bh * Sq * D;
  if (RESIDENT) {
    stage_t<T, D, SCALE_Q>(qh, r0, Sq, qt, a.scale);
    stage_t<T, D, false>(doh, r0, Sq, dot, 0.f);
  }
  key_span(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float lrow[4], drow[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_range(a.ranges, r, Sq, Skv, rs[i], re[i]);
    const float lv = r < Sq ? a.lse[bh * Sq + r] : 0.f;
    lrow[i] = (lv == -INFINITY) ? 0.f : lv;
    drow[i] = r < Sq ? a.di[bh * Sq + r] : 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += BN) {
    if (!RESIDENT) stage_t<T, D, false>(doh, r0, Sq, dot, 0.f);
    kv.stage(true, bk, t0, c_hi, kvt);
    __syncthreads();
    float dp[4][4];
    tile_product<D>(dot, ty, kvt, tx, dp);
    __syncthreads();  // every thread is done with V^T (and dO^T)
    if (!RESIDENT) stage_t<T, D, SCALE_Q>(qh, r0, Sq, qt, a.scale);
    kv.stage(false, bk, t0, c_hi, kvt);
    __syncthreads();
    float s[4][4];
    tile_product<D>(qt, ty, kvt, tx, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = t0 + tx * 4 + j;
      const bool in = col < c_hi;
      const float ks = (ksr && in) ? ksr[col] : 1.f;
      const float vs = (vsr && in) ? vsr[col] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        float sv = ksr ? s[i][j] * ks : s[i][j];
        if (bh_bias && row < Sq && in)
          sv += bh_bias[(size_t)row * Skv + col];
        const float p =
            (col < rs[i] || col >= re[i]) ? 0.f : expf(sv - lrow[i]);
        const float dpv = vsr ? dp[i][j] * vs : dp[i][j];
        const float ds = p * (dpv - drow[i]);
        if (a.out1 && row < Sq && col < Skv)
          a.out1[(bh * Sq + row) * Skv + col] = ds;
        s[i][j] = Elem<T>::round(ksr ? ds * ks : ds);
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
    float* out = a.out0 + (bh * Sq + r) * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      const int d = tx + 16 * e;
      out[d] = acc[i][e] * (a.dqsc ? a.dqsc[bk * D + d] : a.scale);
    }
  }
}

// dK / dV for one (64 keys, b, kv head): the CTA owns its tile's dK and dV
// and walks the GQA group's q heads x the query rows whose range meets the
// tile (their span), so the group reduction needs no atomics and no second
// pass.  K^T and V^T stay resident for D <= 128; up to D = 256 they share
// one buffer, restaged per query tile, to keep shared memory under 227 KB;
// above it Q_s^T and dO^T share another (Q_s^T staged twice per tile).
template <typename T, int D, typename KV>
__device__ __forceinline__ void dkv_body(const BwdArgs& a, const KV& kv) {
  constexpr int DV = D / 16;
  constexpr bool RESIDENT = dkv_resident<D>();
  constexpr bool Q_DO_SHARED = dkv_buffers<D>() == 2;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                             // [D][LD]  Q_s^T
  float* dot = Q_DO_SHARED ? qt : qt + D * LD;  // [D][LD]  dO^T
  float* kt = dot + D * LD;                     // [D][LD]  K^T
  float* vt = RESIDENT ? kt + D * LD : kt;  // [D][LD]  V^T
  float* ps = vt + D * LD;                  // [BM][LD] P, then dS (q-major)
  __shared__ int s_rmin, s_rmax;

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query columns tx*4 + j
  const int ty = tid / 16;  // key rows ty*4 + i
  const size_t bkv = (size_t)b * a.Hkv + hk;
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
      row_range(a.ranges, r, Sq, Skv, st, en);
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
    kv.stage(false, bkv, c0, Skv, kt);
    kv.stage(true, bkv, c0, Skv, vt);
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
    const int h = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + h;
    const float* bh_bias =
        a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
    const T* qh = static_cast<const T*>(a.q) + bh * Sq * D;
    const T* doh = static_cast<const T*>(a.dout) + bh * Sq * D;
    for (int r0 = row_lo; r0 < row_hi; r0 += BM) {
      stage_t<T, D, true>(qh, r0, row_hi, qt, a.scale);
      if (!Q_DO_SHARED) stage_t<T, D, false>(doh, r0, row_hi, dot, 0.f);
      if (!RESIDENT) kv.stage(false, bkv, c0, Skv, kt);
      int rs[4], re[4];
      float lcol[4], dcol[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + tx * 4 + j;
        row_range(a.ranges, r < row_hi ? r : Sq, Sq, Skv, rs[j], re[j]);
        const float lv = r < row_hi ? a.lse[bh * Sq + r] : 0.f;
        lcol[j] = (lv == -INFINITY) ? 0.f : lv;
        dcol[j] = r < row_hi ? a.di[bh * Sq + r] : 0.f;
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
        __syncthreads();  // every thread is done with K^T (and Q_s^T)
        if (Q_DO_SHARED) stage_t<T, D, false>(doh, r0, row_hi, dot, 0.f);
        kv.stage(true, bkv, c0, Skv, vt);
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
      if (Q_DO_SHARED) stage_t<T, D, true>(qh, r0, row_hi, qt, a.scale);
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
    float* dkr = a.out0 + (bkv * Skv + key) * D;
    float* dvr = a.out1 + (bkv * Skv + key) * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      dkr[tx + 16 * e] = dk_acc[i][e];
      dvr[tx + 16 * e] = dv_acc[i][e];
    }
  }
}

}  // namespace mfa

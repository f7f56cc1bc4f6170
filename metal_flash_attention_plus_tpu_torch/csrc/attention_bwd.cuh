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
//
// Four bodies each: dq_body and dkv_body, scalar fp32 FMAs over the
// transposed fp32 tiles (every fp32 instance up to D = 288), and
// dq_body32 and dkv_body32, the same in 32-row tiles above 288 (the flash
// and the exact quantized kernels' fp32 instances at DeepSeek's absorbed
// 576: scalar32);
// dq_tc_body and dkv_tc_body, bf16 mma.sync over bf16 tiles (the bf16
// instances up to D = 256); dq_wide_body and dkv_wide_body, bf16 mma.sync
// with tiles cut for MLA's D = 288 (the flash and the exact quantized
// kernels' bf16 instances at 288; dkv_wide_body splits the GQA group over
// CTAs into an fp32 workspace that flash_dkv_merge_kernel sums in split
// order); and dq_latent_body and dkv_latent_body, bf16 mma.sync at 576
// (the flash and the exact quantized kernels' bf16 instances there; the
// dK/dV's group split and merge as at 288).  dq_tc / dkv_tc / bwd_wide /
// bwd_latent say which; ops/flash_attention_bwd.py::dq_body / dkv_body
// give the same answer.  fp32 stays off the tensor cores: TF32 keeps ~3
// digits and the fp32 instances are held to 2e-5.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "common.cuh"
#include "mma.cuh"

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

// The span [*s_rmin, *s_rmax] of query rows whose range meets keys
// [c0, c_end); *s_rmax < 0 when none does.  Ends with a barrier.
__device__ __forceinline__ void query_span(const int32_t* ranges, int Sq,
                                           int Skv, int c0, int c_end,
                                           int* s_rmin, int* s_rmax) {
  if (threadIdx.x == 0) {
    *s_rmin = INT_MAX;
    *s_rmax = -1;
  }
  __syncthreads();
  int rmin = INT_MAX, rmax = -1;
  for (int r = threadIdx.x; r < Sq; r += blockDim.x) {
    int st, en;
    row_range(ranges, r, Sq, Skv, st, en);
    if (en > st && st < c_end && en > c0) {
      rmin = min(rmin, r);
      rmax = max(rmax, r);
    }
  }
  if (rmax >= 0) {
    atomicMin(s_rmin, rmin);
    atomicMax(s_rmax, rmax);
  }
  __syncthreads();
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

  query_span(a.ranges, Sq, Skv, c0, c_end, &s_rmin, &s_rmax);
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

// ---------------------------------------------------------------------------
// The tensor-core dK/dV body (T = bf16, D <= 256)
//
// The grid, the walk and the numerics are dkv_body's: one CTA per (64 keys,
// b, kv head) owns its dK and dV tile and walks the GQA group's q heads x
// the span of query rows that meets its keys, 64 rows a step, no atomics.
// Operands are bf16 row-major tiles [rows][D] in shared memory (rows padded
// by 16 bytes, so ldmatrix's eight row addresses fall in distinct banks):
// K and V resident (bf16 rows copied with cp.async, or payload bytes copied
// with cp.async and dequantized there, as dkv_body's staging rounds them);
// per step Q (then scaled and rounded to Q_s in place), dO and the rows'
// L, D and key ranges arrive by cp.async into one of two buffers while the
// other step computes.  The 4 * NS warps (NS = dkv_tc_split) take 16 keys
// each:
//   - S^T = K.Q_s^T and dP^T = V.dO^T by bf16 m16n8k16 into fp32, a warp
//     its 16 keys x 64 / NS query columns (ldmatrix of both operands'
//     rows: mma_nt);
//   - P^T = exp(S^T + bias - L) (0 where masked; as exp2, which the
//     element-wise steps' cost favours), dS^T = P^T (dP^T - D) on the
//     fragments, in dkv_body's order;
//   - dV += round_bf16(P^T).dO and dK += round_bf16(dS^T).Q_s by bf16
//     m16n8k16 into fp32 accumulators, a warp its 16 keys x D / NS lanes,
//     dO and Q_s read by ldmatrix.trans (mma_rn).  With NS = 1 (D <= 64)
//     a warp's P^T / dS^T fragments are the A operand as they are (the C
//     fragment of two m16n8 blocks is the A fragment of one m16n8k16):
//     nothing goes through shared memory; with NS > 1 they pass through two
//     bf16 [64][64] tiles.
// Registers: the accumulators take 2 * 16 * D / NS fp32 a warp, 64 a
// thread for D >= 64 (32 at D = 32); NS grows with D (1, 1, 2, 4 at D = 32,
// 64, 128, 256) so they do not outgrow the 255 a thread.  The 4-warp CTAs
// (D <= 64) are held to 170 registers, three an SM: the element-wise steps
// and the products' latency, not the tensor cores, bound them.
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int dkv_tc_split() {
  return D <= 64 ? 1 : D / 64;
}

template <int D>
__host__ __device__ constexpr int dkv_tc_threads() {
  return 128 * dkv_tc_split<D>();
}

// CTAs an SM the body is compiled for (its __launch_bounds__): three 4-warp
// CTAs at D <= 64 (<= 170 registers a thread), else one.
template <int D>
__host__ __device__ constexpr int dkv_tc_min_blocks() {
  return D <= 64 ? 3 : 1;
}

// Whether the dK/dV of T at head dim D runs on the tensor cores: every
// bf16 width, on dkv_tc_body up to D = 256, on dkv_wide_body at MLA's 288
// (bwd_wide; float and quantized K/V alike) and on dkv_latent_body at
// DeepSeek's 576 (bwd_latent; float K/V).  Else dkv_body (dkv_body32
// above 288).
template <typename T, int D>
__host__ __device__ constexpr bool dkv_tc() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Whether a tensor-core dQ or dK/dV at head dim D takes the wide bodies
// (dq_wide_body, dkv_wide_body), whose tiles are cut for D = 288.
template <int D>
__host__ __device__ constexpr bool bwd_wide() {
  return D > 256 && D <= 288;
}

// Whether a tensor-core dQ or dK/dV at head dim D takes the latent bodies
// (dq_latent_body, dkv_latent_body), whose tiles are cut for DeepSeek's
// absorbed width 576 (float and quantized K/V alike).
template <int D>
__host__ __device__ constexpr bool bwd_latent() {
  return D > 288;
}

// Byte offsets of dkv_tc_body's shared memory (~218 KB at D = 256).
template <int D>
struct DkvTcSmem {
  static constexpr int NS = dkv_tc_split<D>();
  static constexpr int ROW = 2 * D + 16;    // a bf16 row [.., D]
  static constexpr int TILE = BN * ROW;     // 64 rows
  static constexpr int P_LD = 2 * BM + 16;  // a P^T / dS^T row [key][64]
  static constexpr int STATS = 4 * BM * 4;  // L [64], D [64], ranges [64][2]
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;   // two buffers
  static constexpr int DO = 4 * TILE;  // two buffers
  static constexpr int ST = 6 * TILE;  // two buffers
  static constexpr int PS = ST + 2 * STATS;
  static constexpr size_t BYTES = PS + (NS > 1 ? 2 * BN * P_LD : 0);
};

// cp.async rows [row0, row0 + ROWS) of a bf16 [rows, D] matrix into dst
// (ROW bytes apart), NT threads; rows from `limit` are zeros.
template <int D, int ROW, int NT, int ROWS = 64>
__device__ __forceinline__ void stage_rows_async(const __nv_bfloat16* src,
                                                 int row0, int limit,
                                                 uint8_t* dst) {
  constexpr int CPR = 2 * D / 16;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * ROW + c * 16,
               src + (size_t)(ok ? row0 + r : 0) * D + c * 8, ok ? 16 : 0);
  }
}

// acc[j] += A[ar0, ar0 + 16) . B[br0 + 8j, br0 + 8j + 8)^T over 16 * KC
// lanes: A and B bf16 row-major tiles whose rows hold k (A_LD, B_LD bytes
// a row), both read by ldmatrix; NB even.
template <int KC, int NB, int A_LD, int B_LD>
__device__ __forceinline__ void mma_nt(const uint8_t* A, int ar0,
                                       const uint8_t* B, int br0,
                                       float (&acc)[NB][4]) {
  const int lane = threadIdx.x & 31;
  const uint8_t* ap = A + (ar0 + ldsm_a_row(lane)) * A_LD + ldsm_a_byte(lane);
  const uint8_t* bp = B + (br0 + ldsm_b_row(lane)) * B_LD + ldsm_b_byte(lane);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, ap + kc * 32);
#pragma unroll
    for (int j2 = 0; j2 < NB / 2; ++j2) {
      uint32_t bf[4];
      ldsm_x4(bf, bp + j2 * 16 * B_LD + kc * 32);
      mma_bf16(acc[2 * j2], af, bf[0], bf[1], acc[2 * j2]);
      mma_bf16(acc[2 * j2 + 1], af, bf[2], bf[3], acc[2 * j2 + 1]);
    }
  }
}

// acc[j] += A . B[k0, k0 + 16)[bc0 + 8j, bc0 + 8j + 8): A one m16n8k16 A
// fragment (16 rows x 16 k), B a bf16 row-major tile [k][n] (B_LD bytes a
// row) read by ldmatrix.trans; NB even.
template <int NB, int B_LD>
__device__ __forceinline__ void mma_rn(const uint32_t (&af)[4],
                                       const uint8_t* B, int k0, int bc0,
                                       float (&acc)[NB][4]) {
  const int lane = threadIdx.x & 31;
  const uint8_t* bp =
      B + (k0 + ldsm_t_k(lane)) * B_LD + (bc0 + ldsm_t_n(lane)) * 2;
#pragma unroll
  for (int n2 = 0; n2 < NB / 2; ++n2) {
    uint32_t bf[4];
    ldsm_x4_t(bf, bp + n2 * 32);
    mma_bf16(acc[2 * n2], af, bf[0], bf[1], acc[2 * n2]);
    mma_bf16(acc[2 * n2 + 1], af, bf[2], bf[3], acc[2 * n2 + 1]);
  }
}

// Two C fragments (16 rows x columns [16 kc, 16 kc + 16): blocks 2 kc and
// 2 kc + 1) rounded to bf16 as the A fragment of those rows with the
// columns as k.
template <int NB>
__device__ __forceinline__ void c_to_a_bf16(const float (&c)[NB][4], int kc,
                                            uint32_t (&af)[4]) {
  af[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  af[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  af[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  af[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Q rows in place: x -> round_bf16(x * scale), as stage_t<T, D, true> rounds
// them (bf16_bits gives cvt.rn's bits on the FP32 pipe); NT threads, ROWS
// rows.
template <int D, int ROW, int NT, int ROWS = 64>
__device__ __forceinline__ void scale_rows_bf16(uint8_t* tile, float scale) {
  constexpr int CPR = 2 * D / 16;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    uint4* p = reinterpret_cast<uint4*>(tile + (i / CPR) * ROW +
                                        (i % CPR) * 16);
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = __fmul_rn(__uint_as_float(w[e] << 16), scale);
      const float hi = __fmul_rn(__uint_as_float(w[e] & 0xFFFF0000u), scale);
      w[e] = __byte_perm(bf16_bits(lo), bf16_bits(hi), 0x7632);
    }
    *p = u;
  }
}

// L, D and the key ranges of query rows [r0, r0 + ROWS) into st by
// cp.async: st[0, ROWS) L, st[ROWS, 2 ROWS) D, st[2 ROWS, 4 ROWS) the
// [start, end) pairs; zeros from row_hi.  NT threads.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_row_stats_async(const BwdArgs& a,
                                                      size_t bh, int r0,
                                                      int row_hi,
                                                      float* st) {
  for (int i = threadIdx.x; i < 4 * ROWS; i += NT) {
    const int r = r0 + (i < 2 * ROWS ? i % ROWS : (i - 2 * ROWS) / 2);
    const bool ok = r < row_hi;
    const float* src =
        i < ROWS ? a.lse + bh * a.Sq + r
        : i < 2 * ROWS ? a.di + bh * a.Sq + r
                       : reinterpret_cast<const float*>(a.ranges) + 2 * r +
                             (i & 1);
    cp_async4(st + i, ok ? src : a.lse, ok ? 4 : 0);
  }
}

// P^T and dS^T in place on a warp's S^T and dP^T fragments, in dkv_body's
// order: element (key key0 + g + 8i, query column qc0 + 8j + 2tq + c, row
// r0 + that column) at [j][2i + c]; st holds the ROWS rows' statistics
// (stage_row_stats_async).  P^T = exp(S^T + bias - L), 0 where masked, as
// exp2 of S log2(e) - L log2(e) (the argument rounded once more: ~1e-6 of
// P, far below its bf16 rounding), live where key - start < end - start;
// dS^T = P^T (dP^T - D).
template <int NQB, int ROWS>
__device__ __forceinline__ void dkv_probs(float (&s)[NQB][4],
                                          float (&dp)[NQB][4],
                                          const float* st, int qc0, int key0,
                                          int r0, int row_hi,
                                          const float* bh_bias, int Skv) {
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NQB; ++j) {
    const int qc = qc0 + 8 * j + 2 * tq;
    const float2 lv = *reinterpret_cast<const float2*>(st + qc);
    const float2 dv2 = *reinterpret_cast<const float2*>(st + ROWS + qc);
    const int4 rg = *reinterpret_cast<const int4*>(st + 2 * ROWS + 2 * qc);
    const float l2[2] = {lv.x == -INFINITY ? 0.f : lv.x * LOG2E,
                         lv.y == -INFINITY ? 0.f : lv.y * LOG2E};
    const float dq[2] = {dv2.x, dv2.y};
    const int rs[2] = {rg.x, rg.z};
    const unsigned span[2] = {(unsigned)max(min(rg.y, Skv) - rg.x, 0),
                              (unsigned)max(min(rg.w, Skv) - rg.z, 0)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + g + 8 * i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = r0 + qc + c;
        float x = s[j][2 * i + c];
        if (bh_bias && row < row_hi && key < Skv)
          x += bh_bias[(size_t)row * Skv + key];
        const bool live = (unsigned)(key - rs[c]) < span[c];
        const float p = live ? exp2f(fmaf(x, LOG2E, -l2[c])) : 0.f;
        s[j][2 * i + c] = p;
        dp[j][2 * i + c] = p * (dp[j][2 * i + c] - dq[c]);
      }
    }
  }
}

// The tensor-core dK/dV (see above).  KV gives tc_load<NT, ROW>(is_v, kv
// head, t0, limit, dst, raw) (cp.async of the tile's 64 rows: bf16 rows
// into dst, ROW bytes apart, or payload rows into the scratch `raw`, D
// bytes apart) and tc_convert<NT, ROW>(...) (raw -> dst as bf16 rows;
// nothing for bf16 rows); NT threads.
template <int D, typename KV>
__device__ __forceinline__ void dkv_tc_body(const BwdArgs& a, const KV& kv) {
  using L = DkvTcSmem<D>;
  constexpr int NS = L::NS;
  constexpr int NT = dkv_tc_threads<D>();
  constexpr int QW = BM / NS;  // query columns of a warp's S^T, dP^T
  constexpr int NQB = QW / 8;
  constexpr int DW = D / NS;  // dK / dV lanes a warp accumulates
  constexpr int NDB = DW / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __shared__ int s_rmin, s_rmax;

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kw = warp & 3;     // keys c0 + 16 kw + [0, 16)
  const int part = warp >> 2;  // query columns / lanes part * QW, part * DW
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bkv = (size_t)b * a.Hkv + hk;
  uint8_t* sk = smem_tc + L::K;
  uint8_t* sv = smem_tc + L::V;

  // K and V (their payloads into the second Q / dO buffers), then step 0.
  kv.template tc_load<NT, L::ROW>(false, bkv, c0, Skv, sk,
                                 smem_tc + L::Q + L::TILE);
  kv.template tc_load<NT, L::ROW>(true, bkv, c0, Skv, sv,
                                 smem_tc + L::DO + L::TILE);
  cp_async_commit();
  query_span(a.ranges, Sq, Skv, c0, min(c0 + BN, Skv), &s_rmin, &s_rmax);
  const int row_lo = s_rmin;
  const int row_hi = s_rmax + 1;
  const int tiles = row_hi > row_lo ? (row_hi - row_lo + BM - 1) / BM : 0;
  const int steps = group * tiles;
  auto head_of = [&](int it) {
    const int gi = it / tiles;
    return a.interleaved ? gi * a.Hkv + hk : hk * group + gi;
  };
  auto prefetch = [&](int it, int buf) {
    const size_t bh = (size_t)b * a.Hq + head_of(it);
    const int r0 = row_lo + (it % tiles) * BM;
    stage_rows_async<D, L::ROW, NT>(
        static_cast<const __nv_bfloat16*>(a.q) + bh * Sq * D, r0, row_hi,
        smem_tc + L::Q + buf * L::TILE);
    stage_rows_async<D, L::ROW, NT>(
        static_cast<const __nv_bfloat16*>(a.dout) + bh * Sq * D, r0, row_hi,
        smem_tc + L::DO + buf * L::TILE);
    stage_row_stats_async<BM, NT>(
        a, bh, r0, row_hi,
        reinterpret_cast<float*>(smem_tc + L::ST + buf * L::STATS));
  };
  if (steps > 0) prefetch(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // K and V's rows landed
  kv.template tc_convert<NT, L::ROW>(false, bkv, c0, Skv, sk,
                                    smem_tc + L::Q + L::TILE);
  kv.template tc_convert<NT, L::ROW>(true, bkv, c0, Skv, sv,
                                    smem_tc + L::DO + L::TILE);

  float dk[NDB][4], dv[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // step it staged, K and V converted; step it - 1 done
    if (it + 1 < steps) prefetch(it + 1, buf ^ 1);
    cp_async_commit();
    uint8_t* sq = smem_tc + L::Q + buf * L::TILE;
    const uint8_t* sdo = smem_tc + L::DO + buf * L::TILE;
    const float* st =
        reinterpret_cast<const float*>(smem_tc + L::ST + buf * L::STATS);
    scale_rows_bf16<D, L::ROW, NT>(sq, a.scale);
    __syncthreads();  // Q_s ready

    const int h = head_of(it);
    const int r0 = row_lo + (it % tiles) * BM;
    const float* bh_bias =
        a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
    float s[NQB][4], dp[NQB][4];
#pragma unroll
    for (int j = 0; j < NQB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nt<D / 16, NQB, L::ROW, L::ROW>(sk, 16 * kw, sq, part * QW, s);
    mma_nt<D / 16, NQB, L::ROW, L::ROW>(sv, 16 * kw, sdo, part * QW, dp);
    dkv_probs<NQB, BM>(s, dp, st, part * QW, c0 + 16 * kw, r0, row_hi,
                       bh_bias, Skv);

    // dV += round_bf16(P^T).dO, dK += round_bf16(dS^T).Q_s, 16 queries a
    // step: the A fragments from the warp's own C fragments (NS = 1) or
    // from the CTA's P^T and dS^T tiles.
    uint8_t* ps = smem_tc + L::PS;
    uint8_t* dss = ps + BN * L::P_LD;
    if constexpr (NS > 1) {
#pragma unroll
      for (int j = 0; j < NQB; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int off = (16 * kw + g + 8 * i) * L::P_LD +
                          (part * QW + 8 * j + 2 * tq) * 2;
          *reinterpret_cast<uint32_t*>(ps + off) =
              pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(dss + off) =
              pack_bf16(dp[j][2 * i], dp[j][2 * i + 1]);
        }
      __syncthreads();  // the CTA's P^T and dS^T tiles
    }
    const int a_off =
        (16 * kw + ldsm_a_row(lane)) * L::P_LD + ldsm_a_byte(lane);
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t pa[4], dsa[4];
      if constexpr (NS == 1) {
        c_to_a_bf16(s, kc, pa);
        c_to_a_bf16(dp, kc, dsa);
      } else {
        ldsm_x4(pa, ps + a_off + kc * 32);
        ldsm_x4(dsa, dss + a_off + kc * 32);
      }
      mma_rn<NDB, L::ROW>(pa, sdo, 16 * kc, part * DW, dv);
      mma_rn<NDB, L::ROW>(dsa, sq, 16 * kc, part * DW, dk);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + 16 * kw + g + 8 * i;
    if (key >= Skv) continue;
    float* dkr = a.out0 + (bkv * Skv + key) * D + part * DW + 2 * tq;
    float* dvr = a.out1 + (bkv * Skv + key) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) =
          make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * j) =
          make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}


// ---------------------------------------------------------------------------
// The tensor-core dQ body (T = bf16, D <= 256)
//
// dq_body's grid and numerics on bf16 mma.sync: one CTA per (64 query rows,
// b, q head), the row tiles last first (under a causal mask they walk the
// most keys), walking the live key span [min start, max end) of its rows in
// 64-key tiles aligned from key 0.  Q (scaled and rounded to Q_s in place
// where SCALE_Q, bit for bit as stage_t<T, D, true>) and dO stay resident
// as bf16 rows; each key tile's K and V rows arrive by cp.async while the
// previous tile computes: bf16 rows into one of two buffers, or payload
// rows into one of two scratch buffers, dequantized into one bf16 tile at
// the start of the tile's step (KV::RAW), as dq_body's staging rounds them;
// the per-token ksr / vsr beside them.  L, D and the key ranges are read
// once per row.  The 4 * NS warps (NS = dkv_tc_split) take 16 query rows
// each:
//   - S = Q_s.K^T and dP = dO.V^T by bf16 m16n8k16 into fp32, a warp its
//     16 rows x 64 / NS key columns (ldmatrix of both operands' rows:
//     mma_nt), times ksr / vsr where given;
//   - P = 2^(S log2(e) + bias log2(e) - L log2(e)) (ex2.approx.ftz; 0 where
//     masked, no mask select on a key range every row of the warp keeps),
//     dS = P (dP - D), dbias = dS on request;
//   - dQ += round_bf16(dS (x ksr)).K by bf16 m16n8k16 into fp32, a warp its
//     16 rows x D / NS lanes, K read by ldmatrix.trans (mma_rn).  With
//     NS = 1 (D <= 64) the dS fragments are the A operand as they are (the
//     C fragment of two m16n8 blocks is the A fragment of one m16n8k16);
//     with NS > 1 they pass through one bf16 [64][64] tile.
// dQ is stored times dqsc[d] or scale.  Registers: the dQ accumulator takes
// D / (2 NS) fp32 a thread, S and dP 32 / NS each, so NS = D / 64 keeps
// D = 256 at ~125 (~165 at D <= 64, where one warp holds S and dP for all
// 64 keys); shared memory ~208 KB at D = 256 (one CTA an SM), ~112 KB at
// D = 128 (two), ~55 KB at D = 64 (three, as the registers allow).
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int dq_tc_threads() {
  return 128 * dkv_tc_split<D>();
}

// CTAs an SM the body is compiled for: three 4-warp CTAs at D <= 64 (<= 170
// registers a thread), two at D = 128, one at D = 256.
template <int D>
__host__ __device__ constexpr int dq_tc_min_blocks() {
  return D <= 64 ? 3 : (D <= 128 ? 2 : 1);
}

// Whether the dQ of T at head dim D runs on the tensor cores (dq_tc_body,
// or dq_wide_body where bwd_wide; else dq_body);
// ops/flash_attention_bwd.py::dq_body gives the same answer.
template <typename T, int D>
__host__ __device__ constexpr bool dq_tc() {
  return dkv_tc<T, D>();
}

// Byte offsets of dq_tc_body's shared memory.  RAW: K and V arrive as
// payload rows (D bytes, two buffers each) dequantized into one bf16 tile
// each; else as bf16 rows into two tiles each.
template <int D, bool RAW>
struct DqTcSmem {
  static constexpr int NS = dkv_tc_split<D>();
  static constexpr int ROW = 2 * D + 16;    // a bf16 row [.., D]
  static constexpr int TILE = BN * ROW;     // 64 rows
  static constexpr int S_LD = 2 * BN + 16;  // a dS row [query][64 keys]
  static constexpr int KV_BUFS = RAW ? 1 : 2;
  static constexpr int Q = 0;
  static constexpr int DO = TILE;
  static constexpr int K = 2 * TILE;
  static constexpr int V = K + KV_BUFS * TILE;
  static constexpr int RAW_K = V + KV_BUFS * TILE;  // two buffers
  static constexpr int RAW_V = RAW_K + (RAW ? 2 * BN * D : 0);
  static constexpr int SC = RAW_V + (RAW ? 2 * BN * D : 0);  // ksr|vsr, x2
  static constexpr int DS = SC + 2 * 2 * BN * 4;
  static constexpr size_t BYTES = DS + (NS > 1 ? BM * S_LD : 0);
};

// The statistics of a thread's two query rows row0 and row0 + 8 in the
// dQ bodies' fragments: L log2(e) (0 for L = -inf), D, the key range as
// start and length, and the keys [live_lo, live_hi) live in every row of
// the warp.
struct DqRows {
  float l2[2], dd[2];
  int rs[2];
  unsigned span[2];
  int live_lo, live_hi;
};

__device__ __forceinline__ DqRows dq_rows(const BwdArgs& a, size_t bh,
                                          int row0) {
  DqRows w;
  w.live_lo = 0;
  w.live_hi = INT_MAX;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    int st, en;
    row_range(a.ranges, row, a.Sq, a.Skv, st, en);
    w.rs[i] = st;
    w.span[i] = (unsigned)max(en - st, 0);
    w.live_lo = max(w.live_lo, st);
    w.live_hi = min(w.live_hi, en);
    const float lv = row < a.Sq ? a.lse[bh * a.Sq + row] : 0.f;
    w.l2[i] = lv == -INFINITY ? 0.f : lv * LOG2E;
    w.dd[i] = row < a.Sq ? a.di[bh * a.Sq + row] : 0.f;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    w.live_lo = max(w.live_lo, __shfl_xor_sync(0xffffffffu, w.live_lo, off));
    w.live_hi = min(w.live_hi, __shfl_xor_sync(0xffffffffu, w.live_hi, off));
  }
  return w;
}

// The tensor-core dQ (see above).  KV: tc_load / tc_convert as for
// dkv_tc_body, and RAW (whether tc_load fills the scratch and tc_convert
// the tile).
template <int D, bool SCALE_Q, typename KV>
__device__ __forceinline__ void dq_tc_body(const BwdArgs& a, const KV& kv) {
  using L = DqTcSmem<D, KV::RAW>;
  constexpr int NS = L::NS;
  constexpr int NT = dq_tc_threads<D>();
  constexpr int KW = BN / NS;  // key columns of a warp's S, dP
  constexpr int NKB = KW / 8;
  constexpr int DW = D / NS;  // dQ lanes a warp accumulates
  constexpr int NDB = DW / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __shared__ int s_lo, s_hi;

  const int Sq = a.Sq, Skv = a.Skv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp & 3;     // query rows r0 + 16 rw + [0, 16)
  const int part = warp >> 2;  // key columns part * KW, dQ lanes part * DW
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  const float* ksr = a.ksr ? a.ksr + bk * Skv : nullptr;
  const float* vsr = a.vsr ? a.vsr + bk * Skv : nullptr;
  uint8_t* sq = smem_tc + L::Q;
  const uint8_t* sdo = smem_tc + L::DO;

  stage_rows_async<D, L::ROW, NT>(
      static_cast<const __nv_bfloat16*>(a.q) + bh * Sq * D, r0, Sq, sq);
  stage_rows_async<D, L::ROW, NT>(
      static_cast<const __nv_bfloat16*>(a.dout) + bh * Sq * D, r0, Sq,
      smem_tc + L::DO);
  cp_async_commit();
  key_span(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_hi = s_hi;
  const int c0 = (s_lo / BN) * BN;
  const int tiles = c0 < c_hi ? (c_hi - c0 + BN - 1) / BN : 0;
  // Tile it's K and V rows (and ksr, vsr) into buffer `buf`: zeros from
  // c_hi.
  auto load = [&](int it, int buf) {
    const int t0 = c0 + it * BN;
    kv.template tc_load<NT, L::ROW>(false, bk, t0, c_hi,
                                   smem_tc + L::K + buf * L::TILE,
                                   smem_tc + L::RAW_K + buf * BN * D);
    kv.template tc_load<NT, L::ROW>(true, bk, t0, c_hi,
                                   smem_tc + L::V + buf * L::TILE,
                                   smem_tc + L::RAW_V + buf * BN * D);
    float* sc = reinterpret_cast<float*>(smem_tc + L::SC) + buf * 2 * BN;
    const int i = threadIdx.x;
    const float* src = i < BN ? ksr : vsr;
    if (i < 2 * BN && src) {
      const bool ok = t0 + i % BN < c_hi;
      cp_async4(sc + i, ok ? src + t0 + i % BN : src, ok ? 4 : 0);
    }
  };
  if (tiles > 0) load(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // Q's and dO's rows landed
  if (SCALE_Q) scale_rows_bf16<D, L::ROW, NT>(sq, a.scale);

  const DqRows w = dq_rows(a, bh, r0 + 16 * rw + g);

  float acc[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    const int t0 = c0 + it * BN;
    cp_async_wait<0>();
    __syncthreads();  // tile it staged, Q scaled; tile it - 1 done
    if (it + 1 < tiles) load(it + 1, buf ^ 1);
    cp_async_commit();
    const int kb = KV::RAW ? 0 : buf;
    uint8_t* sk = smem_tc + L::K + kb * L::TILE;
    uint8_t* sv = smem_tc + L::V + kb * L::TILE;
    if constexpr (KV::RAW) {
      kv.template tc_convert<NT, L::ROW>(false, bk, t0, c_hi, sk,
                                        smem_tc + L::RAW_K + buf * BN * D);
      kv.template tc_convert<NT, L::ROW>(true, bk, t0, c_hi, sv,
                                        smem_tc + L::RAW_V + buf * BN * D);
      __syncthreads();  // K and V dequantized
    }
    const float* sks =
        reinterpret_cast<const float*>(smem_tc + L::SC) + buf * 2 * BN;

    // S and dP for rows 16 rw + [0, 16) and keys kc0 + [0, KW): element
    // (row g + 8i, key kc0 + 8j + 2tq + c) at [j][2i + c].
    const int kc0 = part * KW;
    float s[NKB][4], dp[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nt<D / 16, NKB, L::ROW, L::ROW>(sq, 16 * rw, sk, kc0, s);
    mma_nt<D / 16, NKB, L::ROW, L::ROW>(sdo, 16 * rw, sv, kc0, dp);
    if (ksr) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sks[kc0 + 8 * j + 2 * tq + (e & 1)];
    }
    if (vsr) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] *= sks[BN + kc0 + 8 * j + 2 * tq + (e & 1)];
    }

    // P, dS (dbias) in dq_body's order; s[j][e] becomes dS (x ksr), the
    // value dS.K rounds.
    const bool whole = t0 + kc0 >= w.live_lo && t0 + kc0 + KW <= w.live_hi;
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = r0 + 16 * rw + g + 8 * i;
        const int key = t0 + kc0 + 8 * j + 2 * tq + (e & 1);
        float x = s[j][e];
        if (bh_bias && row < Sq && key < Skv)
          x += bh_bias[(size_t)row * Skv + key];
        float p = ex2_approx(fmaf(x, LOG2E, -w.l2[i]));
        if (!whole) p = (unsigned)(key - w.rs[i]) < w.span[i] ? p : 0.f;
        const float ds = p * (dp[j][e] - w.dd[i]);
        if (a.out1 && row < Sq && key < Skv)
          a.out1[(bh * Sq + row) * Skv + key] = ds;
        s[j][e] = ksr ? ds * sks[kc0 + 8 * j + 2 * tq + (e & 1)] : ds;
      }

    // dQ += round_bf16(dS).K, 16 keys a step: the A fragments from the
    // warp's own C fragments (NS = 1) or from the CTA's dS tile.
    uint8_t* sds = smem_tc + L::DS;
    if constexpr (NS > 1) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(
              sds + (16 * rw + g + 8 * i) * L::S_LD +
              (kc0 + 8 * j + 2 * tq) * 2) =
              pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
      __syncthreads();  // the CTA's dS tile
    }
    const int a_off =
        (16 * rw + ldsm_a_row(lane)) * L::S_LD + ldsm_a_byte(lane);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t af[4];
      if constexpr (NS == 1)
        c_to_a_bf16(s, kc, af);
      else
        ldsm_x4(af, sds + a_off + kc * 32);
      mma_rn<NDB, L::ROW>(af, sk, 16 * kc, part * DW, acc);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * rw + g + 8 * i;
    if (row >= Sq) continue;
    float* out = a.out0 + (bh * Sq + row) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      const int d = part * DW + 8 * j + 2 * tq;
      const float m0 = a.dqsc ? a.dqsc[bk * D + d] : a.scale;
      const float m1 = a.dqsc ? a.dqsc[bk * D + d + 1] : a.scale;
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * i] * m0, acc[j][2 * i + 1] * m1);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide bodies: the bf16 dK/dV and dQ at MLA's D = 288
//
// Replace ops/flash_attention_bwd.py::_dkv_kernel and ::_dq_kernel for the
// bf16 instances above D = 256 (flash_dkv_wide_kernel,
// flash_dq_wide_kernel over float K/V; qflash_dkv_wide_kernel,
// qflash_dq_wide_kernel over int8 / int4 payloads).  The function is
// dkv_tc_body's and dq_tc_body's (the same roundings, P as exp2 of
// S log2(e) - L log2(e)) over the same KV policies: a payload (KV::RAW)
// arrives as its bytes by cp.async and is dequantized into the bf16 tile
// in shared memory, and the quantized dQ takes its folded scales (ksr,
// vsr on S, dS and dP's columns, dqsc at the store; Q arrives pre-scaled).
// Bound: tensor-core operations (8 D a live pair for dK/dV, 6 D for dQ),
// as below D = 256.
//
// Why the D <= 256 layouts do not stretch to 288: a bf16 row is 592 bytes
// with its 16-byte pad (ROW), a 64-row tile 37,888.  dkv_tc_body holds K
// and V plus two buffers each of 64 Q and dO rows: six tiles, 227 KB before
// its statistics and P^T / dS^T tiles.  dq_tc_body holds Q and dO plus two
// buffers each of 64 K and V rows: the same six tiles.  Its D / 64 warp
// split is 4.5 at 288.  And the dK / dV accumulators of a 64-key tile are
// 2 x 64 x 288 fp32, 144 a thread at 8 warps, too many beside S and dP.
//
// dkv_wide_body: one CTA per (64 keys, b, kv head, split) and 12 warps.
//   - Shared memory (205,312 bytes at 288): K and V resident (75,776); Q
//     and dO in steps of 48 query rows, two buffers each (113,664); the
//     steps' L, D and key ranges, two buffers (1,536); the P^T and dS^T
//     tiles, bf16 [64 keys][48 queries] (14,336).  A step is 48 rows, not
//     64, so that both buffers fit.  K's and V's payload rows (64 x 288
//     bytes each) land in the second Q and dO buffers before the walk
//     starts, and are dequantized from there, as in dkv_tc_body.
//   - Warps: 4 key slices of 16 x 3 parts.  For S^T = K.Q_s^T and dP^T =
//     V.dO^T a part is 16 of the step's 48 query columns; for dV +=
//     round(P^T).dO and dK += round(dS^T).Q_s it is 96 of D's 288 lanes (a
//     multiple of 16, as ldmatrix.trans wants).  The two splits are by 3
//     both, so each warp does the same work in each product.  Registers:
//     dK and dV 2 x 16 x 96 fp32 a warp, 96 a thread, S and dP 16.
//   - The grid: 64-key tiles x kv heads gave 64 CTAs at MLA's training
//     shape (B=2, one latent head, S=2048) on 132 SMs, each walking 16 q
//     heads in series.  So the GQA group is dealt into `splits` runs of
//     whole q heads (ops/flash_attention_bwd.py::dkv_splits plans them from
//     shapes), one CTA a run; with splits > 1 each CTA writes its partial
//     fp32 dK and dV into the wrapper's workspace [splits, 2, B, Hkv, Skv,
//     D], and flash_dkv_merge_kernel sums the splits in split order.  No
//     floating-point atomics: two calls give the same bits.
// dq_wide_body: dq_tc_body's grid (one CTA per 64 query rows, b, q head;
// the row tiles last first) with 8 warps.
//   - Shared memory (156,672 bytes over float K/V): Q and dO resident
//     (75,776); K and V in tiles of 32 keys, two buffers each (75,776);
//     the dS tile, bf16 [64 queries][32 keys] (5,120).  Over payloads
//     (156,160 bytes): one bf16 tile each of K and V (37,888), their
//     payload rows in two buffers each (36,864) and the tile's ksr and
//     vsr, two buffers (512), as DqTcSmem's RAW layout.
//   - Warps: 4 row slices of 16 x 2 parts: 16 of the tile's 32 keys for S
//     and dP, 144 of D's lanes for dQ += round(dS).K.  Registers: the dQ
//     accumulator 72 a thread, S and dP 16.
// ---------------------------------------------------------------------------

template <int D>
struct DkvWideSmem {
  static constexpr int NS = 3;                // query and lane parts
  static constexpr int QS = 48;               // query rows a step
  static constexpr int ROW = 2 * D + 16;      // a bf16 row [.., D]
  static constexpr int KTILE = BN * ROW;      // 64 keys
  static constexpr int QTILE = QS * ROW;      // 48 query rows
  static constexpr int P_LD = 2 * QS + 16;    // a P^T / dS^T row [key][48]
  static constexpr int STATS = 4 * QS * 4;    // L [48], D [48], ranges [48][2]
  static constexpr int K = 0;
  static constexpr int V = KTILE;
  static constexpr int Q = 2 * KTILE;         // two buffers
  static constexpr int DO = Q + 2 * QTILE;    // two buffers
  static constexpr int ST = DO + 2 * QTILE;   // two buffers
  static constexpr int PS = ST + 2 * STATS;
  static constexpr int DS = PS + BN * P_LD;
  static constexpr size_t BYTES = DS + BN * P_LD;
  static_assert(D % (16 * NS) == 0 && QS % (16 * NS) == 0,
                "a part's lanes and query columns are whole 16-wide steps");
};

constexpr int DKV_WIDE_THREADS = 384;  // 4 key slices x 3 parts

// dK/dV for one (64 keys, b, kv head) over the q heads of split `sp` of
// the GQA group (see above).  out0 / out1 get dK / dV where splits is 1,
// else ws[sp][0] / ws[sp][1].  KV: tc_load / tc_convert / RAW as for
// dkv_tc_body.
template <int D, typename KV>
__device__ __forceinline__ void dkv_wide_body(const BwdArgs& a, const KV& kv,
                                              int splits, float* ws) {
  using L = DkvWideSmem<D>;
  constexpr int NT = DKV_WIDE_THREADS;
  constexpr int QS = L::QS;
  constexpr int QW = QS / L::NS;  // query columns of a warp's S^T, dP^T
  constexpr int NQB = QW / 8;
  constexpr int DW = D / L::NS;   // dK / dV lanes a warp accumulates
  constexpr int NDB = DW / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __shared__ int s_rmin, s_rmax;

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int group = a.Hq / a.Hkv;
  const int per = (group + splits - 1) / splits;
  const int g_lo = min(sp * per, group);
  const int g_hi = min(g_lo + per, group);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kw = warp & 3;     // keys c0 + 16 kw + [0, 16)
  const int part = warp >> 2;  // query columns part * QW, lanes part * DW
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bkv = (size_t)b * a.Hkv + hk;
  uint8_t* sk = smem_tc + L::K;
  uint8_t* sv = smem_tc + L::V;

  // K and V (their payloads into the second Q / dO buffers), then step 0.
  kv.template tc_load<NT, L::ROW>(false, bkv, c0, Skv, sk,
                                 smem_tc + L::Q + L::QTILE);
  kv.template tc_load<NT, L::ROW>(true, bkv, c0, Skv, sv,
                                 smem_tc + L::DO + L::QTILE);
  cp_async_commit();
  query_span(a.ranges, Sq, Skv, c0, min(c0 + BN, Skv), &s_rmin, &s_rmax);
  const int row_lo = s_rmin;
  const int row_hi = s_rmax + 1;
  const int tiles = row_hi > row_lo ? (row_hi - row_lo + QS - 1) / QS : 0;
  const int steps = (g_hi - g_lo) * tiles;
  auto head_of = [&](int it) {
    const int gi = g_lo + it / tiles;
    return a.interleaved ? gi * a.Hkv + hk : hk * group + gi;
  };
  auto prefetch = [&](int it, int buf) {
    const size_t bh = (size_t)b * a.Hq + head_of(it);
    const int r0 = row_lo + (it % tiles) * QS;
    stage_rows_async<D, L::ROW, NT, QS>(
        static_cast<const __nv_bfloat16*>(a.q) + bh * Sq * D, r0, row_hi,
        smem_tc + L::Q + buf * L::QTILE);
    stage_rows_async<D, L::ROW, NT, QS>(
        static_cast<const __nv_bfloat16*>(a.dout) + bh * Sq * D, r0, row_hi,
        smem_tc + L::DO + buf * L::QTILE);
    stage_row_stats_async<QS, NT>(
        a, bh, r0, row_hi,
        reinterpret_cast<float*>(smem_tc + L::ST + buf * L::STATS));
  };
  if (steps > 0) prefetch(0, 0);
  cp_async_commit();
  if constexpr (KV::RAW) {
    static_assert(BN * D <= L::QTILE, "a payload tile fits a Q buffer");
    cp_async_wait<1>();
    __syncthreads();  // K's and V's payload rows landed
    kv.template tc_convert<NT, L::ROW>(false, bkv, c0, Skv, sk,
                                      smem_tc + L::Q + L::QTILE);
    kv.template tc_convert<NT, L::ROW>(true, bkv, c0, Skv, sv,
                                      smem_tc + L::DO + L::QTILE);
  }

  float dk[NDB][4], dv[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // step it (and K, V) staged, K and V converted; step
                      // it - 1 done
    if (it + 1 < steps) prefetch(it + 1, buf ^ 1);
    cp_async_commit();
    uint8_t* sq = smem_tc + L::Q + buf * L::QTILE;
    const uint8_t* sdo = smem_tc + L::DO + buf * L::QTILE;
    const float* st =
        reinterpret_cast<const float*>(smem_tc + L::ST + buf * L::STATS);
    scale_rows_bf16<D, L::ROW, NT, QS>(sq, a.scale);
    __syncthreads();  // Q_s ready

    const int h = head_of(it);
    const int r0 = row_lo + (it % tiles) * QS;
    const float* bh_bias =
        a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
    float s[NQB][4], dp[NQB][4];
#pragma unroll
    for (int j = 0; j < NQB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nt<D / 16, NQB, L::ROW, L::ROW>(sk, 16 * kw, sq, part * QW, s);
    mma_nt<D / 16, NQB, L::ROW, L::ROW>(sv, 16 * kw, sdo, part * QW, dp);
    dkv_probs<NQB, QS>(s, dp, st, part * QW, c0 + 16 * kw, r0, row_hi,
                       bh_bias, Skv);

    // The CTA's P^T and dS^T tiles in bf16, then dV += P^T.dO and dK +=
    // dS^T.Q_s, 16 queries a k step.
    uint8_t* ps = smem_tc + L::PS;
    uint8_t* dss = smem_tc + L::DS;
#pragma unroll
    for (int j = 0; j < NQB; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = (16 * kw + g + 8 * i) * L::P_LD +
                        (part * QW + 8 * j + 2 * tq) * 2;
        *reinterpret_cast<uint32_t*>(ps + off) =
            pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dss + off) =
            pack_bf16(dp[j][2 * i], dp[j][2 * i + 1]);
      }
    __syncthreads();  // the CTA's P^T and dS^T tiles
    const int a_off =
        (16 * kw + ldsm_a_row(lane)) * L::P_LD + ldsm_a_byte(lane);
#pragma unroll
    for (int kc = 0; kc < QS / 16; ++kc) {
      uint32_t pa[4], dsa[4];
      ldsm_x4(pa, ps + a_off + kc * 32);
      ldsm_x4(dsa, dss + a_off + kc * 32);
      mma_rn<NDB, L::ROW>(pa, sdo, 16 * kc, part * DW, dv);
      mma_rn<NDB, L::ROW>(dsa, sq, 16 * kc, part * DW, dk);
    }
  }
  cp_async_wait<0>();

  const size_t n = (size_t)gridDim.z / splits * a.Hkv * Skv * D;
  float* out_k = splits > 1 ? ws + (2 * (size_t)sp) * n : a.out0;
  float* out_v = splits > 1 ? ws + (2 * (size_t)sp + 1) * n : a.out1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + 16 * kw + g + 8 * i;
    if (key >= Skv) continue;
    float* dkr = out_k + (bkv * Skv + key) * D + part * DW + 2 * tq;
    float* dvr = out_v + (bkv * Skv + key) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) =
          make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * j) =
          make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// RAW: K and V arrive as payload rows (D bytes, two buffers each)
// dequantized into one bf16 tile each, with the tile's ksr and vsr; else
// as bf16 rows into two tiles each.
template <int D, bool RAW>
struct DqWideSmem {
  static constexpr int NS = 2;               // key and lane parts
  static constexpr int KS = 32;              // keys a tile
  static constexpr int ROW = 2 * D + 16;     // a bf16 row [.., D]
  static constexpr int QTILE = BM * ROW;     // 64 query rows
  static constexpr int KTILE = KS * ROW;     // 32 keys
  static constexpr int S_LD = 2 * KS + 16;   // a dS row [query][32 keys]
  static constexpr int KV_BUFS = RAW ? 1 : 2;
  static constexpr int Q = 0;
  static constexpr int DO = QTILE;
  static constexpr int K = 2 * QTILE;
  static constexpr int V = K + KV_BUFS * KTILE;
  static constexpr int RAW_K = V + KV_BUFS * KTILE;  // two buffers
  static constexpr int RAW_V = RAW_K + (RAW ? 2 * KS * D : 0);
  static constexpr int SC = RAW_V + (RAW ? 2 * KS * D : 0);  // ksr|vsr, x2
  static constexpr int DS = SC + (RAW ? 2 * 2 * KS * 4 : 0);
  static constexpr size_t BYTES = DS + BM * S_LD;
  static_assert(D % (16 * NS) == 0 && KS % (16 * NS) == 0,
                "a part's lanes and keys are whole 16-wide steps");
};

constexpr int DQ_WIDE_THREADS = 256;  // 4 row slices x 2 parts

// dQ (and dbias) for one (64 query rows, b, q head), dQ stored times
// a.scale, or a.dqsc over payloads (see above).  SCALE_Q: Q is scaled by
// a.scale and rounded to bf16 here (else the caller passed it
// pre-scaled).  KV: tc_load / tc_convert / RAW as for dq_tc_body.
template <int D, bool SCALE_Q, typename KV>
__device__ __forceinline__ void dq_wide_body(const BwdArgs& a, const KV& kv) {
  using L = DqWideSmem<D, KV::RAW>;
  constexpr int NT = DQ_WIDE_THREADS;
  constexpr int KS = L::KS;
  constexpr int KW = KS / L::NS;  // key columns of a warp's S, dP
  constexpr int NKB = KW / 8;
  constexpr int DW = D / L::NS;   // dQ lanes a warp accumulates
  constexpr int NDB = DW / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __shared__ int s_lo, s_hi;

  const int Sq = a.Sq, Skv = a.Skv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp & 3;     // query rows r0 + 16 rw + [0, 16)
  const int part = warp >> 2;  // key columns part * KW, dQ lanes part * DW
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  // The folded scales exist only over payloads.
  const float* ksr = KV::RAW && a.ksr ? a.ksr + bk * Skv : nullptr;
  const float* vsr = KV::RAW && a.vsr ? a.vsr + bk * Skv : nullptr;
  uint8_t* sq = smem_tc + L::Q;
  const uint8_t* sdo = smem_tc + L::DO;

  stage_rows_async<D, L::ROW, NT>(
      static_cast<const __nv_bfloat16*>(a.q) + bh * Sq * D, r0, Sq, sq);
  stage_rows_async<D, L::ROW, NT>(
      static_cast<const __nv_bfloat16*>(a.dout) + bh * Sq * D, r0, Sq,
      smem_tc + L::DO);
  cp_async_commit();
  key_span(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_hi = s_hi;
  const int c0 = (s_lo / KS) * KS;
  const int tiles = c0 < c_hi ? (c_hi - c0 + KS - 1) / KS : 0;
  // Tile it's K and V rows (and ksr, vsr) into buffer `buf`: zeros from
  // c_hi.
  auto load = [&](int it, int buf) {
    const int t0 = c0 + it * KS;
    const int kb = KV::RAW ? 0 : buf;
    kv.template tc_load<NT, L::ROW, KS>(false, bk, t0, c_hi,
                                       smem_tc + L::K + kb * L::KTILE,
                                       smem_tc + L::RAW_K + buf * KS * D);
    kv.template tc_load<NT, L::ROW, KS>(true, bk, t0, c_hi,
                                       smem_tc + L::V + kb * L::KTILE,
                                       smem_tc + L::RAW_V + buf * KS * D);
    if constexpr (KV::RAW) {
      float* sc = reinterpret_cast<float*>(smem_tc + L::SC) + buf * 2 * KS;
      const int i = threadIdx.x;
      const float* src = i < KS ? ksr : vsr;
      if (i < 2 * KS && src) {
        const bool ok = t0 + i % KS < c_hi;
        cp_async4(sc + i, ok ? src + t0 + i % KS : src, ok ? 4 : 0);
      }
    }
  };
  if (tiles > 0) load(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // Q's and dO's rows landed
  if (SCALE_Q) scale_rows_bf16<D, L::ROW, NT>(sq, a.scale);

  const DqRows w = dq_rows(a, bh, r0 + 16 * rw + g);

  float acc[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    const int t0 = c0 + it * KS;
    cp_async_wait<0>();
    __syncthreads();  // tile it staged, Q scaled; tile it - 1 done
    if (it + 1 < tiles) load(it + 1, buf ^ 1);
    cp_async_commit();
    const int kb = KV::RAW ? 0 : buf;
    uint8_t* sk = smem_tc + L::K + kb * L::KTILE;
    uint8_t* sv = smem_tc + L::V + kb * L::KTILE;
    const float* sks =
        reinterpret_cast<const float*>(smem_tc + L::SC) + buf * 2 * KS;
    if constexpr (KV::RAW) {
      kv.template tc_convert<NT, L::ROW, KS>(false, bk, t0, c_hi, sk,
                                            smem_tc + L::RAW_K +
                                                buf * KS * D);
      kv.template tc_convert<NT, L::ROW, KS>(true, bk, t0, c_hi, sv,
                                            smem_tc + L::RAW_V +
                                                buf * KS * D);
      __syncthreads();  // K and V dequantized
    }

    // S and dP for rows 16 rw + [0, 16) and keys kc0 + [0, KW): element
    // (row g + 8i, key kc0 + 8j + 2tq + c) at [j][2i + c].
    const int kc0 = part * KW;
    float s[NKB][4], dp[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nt<D / 16, NKB, L::ROW, L::ROW>(sq, 16 * rw, sk, kc0, s);
    mma_nt<D / 16, NKB, L::ROW, L::ROW>(sdo, 16 * rw, sv, kc0, dp);
    if (ksr) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= sks[kc0 + 8 * j + 2 * tq + (e & 1)];
    }
    if (vsr) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] *= sks[KS + kc0 + 8 * j + 2 * tq + (e & 1)];
    }

    // P, dS (dbias) as dq_tc_body makes them; s[j][e] becomes dS (x ksr),
    // the value dS.K rounds.
    const bool whole = t0 + kc0 >= w.live_lo && t0 + kc0 + KW <= w.live_hi;
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = r0 + 16 * rw + g + 8 * i;
        const int key = t0 + kc0 + 8 * j + 2 * tq + (e & 1);
        float x = s[j][e];
        if (bh_bias && row < Sq && key < Skv)
          x += bh_bias[(size_t)row * Skv + key];
        float p = ex2_approx(fmaf(x, LOG2E, -w.l2[i]));
        if (!whole) p = (unsigned)(key - w.rs[i]) < w.span[i] ? p : 0.f;
        const float ds = p * (dp[j][e] - w.dd[i]);
        if (a.out1 && row < Sq && key < Skv)
          a.out1[(bh * Sq + row) * Skv + key] = ds;
        s[j][e] = ksr ? ds * sks[kc0 + 8 * j + 2 * tq + (e & 1)] : ds;
      }

    // The CTA's dS tile in bf16, then dQ += dS.K, 16 keys a k step.
    uint8_t* sds = smem_tc + L::DS;
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(
            sds + (16 * rw + g + 8 * i) * L::S_LD +
            (kc0 + 8 * j + 2 * tq) * 2) =
            pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
    __syncthreads();  // the CTA's dS tile
    const int a_off =
        (16 * rw + ldsm_a_row(lane)) * L::S_LD + ldsm_a_byte(lane);
#pragma unroll
    for (int kc = 0; kc < KS / 16; ++kc) {
      uint32_t af[4];
      ldsm_x4(af, sds + a_off + kc * 32);
      mma_rn<NDB, L::ROW>(af, sk, 16 * kc, part * DW, acc);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * rw + g + 8 * i;
    if (row >= Sq) continue;
    float* out = a.out0 + (bh * Sq + row) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      const int d = part * DW + 8 * j + 2 * tq;
      const bool by_lane = KV::RAW && a.dqsc;
      const float m0 = by_lane ? a.dqsc[bk * D + d] : a.scale;
      const float m1 = by_lane ? a.dqsc[bk * D + d + 1] : a.scale;
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * i] * m0, acc[j][2 * i + 1] * m1);
    }
  }
}

// ---------------------------------------------------------------------------
// The latent bodies: the bf16 dQ and dK/dV at DeepSeek's absorbed D = 576
//
// Replace ops/flash_attention_bwd.py::_dq_kernel and ::_dkv_kernel for the
// bf16 instances above D = 288 (flash_dq_latent_kernel,
// flash_dkv_latent_kernel over float K/V; qflash_dq_latent_kernel,
// qflash_dkv_latent_kernel over int8 / int4 payloads).  The function is
// dq_wide_body's and dkv_wide_body's (the same roundings, P as exp2 of
// S log2(e) - L log2(e), and over payloads the folded ksr, vsr and dqsc);
// nothing assumes V's zero rope tail.  Bound: tensor-core operations (6 D
// a live pair for dQ, 8 D for dK/dV).
//
// Payloads (KV::RAW).  The wide bodies copy a tile's payload rows into
// scratch by cp.async and dequantize them there; at 576 no scratch fits
// (dq_latent_body leaves 3 KB of the 227: a raw buffer of 32 K and 32 V
// rows is 36 KB).  So a payload tile is converted on load (KV::tc_fill):
// each thread reads its 16-value chunks of the tile's rows from device
// memory (two chunks' loads in flight at a time), dequantizes them in
// registers as dequant_rows_bf16 does (bit for bit) and stores the bf16
// rows into the one K or V buffer.  The loads are not asynchronous: in
// dq_latent_body a tile's fill waits on device memory (L2: the CTAs of a
// latent head read the same rows) where the float tile's cp.async runs
// under the products; dkv_latent_body fills K and V once, before its walk.
//
// Why the 288 layouts do not stretch to 576: a bf16 row is 1,168 bytes with
// its 16-byte pad, a 64-row tile 74,752.  dq_wide_body holds Q and dO
// (149,504) plus two buffers each of 32 K and V rows (149,504): ~299 KB.
// dkv_wide_body holds K and V for 64 keys (149,504) plus two buffers each
// of 48 Q and dO rows (224,256), and its dK / dV accumulators would be
// 2 x 64 x 576 fp32, 192 registers a thread at 12 warps.
//
// dq_latent_body: dq_wide_body's grid (one CTA per 64 query rows, b, q
// head, the row tiles last first) and warps (4 row slices of 16 x 2 parts:
// 16 of a tile's 32 keys for S and dP, 288 of D's lanes for dQ).
//   - Shared memory (229,376 bytes at 576): Q and dO resident (149,504);
//     ONE buffer each of 32 K and 32 V rows (74,752); the dS tile, bf16 [64
//     queries][32 keys] (5,120).  The loads are staggered instead of
//     double-buffered: dP = dO.V^T runs first, so the next tile's V rows
//     are in flight while S, dS and dQ += dS.K run, and its K rows while
//     its dP runs.
//   - Registers: the dQ accumulator 16 x 288 fp32 a warp, 144 a thread; S
//     and dP 8 each.
// dkv_latent_body: one CTA per (32 keys, b, kv head, split) and 8 warps.
//   - Shared memory (231,936 bytes at 576): K and V resident (74,752); Q and
//     dO in steps of 32 query rows, two buffers each (149,504); the steps'
//     L, D and key ranges, two buffers (1,024); the P^T tile, bf16 [32 keys]
//     [32 queries] (2,560); a 4,096-byte exchange: fp32 dP^T [32][32], then
//     the bf16 dS^T tile.
//   - Warps: S^T = K.Q_s^T and dP^T = V.dO^T are 8 blocks of 16 keys x 16
//     queries, one a warp: warps 0-3 take S^T's, warps 4-7 dP^T's.  These
//     pass dP^T to their S^T twins through the exchange (fp32, swizzled:
//     column ^ 4 (key % 8), so a warp's float2 stores fill all banks); the
//     S^T warps make P^T and dS^T (dkv_probs) and store both in bf16, dS^T
//     over the exchange once all four have read it (a named barrier).  For
//     dV += round(P^T).dO and dK += round(dS^T).Q_s a warp takes 16 keys x
//     144 of D's lanes: dK and dV 144 registers a thread.
//   - The grid: 32-key tiles x kv heads, the GQA group dealt over `splits`
//     CTAs a key tile as in dkv_wide_body (ops/flash_attention_bwd.py::
//     dkv_splits plans it from the 32-key tile), the partials summed by
//     flash_dkv_merge_kernel in split order.
// ---------------------------------------------------------------------------

template <int D>
struct DqLatentSmem {
  static constexpr int NS = 2;              // key and lane parts
  static constexpr int KS = 32;             // keys a tile
  static constexpr int ROW = 2 * D + 16;    // a bf16 row [.., D]
  static constexpr int QTILE = BM * ROW;    // 64 query rows
  static constexpr int KTILE = KS * ROW;    // 32 keys
  static constexpr int S_LD = 2 * KS + 16;  // a dS row [query][32 keys]
  static constexpr int Q = 0;
  static constexpr int DO = QTILE;
  static constexpr int K = 2 * QTILE;  // one buffer
  static constexpr int V = K + KTILE;  // one buffer
  static constexpr int DS = V + KTILE;
  static constexpr size_t BYTES = DS + BM * S_LD;
  static_assert(D % (16 * NS) == 0 && KS % (16 * NS) == 0,
                "a part's lanes and keys are whole 16-wide steps");
};

constexpr int DQ_LATENT_THREADS = 256;  // 4 row slices x 2 parts

// dQ (and dbias) for one (64 query rows, b, q head), stored times a.scale,
// or a.dqsc over payloads (see above).  SCALE_Q: Q is scaled by a.scale and
// rounded to bf16 here (else the caller passed it pre-scaled).  KV: tc_load
// as for dq_tc_body (bf16 rows), or tc_fill (payloads: KV::RAW).
template <int D, bool SCALE_Q, typename KV>
__device__ __forceinline__ void dq_latent_body(const BwdArgs& a,
                                               const KV& kv) {
  using L = DqLatentSmem<D>;
  constexpr int NT = DQ_LATENT_THREADS;
  constexpr int KS = L::KS;
  constexpr int KW = KS / L::NS;  // key columns of a warp's S, dP
  constexpr int NKB = KW / 8;
  constexpr int DW = D / L::NS;   // dQ lanes a warp accumulates
  constexpr int NDB = DW / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __shared__ int s_lo, s_hi;

  const int Sq = a.Sq, Skv = a.Skv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp & 3;     // query rows r0 + 16 rw + [0, 16)
  const int part = warp >> 2;  // key columns part * KW, dQ lanes part * DW
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  // The folded scales exist only over payloads.
  const float* ksr = KV::RAW && a.ksr ? a.ksr + bk * Skv : nullptr;
  const float* vsr = KV::RAW && a.vsr ? a.vsr + bk * Skv : nullptr;
  uint8_t* sq = smem_tc + L::Q;
  const uint8_t* sdo = smem_tc + L::DO;
  uint8_t* sk = smem_tc + L::K;
  uint8_t* sv = smem_tc + L::V;

  stage_rows_async<D, L::ROW, NT>(
      static_cast<const __nv_bfloat16*>(a.q) + bh * Sq * D, r0, Sq, sq);
  stage_rows_async<D, L::ROW, NT>(
      static_cast<const __nv_bfloat16*>(a.dout) + bh * Sq * D, r0, Sq,
      smem_tc + L::DO);
  cp_async_commit();
  key_span(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_hi = s_hi;
  const int c0 = (s_lo / KS) * KS;
  const int tiles = c0 < c_hi ? (c_hi - c0 + KS - 1) / KS : 0;
  // Tile it's V rows (is_v) or K rows into their buffer, zeros from c_hi,
  // as one commit group (an empty one past the last tile, or after a
  // payload's fill, which is done when it returns).
  auto load = [&](bool is_v, int it) {
    if (it < tiles) {
      if constexpr (KV::RAW)
        kv.template tc_fill<NT, L::ROW, KS>(is_v, bk, c0 + it * KS, c_hi,
                                           is_v ? sv : sk);
      else
        kv.template tc_load<NT, L::ROW, KS>(is_v, bk, c0 + it * KS, c_hi,
                                           is_v ? sv : sk, nullptr);
    }
    cp_async_commit();
  };
  // A folded per-token scale of key `key` (0 from c_hi, as the wide body's
  // staged copy).
  auto col_scale = [&](const float* sc, int key) {
    return key < c_hi ? sc[key] : 0.f;
  };
  load(true, 0);
  load(false, 0);
  cp_async_wait<2>();
  __syncthreads();  // Q's and dO's rows landed
  if (SCALE_Q) scale_rows_bf16<D, L::ROW, NT>(sq, a.scale);

  const DqRows w = dq_rows(a, bh, r0 + 16 * rw + g);
  const int kc0 = part * KW;

  float acc[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int t0 = c0 + it * KS;
    cp_async_wait<1>();
    __syncthreads();  // tile it's V rows landed, Q scaled

    // S and dP for rows 16 rw + [0, 16) and keys kc0 + [0, KW): element
    // (row g + 8i, key kc0 + 8j + 2tq + c) at [j][2i + c].
    float s[NKB][4], dp[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nt<D / 16, NKB, L::ROW, L::ROW>(sdo, 16 * rw, sv, kc0, dp);
    cp_async_wait<0>();
    __syncthreads();  // tile it's K rows landed; every warp done with V
    load(true, it + 1);
    mma_nt<D / 16, NKB, L::ROW, L::ROW>(sq, 16 * rw, sk, kc0, s);
    if (ksr) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= col_scale(ksr, t0 + kc0 + 8 * j + 2 * tq + (e & 1));
    }
    if (vsr) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] *= col_scale(vsr, t0 + kc0 + 8 * j + 2 * tq + (e & 1));
    }

    // P, dS (dbias) as dq_wide_body makes them; s[j][e] becomes dS (x ksr),
    // the value dS.K rounds.
    const bool whole = t0 + kc0 >= w.live_lo && t0 + kc0 + KW <= w.live_hi;
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = r0 + 16 * rw + g + 8 * i;
        const int key = t0 + kc0 + 8 * j + 2 * tq + (e & 1);
        float x = s[j][e];
        if (bh_bias && row < Sq && key < Skv)
          x += bh_bias[(size_t)row * Skv + key];
        float p = ex2_approx(fmaf(x, LOG2E, -w.l2[i]));
        if (!whole) p = (unsigned)(key - w.rs[i]) < w.span[i] ? p : 0.f;
        const float ds = p * (dp[j][e] - w.dd[i]);
        if (a.out1 && row < Sq && key < Skv)
          a.out1[(bh * Sq + row) * Skv + key] = ds;
        s[j][e] = ksr ? ds * col_scale(ksr, key) : ds;
      }

    // The CTA's dS tile in bf16, then dQ += dS.K, 16 keys a k step.
    uint8_t* sds = smem_tc + L::DS;
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(
            sds + (16 * rw + g + 8 * i) * L::S_LD +
            (kc0 + 8 * j + 2 * tq) * 2) =
            pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
    __syncthreads();  // the CTA's dS tile
    const int a_off =
        (16 * rw + ldsm_a_row(lane)) * L::S_LD + ldsm_a_byte(lane);
#pragma unroll
    for (int kc = 0; kc < KS / 16; ++kc) {
      uint32_t af[4];
      ldsm_x4(af, sds + a_off + kc * 32);
      mma_rn<NDB, L::ROW>(af, sk, 16 * kc, part * DW, acc);
    }
    __syncthreads();  // every warp done with K and the dS tile
    load(false, it + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * rw + g + 8 * i;
    if (row >= Sq) continue;
    float* out = a.out0 + (bh * Sq + row) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      const int d = part * DW + 8 * j + 2 * tq;
      const bool by_lane = KV::RAW && a.dqsc;
      const float m0 = by_lane ? a.dqsc[bk * D + d] : a.scale;
      const float m1 = by_lane ? a.dqsc[bk * D + d + 1] : a.scale;
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * i] * m0, acc[j][2 * i + 1] * m1);
    }
  }
}

template <int D>
struct DkvLatentSmem {
  static constexpr int KT = 32;              // keys a CTA
  static constexpr int QS = 32;              // query rows a step
  static constexpr int NS = 4;               // lane parts of dK and dV
  static constexpr int ROW = 2 * D + 16;     // a bf16 row [.., D]
  static constexpr int TILE = 32 * ROW;      // 32 rows (KT = QS)
  static constexpr int P_LD = 2 * QS + 16;   // a P^T / dS^T row [key][32]
  static constexpr int STATS = 4 * QS * 4;   // L [32], D [32], ranges [32][2]
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;         // two buffers
  static constexpr int DO = 4 * TILE;        // two buffers
  static constexpr int ST = 6 * TILE;        // two buffers
  static constexpr int PS = ST + 2 * STATS;  // P^T
  static constexpr int X = PS + KT * P_LD;   // fp32 dP^T [KT][QS], then dS^T
  static constexpr size_t BYTES = X + KT * QS * 4;
  static_assert(KT == QS && KT * P_LD <= KT * QS * 4,
                "one row tile size; dS^T fits the exchange");
  static_assert(D % (16 * NS) == 0, "a part's lanes are whole 16-wide steps");
};

constexpr int DKV_LATENT_THREADS = 256;  // 8 warps

// dK/dV for one (32 keys, b, kv head) over the q heads of split `sp` of the
// GQA group (see above).  out0 / out1 get dK / dV where splits is 1, else
// ws[sp][0] / ws[sp][1].  KV: tc_load as for dkv_tc_body (bf16 rows), or
// tc_fill (payloads: KV::RAW).
template <int D, typename KV>
__device__ __forceinline__ void dkv_latent_body(const BwdArgs& a,
                                                const KV& kv, int splits,
                                                float* ws) {
  using L = DkvLatentSmem<D>;
  constexpr int NT = DKV_LATENT_THREADS;
  constexpr int KT = L::KT;
  constexpr int QS = L::QS;
  constexpr int DW = D / L::NS;  // dK / dV lanes a warp accumulates
  constexpr int NDB = DW / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  __shared__ int s_rmin, s_rmax;

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * KT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int group = a.Hq / a.Hkv;
  const int per = (group + splits - 1) / splits;
  const int g_lo = min(sp * per, group);
  const int g_hi = min(g_lo + per, group);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ks = warp & 1;          // keys c0 + 16 ks + [0, 16)
  const int qh = (warp >> 1) & 1;   // S^T / dP^T columns 16 qh + [0, 16)
  const bool dp_warp = warp >= 4;   // dP^T; else S^T, P^T and dS^T
  const int part = warp >> 1;       // dK / dV lanes part * DW
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bkv = (size_t)b * a.Hkv + hk;
  uint8_t* sk = smem_tc + L::K;
  uint8_t* sv = smem_tc + L::V;
  uint8_t* ps = smem_tc + L::PS;
  uint8_t* xs = smem_tc + L::X;
  float* xf = reinterpret_cast<float*>(xs);

  if constexpr (KV::RAW) {  // dequantized once, before the walk
    kv.template tc_fill<NT, L::ROW, KT>(false, bkv, c0, Skv, sk);
    kv.template tc_fill<NT, L::ROW, KT>(true, bkv, c0, Skv, sv);
  } else {
    kv.template tc_load<NT, L::ROW, KT>(false, bkv, c0, Skv, sk, nullptr);
    kv.template tc_load<NT, L::ROW, KT>(true, bkv, c0, Skv, sv, nullptr);
  }
  cp_async_commit();
  query_span(a.ranges, Sq, Skv, c0, min(c0 + KT, Skv), &s_rmin, &s_rmax);
  const int row_lo = s_rmin;
  const int row_hi = s_rmax + 1;
  const int tiles = row_hi > row_lo ? (row_hi - row_lo + QS - 1) / QS : 0;
  const int steps = (g_hi - g_lo) * tiles;
  auto head_of = [&](int it) {
    const int gi = g_lo + it / tiles;
    return a.interleaved ? gi * a.Hkv + hk : hk * group + gi;
  };
  auto prefetch = [&](int it, int buf) {
    const size_t bh = (size_t)b * a.Hq + head_of(it);
    const int r0 = row_lo + (it % tiles) * QS;
    stage_rows_async<D, L::ROW, NT, QS>(
        static_cast<const __nv_bfloat16*>(a.q) + bh * Sq * D, r0, row_hi,
        smem_tc + L::Q + buf * L::TILE);
    stage_rows_async<D, L::ROW, NT, QS>(
        static_cast<const __nv_bfloat16*>(a.dout) + bh * Sq * D, r0, row_hi,
        smem_tc + L::DO + buf * L::TILE);
    stage_row_stats_async<QS, NT>(
        a, bh, r0, row_hi,
        reinterpret_cast<float*>(smem_tc + L::ST + buf * L::STATS));
  };
  if (steps > 0) prefetch(0, 0);
  cp_async_commit();
  // An S^T / dP^T element (key 16 ks + g + 8i, query column 16 qh + 8j +
  // 2tq) and the next column: their float2 in the exchange, the column
  // swizzled by the key's row in an 8-row group (g).
  auto slot = [&](int j, int i) {
    return (16 * ks + g + 8 * i) * QS + ((16 * qh + 8 * j + 2 * tq) ^ (4 * g));
  };

  float dk[NDB][4], dv[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // step it (and K, V) staged; step it - 1 done
    if (it + 1 < steps) prefetch(it + 1, buf ^ 1);
    cp_async_commit();
    uint8_t* sq = smem_tc + L::Q + buf * L::TILE;
    const uint8_t* sdo = smem_tc + L::DO + buf * L::TILE;
    const float* st =
        reinterpret_cast<const float*>(smem_tc + L::ST + buf * L::STATS);
    scale_rows_bf16<D, L::ROW, NT, QS>(sq, a.scale);
    __syncthreads();  // Q_s ready

    const int h = head_of(it);
    const int r0 = row_lo + (it % tiles) * QS;
    const float* bh_bias =
        a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_nt<D / 16, 2, L::ROW, L::ROW>(dp_warp ? sv : sk, 16 * ks,
                                      dp_warp ? sdo : sq, 16 * qh, s);
    if (dp_warp) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(xf + slot(j, i)) =
              make_float2(s[j][2 * i], s[j][2 * i + 1]);
    }
    __syncthreads();  // dP^T in the exchange
    if (!dp_warp) {
      float dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 x = *reinterpret_cast<const float2*>(xf + slot(j, i));
          dp[j][2 * i] = x.x;
          dp[j][2 * i + 1] = x.y;
        }
      named_barrier(1, 128);  // the four S^T warps have read the exchange
      dkv_probs<2, QS>(s, dp, st, 16 * qh, c0 + 16 * ks, r0, row_hi,
                       bh_bias, Skv);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int off = (16 * ks + g + 8 * i) * L::P_LD +
                          (16 * qh + 8 * j + 2 * tq) * 2;
          *reinterpret_cast<uint32_t*>(ps + off) =
              pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(xs + off) =
              pack_bf16(dp[j][2 * i], dp[j][2 * i + 1]);
        }
    }
    __syncthreads();  // the CTA's P^T and dS^T tiles

    // dV += P^T.dO and dK += dS^T.Q_s, 16 queries a k step.
    const int a_off =
        (16 * ks + ldsm_a_row(lane)) * L::P_LD + ldsm_a_byte(lane);
#pragma unroll
    for (int kc = 0; kc < QS / 16; ++kc) {
      uint32_t pa[4], dsa[4];
      ldsm_x4(pa, ps + a_off + kc * 32);
      ldsm_x4(dsa, xs + a_off + kc * 32);
      mma_rn<NDB, L::ROW>(pa, sdo, 16 * kc, part * DW, dv);
      mma_rn<NDB, L::ROW>(dsa, sq, 16 * kc, part * DW, dk);
    }
  }
  cp_async_wait<0>();

  const size_t n = (size_t)gridDim.z / splits * a.Hkv * Skv * D;
  float* out_k = splits > 1 ? ws + (2 * (size_t)sp) * n : a.out0;
  float* out_v = splits > 1 ? ws + (2 * (size_t)sp + 1) * n : a.out1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + 16 * ks + g + 8 * i;
    if (key >= Skv) continue;
    float* dkr = out_k + (bkv * Skv + key) * D + part * DW + 2 * tq;
    float* dvr = out_v + (bkv * Skv + key) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) =
          make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * j) =
          make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The scalar bodies above D = 288 (scalar32): the fp32 dQ and dK/dV at
// DeepSeek's absorbed 576, dq_body's and dkv_body's function and order of
// operations in 32-row tiles (a 64-row layout holds at least two [D][64 + 4]
// fp32 tiles, 156,672 bytes each at 576).  The 256 threads are 8 x 32:
// thread (ty, tx) holds rows 4 ty + [0, 4) of a tile, their scores against
// column tx, and output lanes tx + 32 e.  An operand read four rows at a
// time is staged transposed ([D][32 + 4]: one broadcast float4 a step of
// d); one read a row at a time, or a lane of each row, as rows [32][D + 1]
// (the odd stride puts the 32 rows' lane d, and a row's 32 consecutive
// lanes, in 32 banks).  Shared memory: one transposed tile, one row tile
// and a [32][32 + 4] score tile, 161,408 bytes at 576
// (attention_tiles.cuh's 32-row helpers).  flash_attention.cu's fwd_body32
// and quantized_attention.cu's qattn_body32 are the forwards' counterparts.
// ---------------------------------------------------------------------------

// dq_body over fp32 K/V in 32-row tiles (above): per key tile dO^T and V's
// rows give dP, then Q_s^T (restaged in dO^T's buffer) and K's rows give S;
// dS^T goes to the score tile and dQ += dS.K reads K's rows.  KV gives
// stage32<ROWS>(is_v, kv head, t0, limit, dst): 32 fp32 rows in the layout
// of attention_tiles.cuh's stage32 (float K/V as they are, or payloads
// dequantized); the folded scales ksr, vsr and dqsc as in dq_body.
template <int D, typename KV>
__device__ __forceinline__ void dq_body32(const BwdArgs& a, const KV& kv) {
  constexpr int DE = D / T32;
  extern __shared__ __align__(16) float smem[];
  float* at = smem;                       // [D][LD32]  dO^T, then Q_s^T
  float* kvr = at + D * LD32;             // [32][D + 1]  V rows, then K rows
  float* dst = kvr + T32 * ld_rows32<D>();  // [32][LD32]  dS^T
  __shared__ int s_lo, s_hi;

  const int Sq = a.Sq, Skv = a.Skv;
  const int r0 = blockIdx.x * T32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tx = threadIdx.x % T32;
  const int ty = threadIdx.x / T32;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  const float* ksr = a.ksr ? a.ksr + bk * Skv : nullptr;
  const float* vsr = a.vsr ? a.vsr + bk * Skv : nullptr;
  const float* qh = static_cast<const float*>(a.q) + bh * Sq * D;
  const float* doh = static_cast<const float*>(a.dout) + bh * Sq * D;

  key_span<T32>(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float lrow[4], drow[4], acc[4][DE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_range(a.ranges, r, Sq, Skv, rs[i], re[i]);
    const float lv = r < Sq ? a.lse[bh * Sq + r] : 0.f;
    lrow[i] = (lv == -INFINITY) ? 0.f : lv;
    drow[i] = r < Sq ? a.di[bh * Sq + r] : 0.f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += T32) {
    stage32<D, false, false>(doh, r0, Sq, at, 0.f);
    kv.template stage32<true>(true, bk, t0, c_hi, kvr);
    __syncthreads();
    float dp[4];
    tile_product32<D>(at, ty, kvr, tx, dp);
    __syncthreads();  // every thread is done with dO^T and V
    stage32<D, true, false>(qh, r0, Sq, at, a.scale);
    kv.template stage32<true>(false, bk, t0, c_hi, kvr);
    __syncthreads();
    float s[4];
    tile_product32<D>(at, ty, kvr, tx, s);
    const int col = t0 + tx;
    const bool in = col < c_hi;
    const float ks = (ksr && in) ? ksr[col] : 1.f;
    const float vs = (vsr && in) ? vsr[col] : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      float sv = ksr ? s[i] * ks : s[i];
      if (bh_bias && row < Sq && in) sv += bh_bias[(size_t)row * Skv + col];
      const float p =
          (col < rs[i] || col >= re[i]) ? 0.f : expf(sv - lrow[i]);
      const float ds = p * ((vsr ? dp[i] * vs : dp[i]) - drow[i]);
      if (a.out1 && row < Sq && col < Skv)
        a.out1[(bh * Sq + row) * Skv + col] = ds;
      s[i] = ksr ? ds * ks : ds;
    }
    *reinterpret_cast<float4*>(dst + tx * LD32 + ty * 4) =
        make_float4(s[0], s[1], s[2], s[3]);
    __syncthreads();  // dS^T staged
    accumulate_pm32<D>(dst, ty, kvr, tx, acc);
    __syncthreads();  // before the next tile restages
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    float* out = a.out0 + (bh * Sq + r) * D + tx;
#pragma unroll
    for (int e = 0; e < DE; ++e)
      out[32 * e] =
          acc[i][e] * (a.dqsc ? a.dqsc[bk * D + tx + 32 * e] : a.scale);
  }
}

// dkv_body over fp32 K/V in 32-key tiles (above): per step of 32 query rows
// K^T and Q_s's rows give S^T and P^T, V^T and dO's rows dP^T and dS^T; P
// then dS (query-major, in the score tile) times dO's and then Q_s's rows
// (restaged) accumulate dV and dK.  KV: stage32 as for dq_body32.
template <int D, typename KV>
__device__ __forceinline__ void dkv_body32(const BwdArgs& a, const KV& kv) {
  constexpr int DE = D / T32;
  extern __shared__ __align__(16) float smem[];
  float* at = smem;                        // [D][LD32]  K^T, then V^T
  float* br = at + D * LD32;               // [32][D + 1]  Q_s, dO, Q_s rows
  float* ps = br + T32 * ld_rows32<D>();   // [32][LD32]  P, then dS: [q][key]
  __shared__ int s_rmin, s_rmax;

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * T32;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int tx = threadIdx.x % T32;  // query column tx
  const int ty = threadIdx.x / T32;  // keys c0 + 4 ty + i
  const size_t bkv = (size_t)b * a.Hkv + hk;

  query_span(a.ranges, Sq, Skv, c0, min(c0 + T32, Skv), &s_rmin, &s_rmax);
  const int row_lo = s_rmin;
  const int row_hi = s_rmax + 1;

  float dk_acc[4][DE], dv_acc[4][DE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DE; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + h;
    const float* bh_bias =
        a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
    const float* qh = static_cast<const float*>(a.q) + bh * Sq * D;
    const float* doh = static_cast<const float*>(a.dout) + bh * Sq * D;
    for (int r0 = row_lo; r0 < row_hi; r0 += T32) {
      kv.template stage32<false>(false, bkv, c0, Skv, at);
      stage32<D, true, true>(qh, r0, row_hi, br, a.scale);
      const int row = r0 + tx;
      int rs, re;
      row_range(a.ranges, row < row_hi ? row : Sq, Sq, Skv, rs, re);
      const float lv = row < row_hi ? a.lse[bh * Sq + row] : 0.f;
      const float lcol = (lv == -INFINITY) ? 0.f : lv;
      const float dcol = row < row_hi ? a.di[bh * Sq + row] : 0.f;
      __syncthreads();
      float pt[4];  // [key i] of query tx
      tile_product32<D>(at, ty, br, tx, pt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + ty * 4 + i;
        float s = pt[i];
        if (bh_bias && row < row_hi && col < Skv)
          s += bh_bias[(size_t)row * Skv + col];
        pt[i] = (col < rs || col >= re) ? 0.f : expf(s - lcol);
      }
      __syncthreads();  // every thread is done with K^T and Q_s
      kv.template stage32<false>(true, bkv, c0, Skv, at);
      stage32<D, false, true>(doh, r0, row_hi, br, 0.f);
      __syncthreads();
      float dpt[4];
      tile_product32<D>(at, ty, br, tx, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) dpt[i] = pt[i] * (dpt[i] - dcol);  // dS^T
      *reinterpret_cast<float4*>(ps + tx * LD32 + ty * 4) =
          make_float4(pt[0], pt[1], pt[2], pt[3]);
      __syncthreads();
      accumulate_pm32<D>(ps, ty, br, tx, dv_acc);  // dV += P^T.dO
      __syncthreads();
      stage32<D, true, true>(qh, r0, row_hi, br, a.scale);
      *reinterpret_cast<float4*>(ps + tx * LD32 + ty * 4) =
          make_float4(dpt[0], dpt[1], dpt[2], dpt[3]);
      __syncthreads();
      accumulate_pm32<D>(ps, ty, br, tx, dk_acc);  // dK += dS^T.Q_s
      __syncthreads();  // before the next step restages
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty * 4 + i;
    if (key >= Skv) continue;
    float* dkr = a.out0 + (bkv * Skv + key) * D + tx;
    float* dvr = a.out1 + (bkv * Skv + key) * D + tx;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      dkr[32 * e] = dk_acc[i][e];
      dvr[32 * e] = dv_acc[i][e];
    }
  }
}

}  // namespace mfa

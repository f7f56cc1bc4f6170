// Paged attention kernels for Hopper (sm_90a): single-token decode and
// chunked causal prefill over the merged page pool, float or quantized.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - serving/paged_attention.py::_decode_kernel_streamed and ::_decode_kernel
//     (one function, two TPU schedules chosen by head_dim) -> paged_decode_kernel
//   - serving/paged_attention.py::_prefill_kernel -> paged_prefill_kernel
//
// Pool layouts (one layer of serving/kv_cache.py's pool, or of the MLA
// latent pool of models/cached_mla.py), MODE of the kernels' template:
//   - KV_FLOAT: kv [Hkv, NP+1, S_SUB*PT, D] of T (float or bf16, q's dtype).
//     S_SUB = 2: K of a page in token rows [0, PT), V in rows [PT, 2PT);
//     S_SUB = 1: one state per token that serves as K and V (MLA's latent
//     pages, [c | k_rope]);
//   - KV_INT8: the same rows in int8, with per-token symmetric scales
//     ks, vs [Hkv, NP+1, 1, PT] fp32 (row vectors);
//   - KV_INT4: kv [Hkv, NP+1, PT, D] int8, ONE byte per (token, d): K + 8 in
//     the low nibble, V as the signed high nibble (value << 4); K is
//     (byte & 0xF) - 8, V the arithmetic shift byte >> 4; scales as int8.
// V_TAIL_ZERO (vtz): V reads K's rows with its last vtz lanes zeroed (the
// rope tail of an MLA latent state, so one pool serves both sides).  The
// kernels stage V whole and store 0 in O's last vtz lanes instead: each O
// lane depends on its own V lane only, so the kept lanes are the same.
// Page ids come from int32 tables; an id is clamped into the pool so a bad
// entry cannot read outside it.  Each token's scale is read by its page id,
// which serves both TPU decode schedules (per-page scales in the streamed
// one, scales densified by the wrapper in the wave one).
// Head dims: D is a template constant for 32, 64, 128 and 288 (MLA's
// 256 + 32), and a run-time value (any multiple of 16 up to 288) in the
// DC = 0 instances.
//
// Numerics, shared with the plain PyTorch versions in
// serving/paged_attention.py so the two can be held to a tight tolerance:
//   - q is pre-scaled and rounded back to T: (float(q) * scale) -> T;
//   - s = sum_d q * k in fp32 (k the integer payload in the quantized
//     modes), THEN s *= ks[token]; then the causal or length mask;
//   - softmax statistics are fp32, natural exp, online (running max m,
//     running sum l, rescale alpha = exp(m_prev - m_next), alpha = 0 while
//     m_prev is -inf, p = 0 where the score is -inf); l sums the p before
//     any V scale;
//   - quantized modes: p *= vs[token]; then P is rounded to T before P.V
//     with the integer V (float mode: P rounded to T, V in T);
//   - the P.V sum is fp32 and the output is acc / l in T.
//
// Paged decode: what bounds it on the H100, and the design.
//   One query token per sequence against its whole cache: 2 flops per KV
//   element, far below the ~295 flop/byte ridge, so the bound is the live
//   KV bytes over 3.35 TB/s: 4*D bytes per token and KV head in bf16 (2*D
//   with one-state pages); in int8 half of that plus 8 bytes of scales; in
//   int4 a quarter plus the same 8 bytes.  One CTA per (sequence, KV head,
//   slice of the GQA group) holds up to 2048 / D of the group's query rows
//   (q head h -> kv head h / group), so each KV byte is read once per slice:
//   once for the flagship (group 4 x D 64), three times for MLA (group 16 x
//   D 288, Hkv = 1), whose slices also triple the CTAs of its one KV head.
//   The CTA walks the live tokens, ceil(length / 64) tiles of 64 tokens,
//   reading its own page ids; each tile's K and V rows are staged in shared
//   memory as fp32 with coalesced 16-byte loads (int8 and int4 widened while
//   staging; padded rows, no bank conflicts in the score loop) and consumed
//   by scalar fp32 FMAs.  Tiles of 64 tokens rather than whole pages keep
//   shared memory under 160 KB for any page size, D = 288 and fp32 alike.
//   Known limit: at batch 8 x 4 KV heads this is 32 CTAs on 132 SMs, and
//   each CTA loads then computes with no overlap; the kernel is latency
//   bound, well short of the byte bound, so the quantized modes' fewer bytes
//   move its time little.  Split-KV (flash-decoding) and cp.async/TMA double
//   buffering are the planned fixes.
//
// Paged chunked prefill: what bounds it on the H100, and the design.
//   A chunk of C queries of one sequence against its cached prefix plus its
//   own causal triangle: 4*Hq*C*(offset+C)*D flops over ~(offset+C)*Hkv*2*D
//   elements of KV, i.e. compute bound at the engine's C = 256 (989 TFLOP/s
//   bf16 tensor cores) in every pool mode.  This first version does the
//   products with scalar fp32 FMAs (67 TFLOP/s peak), so it cannot reach
//   that bound; it is the right-and-simple step before wgmma/TMA.  One CTA
//   per (64-row tile of the group-major rows r = g*C + c, KV head); the
//   rows of one KV head are contiguous in q [Hq, C, D], so the tile is one
//   strided block.  The CTA walks 64-token KV tiles up to its own causal
//   limit (global positions: column <= offset + (r mod C)), skipping the
//   tiles no row of it can see.  Q, K and P are staged transposed in shared
//   memory so each thread's 4x4 score block and 4 x D/16 output block read
//   16-byte vectors.  Above D = 128, K^T and V share one buffer (V staged
//   after the scores), which keeps D = 288 at 171 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mfa::Elem;

constexpr int KV_FLOAT = 0;
constexpr int KV_INT8 = 1;
constexpr int KV_INT4 = 2;
constexpr int MAX_D = 288;  // the run-time head dim's limit (DC = 0)

__device__ __forceinline__ int clamp_page(int page, int num_pages_total) {
  return min(max(page, 0), num_pages_total - 1);
}

// 16-byte loads of a token's K and V rows widened to fp32: S is the pool's
// element type, VEC the elements per load.  load() reads the K row (is_v
// false) or the V row at p; load2() reads both, the V row v_off elements
// on (0: K is V, one load serves both); an int4 byte holds both, K in its
// low nibble and V in its high one, so it is read once.
template <typename T, int MODE>
struct KVLoad;

template <typename T>
struct KVLoad<T, KV_FLOAT> {
  using S = T;
  static constexpr int VEC = Elem<T>::VEC;
  static __device__ __forceinline__ void load(const S* p, bool, float* f) {
    Elem<T>::unpack(*reinterpret_cast<const uint4*>(p), f);
  }
  static __device__ __forceinline__ void load2(const S* p, size_t v_off,
                                               float* kf, float* vf) {
    load(p, false, kf);
    if (v_off) {
      load(p + v_off, true, vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[e] = kf[e];
    }
  }
};

template <typename T>
struct KVLoad<T, KV_INT8> {
  using S = int8_t;
  static constexpr int VEC = 16;
  static __device__ __forceinline__ void load(const S* p, bool, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = (float)b[e];
  }
  static __device__ __forceinline__ void load2(const S* p, size_t v_off,
                                               float* kf, float* vf) {
    load(p, false, kf);
    if (v_off) {
      load(p + v_off, true, vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[e] = kf[e];
    }
  }
};

template <typename T>
struct KVLoad<T, KV_INT4> {
  using S = int8_t;
  static constexpr int VEC = 16;
  static __device__ __forceinline__ void load(const S* p, bool is_v,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int x = b[e];
      f[e] = (float)(is_v ? (x >> 4) : ((x & 0xF) - 8));
    }
  }
  static __device__ __forceinline__ void load2(const S* p, size_t,
                                               float* kf, float* vf) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int x = b[e];
      kf[e] = (float)((x & 0xF) - 8);
      vf[e] = (float)(x >> 4);
    }
  }
};

// q_row . k_row over n4 float4s, the products summed in lane order; fully
// unrolled when the head dim DC is a compile-time constant.
template <int DC>
__device__ __forceinline__ float row_dot(const float4* a, const float4* b,
                                         int n4) {
  float s = 0.f;
  auto step = [&](int c) {
    const float4 x = a[c];
    const float4 y = b[c];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  };
  if constexpr (DC != 0) {
#pragma unroll
    for (int c = 0; c < DC / 4; ++c) step(c);
  } else {
#pragma unroll 8
    for (int c = 0; c < n4; ++c) step(c);
  }
  return s;
}

// Where a token's rows lie in the pool: page rows (S_SUB * PT, or PT for
// the int4 byte) and V's row offset within the page (0 when K is V).
struct PoolGeom {
  int PT, rows, v_row, vtz;
};

template <int MODE>
PoolGeom pool_geom(int PT, int s_sub, int vtz) {
  const int ss = MODE == KV_INT4 ? 1 : s_sub;
  return PoolGeom{PT, ss * PT, (ss - 1) * PT, vtz};
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 128;
constexpr int DEC_TK = 64;        // KV tokens per tile
constexpr int DEC_MAX_OUT = 16;   // output elements per thread
constexpr int DEC_MAX_ROWS = DEC_MAX_OUT * DEC_THREADS;  // gc * D per CTA

size_t decode_smem_bytes(int gc, int D) {
  return sizeof(float) *
         (size_t)(gc * D + 2 * DEC_TK * (D + 4) + gc * DEC_TK + 3 * gc +
                  2 * DEC_TK);
}

template <typename T, int DC, int MODE>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ kv_,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lengths, T* __restrict__ out,
                    int Hq, int Hkv, int gc, int d_rt, int num_pages_total,
                    PoolGeom pg, int max_pages, float scale) {
  using E = Elem<T>;
  using L = KVLoad<T, MODE>;
  constexpr bool QUANT = MODE != KV_FLOAT;
  const int D = DC ? DC : d_rt;
  const int KS = D + 4;           // padded smem row (floats)
  const int VPR = D / L::VEC;     // 16-byte vectors per token row
  const int v_keep = D - pg.vtz;  // output lanes V does not zero
  const int PT = pg.PT;
  const typename L::S* kv = static_cast<const typename L::S*>(kv_);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int g0 = blockIdx.z * gc;     // this CTA's slice of the group
  const int gn = min(gc, G - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [gc][D]
  float* ks = qs + gc * D;         // [TK][KS]
  float* vs = ks + DEC_TK * KS;    // [TK][KS]
  float* ps = vs + DEC_TK * KS;    // [gc][TK]
  float* m_s = ps + gc * DEC_TK;   // [gc]
  float* l_s = m_s + gc;           // [gc]
  float* a_s = l_s + gc;           // [gc]
  float* ksc = a_s + gc;           // [TK] K scales of the tile's tokens
  float* vsc = ksc + DEC_TK;       // [TK] V scales

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G + g0) * D;
  for (int i = tid; i < gn * D; i += DEC_THREADS)
    qs[i] = E::round(E::load(qb + i) * scale);
  for (int g = tid; g < gn; g += DEC_THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[DEC_MAX_OUT];
#pragma unroll
  for (int k = 0; k < DEC_MAX_OUT; ++k) acc[k] = 0.f;

  const int n_out = gn * D;
  const int32_t* row = table + (size_t)b * max_pages;
  const size_t head_base = (size_t)h * num_pages_total;
  const size_t v_off = (size_t)pg.v_row * D;
  const int n_tok = min(lengths[b], max_pages * PT);

  for (int t0 = 0; t0 < n_tok; t0 += DEC_TK) {
    for (int i = tid; i < DEC_TK * VPR; i += DEC_THREADS) {
      const int t = i / VPR;
      const int c = i % VPR;
      const int pos = t0 + t;
      float kf[L::VEC], vf[L::VEC];
      if (pos < n_tok) {
        const int page = clamp_page(row[pos / PT], num_pages_total);
        L::load2(
            kv + ((head_base + page) * pg.rows + pos % PT) * D + c * L::VEC,
            v_off, kf, vf);
      } else {
#pragma unroll
        for (int e = 0; e < L::VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) {
        ks[t * KS + c * L::VEC + e] = kf[e];
        vs[t * KS + c * L::VEC + e] = vf[e];
      }
    }
    if (QUANT) {
      for (int t = tid; t < DEC_TK; t += DEC_THREADS) {
        const int pos = t0 + t;
        float a = 0.f, v = 0.f;
        if (pos < n_tok) {
          const size_t at =
              (head_base + clamp_page(row[pos / PT], num_pages_total)) * PT +
              pos % PT;
          a = kscale[at];
          v = vscale[at];
        }
        ksc[t] = a;
        vsc[t] = v;
      }
    }
    __syncthreads();

    for (int i = tid; i < gn * DEC_TK; i += DEC_THREADS) {
      const int g = i / DEC_TK;
      const int t = i % DEC_TK;
      float s = row_dot<DC>(reinterpret_cast<const float4*>(qs + g * D),
                            reinterpret_cast<const float4*>(ks + t * KS),
                            D / 4);
      if (QUANT) s *= ksc[t];
      ps[i] = (t0 + t < n_tok) ? s : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < gn; g += DEC_THREADS / 32) {
      float* pr = ps + g * DEC_TK;
      const float s0 = pr[lane];
      const float s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_next);
      const float p0 = (s0 == -INFINITY) ? 0.f : expf(s0 - m_next);
      const float p1 = (s1 == -INFINITY) ? 0.f : expf(s1 - m_next);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      pr[lane] = E::round(QUANT ? p0 * vsc[lane] : p0);
      pr[lane + 32] = E::round(QUANT ? p1 * vsc[lane + 32] : p1);
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_next;
        l_s[g] = alpha * l_s[g] + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < DEC_MAX_OUT; ++k) {
      const int o = tid + k * DEC_THREADS;
      if (o < n_out) {
        const int g = o / D;
        const int d = o % D;
        const float* pr = ps + g * DEC_TK;
        float pv = 0.f;
#pragma unroll 8
        for (int t = 0; t < DEC_TK; ++t) pv = fmaf(pr[t], vs[t * KS + d], pv);
        acc[k] = acc[k] * a_s[g] + pv;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * Hq + (size_t)h * G + g0) * D;
#pragma unroll
  for (int k = 0; k < DEC_MAX_OUT; ++k) {
    const int o = tid + k * DEC_THREADS;
    if (o < n_out) {
      float l = l_s[o / D];
      if (l == 0.f) l = 1.f;
      E::store(ob + o, o % D < v_keep ? acc[k] / l : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Chunked prefill
// ---------------------------------------------------------------------------

constexpr int PF_BM = 64;  // query rows per CTA
constexpr int PF_BN = 64;  // KV tokens per tile
constexpr int PF_THREADS = 256;  // 16 x 16: 4 rows x 4 columns each
constexpr int PF_PAD = 4;

// K^T and V share one buffer above D = 128 (see the file comment).
__host__ __device__ constexpr bool prefill_shares_kv(int dmax) {
  return dmax > 128;
}

size_t prefill_smem_bytes(int D, bool share) {
  const int ldm = PF_BM + PF_PAD, ldn = PF_BN + PF_PAD, ldv = D + PF_PAD;
  const size_t kv = share ? (size_t)max(D * ldn, PF_BN * ldv)
                          : (size_t)D * ldn + (size_t)PF_BN * ldv;
  return sizeof(float) *
         ((size_t)D * ldm + kv + (size_t)PF_BN * ldm + 2 * PF_BN);
}

template <typename T, int DC, int MODE>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_kernel(const T* __restrict__ q, const void* __restrict__ kv_,
                     const float* __restrict__ kscale,
                     const float* __restrict__ vscale,
                     const int32_t* __restrict__ page_row,
                     T* __restrict__ out, int Hq, int Hkv, int C, int d_rt,
                     int num_pages_total, PoolGeom pg, int max_pages,
                     int offset, float scale) {
  using E = Elem<T>;
  using L = KVLoad<T, MODE>;
  constexpr bool QUANT = MODE != KV_FLOAT;
  constexpr int DMAX = DC ? DC : MAX_D;
  constexpr int DVMAX = DMAX / 16;  // output dims per thread, at most
  constexpr bool SHARE = prefill_shares_kv(DMAX);
  constexpr int LDM = PF_BM + PF_PAD;
  constexpr int LDN = PF_BN + PF_PAD;
  const int D = DC ? DC : d_rt;
  const int DV = D / 16;          // output dims per thread
  const int LDV = D + PF_PAD;
  const int VPR = D / L::VEC;     // KV loads per token row
  const int QPR = D / E::VEC;     // q loads per row
  const int v_keep = D - pg.vtz;  // output lanes V does not zero
  const int PT = pg.PT;
  const typename L::S* kv = static_cast<const typename L::S*>(kv_);

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                // [D][LDM]   Q transposed
  float* kt = qt + D * LDM;        // [D][LDN]   K transposed
  float* vs = SHARE ? kt : kt + D * LDN;  // [BN][LDV]
  float* pt = SHARE ? kt + max(D * LDN, PF_BN * LDV)
                    : vs + PF_BN * LDV;   // [BN][LDM]  P transposed
  float* ksc = pt + PF_BN * LDM;   // [BN] K scales of the tile's tokens
  float* vsc = ksc + PF_BN;        // [BN] V scales

  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows = G * C;
  const int r0 = blockIdx.x * PF_BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t head_row0 = (size_t)h * rows;
  const T* qh = q + head_row0 * D;

  for (int i = tid; i < PF_BM * QPR; i += PF_THREADS) {
    const int r = i / QPR;
    const int c = i % QPR;
    float f[E::VEC];
    if (r0 + r < rows) {
      E::unpack(*reinterpret_cast<const uint4*>(qh + (size_t)(r0 + r) * D +
                                                c * E::VEC),
                f);
#pragma unroll
      for (int e = 0; e < E::VEC; ++e) f[e] = E::round(f[e] * scale);
    } else {
#pragma unroll
      for (int e = 0; e < E::VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E::VEC; ++e) qt[(c * E::VEC + e) * LDM + r] = f[e];
  }

  int lim[4];  // last visible global column of each of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) lim[i] = offset + (r0 + ty * 4 + i) % C;
  const int r_last = min(r0 + PF_BM, rows) - 1;
  const int c_max = (r0 / C == r_last / C) ? (r_last % C) : (C - 1);
  const int kv_end = min(offset + c_max + 1, max_pages * PT);

  float m[4], l[4], acc[4][DVMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e) acc[i][e] = 0.f;
  }
  const size_t head_base = (size_t)h * num_pages_total;
  const size_t v_off = (size_t)pg.v_row * D;

  // Stage tile t0's K rows (as K^T) and, with KV_ROWS, its V rows in one
  // pass; V_ONLY: its V rows alone.
  constexpr int KV_ROWS = 0, V_ONLY = 1;
  auto stage = [&](int t0, int what) {
    for (int i = tid; i < PF_BN * VPR; i += PF_THREADS) {
      const int t = i / VPR;
      const int c = i % VPR;
      const int pos = t0 + t;
      float kf[L::VEC], vf[L::VEC];
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) kf[e] = vf[e] = 0.f;
      if (pos < kv_end) {
        const int page = clamp_page(page_row[pos / PT], num_pages_total);
        const typename L::S* p =
            kv + ((head_base + page) * pg.rows + pos % PT) * D + c * L::VEC;
        if (what == V_ONLY)
          L::load(p + v_off, true, vf);
        else if (SHARE)
          L::load(p, false, kf);
        else
          L::load2(p, v_off, kf, vf);
      }
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) {
        const int d = c * L::VEC + e;
        if (what != V_ONLY) kt[d * LDN + t] = kf[e];
        if (what == V_ONLY || !SHARE) vs[t * LDV + d] = vf[e];
      }
    }
  };

  for (int t0 = 0; t0 < kv_end; t0 += PF_BN) {
    __syncthreads();  // Q staged (first tile); last tile's readers done
    stage(t0, KV_ROWS);  // K^T, and V unless it shares K^T's buffer
    if (QUANT) {
      for (int t = tid; t < PF_BN; t += PF_THREADS) {
        const int pos = t0 + t;
        float a = 0.f, v = 0.f;
        if (pos < kv_end) {
          const size_t at =
              (head_base + clamp_page(page_row[pos / PT], num_pages_total)) *
                  PT +
              pos % PT;
          a = kscale[at];
          v = vscale[at];
        }
        ksc[t] = a;
        vsc[t] = v;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDM + ty * 4);
      const float4 k4 = *reinterpret_cast<const float4*>(kt + d * LDN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv4[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx * 4 + j;
        if (QUANT) s[i][j] *= ksc[tx * 4 + j];
        if (col > lim[i] || col >= kv_end) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are the 16 lanes sharing ty in one warp.
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_next);
        sum += p;
        s[i][j] = E::round(QUANT ? p * vsc[tx * 4 + j] : p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
#pragma unroll
      for (int e = 0; e < DVMAX; ++e) acc[i][e] *= alpha;
    }
    if (SHARE) {
      __syncthreads();  // every thread is done with K^T
      stage(t0, V_ONLY);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * LDM + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int c = 0; c < PF_BN; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * LDM + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vr = vs + c * LDV + tx * DV;
#pragma unroll
      for (int e = 0; e < DVMAX; ++e) {
        if (e < DV) {
          const float ve = vr[e];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], ve, acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r < rows) {
      const float li = (l[i] == 0.f) ? 1.f : l[i];
      T* orow = out + (head_row0 + r) * D + tx * DV;
#pragma unroll
      for (int e = 0; e < DVMAX; ++e)
        if (e < DV)
          E::store(orow + e, tx * DV + e < v_keep ? acc[i][e] / li : 0.f);
    }
  }
}

template <typename T, int DC, int MODE>
int launch_decode(const void* q, const void* kv, const void* ks,
                  const void* vs, const void* table, const void* lengths,
                  void* out, int B, int Hq, int Hkv, int D,
                  int num_pages_total, int PT, int s_sub, int vtz,
                  int max_pages, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  // Slices of the group: as few as hold G * D outputs at DEC_MAX_ROWS each,
  // evened out.
  const int splits = (G * D + DEC_MAX_ROWS - 1) / DEC_MAX_ROWS;
  const int gc = (G + splits - 1) / splits;
  if (gc * D > DEC_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const size_t smem = decode_smem_bytes(gc, D);
  auto kern = paged_decode_kernel<T, DC, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(Hkv, B, (G + gc - 1) / gc), DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), kv, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), Hq, Hkv,
      gc, D, num_pages_total, pool_geom<MODE>(PT, s_sub, vtz), max_pages,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DC, int MODE>
int launch_prefill(const void* q, const void* kv, const void* ks,
                   const void* vs, const void* page_row, void* out, int Hq,
                   int Hkv, int C, int D, int num_pages_total, int PT,
                   int s_sub, int vtz, int max_pages, int offset, float scale,
                   cudaStream_t stream) {
  const int rows = (Hq / Hkv) * C;
  const size_t smem =
      prefill_smem_bytes(D, prefill_shares_kv(DC ? DC : MAX_D));
  auto kern = paged_prefill_kernel<T, DC, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((rows + PF_BM - 1) / PF_BM, Hkv), PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), kv, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(page_row),
      static_cast<T*>(out), Hq, Hkv, C, D, num_pages_total,
      pool_geom<MODE>(PT, s_sub, vtz), max_pages, offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype (q's and, in mode 0, the
// pool's): 0 = float32, 1 = bfloat16.  mode: 0 float pool, 1 int8 halves,
// 2 int4 shared byte; ks and vs are ignored (may be null) in mode 0.
// s_sub: page rows per token (1 or 2; 1 for the int4 byte); vtz: V's
// zeroed tail lanes.  Returns the launch's cudaError_t;
// cudaErrorInvalidValue for an unsupported dtype, mode, page layout or head
// dim (a multiple of 16 up to 288).
extern "C" {

#define MFA_DISPATCH(LAUNCH, ...)                                           \
  do {                                                                      \
    if (dtype == 0) {                                                       \
      MFA_MODES(LAUNCH, float, __VA_ARGS__);                                \
    } else if (dtype == 1) {                                                \
      MFA_MODES(LAUNCH, __nv_bfloat16, __VA_ARGS__);                        \
    }                                                                       \
  } while (0)
#define MFA_MODES(LAUNCH, T, ...)                                           \
  do {                                                                      \
    if (mode == KV_FLOAT) MFA_DIMS(LAUNCH, T, KV_FLOAT, __VA_ARGS__);       \
    if (mode == KV_INT8) MFA_DIMS(LAUNCH, T, KV_INT8, __VA_ARGS__);         \
    if (mode == KV_INT4) MFA_DIMS(LAUNCH, T, KV_INT4, __VA_ARGS__);         \
  } while (0)
#define MFA_DIMS(LAUNCH, T, MODE, ...)                                      \
  do {                                                                      \
    if (D == 32) return LAUNCH<T, 32, MODE>(__VA_ARGS__);                   \
    if (D == 64) return LAUNCH<T, 64, MODE>(__VA_ARGS__);                   \
    if (D == 128) return LAUNCH<T, 128, MODE>(__VA_ARGS__);                 \
    if (D == 288) return LAUNCH<T, 288, MODE>(__VA_ARGS__);                 \
    return LAUNCH<T, 0, MODE>(__VA_ARGS__);                                 \
  } while (0)

static bool valid_layout(int mode, int D, int s_sub, int vtz) {
  if (D <= 0 || D % 16 || D > MAX_D || vtz < 0 || vtz >= D) return false;
  if (mode == KV_INT4) return s_sub == 1 && vtz == 0;
  return s_sub == 1 || s_sub == 2;
}

int mfa_paged_decode(const void* q, const void* kv, const void* ks,
                     const void* vs, const void* table, const void* lengths,
                     void* out, int dtype, int mode, int B, int Hq, int Hkv,
                     int D, int num_pages_total, int PT, int s_sub, int vtz,
                     int max_pages, float scale, void* stream) {
  if (!valid_layout(mode, D, s_sub, vtz) || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_decode, q, kv, ks, vs, table, lengths, out, B, Hq, Hkv,
               D, num_pages_total, PT, s_sub, vtz, max_pages, scale, s);
  return (int)cudaErrorInvalidValue;
}

int mfa_paged_prefill(const void* q, const void* kv, const void* ks,
                      const void* vs, const void* page_row, void* out,
                      int dtype, int mode, int Hq, int Hkv, int C, int D,
                      int num_pages_total, int PT, int s_sub, int vtz,
                      int max_pages, int offset, float scale, void* stream) {
  if (!valid_layout(mode, D, s_sub, vtz) || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_prefill, q, kv, ks, vs, page_row, out, Hq, Hkv, C, D,
               num_pages_total, PT, s_sub, vtz, max_pages, offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

#undef MFA_DIMS
#undef MFA_MODES
#undef MFA_DISPATCH

const char* mfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Quantized attention backward for Hopper (sm_90a): dQ and dK/dV over int8
// or group-planar int4 K/V, exact (dequantizing or folded) and full-integer.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu,
// ops/flash_attention_bwd.py):
//   - _dq_kernel, quantized modes   -> qflash_dq_kernel
//   - _dkv_kernel, quantized modes  -> qflash_dkv_kernel
//   - _dq_fullint_kernel            -> fullint_dq_kernel
//   - _dkv_fullint_kernel           -> fullint_dkv_kernel
//
// The exact pair runs the flash backward's bodies (attention_bwd.cuh) with
// K/V staged from their payloads (quantized_tiles.cuh):
//   - dQ: Q and dO arrive as the kernel uses them (T, pre-scaled; in the
//     folded mode TENSOR / CHANNEL K scales are folded into Q and V scales
//     into dO by the wrapper) and each of K, V is dequantized per token
//     ((w - zp)*s) or per BLOCK_2D block and rounded to T, or read as its
//     integers (folded); per-token K scales (ROW, folded) multiply S's and
//     dS's columns, per-token V scales dP's; dQ is stored times a
//     per-channel vector [B, Hkv, D] (scale x the folded K scales).
//     bf16 runs on the tensor cores (qflash_dq_tc_kernel: dq_tc_body, the
//     payload rows double-buffered by cp.async and dequantized in shared
//     memory a tile at a time), fp32 on the scalar body;
//   - dK/dV: gradients with respect to the DEQUANTIZED K/V: each K/V tile is
//     dequantized (per token, per BLOCK_2D block or per channel) and rounded
//     to T as it is staged, then used with the unfolded Q (scaled by `scale`
//     and rounded here) and dO; the group reduction happens in the kernel.
//     bf16 runs on the tensor cores (qflash_dkv_tc_kernel: dkv_tc_body, the
//     payload rows copied by cp.async and dequantized in shared memory),
//     fp32 on the scalar body.
//
// The full-integer pair takes per-token int8 Q (Q*scale quantized, scales
// qsc [B, Hq, Sq], times a TENSOR K scale) and int8 dO twice: dO itself
// (dor, scales dorsc) and dO times the V scales (dov, dovsc).  K and V are
// int8 SYMMETRIC: ROW K scales ks [B, Hkv, Skv] or none (TENSOR, folded into
// qsc and the store multiplier).  L is the logsumexp with -inf read as 0.
//   - dQ: S = Q_int.K_int^T and dP = dOv_int.V_int^T in int32 (__dp4a);
//     p = exp(S*qsc (*ks) - L); dS = p*(dP*dovsc - D) (*ks); dQ += dS'.K_int
//     with dS' = round_bf16(dS) (level 1) or dS row-quantized to int8
//     (absmax/127, +-0.5 then truncation) and scaled back (level 2);
//     stored times `store` (scale x a TENSOR K scale);
//   - dK/dV per key tile over the group's q heads: S^T, dP^T in int32;
//     P^T = exp(S^T*qsc (*ks) - L); dV += P'.dO_int with P = P^T*dorsc;
//     dK += dS'.Q_int with dS = P^T*(dP^T*dovsc - D)*qsc; P' and dS' as
//     above (P row-quantized to [0, 127]); dK stored times `store`
//     (1 / a TENSOR K scale).
//   Level 2 quantizes each row over the TPU kernel's tile width `width`
//   (its block_kv_dq for dQ, block_q_dkv for dK/dV), passed as data: a
//   tile's row maxima come from a first pass over it (S and dP computed
//   twice), so level 2 is held to the TPU numerics whatever the CUDA tiles.
//   width = 0 is level 1.
//
// What bounds them on the H100, and the design.
//   At the JAX package's north-star shape (B=4, H=4, S=4096, D=256, FULL)
//   each product is 2*S^2*D*B*H = 1.37e11 operations: the full-integer dQ
//   does two int8 products and one bf16 (bound ~0.28 ms), its dK/dV two of
//   each (~0.42 ms); the exact pair does 3 and 4 bf16 products.  These first
//   versions take the flash kernels' shape (one CTA per 64 query rows or 64
//   keys, 256 threads, 4 x 4 outputs each) with __dp4a for the int8
//   products and scalar fp32 FMAs for the rest, so they sit far from that
//   bound; the bf16 exact dQ and dK/dV run bf16 mma.sync (dq_tc_body,
//   dkv_tc_body), the full-integer pair awaits mma.sync / wgmma (s8 and
//   bf16).  The payloads are widened
//   while they are staged into shared memory, so device memory sees only
//   the integer bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"
#include "quantized_tiles.cuh"

namespace {

using mfa::BM;
using mfa::BN;
using mfa::BwdArgs;
using mfa::KVOperand;
using mfa::LD;
using mfa::THREADS;
using mfa::accumulate_pm;
using mfa::byte_of;
using mfa::round_bf16;
using mfa::launch_with_smem;
using mfa::stage_kv;
using mfa::stage_words;
using mfa::store_t;
using mfa::tile_product_i8;

// ---------------------------------------------------------------------------
// The exact pair
// ---------------------------------------------------------------------------

// K and V tiles from their payloads, dequantized (rounded to bf16 with rb)
// or as integers.
template <int D>
struct QuantKV {
  KVOperand k, v;
  int Skv, br, bs;
  bool rb;
  __device__ __forceinline__ void stage(bool is_v, size_t head, int t0,
                                        int limit, float* dst) const {
    stage_kv<D>(is_v ? v : k, head, Skv, br, bs, rb, t0, limit, dst);
  }
  // dkv_tc_body's staging (bf16): the payload rows by cp.async into `raw`,
  // then dequantized and rounded to bf16 rows there, as stage_kv rounds.
  template <int NT, int ROW>
  __device__ __forceinline__ void tc_load(bool is_v, size_t head, int t0,
                                          int limit, uint8_t*,
                                          uint8_t* raw) const {
    const KVOperand& op = is_v ? v : k;
    mfa::stage_raw<D, D, NT>(op.pay, op.bits, head, Skv, t0, limit, raw);
  }
  template <int NT, int ROW>
  __device__ __forceinline__ void tc_convert(bool is_v, size_t head, int t0,
                                             int limit, uint8_t* dst,
                                             const uint8_t* raw) const {
    mfa::dequant_rows_bf16<D, D, NT>(is_v ? v : k, raw, head, Skv, br, bs,
                                     t0, limit, dst, ROW);
  }
  static constexpr bool RAW = true;  // tc_load fills `raw`, tc_convert dst
};

// Replaces _dq_kernel's quantized modes.  Bound: operations (6*D per live
// pair).  The fp32 instances; bf16 takes qflash_dq_tc_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qflash_dq_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dq_body<T, D, false>(a, kv);
}

// The same on the tensor cores (attention_bwd.cuh::dq_tc_body), bf16: the
// payload rows double-buffered by cp.async, dequantized in shared memory.
template <int D>
__global__ void __launch_bounds__(mfa::dq_tc_threads<D>(),
                           mfa::dq_tc_min_blocks<D>())
qflash_dq_tc_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dq_tc_body<D, false>(a, kv);
}

// Replaces _dkv_kernel's quantized modes.  Bound: operations (8*D per live
// pair).  The fp32 instances; bf16 takes qflash_dkv_tc_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qflash_dkv_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dkv_body<T, D>(a, kv);
}

// The same on the tensor cores (attention_bwd.cuh::dkv_tc_body), bf16.
template <int D>
__global__ void __launch_bounds__(mfa::dkv_tc_threads<D>(),
                           mfa::dkv_tc_min_blocks<D>())
qflash_dkv_tc_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dkv_tc_body<D>(a, kv);
}

// ---------------------------------------------------------------------------
// The full-integer pair
// ---------------------------------------------------------------------------

struct FullintArgs {
  const int8_t* qq;    // [B, Hq, Sq, D]
  const float* qsc;    // [B, Hq, Sq]
  const int8_t* kq;    // [B, Hkv, Skv, D]
  const float* ks;     // [B, Hkv, Skv] (ROW K) or null (TENSOR K)
  const int8_t* vq;    // [B, Hkv, Skv, D]
  const int8_t* dor;   // dO [B, Hq, Sq, D] (dK/dV only)
  const float* dorsc;  // [B, Hq, Sq]
  const int8_t* dov;   // dO x the V scales [B, Hq, Sq, D]
  const float* dovsc;  // [B, Hq, Sq]
  const float* lse;    // [B, Hq, Sq], -inf read as 0 by the wrapper
  const float* di;     // [B, Hq, Sq]
  float* out0;         // dQ [B, Hq, Sq, D] | dK [B, Hkv, Skv, D]
  float* out1;         // dV [B, Hkv, Skv, D]
  int Hq, Hkv, Sq, Skv, interleaved;
  int width;    // level 2's row-quantization width; 0: level 1
  float store;  // multiplier of dQ | dK at the store
};

// int8 rows [r0, r0 + 64) of a [rows, D] matrix (zeros from `limit`)
// transposed into dst[d * LD + r] as fp32.
template <int D>
__device__ __forceinline__ void stage_i8(const int8_t* base, int r0,
                                         int limit, float* dst) {
  constexpr int W = D / 4;
  for (int i = threadIdx.x; i < 64 * W; i += THREADS) {
    const int r = i / W;
    const int w = i % W;
    const int word =
        r0 + r < limit
            ? *reinterpret_cast<const int*>(base + (size_t)(r0 + r) * D + 4 * w)
            : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(4 * w + e) * LD + r] = byte_of(word, e);
  }
}

// Max over the 16 lanes that share a row (the lanes of one ty in a warp).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One value of a level-2 product: x quantized over its row's maximum `am`
// (signed: +-0.5 then truncation; else x >= 0, +0.5 then truncation) and
// scaled back by am/127.
__device__ __forceinline__ float rowquant(float x, float am, bool is_signed) {
  const float inv = 127.f / fmaxf(am, 1e-30f);
  const float xs = x * inv;
  const float q = (float)(int)(xs + (is_signed ? (xs >= 0.f ? 0.5f : -0.5f)
                                               : 0.5f));
  return q * (am * (1.f / 127.f));
}

template <int D>
constexpr size_t fullint_dq_smem_bytes() {
  // Q, dOv and K|V words; K^T fp32; dS^T
  return (3 * (size_t)(D / 4) * LD + (size_t)D * LD + (size_t)BN * LD) * 4;
}

template <int D>
constexpr size_t fullint_dkv_smem_bytes() {
  // K, V, Q and dOv words; dO^T then Q^T fp32; P then dS (q-major)
  return (4 * (size_t)(D / 4) * LD + (size_t)D * LD + (size_t)BM * LD) * 4;
}

// Replaces _dq_fullint_kernel.  Bound: operations (2 int8 and 1 bf16
// product of 2*D per pair).  One CTA per (64 query rows, b, q head) keeps
// its Q and dOv words resident and walks the keys.
template <int D>
__global__ void __launch_bounds__(THREADS)
fullint_dq_kernel(const FullintArgs a) {
  constexpr int DV = D / 16;
  constexpr int W4 = D / 4;
  extern __shared__ __align__(16) float smem[];
  int* qw = reinterpret_cast<int*>(smem);  // [D/4][LD] Q words
  int* dow = qw + W4 * LD;                 // [D/4][LD] dOv words
  int* kvw = dow + W4 * LD;                // [D/4][LD] V, then K words
  float* kf = reinterpret_cast<float*>(kvw + W4 * LD);  // [D][LD] K^T
  float* dst = kf + D * LD;                             // [BN][LD] dS'^T

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
  const int8_t* kh = a.kq + bk * Skv * D;
  const int8_t* vh = a.vq + bk * Skv * D;
  const float* ks = a.ks ? a.ks + bk * Skv : nullptr;

  stage_words<D>(a.qq + bh * Sq * D, D, r0, Sq, qw);
  stage_words<D>(a.dov + bh * Sq * D, D, r0, Sq, dow);

  float qs[4], lrow[4], drow[4], dvs[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    const bool live = r < Sq;
    qs[i] = live ? a.qsc[bh * Sq + r] : 0.f;
    lrow[i] = live ? a.lse[bh * Sq + r] : 0.f;
    drow[i] = live ? a.di[bh * Sq + r] : 0.f;
    dvs[i] = live ? a.dovsc[bh * Sq + r] : 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.f;
  }

  const bool level2 = a.width > 0;
  const int width = level2 ? a.width : Skv;
  for (int c0 = 0; c0 < Skv; c0 += width) {
    const int c_end = min(c0 + width, Skv);
    float amax[4] = {0.f, 0.f, 0.f, 0.f};
    for (int pass = level2 ? 0 : 1; pass < 2; ++pass) {
      for (int t0 = c0; t0 < c_end; t0 += BN) {
        __syncthreads();  // the previous tile's readers are done
        stage_words<D>(vh, D, t0, c_end, kvw);
        __syncthreads();
        int dpi[4][4];
        tile_product_i8<D>(dow, ty, kvw, tx, dpi);
        __syncthreads();  // every thread is done with the V words
        stage_words<D>(kh, D, t0, c_end, kvw);
        if (pass == 1) stage_i8<D>(kh, t0, c_end, kf);
        __syncthreads();
        int si[4][4];
        tile_product_i8<D>(qw, ty, kvw, tx, si);
        float ds[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = t0 + tx * 4 + j;
          const bool in = col < c_end;
          const float k_s = (ks && in) ? ks[col] : 1.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float s = (float)si[i][j] * qs[i];
            if (ks) s *= k_s;
            const float p = in ? expf(s - lrow[i]) : 0.f;
            float d = p * ((float)dpi[i][j] * dvs[i] - drow[i]);
            if (ks) d *= k_s;
            ds[i][j] = d;
          }
        }
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float m = fmaxf(fmaxf(fabsf(ds[i][0]), fabsf(ds[i][1])),
                            fmaxf(fabsf(ds[i][2]), fabsf(ds[i][3])));
            amax[i] = fmaxf(amax[i], row_max16(m));
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ds[i][j] = level2 ? rowquant(ds[i][j], amax[i], true)
                              : round_bf16(ds[i][j]);
        store_t(dst, ty, tx, ds);
        __syncthreads();  // dS'^T and K^T staged
        accumulate_pm<D>(dst, ty, kf, tx, acc);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    float* out = a.out0 + (bh * Sq + r) * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) out[tx + 16 * e] = acc[i][e] * a.store;
  }
}

// Replaces _dkv_fullint_kernel.  Bound: operations (2 int8 and 2 bf16
// products of 2*D per pair).  One CTA per (64 keys, b, kv head) keeps its K
// and V words resident, owns its dK and dV and walks the group's q heads x
// every query row (the path has no mask).
template <int D>
__global__ void __launch_bounds__(THREADS)
fullint_dkv_kernel(const FullintArgs a) {
  constexpr int DV = D / 16;
  constexpr int W4 = D / 4;
  extern __shared__ __align__(16) float smem[];
  int* kw = reinterpret_cast<int*>(smem);  // [D/4][LD] K words
  int* vw = kw + W4 * LD;                  // [D/4][LD] V words
  int* qw = vw + W4 * LD;                  // [D/4][LD] Q words
  int* dvw = qw + W4 * LD;                 // [D/4][LD] dOv words
  float* mf = reinterpret_cast<float*>(dvw + W4 * LD);  // [D][LD] dO^T|Q^T
  float* ps = mf + D * LD;  // [BM][LD] P', then dS' (q-major)

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query columns tx*4 + j
  const int ty = tid / 16;  // key rows ty*4 + i
  const size_t bkv = (size_t)b * a.Hkv + hk;

  stage_words<D>(a.kq + bkv * Skv * D, D, c0, Skv, kw);
  stage_words<D>(a.vq + bkv * Skv * D, D, c0, Skv, vw);
  float ksr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty * 4 + i;
    ksr[i] = (a.ks && key < Skv) ? a.ks[bkv * Skv + key] : 1.f;
  }

  float dk_acc[4][DV], dv_acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DV; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const bool level2 = a.width > 0;
  const int width = level2 ? a.width : Sq;
  for (int g = 0; g < group; ++g) {
    const int h = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + h;
    const int8_t* qh = a.qq + bh * Sq * D;
    for (int q0 = 0; q0 < Sq; q0 += width) {
      const int q_end = min(q0 + width, Sq);
      float am_p[4] = {0.f, 0.f, 0.f, 0.f};
      float am_s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pass = level2 ? 0 : 1; pass < 2; ++pass) {
        for (int r0 = q0; r0 < q_end; r0 += BM) {
          __syncthreads();  // the previous tile's readers are done
          stage_words<D>(qh, D, r0, q_end, qw);
          stage_words<D>(a.dov + bh * Sq * D, D, r0, q_end, dvw);
          if (pass == 1) stage_i8<D>(a.dor + bh * Sq * D, r0, q_end, mf);
          bool in[4];
          float qs[4], lcol[4], dcol[4], dors[4], dovs[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + tx * 4 + j;
            in[j] = r < q_end;
            const size_t o = bh * Sq + (in[j] ? r : 0);
            qs[j] = a.qsc[o];
            lcol[j] = a.lse[o];
            dcol[j] = a.di[o];
            dors[j] = a.dorsc[o];
            dovs[j] = a.dovsc[o];
          }
          __syncthreads();
          float pd[4][4], dsv[4][4];  // [key i][query j]
          {
            int sti[4][4];
            tile_product_i8<D>(kw, ty, qw, tx, sti);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float st = (float)sti[i][j] * qs[j];
                if (a.ks) st *= ksr[i];
                pd[i][j] = in[j] ? expf(st - lcol[j]) : 0.f;  // P^T
              }
          }
          {
            int dpti[4][4];
            tile_product_i8<D>(vw, ty, dvw, tx, dpti);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float pt = pd[i][j];
                dsv[i][j] =
                    pt * ((float)dpti[i][j] * dovs[j] - dcol[j]) * qs[j];
                pd[i][j] = pt * dors[j];
              }
          }
          if (pass == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float mp = 0.f, ms = 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                mp = fmaxf(mp, pd[i][j]);
                ms = fmaxf(ms, fabsf(dsv[i][j]));
              }
              am_p[i] = fmaxf(am_p[i], row_max16(mp));
              am_s[i] = fmaxf(am_s[i], row_max16(ms));
            }
            continue;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pd[i][j] = level2 ? rowquant(pd[i][j], am_p[i], false)
                                : round_bf16(pd[i][j]);
              dsv[i][j] = level2 ? rowquant(dsv[i][j], am_s[i], true)
                                 : round_bf16(dsv[i][j]);
            }
          // P', q-major: ps[q * LD + key], the layout accumulate_pm reads.
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(ps + (tx * 4 + j) * LD + ty * 4) =
                make_float4(pd[0][j], pd[1][j], pd[2][j], pd[3][j]);
          __syncthreads();
          accumulate_pm<D>(ps, ty, mf, tx, dv_acc);  // dV += P'.dO_int
          __syncthreads();
          stage_i8<D>(qh, r0, q_end, mf);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(ps + (tx * 4 + j) * LD + ty * 4) =
                make_float4(dsv[0][j], dsv[1][j], dsv[2][j], dsv[3][j]);
          __syncthreads();
          accumulate_pm<D>(ps, ty, mf, tx, dk_acc);  // dK += dS'.Q_int
        }
      }
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
      dkr[tx + 16 * e] = dk_acc[i][e] * a.store;
      dvr[tx + 16 * e] = dv_acc[i][e];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_qflash(bool dq, const BwdArgs& a, const QuantKV<D>& kv, int B,
                  cudaStream_t stream) {
  const dim3 dq_grid((a.Sq + BM - 1) / BM, a.Hq, B);
  if constexpr (mfa::dq_tc<T, D>()) {
    if (dq)
      return launch_with_smem(qflash_dq_tc_kernel<D>, dq_grid,
                              mfa::dq_tc_threads<D>(),
                              mfa::DqTcSmem<D, true>::BYTES, stream, a, kv);
  } else if (dq) {
    return launch_with_smem(qflash_dq_kernel<T, D>, dq_grid, THREADS,
                            mfa::dq_smem_floats<D>() * sizeof(float), stream,
                            a, kv);
  }
  const dim3 grid((a.Skv + BN - 1) / BN, a.Hkv, B);
  if constexpr (mfa::dkv_tc<T, D>())
    return launch_with_smem(qflash_dkv_tc_kernel<D>, grid,
                            mfa::dkv_tc_threads<D>(), mfa::DkvTcSmem<D>::BYTES,
                            stream, a, kv);
  else
    return launch_with_smem(qflash_dkv_kernel<T, D>, grid, THREADS,
                            mfa::dkv_smem_floats<D>() * sizeof(float), stream,
                            a, kv);
}

template <int D>
int launch_fullint(bool dq, const FullintArgs& a, int B,
                   cudaStream_t stream) {
  if (dq)
    return launch_with_smem(fullint_dq_kernel<D>,
                            dim3((a.Sq + BM - 1) / BM, a.Hq, B), THREADS,
                            fullint_dq_smem_bytes<D>(), stream, a);
  return launch_with_smem(fullint_dkv_kernel<D>,
                          dim3((a.Skv + BN - 1) / BN, a.Hkv, B), THREADS,
                          fullint_dkv_smem_bytes<D>(), stream, a);
}

bool valid_bits(int bits) { return bits == 8 || bits == 4; }

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported dtype (0 float32,
// 1 bfloat16), head dim (32, 64, 128, 256), bit width or head grouping.
extern "C" {

// The exact dQ (dq = 1: out0 = dQ, out1 = dbias or null; q pre-scaled) or
// dK/dV (dq = 0: out0 = dK, out1 = dV; q scaled by `scale` here).  k_mode /
// v_mode: 0 integers, 1 per token, 2 BLOCK_2D, 5 per channel.
int mfa_qflash_bwd(int dq, const void* q, const void* dout, const void* kq,
                   const void* ks, const void* kz, const void* vq,
                   const void* vs, const void* vz, const void* ksr,
                   const void* vsr, const void* dqsc, const void* lse,
                   const void* di, const void* ranges, const void* bias,
                   long long bias_sb, long long bias_sh, void* out0,
                   void* out1, int dtype, int B, int Hq, int Hkv, int Sq,
                   int Skv, int D, int interleaved, int bits_k, int bits_v,
                   int k_mode, int v_mode, int br, int bs, float scale,
                   void* stream) {
  if (Hkv <= 0 || Hq % Hkv || !valid_bits(bits_k) || !valid_bits(bits_v))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(di),
                  static_cast<const int32_t*>(ranges),
                  static_cast<const float*>(bias), bias_sb, bias_sh,
                  static_cast<const float*>(ksr),
                  static_cast<const float*>(vsr),
                  static_cast<const float*>(dqsc), static_cast<float*>(out0),
                  static_cast<float*>(out1), Hq, Hkv, Sq, Skv, interleaved,
                  scale};
  const KVOperand k{static_cast<const uint8_t*>(kq),
                    static_cast<const float*>(ks),
                    static_cast<const float*>(kz), bits_k, k_mode};
  const KVOperand v{static_cast<const uint8_t*>(vq),
                    static_cast<const float*>(vs),
                    static_cast<const float*>(vz), bits_v, v_mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_QFLASH(T, DD) \
  return launch_qflash<T, DD>(dq, a, QuantKV<DD>{k, v, Skv, br, bs, dtype == 1}, B, s)
  if (dtype == 0) {
    if (D == 32) MFA_QFLASH(float, 32);
    if (D == 64) MFA_QFLASH(float, 64);
    if (D == 128) MFA_QFLASH(float, 128);
    if (D == 256) MFA_QFLASH(float, 256);
  } else if (dtype == 1) {
    if (D == 32) MFA_QFLASH(__nv_bfloat16, 32);
    if (D == 64) MFA_QFLASH(__nv_bfloat16, 64);
    if (D == 128) MFA_QFLASH(__nv_bfloat16, 128);
    if (D == 256) MFA_QFLASH(__nv_bfloat16, 256);
  }
#undef MFA_QFLASH
  return (int)cudaErrorInvalidValue;
}

// The full-integer dQ (dq = 1: out0 = dQ) or dK/dV (dq = 0: out0 = dK,
// out1 = dV).
int mfa_fullint_bwd(int dq, const void* qq, const void* qsc, const void* kq,
                    const void* ks, const void* vq, const void* dor,
                    const void* dorsc, const void* dov, const void* dovsc,
                    const void* lse, const void* di, void* out0, void* out1,
                    int B, int Hq, int Hkv, int Sq, int Skv, int D,
                    int interleaved, int width, float store, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || width < 0) return (int)cudaErrorInvalidValue;
  const FullintArgs a{
      static_cast<const int8_t*>(qq),   static_cast<const float*>(qsc),
      static_cast<const int8_t*>(kq),   static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq),   static_cast<const int8_t*>(dor),
      static_cast<const float*>(dorsc), static_cast<const int8_t*>(dov),
      static_cast<const float*>(dovsc), static_cast<const float*>(lse),
      static_cast<const float*>(di),    static_cast<float*>(out0),
      static_cast<float*>(out1),        Hq, Hkv, Sq, Skv, interleaved,
      width,                            store};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_fullint<32>(dq, a, B, s);
  if (D == 64) return launch_fullint<64>(dq, a, B, s);
  if (D == 128) return launch_fullint<128>(dq, a, B, s);
  if (D == 256) return launch_fullint<256>(dq, a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

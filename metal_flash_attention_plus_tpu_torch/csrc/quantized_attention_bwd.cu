// Quantized attention backward for Hopper (sm_90a): dQ and dK/dV over int8
// or group-planar int4 K/V, exact (dequantizing or folded) and full-integer.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu,
// ops/flash_attention_bwd.py):
//   - _dq_kernel, quantized modes   -> qflash_dq_tc_kernel (bf16 up to
//     D = 256), qflash_dq_wide_kernel (bf16 at D = 288),
//     qflash_dq_latent_kernel (bf16 at D = 576), qflash_dq_kernel (fp32)
//   - _dkv_kernel, quantized modes  -> qflash_dkv_tc_kernel (bf16 up to
//     D = 256), qflash_dkv_wide_kernel (bf16 at D = 288) or
//     qflash_dkv_latent_kernel (bf16 at D = 576) then flash_attention.cu's
//     flash_dkv_merge_kernel, qflash_dkv_kernel (fp32)
//   - _dq_fullint_kernel            -> fullint_dq_tc_kernel, fullint_dq_kernel
//                                      (fullint_dq32_kernel at D = 576)
//   - _dkv_fullint_kernel           -> fullint_dkv_tc_kernel (then
//                                      flash_dkv_merge_kernel at D = 576),
//                                      fullint_dkv_kernel
//                                      (fullint_dkv32_kernel at D = 576)
// Head dims: both pairs are built for D = 32, 64, 128, 256, MLA's 288 and
// DeepSeek's absorbed 576 (ops/quantized_attention.py::qattn_width runs
// every other head dim from 1 to 576 zero-padded at the next); above 576
// every multiple of 16 runs csrc/split_d_quantized_bwd.cu's kernels
// (split_d_qdq_kernel and split_d_qdkv_kernel over the payloads,
// split_d_fullint_dq_kernel, split_d_fullint_dkv_kernel), which
// mfa_qflash_bwd and mfa_fullint_bwd launch.
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
//     memory a tile at a time; at D = 288 qflash_dq_wide_kernel:
//     dq_wide_body, 32-key tiles; at D = 576 qflash_dq_latent_kernel:
//     dq_latent_body, each tile's payload dequantized as it loads), fp32 on
//     the scalar body (dq_body32 in 32-row tiles at 576);
//   - dK/dV: gradients with respect to the DEQUANTIZED K/V: each K/V tile is
//     dequantized (per token, per BLOCK_2D block or per channel) and rounded
//     to T as it is staged, then used with the unfolded Q (scaled by `scale`
//     and rounded here) and dO; the group reduction happens in the kernel.
//     bf16 runs on the tensor cores (qflash_dkv_tc_kernel: dkv_tc_body, the
//     payload rows copied by cp.async and dequantized in shared memory; at
//     D = 288 qflash_dkv_wide_kernel: dkv_wide_body, 48-row query steps;
//     at D = 576 qflash_dkv_latent_kernel: dkv_latent_body, a CTA's 32 keys
//     dequantized once as they load; at both the GQA group split over
//     `splits` CTAs a key tile into an fp32 workspace that
//     flash_dkv_merge_kernel sums in split order), fp32 on the scalar body
//     (dkv_body32 in 32-key tiles at 576).
//
// The full-integer pair takes per-token int8 Q (Q*scale quantized, scales
// qsc [B, Hq, Sq], times a TENSOR K scale) and int8 dO twice: dO itself
// (dor, scales dorsc) and dO times the V scales (dov, dovsc).  K and V are
// int8 SYMMETRIC: ROW K scales ks [B, Hkv, Skv] or none (TENSOR, folded into
// qsc and the store multiplier).  L is the logsumexp with -inf read as 0.
//   - dQ: S = Q_int.K_int^T and dP = dOv_int.V_int^T in int32;
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
//   span's row maxima come from a first pass over it (S and dP computed
//   twice) where it is wider than one 64-wide tile, so level 2 is held to
//   the TPU numerics whatever the CUDA tiles.  width = 0 is level 1.
//
// What bounds them on the H100, and the design.
//   At the JAX package's north-star shape (B=4, H=4, S=4096, D=256, FULL)
//   each product is 2*S^2*D*B*H = 1.37e11 operations: the full-integer dQ
//   does two int8 products and one bf16 (level 2: three int8; bound ~0.28
//   ms), its dK/dV two of each (~0.42 ms): operations bound them.  They run
//   on the tensor cores (fullint_dq_tc_kernel, fullint_dkv_tc_kernel; the
//   grids and walks of attention_bwd.cuh's dq_tc_body and dkv_tc_body,
//   cut at MLA's D = 288 as fi_split, fi_dkv_rows and fi_biased say, and
//   at DeepSeek's 576 in the latent bodies' frame: 32-row CTAs of 8 warps,
//   the lanes split over four warp groups, 32-key (32-query) steps, and
//   the dK/dV's GQA group dealt over CTAs and merged in split order, as
//   fi_tile and fullint_dkv_splits say):
//   the int8 rows are copied by cp.async as they are (16-byte rows padded
//   by 16, so ldmatrix's eight row addresses fall in distinct banks), S and
//   dP (S^T, dP^T) run as s8 m16n8k32 mma.sync into int32 (summed from
//   mma.cuh's I32_BIAS: |S| <= 127 * 128 * 256 < 2^22, Q and dO being
//   clamped to +-127), the element-wise steps on the C fragments
//   (ex2.approx with log2(e) folded in), and the output products as bf16
//   m16n8k16 over the integer operand converted to bf16 rows once a tile
//   on the FP32 pipe (level 1: int8 is exact in bf16) or as s8 m16n8k32 over
//   the operand transposed into [d][position] rows, its positions permuted
//   within each 16 as the A operand built from C fragments holds them
//   (level 2; quantized_attention.cu's int8 P.V does the same).  Level 2's
//   dQ sums each span's integer product in int32 and scales it by am/127
//   at the span's end, as the plain version's _quantized_product does; the
//   dK/dV, whose two fp32 accumulators leave no room for two int32 ones at
//   D = 256 (64 of the 128 registers its 16 warps may have), scales each
//   tile's integer product (each k step's where a span ends between
//   them).  Widths that are not whole k steps (32
//   keys or queries: below it, or 8 or 16 times an odd number, which
//   sequences that no power of two from 32 divides get) take the scalar
//   kernels (fullint_dq_kernel, fullint_dkv_kernel: __dp4a and fp32
//   FMAs); the routing is fullint_tc, as
//   ops/flash_attention_bwd.py::fullint_body says.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"
#include "quantized_tiles.cuh"
#include "split_d.cuh"

namespace {

using mfa::BM;
using mfa::BN;
using mfa::BwdArgs;
using mfa::KVOperand;
using mfa::LD;
using mfa::LOG2E;
using mfa::THREADS;
using mfa::accumulate_pm;
using mfa::byte_of;
using mfa::fi_quant;
using mfa::fi_rows_t;
using mfa::fi_store_bf16;
using mfa::fi_store_s8;
using mfa::launch_with_smem;
using mfa::mma_s8_rows;
using mfa::quad_max;
using mfa::row_max16;
using mfa::rowquant;
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
  // The tensor-core bodies' staging (bf16): ROWS payload rows by cp.async
  // into `raw` (D bytes apart), then dequantized and rounded to bf16 rows
  // in dst, as stage_kv rounds.
  template <int NT, int ROW, int ROWS = 64>
  __device__ __forceinline__ void tc_load(bool is_v, size_t head, int t0,
                                          int limit, uint8_t*,
                                          uint8_t* raw) const {
    const KVOperand& op = is_v ? v : k;
    mfa::stage_raw<D, D, NT, ROWS>(op.pay, op.bits, head, Skv, t0, limit,
                                   raw);
  }
  template <int NT, int ROW, int ROWS = 64>
  __device__ __forceinline__ void tc_convert(bool is_v, size_t head, int t0,
                                             int limit, uint8_t* dst,
                                             const uint8_t* raw) const {
    mfa::dequant_rows_bf16<D, D, NT, ROWS>(is_v ? v : k, raw, head, Skv, br,
                                           bs, t0, limit, dst, ROW);
  }
  static constexpr bool RAW = true;  // tc_load fills `raw`, tc_convert dst
  // The latent bodies' staging (bf16, at 576, where no scratch fits): ROWS
  // payload rows read from device memory and dequantized as they load
  // into bf16 rows in dst, as tc_convert makes them.
  template <int NT, int ROW, int ROWS>
  __device__ __forceinline__ void tc_fill(bool is_v, size_t head, int t0,
                                          int limit, uint8_t* dst) const {
    mfa::dequant_fill_bf16<D, NT, ROWS>(is_v ? v : k, head, Skv, br, bs, t0,
                                        limit, dst, ROW);
  }
  // The 32-row scalar bodies' staging (fp32, above 288).
  template <bool ROWS>
  __device__ __forceinline__ void stage32(bool is_v, size_t head, int t0,
                                          int limit, float* dst) const {
    mfa::stage_kv32<D, ROWS>(is_v ? v : k, head, Skv, br, bs, rb, t0, limit,
                             dst);
  }
};

// Replaces _dq_kernel's quantized modes.  Bound: operations (6*D per live
// pair).  The fp32 instances (in 32-row tiles above D = 288:
// mfa::scalar32); bf16 takes qflash_dq_tc_kernel, qflash_dq_wide_kernel or
// qflash_dq_latent_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qflash_dq_kernel(const BwdArgs a, const QuantKV<D> kv) {
  if constexpr (mfa::scalar32<D>()) {
    static_assert(std::is_same<T, float>::value, "fp32 only above 288");
    mfa::dq_body32<D>(a, kv);
  } else {
    mfa::dq_body<T, D, false>(a, kv);
  }
}

// The same on the tensor cores (attention_bwd.cuh::dq_tc_body), bf16: the
// payload rows double-buffered by cp.async, dequantized in shared memory.
template <int D>
__global__ void __launch_bounds__(mfa::dq_tc_threads<D>(),
                           mfa::dq_tc_min_blocks<D>())
qflash_dq_tc_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dq_tc_body<D, false>(a, kv);
}

// The same at D = 288 (attention_bwd.cuh::dq_wide_body: 32-key tiles, 8
// warps, one CTA an SM), bf16.
template <int D>
__global__ void __launch_bounds__(mfa::DQ_WIDE_THREADS, 1)
qflash_dq_wide_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dq_wide_body<D, false>(a, kv);
}

// The same at D = 576 (attention_bwd.cuh::dq_latent_body: 32-key tiles, 8
// warps, one CTA an SM, each tile's K and V payload rows dequantized as
// they load), bf16.
template <int D>
__global__ void __launch_bounds__(mfa::DQ_LATENT_THREADS, 1)
qflash_dq_latent_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dq_latent_body<D, false>(a, kv);
}

// Replaces _dkv_kernel's quantized modes.  Bound: operations (8*D per live
// pair).  The fp32 instances (in 32-key tiles above D = 288:
// mfa::scalar32); bf16 takes qflash_dkv_tc_kernel, qflash_dkv_wide_kernel
// or qflash_dkv_latent_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
qflash_dkv_kernel(const BwdArgs a, const QuantKV<D> kv) {
  if constexpr (mfa::scalar32<D>()) {
    static_assert(std::is_same<T, float>::value, "fp32 only above 288");
    mfa::dkv_body32<D>(a, kv);
  } else {
    mfa::dkv_body<T, D>(a, kv);
  }
}

// The same on the tensor cores (attention_bwd.cuh::dkv_tc_body), bf16.
template <int D>
__global__ void __launch_bounds__(mfa::dkv_tc_threads<D>(),
                           mfa::dkv_tc_min_blocks<D>())
qflash_dkv_tc_kernel(const BwdArgs a, const QuantKV<D> kv) {
  mfa::dkv_tc_body<D>(a, kv);
}

// The same at D = 288 (attention_bwd.cuh::dkv_wide_body: 48-row query
// steps, 12 warps, one CTA an SM), bf16; the GQA group dealt over
// gridDim.z / B = splits CTAs a key tile, each writing its partial dK and
// dV into ws [splits, 2, B, Hkv, Skv, D] where splits > 1.
template <int D>
__global__ void __launch_bounds__(mfa::DKV_WIDE_THREADS, 1)
qflash_dkv_wide_kernel(const BwdArgs a, const QuantKV<D> kv, int splits,
                       float* __restrict__ ws) {
  mfa::dkv_wide_body<D>(a, kv, splits, ws);
}

// The same at D = 576 (attention_bwd.cuh::dkv_latent_body: 32-key CTAs,
// 32-row query steps, 8 warps, one CTA an SM, K and V dequantized once as
// they load), bf16; the GQA group split as qflash_dkv_wide_kernel's.
template <int D>
__global__ void __launch_bounds__(mfa::DKV_LATENT_THREADS, 1)
qflash_dkv_latent_kernel(const BwdArgs a, const QuantKV<D> kv, int splits,
                         float* __restrict__ ws) {
  mfa::dkv_latent_body<D>(a, kv, splits, ws);
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

// The scalar kernels (level-2 widths that are not whole s8 k steps).

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

// Replaces _dq_fullint_kernel at level-2 widths that are not whole s8 k
// steps (the rest take fullint_dq_tc_kernel).  Bound: operations (3 int8 products of
// 2*D per pair).  One CTA per (64 query rows, b, q head) keeps its Q and
// dOv words resident and walks the keys; __dp4a and scalar fp32 FMAs.
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

  for (int c0 = 0; c0 < Skv; c0 += a.width) {
    const int c_end = min(c0 + a.width, Skv);
    float amax[4] = {0.f, 0.f, 0.f, 0.f};
    for (int pass = 0; pass < 2; ++pass) {
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
            ds[i][j] = rowquant(ds[i][j], amax[i], true);
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

// Replaces _dkv_fullint_kernel at level-2 widths that are not whole s8 k
// steps (the rest take fullint_dkv_tc_kernel).  Bound: operations (4 int8 products of
// 2*D per pair).  One CTA per (64 keys, b, kv head) keeps its K and V words
// resident, owns its dK and dV and walks the group's q heads x every query
// row (the path has no mask); __dp4a and scalar fp32 FMAs.
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


  for (int g = 0; g < group; ++g) {
    const int h = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + h;
    const int8_t* qh = a.qq + bh * Sq * D;
    for (int q0 = 0; q0 < Sq; q0 += a.width) {
      const int q_end = min(q0 + a.width, Sq);
      float am_p[4] = {0.f, 0.f, 0.f, 0.f};
      float am_s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pass = 0; pass < 2; ++pass) {
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
              pd[i][j] = rowquant(pd[i][j], am_p[i], false);
              dsv[i][j] = rowquant(dsv[i][j], am_s[i], true);
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

// The scalar pair at DeepSeek's D = 576 (scalar32), in the 32-row layout of
// attention_tiles.cuh: 256 threads as 8 x 32, thread (ty, tx) rows (keys)
// 4 ty + [0, 4) of a tile, score column tx and output lanes tx + 32 e, so
// a thread holds 72 fp32 dQ lanes (144 dK and dV lanes) where the 64-row
// layout would hold 144 (288).  Word tiles are transposed ([D/4][32 + 4]:
// a thread's four rows one int4 a step of d); the operand of the output
// product is fp32 rows [32][D + 1].  The order of operations is the 64-row
// kernels'.

// int8 rows [r0, r0 + 32) (zeros from `limit`), rows D bytes apart, as
// transposed words dst[w * LD32 + r] (consecutive threads on consecutive
// rows, so the stores fill 32 banks).
template <int D>
__device__ __forceinline__ void stage_words32(const int8_t* base, int r0,
                                              int limit, int* dst) {
  constexpr int W = D / 4;
  for (int i = threadIdx.x; i < mfa::T32 * W; i += THREADS) {
    const int r = i % mfa::T32;
    const int w = i / mfa::T32;
    dst[w * mfa::LD32 + r] =
        r0 + r < limit ? *reinterpret_cast<const int*>(
                             base + (size_t)(r0 + r) * D + 4 * w)
                       : 0;
  }
}

// int8 rows [r0, r0 + 32) (zeros from `limit`) as fp32 rows dst[r * (D + 1)
// + d].
template <int D>
__device__ __forceinline__ void stage_i8_rows32(const int8_t* base, int r0,
                                                int limit, float* dst) {
  constexpr int W = D / 4;
  for (int i = threadIdx.x; i < mfa::T32 * W; i += THREADS) {
    const int r = i / W;
    const int w = i % W;
    const int word =
        r0 + r < limit
            ? *reinterpret_cast<const int*>(base + (size_t)(r0 + r) * D + 4 * w)
            : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[r * mfa::ld_rows32<D>() + 4 * w + e] = byte_of(word, e);
  }
}

// acc[i] = sum_w dp4a(a[w][4 ay + i], b[w][bx]) over transposed word tiles.
template <int D>
__device__ __forceinline__ void tile_product_i8_32(const int* a, int ay,
                                                   const int* b, int bx,
                                                   int (&acc)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0;
#pragma unroll 4
  for (int w = 0; w < D / 4; ++w) {
    const int4 x = *reinterpret_cast<const int4*>(a + w * mfa::LD32 + ay * 4);
    const int y = b[w * mfa::LD32 + bx];
    acc[0] = __dp4a(x.x, y, acc[0]);
    acc[1] = __dp4a(x.y, y, acc[1]);
    acc[2] = __dp4a(x.z, y, acc[2]);
    acc[3] = __dp4a(x.w, y, acc[3]);
  }
}

// Max over the 32 lanes of a warp (the columns of one ty's rows).
__device__ __forceinline__ float row_max32(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int D>
constexpr size_t fullint_dq_smem32() {
  // Q, dOv and K|V words; K rows fp32; dS'^T
  return (3 * (size_t)(D / 4) * mfa::LD32 +
          (size_t)mfa::T32 * mfa::ld_rows32<D>() +
          (size_t)mfa::T32 * mfa::LD32) *
         4;
}

template <int D>
constexpr size_t fullint_dkv_smem32() {
  // K, V, Q and dOv words; dO then Q rows fp32; P' then dS' (q-major)
  return (4 * (size_t)(D / 4) * mfa::LD32 +
          (size_t)mfa::T32 * mfa::ld_rows32<D>() +
          (size_t)mfa::T32 * mfa::LD32) *
         4;
}

// fullint_dq_kernel's function at D = 576 (it replaces _dq_fullint_kernel
// there at level-2 widths that are not whole s8 k steps; bound: operations,
// 3 int8 products of 2*D per pair): one CTA per (32 query rows, b, q head)
// keeps its Q and dOv words resident and walks the keys in 32-key tiles,
// each span of `width` twice (its rows' |dS| maxima, then dQ += dS'.K).
template <int D>
__global__ void __launch_bounds__(THREADS)
fullint_dq32_kernel(const FullintArgs a) {
  constexpr int DE = D / mfa::T32;
  constexpr int W4 = D / 4;
  constexpr int T = mfa::T32;
  extern __shared__ __align__(16) float smem[];
  int* qw = reinterpret_cast<int*>(smem);  // [D/4][LD32] Q words
  int* dow = qw + W4 * mfa::LD32;          // [D/4][LD32] dOv words
  int* kvw = dow + W4 * mfa::LD32;         // [D/4][LD32] V, then K words
  float* kf = reinterpret_cast<float*>(kvw + W4 * mfa::LD32);  // K rows
  float* dst = kf + T * mfa::ld_rows32<D>();  // [32][LD32] dS'^T

  const int Sq = a.Sq, Skv = a.Skv;
  const int r0 = blockIdx.x * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int hk = a.interleaved ? h % a.Hkv : h / group;
  const int tx = threadIdx.x % T;  // key column tx
  const int ty = threadIdx.x / T;  // query rows 4 ty + i
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const int8_t* kh = a.kq + bk * Skv * D;
  const int8_t* vh = a.vq + bk * Skv * D;
  const float* ks = a.ks ? a.ks + bk * Skv : nullptr;

  stage_words32<D>(a.qq + bh * Sq * D, r0, Sq, qw);
  stage_words32<D>(a.dov + bh * Sq * D, r0, Sq, dow);

  float qs[4], lrow[4], drow[4], dvs[4], acc[4][DE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    const bool live = r < Sq;
    qs[i] = live ? a.qsc[bh * Sq + r] : 0.f;
    lrow[i] = live ? a.lse[bh * Sq + r] : 0.f;
    drow[i] = live ? a.di[bh * Sq + r] : 0.f;
    dvs[i] = live ? a.dovsc[bh * Sq + r] : 0.f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[i][e] = 0.f;
  }

  for (int c0 = 0; c0 < Skv; c0 += a.width) {
    const int c_end = min(c0 + a.width, Skv);
    float amax[4] = {0.f, 0.f, 0.f, 0.f};
    for (int pass = 0; pass < 2; ++pass) {
      for (int t0 = c0; t0 < c_end; t0 += T) {
        __syncthreads();  // the previous tile's readers are done
        stage_words32<D>(vh, t0, c_end, kvw);
        __syncthreads();
        int dpi[4];
        tile_product_i8_32<D>(dow, ty, kvw, tx, dpi);
        __syncthreads();  // every thread is done with the V words
        stage_words32<D>(kh, t0, c_end, kvw);
        if (pass == 1) stage_i8_rows32<D>(kh, t0, c_end, kf);
        __syncthreads();
        int si[4];
        tile_product_i8_32<D>(qw, ty, kvw, tx, si);
        const int col = t0 + tx;
        const bool in = col < c_end;
        const float k_s = (ks && in) ? ks[col] : 1.f;
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sv = (float)si[i] * qs[i];
          if (ks) sv *= k_s;
          const float p = in ? expf(sv - lrow[i]) : 0.f;
          float d = p * ((float)dpi[i] * dvs[i] - drow[i]);
          if (ks) d *= k_s;
          ds[i] = d;
        }
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            amax[i] = fmaxf(amax[i], row_max32(fabsf(ds[i])));
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = rowquant(ds[i], amax[i], true);
        *reinterpret_cast<float4*>(dst + tx * mfa::LD32 + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
        __syncthreads();  // dS'^T and K's rows staged
        mfa::accumulate_pm32<D>(dst, ty, kf, tx, acc);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    float* out = a.out0 + (bh * Sq + r) * D + tx;
#pragma unroll
    for (int e = 0; e < DE; ++e) out[32 * e] = acc[i][e] * a.store;
  }
}

// fullint_dkv_kernel's function at D = 576 (it replaces _dkv_fullint_kernel
// there at those widths; bound: operations, 4 int8 products of 2*D per
// pair): one CTA per (32 keys, b, kv head, split)
// keeps its K and V words resident, owns its dK and dV and walks its run
// of the group's q heads (fullint_dkv_tc_kernel's splits, partials into
// ws) x every query row in 32-row steps.
template <int D>
__global__ void __launch_bounds__(THREADS)
fullint_dkv32_kernel(const FullintArgs a, int splits, float* ws) {
  constexpr int DE = D / mfa::T32;
  constexpr int W4 = D / 4;
  constexpr int T = mfa::T32;
  extern __shared__ __align__(16) float smem[];
  int* kw = reinterpret_cast<int*>(smem);  // [D/4][LD32] K words
  int* vw = kw + W4 * mfa::LD32;           // [D/4][LD32] V words
  int* qw = vw + W4 * mfa::LD32;           // [D/4][LD32] Q words
  int* dvw = qw + W4 * mfa::LD32;          // [D/4][LD32] dOv words
  float* mf = reinterpret_cast<float*>(dvw + W4 * mfa::LD32);  // dO|Q rows
  float* ps = mf + T * mfa::ld_rows32<D>();  // [32][LD32] P', dS' (q-major)

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * T;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int group = a.Hq / a.Hkv;
  const int tx = threadIdx.x % T;  // query column tx
  const int ty = threadIdx.x / T;  // key rows 4 ty + i
  const size_t bkv = (size_t)b * a.Hkv + hk;
  const int per_split = (group + splits - 1) / splits;
  const int g_lo = split * per_split;
  const int g_hi = min(group, g_lo + per_split);

  stage_words32<D>(a.kq + bkv * Skv * D, c0, Skv, kw);
  stage_words32<D>(a.vq + bkv * Skv * D, c0, Skv, vw);
  float ksr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty * 4 + i;
    ksr[i] = (a.ks && key < Skv) ? a.ks[bkv * Skv + key] : 1.f;
  }

  float dk_acc[4][DE], dv_acc[4][DE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DE; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int g = g_lo; g < g_hi; ++g) {
    const int h = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + h;
    const int8_t* qh = a.qq + bh * Sq * D;
    for (int q0 = 0; q0 < Sq; q0 += a.width) {
      const int q_end = min(q0 + a.width, Sq);
      float am_p[4] = {0.f, 0.f, 0.f, 0.f};
      float am_s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pass = 0; pass < 2; ++pass) {
        for (int r0 = q0; r0 < q_end; r0 += T) {
          __syncthreads();  // the previous tile's readers are done
          stage_words32<D>(qh, r0, q_end, qw);
          stage_words32<D>(a.dov + bh * Sq * D, r0, q_end, dvw);
          if (pass == 1) stage_i8_rows32<D>(a.dor + bh * Sq * D, r0, q_end, mf);
          const int r = r0 + tx;
          const bool in = r < q_end;
          const size_t o = bh * Sq + (in ? r : 0);
          const float qs = a.qsc[o], lcol = a.lse[o], dcol = a.di[o];
          const float dors = a.dorsc[o], dovs = a.dovsc[o];
          __syncthreads();
          float pd[4], dsv[4];  // [key i] of query tx
          {
            int sti[4], dpti[4];
            tile_product_i8_32<D>(kw, ty, qw, tx, sti);
            tile_product_i8_32<D>(vw, ty, dvw, tx, dpti);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float st = (float)sti[i] * qs;
              if (a.ks) st *= ksr[i];
              const float pt = in ? expf(st - lcol) : 0.f;  // P^T
              dsv[i] = pt * ((float)dpti[i] * dovs - dcol) * qs;
              pd[i] = pt * dors;
            }
          }
          if (pass == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              am_p[i] = fmaxf(am_p[i], row_max32(pd[i]));
              am_s[i] = fmaxf(am_s[i], row_max32(fabsf(dsv[i])));
            }
            continue;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pd[i] = rowquant(pd[i], am_p[i], false);
            dsv[i] = rowquant(dsv[i], am_s[i], true);
          }
          // P', q-major: ps[q * LD32 + key], the layout accumulate_pm32
          // reads.
          *reinterpret_cast<float4*>(ps + tx * mfa::LD32 + ty * 4) =
              make_float4(pd[0], pd[1], pd[2], pd[3]);
          __syncthreads();
          mfa::accumulate_pm32<D>(ps, ty, mf, tx, dv_acc);  // dV += P'.dO
          __syncthreads();
          stage_i8_rows32<D>(qh, r0, q_end, mf);
          *reinterpret_cast<float4*>(ps + tx * mfa::LD32 + ty * 4) =
              make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
          __syncthreads();
          mfa::accumulate_pm32<D>(ps, ty, mf, tx, dk_acc);  // dK += dS'.Q
        }
      }
    }
  }

  const size_t n = (size_t)gridDim.z / splits * a.Hkv * Skv * D;
  float* out_k = splits > 1 ? ws + (2 * (size_t)split) * n : a.out0;
  float* out_v = splits > 1 ? ws + (2 * (size_t)split + 1) * n : a.out1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty * 4 + i;
    if (key >= Skv) continue;
    float* dkr = out_k + (bkv * Skv + key) * D + tx;
    float* dvr = out_v + (bkv * Skv + key) * D + tx;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      dkr[32 * e] = dk_acc[i][e] * a.store;
      dvr[32 * e] = dv_acc[i][e];
    }
  }
}

// ---------------------------------------------------------------------------
// The full-integer pair on the tensor cores (level 1; level-2 widths of
// whole s8 k steps)
//
// fullint_dq_tc_kernel: one CTA per (64 query rows, b, q head; 32 at
// D = 576: fi_tile), 4 * NS warps of 16 rows (2 * NS at 576; NS =
// fi_split: the warp groups split S's and dP's key columns and dQ's lanes,
// as in dq_tc_body); Q and dOv resident as int8 rows, each key tile's K
// and V rows (and ROW K scales) double-buffered by cp.async.
// fullint_dkv_tc_kernel: one CTA per (64 keys, b, kv head; 32 at 576, and
// a split of the GQA group there), 4 * NS warps of 16 keys (2 * NS at 576;
// the groups split S^T's and dP^T's query columns and dK's and dV's lanes,
// as in dkv_tc_body); K and V resident, each step's Q, dOv and dO rows and
// their per-row vectors double-buffered, walking its q heads x every query
// tile (the path has no mask).  With NS = 1
// (level 1 up to D = 64) a warp's C fragments of dS (P^T, dS^T) are the
// output product's A operand as they are; with NS > 1 they pass through
// shared memory.
// ---------------------------------------------------------------------------

// The level-2 widths the tensor-core kernels take: whole s8 k steps (32
// keys or queries), the spans whose integer products they sum under one
// scale.  A sequence that no power of two from 32 divides gets a narrower
// width from the TPU's tiling (_tile_width), or one of 8 or 16 times an odd
// number (48 at 336): those take the scalar kernels.
constexpr int FI_K_STEP = 32;

__host__ __device__ constexpr bool fullint_tc(int width) {
  return width % FI_K_STEP == 0;
}

// Warp groups: dkv_tc_split's at level 1 (1, 1, 2, 4 at D = 32, 64, 128,
// 256); at level 2, where the dQ's int32 span sums double its accumulators,
// 2 up to D = 128 and 4 at D = 256, so the quantized dS (P', dS') always
// pass through shared memory.  At MLA's D = 288 two at both levels: a
// warp's lanes (D / NS) must be whole 16-lane steps and its key or query
// columns (64 / NS) whole 8-column blocks, and of the splits that give
// both (1 and 2; 4 would leave 72 lanes) 2 keeps S's and dP's fragments
// (and, at level 2, dQ's int32 sums beside its fp32 ones) within 255
// registers a thread.  Its lane accumulators are 144 fp32 a thread in the
// dK/dV (dK and dV, 144 lanes each), where D = 256 keeps 64.
// At DeepSeek's D = 576 four at both levels over 32-row tiles (fi_tile):
// 144 lanes a warp, 72 fp32 accumulators in the dQ (and 72 int32 span
// sums at level 2), 144 in the dK/dV, and one 8-column block of S and dP
// (S^T, dP^T) a warp.
template <int D, bool L2>
__host__ __device__ constexpr int fi_split() {
  return D > 288   ? 4
         : D > 256 ? 2
         : L2      ? (D <= 128 ? 2 : 4)
                   : mfa::dkv_tc_split<D>();
}

// A CTA's query rows (dQ) or keys (dK/dV), and the keys a dQ step stages:
// 64, or 32 at D = 576, where 64 int8 rows of Q, dOv and two buffers of K
// and V alone take 227 KB: a CTA holds two warps of 16 rows (keys) in each
// of its fi_split warp groups.
template <int D>
__host__ __device__ constexpr int fi_tile() {
  return D > 288 ? 32 : 64;
}

template <int D, bool L2>
__host__ __device__ constexpr int fi_threads() {
  return 32 * (fi_tile<D>() / 16) * fi_split<D, L2>();
}

// Query rows a dK/dV step stages: 64, or 32 at level 1 at D = 288, where
// two buffers each of 64 Q, dOv and dO rows beside K, V and the bf16
// operand tiles would take 252 KB of the 227 a CTA may have, and 32 at
// D = 576 (fi_tile).
template <int D, bool L2>
__host__ __device__ constexpr int fi_dkv_rows() {
  return D > 288 || (D > 256 && !L2) ? 32 : 64;
}

// Whether S's and dP's int32 sums start from I32_BIAS (read back with
// biased_f32, on the FP32 pipe): |S| <= 127 * 128 * D < 2^22 needs D <=
// 256; at 288 they start from 0 and convert with I2F.
template <int D>
__host__ __device__ constexpr bool fi_biased() {
  return D <= 256;
}

template <bool BIASED>
__device__ __forceinline__ float fi_sum_f32(int x) {
  return BIASED ? mfa::biased_f32(x) : (float)x;
}

// CTAs an SM a kernel is compiled for (its __launch_bounds__): three 4-warp
// CTAs at level 1 up to D = 64 (<= 170 registers a thread), two for the
// level-1 dQ at D = 128 and the level-2 dQ up to D = 64, else one.
template <int D, bool L2, bool DQ>
__host__ __device__ constexpr int fi_min_blocks() {
  return L2 ? (DQ && D <= 64 ? 2 : 1)
            : (D <= 64 ? 3 : (DQ && D == 128 ? 2 : 1));
}

// Row sizes (bytes) of the shared tiles.
template <int D>
struct FiRows {
  static constexpr int RI = D + 16;      // an int8 row [.., D]
  static constexpr int RB = 2 * D + 16;  // a bf16 row [.., D]
};

// Byte offsets of fullint_dq_tc_kernel's shared memory (147,968 bytes at
// D = 256, level 1; 164,352 at D = 288, 146,432 at level 2; 153,856 at
// D = 576, 144,128 at level 2): ROWS query rows, KT keys a step.
template <int D, bool L2>
struct FiDqSmem : FiRows<D> {
  using R = FiRows<D>;
  static constexpr int NS = fi_split<D, L2>();
  static constexpr int ROWS = fi_tile<D>();
  static constexpr int KT = fi_tile<D>();
  static constexpr int TQ = ROWS * R::RI;  // ROWS int8 rows
  static constexpr int TI = KT * R::RI;    // KT int8 rows
  static constexpr int PT = KT + 16;       // an int8 row of KT positions
  static constexpr int PB = 2 * KT + 16;   // a bf16 row of KT
  static constexpr int Q = 0;
  static constexpr int DOV = TQ;
  static constexpr int K = 2 * TQ;      // two buffers
  static constexpr int V = K + 2 * TI;  // two buffers
  // K as the dQ product's operand: bf16 rows [key][d] (level 1) or int8
  // [d][key position] (level 2).
  static constexpr int KOP = V + 2 * TI;
  static constexpr int KS = KOP + (L2 ? D * PT : KT * R::RB);  // x2
  static constexpr int AM = KS + 2 * KT * 4;  // [NS][ROWS][2 spans]
  static constexpr int DS = AM + (L2 ? NS * ROWS * 2 * 4 : 0);
  static constexpr size_t BYTES = DS + (NS > 1 ? ROWS * (L2 ? PT : PB) : 0);
};

// Byte offsets of fullint_dkv_tc_kernel's shared memory (227,840 bytes at
// D = 256, level 1, of the 232,448 a CTA may have; 146,688 at D = 288 in
// 32-row query steps, 216,576 at level 2; 213,760 at D = 576, 213,248 at
// level 2): KEYS keys, QT query rows a step.  DOR1 (level 1 at 576): one
// buffer of dO rows, which the kernel fills for the next step once this
// step's are converted (two would pass the 227 KB by 256 bytes).
template <int D, bool L2>
struct FiDkvSmem : FiRows<D> {
  using R = FiRows<D>;
  static constexpr int NS = fi_split<D, L2>();
  static constexpr int KEYS = fi_tile<D>();
  static constexpr int QT = fi_dkv_rows<D, L2>();  // query rows a step
  static constexpr bool DOR1 = !L2 && D > 288;
  static constexpr int TK = KEYS * R::RI;  // KEYS int8 rows
  static constexpr int TQ = QT * R::RI;    // QT int8 rows
  static constexpr int PT = QT + 16;       // an int8 row of QT positions
  static constexpr int PQ = 2 * QT + 16;   // a bf16 row of QT positions
  static constexpr int K = 0;
  static constexpr int V = TK;
  static constexpr int Q = 2 * TK;          // two buffers
  static constexpr int DOV = Q + 2 * TQ;    // two buffers
  static constexpr int DOR = DOV + 2 * TQ;  // two buffers (one: DOR1)
  // qsc, L, D, dorsc, dovsc of the step's QT queries, two buffers.
  static constexpr int ST = DOR + (DOR1 ? 1 : 2) * TQ;
  // Q and dO as the dK / dV products' operands: bf16 rows [query][d]
  // (level 1) or int8 [d][query position] (level 2).
  static constexpr int OP_BYTES = L2 ? D * PT : QT * R::RB;
  static constexpr int OP = ST + 2 * 5 * QT * 4;
  static constexpr int AM = OP + 2 * OP_BYTES;  // [NS][KEYS][2][P, dS]
  static constexpr int PS = AM + (L2 ? NS * KEYS * 4 * 4 : 0);
  static constexpr size_t BYTES =
      PS + (NS > 1 ? 2 * KEYS * (L2 ? PT : PQ) : 0);
};

// cp.async of int8 rows [t0, t0 + ROWS) of matrix `head` of a [.., n, D]
// tensor into dst (D + 16 bytes apart; quantized_tiles.cuh's stage_raw),
// NT threads; rows from n are zeros.
template <int D, int NT, int ROWS = 64>
__device__ __forceinline__ void fi_stage_rows(const int8_t* x, size_t head,
                                              int n, int t0, uint8_t* dst) {
  mfa::stage_raw<D, D + 16, NT, ROWS>(reinterpret_cast<const uint8_t*>(x), 8,
                                      head, n, t0, n, dst);
}

// ROWS int8 rows (D + 16 bytes apart) as bf16 rows (2 D + 16 bytes apart),
// 16 values an item, on the FP32 pipe (mma.cuh::s8_f32; exact).
template <int D, int NT, int ROWS = 64>
__device__ __forceinline__ void fi_rows_bf16(const uint8_t* src,
                                             uint8_t* dst) {
  constexpr int CPR = D / 16;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR;
    const int c = i % CPR;
    const uint4 u =
        *reinterpret_cast<const uint4*>(src + r * (D + 16) + 16 * c);
    const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                           u.z ^ 0x80808080u, u.w ^ 0x80808080u};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * e] = mfa::pack_bf16_exact(mfa::s8_f32<0>(w[e]),
                                      mfa::s8_f32<1>(w[e]));
      o[2 * e + 1] = mfa::pack_bf16_exact(mfa::s8_f32<2>(w[e]),
                                          mfa::s8_f32<3>(w[e]));
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * (2 * D + 16) + 32 * c);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// acc[j] = A[ar0, ar0 + 16) . B[br0 + 8j, br0 + 8j + 8)^T over 32 * KC
// bytes of k, A and B int8 tiles whose rows hold k, summed from I32_BIAS
// (mma.cuh: read back with biased_f32) where BIASED, else from 0
// (fi_sum_f32 reads either).
template <int KC, int NB, int LDA, int LDB, bool BIASED = true>
__device__ __forceinline__ void mma_s8_nt(const uint8_t* A, int ar0,
                                          const uint8_t* B, int br0,
                                          int (&acc)[NB][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = BIASED ? mfa::I32_BIAS : 0;
  const uint8_t* ap =
      A + (ar0 + mfa::ldsm_a_row(lane)) * LDA + mfa::ldsm_a_byte(lane);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t af[4];
    mfa::ldsm_x4(af, ap + kc * 32);
    mma_s8_rows<NB, LDB>(af, B, br0, kc * 32, acc);
  }
}

// acc += iacc * sc (sc per row: [e >> 1]), iacc back to 0: a span's integer
// product scaled back.
template <int NB>
__device__ __forceinline__ void fi_flush(float (&acc)[NB][4],
                                         int (&iacc)[NB][4],
                                         const float (&sc)[2]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += (float)iacc[j][e] * sc[e >> 1];
      iacc[j][e] = 0;
    }
}

// v[sp] for a run-time sp, and v[sp] = max(v[sp], m), without indexing the
// registers at run time.
__device__ __forceinline__ float pick(const float (&v)[2], bool sp) {
  return sp ? v[1] : v[0];
}
__device__ __forceinline__ void max_at(float (&v)[2], bool sp, float m) {
  v[0] = sp ? v[0] : fmaxf(v[0], m);
  v[1] = sp ? fmaxf(v[1], m) : v[1];
}

// The order in which a kernel visits the T-wide tiles (64, or 32: the
// dK/dV at level 1 at D = 288, both kernels at 576) of the sequence it
// walks (keys for dQ, a q head's queries for dK/dV), n long: level 1
// (width 0) one pass over every tile; level 2 spans of `width` (a multiple
// of 32), grouped in chunks of whole tiles: the span (a multiple of 64) or
// two (32, 96, ...).  A chunk of several tiles takes two passes (its spans'
// row maxima, then the products), a chunk of one tile one.  Span sp of a
// chunk holds its positions [sp * width, (sp + 1) * width).
struct FiWalk {
  int T, tiles, passes, chunks;
  __device__ FiWalk(int width, int n, int t = BN) : T(t) {
    const int chunk = width == 0 ? max((n + T - 1) / T * T, T)
                                 : (width % BN ? 2 * width : width);
    tiles = chunk / T;
    passes = tiles > 1 && width ? 2 : 1;
    chunks = (n + chunk - 1) / chunk;
  }
  __device__ int steps() const { return chunks * passes * tiles; }
  __device__ int t0(int it) const {
    return (it / (passes * tiles) * tiles + it % tiles) * T;
  }
  __device__ int pass(int it) const { return it / tiles % passes; }
  __device__ int tile(int it) const { return it % tiles; }
};

// Replaces _dq_fullint_kernel.  Bound: operations (2 int8 and 1 bf16
// product of 2*D per pair; level 2: 3 int8).
template <int D, bool L2>
__global__ void __launch_bounds__(fi_threads<D, L2>(),
                                  fi_min_blocks<D, L2, true>())
fullint_dq_tc_kernel(const FullintArgs a) {
  using L = FiDqSmem<D, L2>;
  constexpr int NS = L::NS;
  constexpr int ROWS = L::ROWS;  // query rows a CTA
  constexpr int KT = L::KT;      // keys a step
  constexpr int RWS = ROWS / 16;  // warps of 16 rows a group
  constexpr int NT = fi_threads<D, L2>();
  constexpr int KW = KT / NS;  // key columns of a warp's S, dP
  constexpr int NKB = KW / 8;
  constexpr int DW = D / NS;  // dQ lanes a warp accumulates
  constexpr int NDB = DW / 8;
  constexpr bool BIASED = fi_biased<D>();
  static_assert(!L2 || NS > 1, "level 2 stages dS in shared memory");
  extern __shared__ __align__(16) uint8_t sm[];

  const int Sq = a.Sq, Skv = a.Skv;
  const int r0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % RWS;     // query rows r0 + 16 rw + [0, 16)
  const int part = warp / RWS;  // key columns kc0 + [0, KW), dQ lanes
  const int kc0 = part * KW;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* ks = a.ks ? a.ks + bk * Skv : nullptr;

  fi_stage_rows<D, NT, ROWS>(a.qq, bh, Sq, r0, sm + L::Q);
  fi_stage_rows<D, NT, ROWS>(a.dov, bh, Sq, r0, sm + L::DOV);
  mfa::cp_async_commit();
  const FiWalk wk(L2 ? a.width : 0, Skv, KT);
  const int steps = wk.steps();
  // Step it's K and V rows (and ROW K scales) into buffer buf.
  auto load = [&](int it, int buf) {
    const int t0 = wk.t0(it);
    fi_stage_rows<D, NT, KT>(a.kq, bk, Skv, t0, sm + L::K + buf * L::TI);
    fi_stage_rows<D, NT, KT>(a.vq, bk, Skv, t0, sm + L::V + buf * L::TI);
    if (ks && threadIdx.x < KT) {
      const int i = threadIdx.x;
      const bool ok = t0 + i < Skv;
      mfa::cp_async4(reinterpret_cast<float*>(sm + L::KS) + buf * KT + i,
                     ks + (ok ? t0 + i : 0), ok ? 4 : 0);
    }
  };
  if (steps > 0) load(0, 0);
  mfa::cp_async_commit();

  // This thread's rows: r0 + 16 rw + g + 8i.
  float qs[2], l2[2], dd[2], dvs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * rw + g + 8 * i;
    const bool live = row < Sq;
    qs[i] = live ? a.qsc[bh * Sq + row] : 0.f;
    l2[i] = live ? a.lse[bh * Sq + row] * LOG2E : 0.f;
    dd[i] = live ? a.di[bh * Sq + row] : 0.f;
    dvs[i] = live ? a.dovsc[bh * Sq + row] : 0.f;
  }
  float acc[NDB][4];
  int iacc[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.f;
      iacc[j][e] = 0;
    }
  // Level 2, per row and span of the chunk: the running |dS| max of this
  // thread's values, then the rows' 127 / am and am / 127.
  float run[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float inv[2][2], sc[2][2];

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    mfa::cp_async_wait<0>();
    __syncthreads();  // step it staged; step it - 1 done
    if (it + 1 < steps) load(it + 1, buf ^ 1);
    mfa::cp_async_commit();
    const int t0 = wk.t0(it);
    const int pass = wk.pass(it);
    const int tile = wk.tile(it);
    const bool last = pass == wk.passes - 1;
    const uint8_t* sk = sm + L::K + buf * L::TI;
    const uint8_t* sv = sm + L::V + buf * L::TI;
    if (last) {
      if constexpr (L2)
        fi_rows_t<D, NT, KT>(sk, sm + L::KOP);
      else
        fi_rows_bf16<D, NT, KT>(sk, sm + L::KOP);
    }

    // S and dP for rows 16 rw + [0, 16), keys kc0 + [0, KW): element (row
    // g + 8i, key kc0 + 8j + 2tq + c) at [j][2i + c].
    float ds[NKB][4];
    {
      int si[NKB][4], dpi[NKB][4];
      mma_s8_nt<D / 32, NKB, L::RI, L::RI, BIASED>(sm + L::Q, 16 * rw, sk,
                                                   kc0, si);
      mma_s8_nt<D / 32, NKB, L::RI, L::RI, BIASED>(sm + L::DOV, 16 * rw, sv,
                                                   kc0, dpi);
      const float* kst = reinterpret_cast<const float*>(sm + L::KS) +
                         buf * KT;
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int kc = kc0 + 8 * j + 2 * tq + (e & 1);
          const float ksv = ks ? kst[kc] : 1.f;
          const float s = fi_sum_f32<BIASED>(si[j][e]) * qs[i] * ksv;
          const float p = t0 + kc < Skv
                              ? mfa::ex2_approx(fmaf(s, LOG2E, -l2[i]))
                              : 0.f;
          ds[j][e] =
              p * (fi_sum_f32<BIASED>(dpi[j][e]) * dvs[i] - dd[i]) * ksv;
        }
    }

    uint8_t* sds = sm + L::DS;
    if constexpr (!L2) {
      // dQ += round_bf16(dS).K, 16 keys a k step.
      if constexpr (NS > 1) fi_store_bf16<NKB, L::PB>(ds, 16 * rw, kc0, sds);
      __syncthreads();  // K's bf16 rows (and the CTA's dS tile)
      const int a_off =
          (16 * rw + mfa::ldsm_a_row(lane)) * L::PB + mfa::ldsm_a_byte(lane);
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc) {
        uint32_t af[4];
        if constexpr (NS == 1)
          mfa::c_to_a_bf16(ds, kc, af);
        else
          mfa::ldsm_x4(af, sds + a_off + kc * 32);
        mfa::mma_rn<NDB, L::RB>(af, sm + L::KOP, 16 * kc, part * DW, acc);
      }
    } else {
      if (pass == 0) {
        if (tile == 0) run[0][0] = run[0][1] = run[1][0] = run[1][1] = 0.f;
#pragma unroll
        for (int j = 0; j < NKB; ++j) {
          const bool sp = tile * KT + kc0 + 8 * j >= a.width;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            max_at(run[i], sp,
                   fmaxf(fabsf(ds[j][2 * i]), fabsf(ds[j][2 * i + 1])));
        }
      }
      if (!last) continue;
      if (tile == 0) {  // the chunk's row maxima are complete
        float* amx = reinterpret_cast<float*>(sm + L::AM);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int sp = 0; sp < 2; ++sp) {
            const float m = quad_max(run[i][sp]);
            if (tq == 0)
              amx[(part * ROWS + 16 * rw + g + 8 * i) * 2 + sp] = m;
          }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int sp = 0; sp < 2; ++sp) {
            float am = 0.f;
#pragma unroll
            for (int p = 0; p < NS; ++p)
              am = fmaxf(am,
                         amx[(p * ROWS + 16 * rw + g + 8 * i) * 2 + sp]);
            inv[i][sp] = 127.f / fmaxf(am, 1e-30f);
            sc[i][sp] = am * (1.f / 127.f);
          }
      }
#pragma unroll
      for (int j = 0; j < NKB; ++j) {
        const bool sp = tile * KT + kc0 + 8 * j >= a.width;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = fi_quant(ds[j][e], pick(inv[e >> 1], sp));
      }
      // dQ += dS_int.K_int, 32 keys a k step (K^T in permuted positions).
      constexpr int KK = KT / 32;  // k steps a tile
      fi_store_s8<NKB, L::PT>(ds, 16 * rw, kc0, sds);
      __syncthreads();  // K^T and the CTA's dS tile
      uint32_t af[KK][4];
      const uint8_t* ap = sds + (16 * rw + mfa::ldsm_a_row(lane)) * L::PT +
                          mfa::ldsm_a_byte(lane);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) mfa::ldsm_x4(af[kk], ap + 32 * kk);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        mma_s8_rows<NDB, L::PT>(af[kk], sm + L::KOP, part * DW, 32 * kk,
                                iacc);
        const int pos = (KK * tile + kk) * 32;  // the k step's, in the chunk
        if ((pos + 32) % a.width == 0) {  // its span ends here
          const bool sp = pos >= a.width;
          fi_flush(acc, iacc, {pick(sc[0], sp), pick(sc[1], sp)});
        }
      }
    }
  }
  mfa::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 16 * rw + g + 8 * i;
    if (row >= Sq) continue;
    float* out = a.out0 + (bh * Sq + row) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * i] * a.store, acc[j][2 * i + 1] * a.store);
  }
}

// Replaces _dkv_fullint_kernel.  Bound: operations (2 int8 and 2 bf16
// products of 2*D per pair; level 2: 4 int8).  splits > 1 (at D = 576,
// ops/flash_attention_bwd.py::fullint_dkv_splits): the GQA group dealt
// over that many CTAs a key tile (runs of whole q heads), each writing its
// partial dK (times `store`) and dV into ws [splits, 2, B, Hkv, Skv, D],
// which flash_attention.cu's flash_dkv_merge_kernel sums in split order.
template <int D, bool L2>
__global__ void __launch_bounds__(fi_threads<D, L2>(),
                                  fi_min_blocks<D, L2, false>())
fullint_dkv_tc_kernel(const FullintArgs a, int splits, float* ws) {
  using L = FiDkvSmem<D, L2>;
  constexpr int NS = L::NS;
  constexpr int KEYS = L::KEYS;   // keys a CTA
  constexpr int KWS = KEYS / 16;  // warps of 16 keys a group
  constexpr int NT = fi_threads<D, L2>();
  constexpr int QT = L::QT;    // query rows a step
  constexpr int QW = QT / NS;  // query columns of a warp's S^T, dP^T
  constexpr int NQB = QW / 8;
  constexpr int DW = D / NS;  // dK / dV lanes a warp accumulates
  constexpr int NDB = DW / 8;
  constexpr bool BIASED = fi_biased<D>();
  static_assert(!L2 || NS > 1, "level 2 stages P' and dS' in shared memory");
  extern __shared__ __align__(16) uint8_t sm[];

  const int Sq = a.Sq, Skv = a.Skv;
  const int c0 = blockIdx.x * KEYS;
  const int hk = blockIdx.y;
  // The GQA group split exists at D = 576 only (fullint_dkv_splits): the
  // narrower instances keep their single-CTA walk.
  const int nsplit = D > 288 ? splits : 1;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int group = a.Hq / a.Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kw = warp % KWS;     // keys c0 + 16 kw + [0, 16)
  const int part = warp / KWS;  // query columns qc0 + [0, QW), dK/dV lanes
  const int qc0 = part * QW;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bkv = (size_t)b * a.Hkv + hk;
  // This CTA's run of the group's q heads: [g_lo, g_lo + n_heads).
  const int per_split = (group + nsplit - 1) / nsplit;
  const int g_lo = split * per_split;
  const int n_heads = max(min(group - g_lo, per_split), 0);

  fi_stage_rows<D, NT, KEYS>(a.kq, bkv, Skv, c0, sm + L::K);
  fi_stage_rows<D, NT, KEYS>(a.vq, bkv, Skv, c0, sm + L::V);
  mfa::cp_async_commit();
  const FiWalk wk(L2 ? a.width : 0, Sq, QT);
  const int per = wk.steps();  // steps a q head
  const int steps = n_heads * per;
  auto head_of = [&](int it) {
    const int gi = g_lo + it / per;
    return a.interleaved ? gi * a.Hkv + hk : hk * group + gi;
  };
  // Step it's dO rows into buffer buf (the one buffer with DOR1).
  auto stage_dor = [&](int it, int buf) {
    const size_t bh = (size_t)b * a.Hq + head_of(it);
    fi_stage_rows<D, NT, QT>(a.dor, bh, Sq, wk.t0(it % per),
                             sm + L::DOR + (L::DOR1 ? 0 : buf * L::TQ));
  };
  // Step it's Q, dOv (and, in its last pass, dO: with DOR1 only for step
  // 0, the later steps' once the step before has converted its own) rows
  // and their vectors into buffer buf: zeros from Sq.
  auto prefetch = [&](int it, int buf) {
    const size_t bh = (size_t)b * a.Hq + head_of(it);
    const int r0 = wk.t0(it % per);
    fi_stage_rows<D, NT, QT>(a.qq, bh, Sq, r0, sm + L::Q + buf * L::TQ);
    fi_stage_rows<D, NT, QT>(a.dov, bh, Sq, r0, sm + L::DOV + buf * L::TQ);
    if (wk.pass(it % per) == wk.passes - 1 && (!L::DOR1 || it == 0))
      stage_dor(it, buf);
    float* st = reinterpret_cast<float*>(sm + L::ST) + buf * 5 * QT;
    for (int i = threadIdx.x; i < 5 * QT; i += NT) {
      const int v = i / QT;
      const int r = r0 + i % QT;
      const bool ok = r < Sq;
      const float* src = v == 0   ? a.qsc
                         : v == 1 ? a.lse
                         : v == 2 ? a.di
                         : v == 3 ? a.dorsc
                                  : a.dovsc;
      mfa::cp_async4(st + i, src + bh * Sq + (ok ? r : 0), ok ? 4 : 0);
    }
  };
  if (steps > 0) prefetch(0, 0);
  mfa::cp_async_commit();

  float ksr[2];  // this thread's keys c0 + 16 kw + g + 8i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + 16 * kw + g + 8 * i;
    ksr[i] = (a.ks && key < Skv) ? a.ks[bkv * Skv + key] : 1.f;
  }
  float dk[NDB][4], dv[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  // Level 2, per [P', dS'][key row][span of the chunk]: this thread's
  // running max, then the rows' 127 / am and am / 127.
  float run[2][2][2] = {}, inv[2][2][2], sc[2][2][2];

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    mfa::cp_async_wait<0>();
    __syncthreads();  // step it staged, K and V landed; step it - 1 done
    if (it + 1 < steps) prefetch(it + 1, buf ^ 1);
    mfa::cp_async_commit();
    const int sit = it % per;
    const int r0 = wk.t0(sit);
    const int pass = wk.pass(sit);
    const int tile = wk.tile(sit);
    const bool last = pass == wk.passes - 1;
    const uint8_t* sq = sm + L::Q + buf * L::TQ;
    const uint8_t* sdor = sm + L::DOR + (L::DOR1 ? 0 : buf * L::TQ);
    uint8_t* opq = sm + L::OP;
    uint8_t* opdo = sm + L::OP + L::OP_BYTES;
    if (last) {
      if constexpr (L2) {
        fi_rows_t<D, NT, QT>(sq, opq);
        fi_rows_t<D, NT, QT>(sdor, opdo);
      } else {
        fi_rows_bf16<D, NT, QT>(sq, opq);
        fi_rows_bf16<D, NT, QT>(sdor, opdo);
      }
    }

    // S^T and dP^T for keys 16 kw + [0, 16), queries qc0 + [0, QW):
    // element (key g + 8i, query qc0 + 8j + 2tq + c) at [j][2i + c].
    float pd[NQB][4], dsv[NQB][4];
    {
      int sti[NQB][4], dpti[NQB][4];
      mma_s8_nt<D / 32, NQB, L::RI, L::RI, BIASED>(sm + L::K, 16 * kw, sq,
                                                   qc0, sti);
      mma_s8_nt<D / 32, NQB, L::RI, L::RI, BIASED>(
          sm + L::V, 16 * kw, sm + L::DOV + buf * L::TQ, qc0, dpti);
      const float* st =
          reinterpret_cast<const float*>(sm + L::ST) + buf * 5 * QT;
#pragma unroll
      for (int j = 0; j < NQB; ++j) {
        const int qc = qc0 + 8 * j + 2 * tq;
        const float2 qs = *reinterpret_cast<const float2*>(st + qc);
        const float2 lv = *reinterpret_cast<const float2*>(st + QT + qc);
        const float2 di = *reinterpret_cast<const float2*>(st + 2 * QT + qc);
        const float2 dors =
            *reinterpret_cast<const float2*>(st + 3 * QT + qc);
        const float2 dovs =
            *reinterpret_cast<const float2*>(st + 4 * QT + qc);
        const float q2[2] = {qs.x, qs.y};
        const float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
        const float d2[2] = {di.x, di.y};
        const float r2[2] = {dors.x, dors.y};
        const float v2[2] = {dovs.x, dovs.y};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * i + c;
            const float x = fi_sum_f32<BIASED>(sti[j][e]) * q2[c] * ksr[i];
            const float pt = r0 + qc + c < Sq
                                 ? mfa::ex2_approx(fmaf(x, LOG2E, -l2[c]))
                                 : 0.f;
            dsv[j][e] = pt *
                        (fi_sum_f32<BIASED>(dpti[j][e]) * v2[c] - d2[c]) *
                        q2[c];
            pd[j][e] = pt * r2[c];
          }
      }
    }

    uint8_t* ps = sm + L::PS;
    uint8_t* dss = ps + KEYS * (L2 ? L::PT : L::PQ);
    if constexpr (!L2) {
      // dV += round_bf16(P').dO, dK += round_bf16(dS').Q, 16 queries a k
      // step.
      if constexpr (NS > 1) {
        fi_store_bf16<NQB, L::PQ>(pd, 16 * kw, qc0, ps);
        fi_store_bf16<NQB, L::PQ>(dsv, 16 * kw, qc0, dss);
      }
      __syncthreads();  // Q's and dO's bf16 rows (and P', dS' tiles)
      if (L::DOR1 && it + 1 < steps) {  // this step's dO rows converted
        stage_dor(it + 1, 0);
        mfa::cp_async_commit();
      }
      const int a_off =
          (16 * kw + mfa::ldsm_a_row(lane)) * L::PQ + mfa::ldsm_a_byte(lane);
#pragma unroll
      for (int kc = 0; kc < QT / 16; ++kc) {
        uint32_t pa[4], dsa[4];
        if constexpr (NS == 1) {
          mfa::c_to_a_bf16(pd, kc, pa);
          mfa::c_to_a_bf16(dsv, kc, dsa);
        } else {
          mfa::ldsm_x4(pa, ps + a_off + kc * 32);
          mfa::ldsm_x4(dsa, dss + a_off + kc * 32);
        }
        mfa::mma_rn<NDB, L::RB>(pa, opdo, 16 * kc, part * DW, dv);
        mfa::mma_rn<NDB, L::RB>(dsa, opq, 16 * kc, part * DW, dk);
      }
    } else {
      if (pass == 0) {
        if (tile == 0)
#pragma unroll
          for (int k = 0; k < 8; ++k) (&run[0][0][0])[k] = 0.f;
#pragma unroll
        for (int j = 0; j < NQB; ++j) {
          const bool sp = tile * QT + qc0 + 8 * j >= a.width;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            max_at(run[0][i], sp, fmaxf(pd[j][2 * i], pd[j][2 * i + 1]));
            max_at(run[1][i], sp,
                   fmaxf(fabsf(dsv[j][2 * i]), fabsf(dsv[j][2 * i + 1])));
          }
        }
      }
      if (!last) continue;
      if (tile == 0) {  // the chunk's row maxima are complete
        float* amx = reinterpret_cast<float*>(sm + L::AM);
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int sp = 0; sp < 2; ++sp) {
              const float m = quad_max(run[k][i][sp]);
              if (tq == 0)
                amx[((part * KEYS + 16 * kw + g + 8 * i) * 2 + sp) * 2 + k] =
                    m;
            }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int sp = 0; sp < 2; ++sp) {
              float am = 0.f;
#pragma unroll
              for (int p = 0; p < NS; ++p)
                am = fmaxf(
                    am,
                    amx[((p * KEYS + 16 * kw + g + 8 * i) * 2 + sp) * 2 + k]);
              inv[k][i][sp] = 127.f / fmaxf(am, 1e-30f);
              sc[k][i][sp] = am * (1.f / 127.f);
            }
      }
#pragma unroll
      for (int j = 0; j < NQB; ++j) {
        const bool sp = tile * QT + qc0 + 8 * j >= a.width;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pd[j][e] = fi_quant(pd[j][e], pick(inv[0][e >> 1], sp));
          dsv[j][e] = fi_quant(dsv[j][e], pick(inv[1][e >> 1], sp));
        }
      }
      // dV += P_int.dO_int, dK += dS_int.Q_int, 32 queries a k step (dO^T,
      // Q^T in permuted positions).
      constexpr int KK = QT / 32;  // k steps a tile
      fi_store_s8<NQB, L::PT>(pd, 16 * kw, qc0, ps);
      fi_store_s8<NQB, L::PT>(dsv, 16 * kw, qc0, dss);
      __syncthreads();  // Q^T, dO^T and the P', dS' tiles
      uint32_t pa[KK][4], dsa[KK][4];
      const int a_off = (16 * kw + mfa::ldsm_a_row(lane)) * L::PT +
                        mfa::ldsm_a_byte(lane);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        mfa::ldsm_x4(pa[kk], ps + a_off + 32 * kk);
        mfa::ldsm_x4(dsa[kk], dss + a_off + 32 * kk);
      }
      // The tile's integer products (|x| <= 64 * 127 * 127 < 2^22, summed
      // from I32_BIAS) scaled into the fp32 accumulators, or each k step's
      // where a span ends between them: k step kk's sums are scaled after
      // it where flush[kk], by span span[kk]'s scales.
      bool flush[KK], span[KK];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int kp = QT * tile + 32 * kk;  // the k step's, in the chunk
        flush[kk] = kk == KK - 1 || (kp + 32) % a.width == 0;
        span[kk] = kp >= a.width;
      }
#pragma unroll
      for (int n2 = 0; n2 < NDB / 2; ++n2) {
        int cv[2][4], ck[2][4];
        auto scale_into = [&](bool sp) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv[2 * n2 + m][e] +=
                  mfa::biased_f32(cv[m][e]) * pick(sc[0][e >> 1], sp);
              dk[2 * n2 + m][e] +=
                  mfa::biased_f32(ck[m][e]) * pick(sc[1][e >> 1], sp);
              cv[m][e] = ck[m][e] = mfa::I32_BIAS;
            }
        };
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cv[0][e] = cv[1][e] = ck[0][e] = ck[1][e] = mfa::I32_BIAS;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          mma_s8_rows<2, L::PT>(pa[kk], opdo, part * DW + 16 * n2, 32 * kk,
                                cv);
          mma_s8_rows<2, L::PT>(dsa[kk], opq, part * DW + 16 * n2, 32 * kk,
                                ck);
          if (flush[kk]) scale_into(span[kk]);
        }
      }
    }
  }
  mfa::cp_async_wait<0>();

  const size_t n = (size_t)gridDim.z / nsplit * a.Hkv * Skv * D;
  float* out_k = nsplit > 1 ? ws + (2 * (size_t)split) * n : a.out0;
  float* out_v = nsplit > 1 ? ws + (2 * (size_t)split + 1) * n : a.out1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + 16 * kw + g + 8 * i;
    if (key >= Skv) continue;
    float* dkr = out_k + (bkv * Skv + key) * D + part * DW + 2 * tq;
    float* dvr = out_v + (bkv * Skv + key) * D + part * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) =
          make_float2(dk[j][2 * i] * a.store, dk[j][2 * i + 1] * a.store);
      *reinterpret_cast<float2*>(dvr + 8 * j) =
          make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// As the flash kernels route (dq_tc / dkv_tc, bwd_wide at D = 288 and
// bwd_latent at 576): bf16 to dq_tc_body / dkv_tc_body up to D = 256, to
// the wide bodies at 288 and to the latent bodies at 576, fp32 to the
// scalar bodies (32-row tiles at 576: scalar32).  splits > 1 (the wide and
// latent dK/dV only) deals the GQA group over that many CTAs a key tile,
// their partials into ws.
template <typename T, int D>
int launch_qflash(bool dq, const BwdArgs& a, const QuantKV<D>& kv, int B,
                  int splits, float* ws, cudaStream_t stream) {
  constexpr bool TC = mfa::dq_tc<T, D>();  // = dkv_tc
  constexpr bool WIDE = TC && mfa::bwd_wide<D>();
  constexpr bool LATENT = TC && mfa::bwd_latent<D>();
  constexpr bool SCALAR32 = !TC && mfa::scalar32<D>();
  if (splits < 1 || (splits > 1 && (!(WIDE || LATENT) || dq || !ws)) ||
      splits > a.Hq / a.Hkv)
    return (int)cudaErrorInvalidValue;
  // Query rows (dQ) or keys (dK/dV) a CTA: 32 on the latent dK/dV and the
  // 32-row scalar bodies, else 64 (BM = BN).
  constexpr int DQ_ROWS = SCALAR32 ? mfa::T32 : BM;
  constexpr int KEYS = SCALAR32 || LATENT ? mfa::T32 : BN;
  const dim3 dq_grid((a.Sq + DQ_ROWS - 1) / DQ_ROWS, a.Hq, B);
  const dim3 grid((a.Skv + KEYS - 1) / KEYS, a.Hkv, B);
  if constexpr (LATENT) {
    if (dq)
      return launch_with_smem(qflash_dq_latent_kernel<D>, dq_grid,
                              mfa::DQ_LATENT_THREADS,
                              mfa::DqLatentSmem<D>::BYTES, stream, a, kv);
    return launch_with_smem(qflash_dkv_latent_kernel<D>,
                            dim3(grid.x, grid.y, grid.z * splits),
                            mfa::DKV_LATENT_THREADS,
                            mfa::DkvLatentSmem<D>::BYTES, stream, a, kv,
                            splits, ws);
  } else if constexpr (WIDE) {
    if (dq)
      return launch_with_smem(qflash_dq_wide_kernel<D>, dq_grid,
                              mfa::DQ_WIDE_THREADS,
                              mfa::DqWideSmem<D, true>::BYTES, stream, a, kv);
    return launch_with_smem(qflash_dkv_wide_kernel<D>,
                            dim3(grid.x, grid.y, grid.z * splits),
                            mfa::DKV_WIDE_THREADS, mfa::DkvWideSmem<D>::BYTES,
                            stream, a, kv, splits, ws);
  } else if constexpr (TC) {
    if (dq)
      return launch_with_smem(qflash_dq_tc_kernel<D>, dq_grid,
                              mfa::dq_tc_threads<D>(),
                              mfa::DqTcSmem<D, true>::BYTES, stream, a, kv);
    return launch_with_smem(qflash_dkv_tc_kernel<D>, grid,
                            mfa::dkv_tc_threads<D>(), mfa::DkvTcSmem<D>::BYTES,
                            stream, a, kv);
  } else {
    if (dq)
      return launch_with_smem(qflash_dq_kernel<T, D>, dq_grid, THREADS,
                              SCALAR32 ? mfa::smem32_bytes<D>()
                                       : mfa::dq_smem_floats<D>() *
                                             sizeof(float),
                              stream, a, kv);
    return launch_with_smem(qflash_dkv_kernel<T, D>, grid, THREADS,
                            SCALAR32 ? mfa::smem32_bytes<D>()
                                     : mfa::dkv_smem_floats<D>() *
                                           sizeof(float),
                            stream, a, kv);
  }
}

template <int D, bool L2>
int launch_fullint_tc(bool dq, const FullintArgs& a, int B, int splits,
                      float* ws, cudaStream_t stream) {
  constexpr int NT = fi_threads<D, L2>();
  constexpr int T = fi_tile<D>();
  if (dq)
    return launch_with_smem(fullint_dq_tc_kernel<D, L2>,
                            dim3((a.Sq + T - 1) / T, a.Hq, B), NT,
                            FiDqSmem<D, L2>::BYTES, stream, a);
  return launch_with_smem(fullint_dkv_tc_kernel<D, L2>,
                          dim3((a.Skv + T - 1) / T, a.Hkv, B * splits), NT,
                          FiDkvSmem<D, L2>::BYTES, stream, a, splits, ws);
}

// Level 1 and level-2 widths from one k step on the tensor cores, the
// narrower widths on the scalar kernels (in 32-row tiles at D = 576).
// splits > 1: the dK/dV at D = 576 only.
template <int D>
int launch_fullint(bool dq, const FullintArgs& a, int B, int splits,
                   float* ws, cudaStream_t stream) {
  if (a.width == 0)
    return launch_fullint_tc<D, false>(dq, a, B, splits, ws, stream);
  if (fullint_tc(a.width))
    return launch_fullint_tc<D, true>(dq, a, B, splits, ws, stream);
  if constexpr (mfa::scalar32<D>()) {
    constexpr int T = mfa::T32;
    if (dq)
      return launch_with_smem(fullint_dq32_kernel<D>,
                              dim3((a.Sq + T - 1) / T, a.Hq, B), THREADS,
                              fullint_dq_smem32<D>(), stream, a);
    return launch_with_smem(fullint_dkv32_kernel<D>,
                            dim3((a.Skv + T - 1) / T, a.Hkv, B * splits),
                            THREADS, fullint_dkv_smem32<D>(), stream, a,
                            splits, ws);
  } else {
    if (dq)
      return launch_with_smem(fullint_dq_kernel<D>,
                              dim3((a.Sq + BM - 1) / BM, a.Hq, B), THREADS,
                              fullint_dq_smem_bytes<D>(), stream, a);
    return launch_with_smem(fullint_dkv_kernel<D>,
                            dim3((a.Skv + BN - 1) / BN, a.Hkv, B), THREADS,
                            fullint_dkv_smem_bytes<D>(), stream, a);
  }
}

bool valid_bits(int bits) { return bits == 8 || bits == 4; }

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported dtype (0 float32,
// 1 bfloat16), head dim (32, 64, 128, 256, 288, 576, or above 576 a
// multiple of 16), bit width or head grouping.
extern "C" {

// The exact dQ (dq = 1: out0 = dQ, out1 = dbias or null; q pre-scaled) or
// dK/dV (dq = 0: out0 = dK, out1 = dV; q scaled by `scale` here).  k_mode /
// v_mode: 0 integers, 1 per token, 2 BLOCK_2D, 5 per channel.  splits:
// the CTAs that share a key tile's GQA group (bf16 dK/dV at D = 288 and
// 576, both dtypes above 576, ops/flash_attention_bwd.py::dkv_splits; 1
// elsewhere); with splits > 1 the partials go to ws, fp32 [splits, 2, B,
// Hkv, Skv, D], and mfa_flash_dkv_merge sums them into out0 and out1.  For
// the dQ above 576, splits: the runs of the KV axis
// (ops/flash_attention_bwd.py::split_d_dq_splits), whose unscaled partials
// go to ws, fp32 [splits, B, Hq, Sq, D], for mfa_split_d_dq_merge.
int mfa_qflash_bwd(int dq, const void* q, const void* dout, const void* kq,
                   const void* ks, const void* kz, const void* vq,
                   const void* vs, const void* vz, const void* ksr,
                   const void* vsr, const void* dqsc, const void* lse,
                   const void* di, const void* ranges, const void* bias,
                   long long bias_sb, long long bias_sh, void* out0,
                   void* out1, int dtype, int B, int Hq, int Hkv, int Sq,
                   int Skv, int D, int interleaved, int bits_k, int bits_v,
                   int k_mode, int v_mode, int br, int bs, float scale,
                   int splits, void* ws, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || !valid_bits(bits_k) || !valid_bits(bits_v))
    return (int)cudaErrorInvalidValue;
  if (D > 576) {
    mfa_sd::FlashArgs fa{
        q, kq, vq, dout, static_cast<const float*>(lse),
        static_cast<const float*>(di), static_cast<const int32_t*>(ranges),
        static_cast<const float*>(bias), bias_sb, bias_sh, nullptr,
        static_cast<float*>(out0), static_cast<float*>(out1), B, Hq, Hkv, Sq,
        Skv, D, interleaved, scale, 0.f};
    const mfa_sd::QuantKV qkv{
        static_cast<const float*>(ks),   static_cast<const float*>(kz),
        static_cast<const float*>(vs),   static_cast<const float*>(vz),
        static_cast<const float*>(ksr),  static_cast<const float*>(vsr),
        static_cast<const float*>(dqsc), bits_k, bits_v, k_mode, v_mode, br,
        bs};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dq) {
      fa.splits = splits;
      fa.ws = static_cast<float*>(ws);
      return mfa_sd::launch_qdq(dtype, fa, qkv, st);
    }
    return mfa_sd::launch_qdkv(dtype, fa, qkv, splits,
                               static_cast<float*>(ws), st);
  }
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
  float* w = static_cast<float*>(ws);
#define MFA_QFLASH(T, DD)                                               \
  return launch_qflash<T, DD>(                                          \
      dq, a, QuantKV<DD>{k, v, Skv, br, bs, dtype == 1}, B, splits, w, s)
  if (dtype == 0) {
    if (D == 32) MFA_QFLASH(float, 32);
    if (D == 64) MFA_QFLASH(float, 64);
    if (D == 128) MFA_QFLASH(float, 128);
    if (D == 256) MFA_QFLASH(float, 256);
    if (D == 288) MFA_QFLASH(float, 288);
    if (D == 576) MFA_QFLASH(float, 576);
  } else if (dtype == 1) {
    if (D == 32) MFA_QFLASH(__nv_bfloat16, 32);
    if (D == 64) MFA_QFLASH(__nv_bfloat16, 64);
    if (D == 128) MFA_QFLASH(__nv_bfloat16, 128);
    if (D == 256) MFA_QFLASH(__nv_bfloat16, 256);
    if (D == 288) MFA_QFLASH(__nv_bfloat16, 288);
    if (D == 576) MFA_QFLASH(__nv_bfloat16, 576);
  }
#undef MFA_QFLASH
  return (int)cudaErrorInvalidValue;
}

// The full-integer dQ (dq = 1: out0 = dQ) or dK/dV (dq = 0: out0 = dK,
// out1 = dV) at D = 32, 64, 128, 256, 288 and 576.  splits: the CTAs that
// share a key tile's GQA group (the dK/dV at D = 576 and above,
// ops/flash_attention_bwd.py::fullint_dkv_splits; 1 elsewhere); with
// splits > 1 the partials (dK times `store`) go to ws, fp32 [splits, 2, B,
// Hkv, Skv, D], and mfa_flash_dkv_merge sums them into out0 and out1.
int mfa_fullint_bwd(int dq, const void* qq, const void* qsc, const void* kq,
                    const void* ks, const void* vq, const void* dor,
                    const void* dorsc, const void* dov, const void* dovsc,
                    const void* lse, const void* di, void* out0, void* out1,
                    int B, int Hq, int Hkv, int Sq, int Skv, int D,
                    int interleaved, int width, float store, int splits,
                    void* ws, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || width < 0 || splits < 1 ||
      splits > Hq / Hkv ||
      (splits > 1 && (dq || ws == nullptr || D < 576)))
    return (int)cudaErrorInvalidValue;
  if (D > 576)
    return mfa_sd::launch_fullint(
        dq,
        mfa_sd::FullintArgs{
            static_cast<const int8_t*>(qq),   static_cast<const float*>(qsc),
            static_cast<const int8_t*>(kq),   static_cast<const float*>(ks),
            static_cast<const int8_t*>(vq),   static_cast<const int8_t*>(dor),
            static_cast<const float*>(dorsc), static_cast<const int8_t*>(dov),
            static_cast<const float*>(dovsc), static_cast<const float*>(lse),
            static_cast<const float*>(di),    static_cast<float*>(out0),
            static_cast<float*>(out1),        B,
            Hq,                               Hkv,
            Sq,                               Skv,
            D,                                interleaved,
            width,                            store},
        splits, static_cast<float*>(ws), static_cast<cudaStream_t>(stream));
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
  float* w = static_cast<float*>(ws);
  if (D == 32) return launch_fullint<32>(dq, a, B, splits, w, s);
  if (D == 64) return launch_fullint<64>(dq, a, B, splits, w, s);
  if (D == 128) return launch_fullint<128>(dq, a, B, splits, w, s);
  if (D == 256) return launch_fullint<256>(dq, a, B, splits, w, s);
  if (D == 288) return launch_fullint<288>(dq, a, B, splits, w, s);
  if (D == 576) return launch_fullint<576>(dq, a, B, splits, w, s);
  return (int)cudaErrorInvalidValue;
}

// The kernels mfa_fullint_bwd launches for a head dim D (1 to 576, run at
// its kernel width; above 576 the multiples of 16) and level-2 width
// `width` (0: level 1): 2 the split-D pair (above 576, both levels), 1 the
// tensor-core pair, 0 the scalar pair, -1 none
// (ops/flash_attention_bwd.py::fullint_body gives the same answer).
int mfa_fullint_tc_body(int D, int width) {
  if (width < 0 || D < 1 || (D > 576 && !mfa_sd::takes(D))) return -1;
  if (D > 576) return 2;
  return fullint_tc(width) ? 1 : 0;
}

}  // extern "C"

// The quantized attention backward above head dim 576 for Hopper (sm_90a):
// the exact quantized dQ and dK/dV and the full-integer pair on the
// split-D frame (csrc/split_d_frame.cuh), the head dim a run-time value.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu,
// ops/flash_attention_bwd.py) above D = 576:
//   - _dq_kernel, quantized modes  -> split_d_qdq_kernel (the frame's dQ
//                                     body over PayloadKV; then
//                                     split_d_attention.cu's
//                                     split_d_dq_merge_kernel where the
//                                     KV axis splits)
//   - _dkv_kernel, quantized modes -> split_d_qdkv_kernel (its dK/dV body)
//                                     (then flash_attention.cu's
//                                     flash_dkv_merge_kernel)
//   - _dq_fullint_kernel           -> split_d_fullint_dq_kernel
//   - _dkv_fullint_kernel          -> split_d_fullint_dkv_kernel (then
//                                     flash_dkv_merge_kernel)
// csrc/quantized_attention_bwd.cu's router (mfa_qflash_bwd, mfa_fullint_bwd)
// calls the launchers here for D > 576 (split_d.cuh).
//
// The exact pair is the flash dQ and dK/dV of the frame with the payloads
// as K and V (PayloadKV: dequantized per token, BLOCK_2D block or channel
// as they stage, or the integers for the folded dQ, rounded to T by the
// staging bit for bit with dequant_rows_bf16), the folded dQ's per-token
// column scales (ksr on S and dS, vsr on dP) and its store multipliers
// (dqsc), in attention_bwd.cuh::dq_body's order.  Whole payload rows (int8;
// int4 where D is a multiple of 32) under a bf16 Q take the raw path
// (PayloadKV<true>): their raw bytes land through the scores' cp.async
// ring and widen a chunk ahead, as the quantized forward's do; the dQ's K
// slice lands raw under the scores; the dK/dV computes S and dP with the
// payload on the ring's B side and reads their transposes back, its 64
// keys' raw K rows resident in shared memory past Smem<64, 2> where they
// fit (rows of up to 1,104 bytes: int8 to D = 1104, int4 to 2208), which
// saves each q head and row step their copies (7% of the kernel's time
// at D = 640 and 1024 on an H100).  The dQ's
// KV axis splits where few row tiles leave SMs idle
// (ops/flash_attention_bwd.py::split_d_dq_splits), its runs merged by
// split_d_attention.cu::split_d_dq_merge_kernel.
//
// The full-integer pair (csrc/quantized_attention_bwd.cu's file comment has
// its numerics; the plain versions are ops/flash_attention_bwd.py's
// fullint_dq_plain and fullint_dkv_plain): S = Q_int.K_int^T and dP =
// dOv_int.V_int^T on s8 mma.sync, exact in int32.  A head's slices run as
// clusters of C CTAs (mfa_sd::
// fullint_cluster, ops/flash_attention_bwd.py::split_d_fullint_cluster:
// the largest divisor of the slices up to 16; 3 at D = 640, 4 at 1024, 5
// at 1152, 9 at 2304), which split the contraction: each CTA sums S and dP
// over the lanes of slices / C slices only (ring_pair: one cp.async ring
// over S's chunks, then dP's, 64 lanes (two k steps) a stage and one
// barrier a stage: with 32-lane stages the barriers, not the products,
// set the ring's pace), so the bytes it reads and its score products fall
// by C, and leaves its int32 partials in shared memory.
// After a cluster barrier the owner of each 16-row slab of the tile (CTA
// slab % C) adds the C partials (through distributed shared memory; int32,
// so the same integers as one CTA summing alone) and computes p = exp(S
// qsc (ks) - L) and dS = p (dP dovsc - D) (ks) there, in the C fragments'
// layout; after a second barrier every CTA gathers the owners' rows of
// the operand its output product takes, then multiplies its own 256-lane
// slice:
//   - level 1: round_bf16(dS).K_int (dQ), round_bf16(P dorsc).dO_int and
//     round_bf16(dS^T qsc).Q_int (dV, dK) on bf16 mma.sync (the integers
//     are exact in bf16);
//   - level 2: each row of dS (P, dS^T) quantized to int8 codes over spans
//     of `width` keys (queries) by its |max| over the span (+-0.5 then
//     truncation), the codes (A) times the slice's integers transposed into
//     [lane][position] rows (B) on s8 mma.sync into int32, scaled by the
//     row's max / 127 (the codes' scales gathered with them): the dQ each
//     span's sum at its end, as the plain version's _quantized_product,
//     the dK/dV (two accumulators) each tile's.  Every width
//     from 1 up: a span's tiles end at the span's end, the positions past
//     it zero (so a span that ends inside a k step is multiplied with the
//     rest of the step's codes zero); a span of one tile or less is taken
//     in one pass, a wider one in two, its row maxima first, so the codes
//     are the plain version's whatever the tiles.
// Gathering the owners' 16 x 64 operand rows (2 KiB of bf16, 1 KiB of
// codes a slab) instead of every CTA reading every partial (C - 1 times
// 32 KiB a tile) keeps the cluster's distributed shared memory traffic,
// whose rate bounded the first design, to about a third at C = 4.
// dK is stored times `store`; the dK/dV's GQA group is dealt over `splits`
// CTAs a key tile (ops/flash_attention_bwd.py::fullint_dkv_splits) into a
// workspace that flash_dkv_merge_kernel sums in split order.
// What bounds them: the tensor-core operations (the exact dQ (4 s + 2) D a
// live pair, dK/dV (4 s + 4) D, s = slices: the scores recomputed once a
// slice; the full-integer pair 4 D / C of s8 scores a CTA and its output
// products, level 2's scores twice over spans wider than a tile), and the
// cluster's barriers and distributed shared memory traffic, two barriers
// a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "split_d_frame.cuh"

namespace {

namespace cg = cooperative_groups;

using mfa_sd::FullintArgs;
using mfa_sd::QuantKV;

// int8 rows of head `head` of a [.., n, D] tensor from row r0, zeros from
// `limit`.
__device__ __forceinline__ I8Rows i8_rows(const int8_t* x, size_t head,
                                          int n, int D, int r0, int limit) {
  return I8Rows{x + head * n * (size_t)D, r0, limit, D};
}

// ---------------------------------------------------------------------------
// The full-integer pair
// ---------------------------------------------------------------------------

constexpr int XS_BYTES = 256 * 128;  // S, dP partials: 32 int32 a thread
constexpr int RLD = SLICE + 16;      // bytes a raw int8 slice row
constexpr int OLD = TILE + 16;       // bytes a row of level 2's s8 operands
constexpr int QC = 64;  // int8 lanes a stage of ring_pair: two k steps

// A CTA's place in its cluster of C CTAs (the slices of one head, rank =
// slice % C) and its share of the scores' contraction: the head dim in
// runs of slices(D) / C slices, rank r summing S and dP over lanes [lo, lo
// + nq * QC) of run r.  C = 1 (a launch without a cluster): the whole
// head dim.
struct Share {
  int C, rank, lo, nq;
};
__device__ __forceinline__ Share share_of(int D) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int per = mfa_sd::slices(D) / C * SLICE;
  const int lo = rank * per;
  return {C, rank, lo, (min(lo + per, D) - lo + QC - 1) / QC};
}

// The cluster's barrier (release, then acquire), or the CTA's without a
// cluster.
__device__ __forceinline__ void cluster_sync(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The CTA of a cluster that completes slab s (rows 16 s + [0, 16) of a 64 x
// 64 score tile): its partial sums, p and dS, for every CTA.
__device__ __forceinline__ int owner(int s, int C) { return s % C; }

// S = A1.B1^T and dP = A2.B2^T over lanes [lo, lo + nq * QC) of int8 rows
// (64 each, RAW): one cp.async ring of NS stages over the 2 nq chunks of
// QC lanes, (a1, b1)'s then (a2, b2)'s, so dP's first chunks land under
// S's last products; one barrier a chunk (a stage row holds 64 int8 lanes
// in the CRB bytes a bf16 chunk row takes).  Warp w sums rows 16 (w % 4)
// + [0, 16) and columns 32 (w / 4) + [0, 32) in C fragments (s[j]: the
// columns' 8-wide block j), exactly in int32.  Ends with a barrier.
template <typename A1, typename B1, typename A2, typename B2>
__device__ __forceinline__ void ring_pair(int nq, int lo, uint8_t* ra,
                                          uint8_t* rb, const A1& a1,
                                          const B1& b1, const A2& a2,
                                          const B2& b2, int (&s)[4][4],
                                          int (&dp)[4][4]) {
  static_assert(QC + 16 <= CRB, "a stage row holds QC int8 lanes");
  const int warp = threadIdx.x >> 5;
  const int slab = warp & 3, half = warp >> 2;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0;
  const int n = 2 * nq;
  const auto issue = [&](int c) {
    uint8_t* da = ra + (c % NS) * TILE * CRB;
    uint8_t* db = rb + (c % NS) * TILE * CRB;
    const int l = lo + (c < nq ? c : c - nq) * QC;
    for (int i = threadIdx.x; i < TILE * (QC / 16); i += 256) {
      const int r = i / (QC / 16), p = 16 * (i % (QC / 16));
      if (c < nq) {
        a1.copy16(r, l + p, da + r * CRB + p);
        b1.copy16(r, l + p, db + r * CRB + p);
      } else {
        a2.copy16(r, l + p, da + r * CRB + p);
        b2.copy16(r, l + p, db + r * CRB + p);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < n) issue(c);
    mfa::cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    mfa::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's readers done
    if (c + NS - 1 < n) issue(c + NS - 1);
    mfa::cp_async_commit();
    const uint8_t* a = ra + (c % NS) * TILE * CRB;
    const uint8_t* b = rb + (c % NS) * TILE * CRB;
#pragma unroll
    for (int k = 0; k < QC; k += DC) {
      if (c < nq)
        mma_chunk_s8(a + k, 16 * slab, b + k, 32 * half, s);
      else
        mma_chunk_s8(a + k, 16 * slab, b + k, 32 * half, dp);
    }
  }
  __syncthreads();
}

// A thread's S and dP partials (its warp's C fragments) into part, by
// warp, register and lane.
__device__ __forceinline__ void put_partials(int* part, const int (&s)[4][4],
                                             const int (&dp)[4][4]) {
  int4* p = reinterpret_cast<int4*>(part);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[(warp * 8 + j) * 32 + lane] =
        make_int4(s[j][0], s[j][1], s[j][2], s[j][3]);
    p[(warp * 8 + 4 + j) * 32 + lane] =
        make_int4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
  }
}

// The whole head dim's S and dP of a thread's fragments: its CTA's partial
// plus the other CTAs' (their part, through distributed shared memory, in
// rank order; int32, so the same integers in any order).  After the
// cluster barrier that follows put_partials.
__device__ __forceinline__ void add_partials(const int* part, const Share& sh,
                                             int (&s)[4][4],
                                             int (&dp)[4][4]) {
  cg::cluster_group cl = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = 0; r < sh.C; ++r) {
    if (r == sh.rank) continue;
    const int4* p = reinterpret_cast<const int4*>(
        cl.map_shared_rank(const_cast<int*>(part), r));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 u = p[(warp * 8 + j) * 32 + lane];
      const int4 v = p[(warp * 8 + 4 + j) * 32 + lane];
      s[j][0] += u.x;
      s[j][1] += u.y;
      s[j][2] += u.z;
      s[j][3] += u.w;
      dp[j][0] += v.x;
      dp[j][1] += v.y;
      dp[j][2] += v.z;
      dp[j][3] += v.w;
    }
  }
}

// Rows of slab s (16 rows of `bytes`, a multiple of 16, `ld` bytes apart)
// of a tile in every CTA whose slab s another CTA owns, copied from the
// owner's same tile through distributed shared memory (all threads).
__device__ __forceinline__ void gather_slabs(uint8_t* tile, int ld,
                                             int bytes, const Share& sh) {
  if (sh.C == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  const int per_row = bytes / 16;
  for (int i = threadIdx.x; i < 4 * 16 * per_row; i += 256) {
    const int s = i / (16 * per_row);
    const int src = owner(s, sh.C);
    if (src == sh.rank) continue;
    const int r = 16 * s + (i / per_row) % 16, p = 16 * (i % per_row);
    const uint8_t* from = cl.map_shared_rank(tile, src);
    *reinterpret_cast<int4*>(tile + r * ld + p) =
        *reinterpret_cast<const int4*>(from + r * ld + p);
  }
}

// An owner thread's score values (its warp's C fragments: row 16 slab + g
// + 8 (e >> 1), column 32 half + 8 j + 2 t + (e & 1)) into the CTA's tiles:
// level 1 rounded to bf16 into the row-major bf16 tile [TILE][PRB] (the A
// operand of PV<bf16>::mul_tc); level 2 as codes over the rows' maxima am
// (fi_quant: +-0.5 then truncation, as the plain version rounds) into the
// int8 tile [TILE][OLD] in fi_rows_t's permuted positions, and each row's
// am / 127 into rs.  Level 2's dS (P) and inverse scales are rounded as
// the plain version's torch operations round them, so the codes are its
// codes bit for bit.
__device__ __forceinline__ void store_bf16_tile(const float (&v)[4][4],
                                                uint8_t* tile) {
  const int warp = threadIdx.x >> 5;
  mfa::fi_store_bf16<4, PRB>(v, 16 * (warp & 3), 32 * (warp >> 2), tile);
}
__device__ __forceinline__ void store_code_tile(const float (&v)[4][4],
                                                const float (&am)[2],
                                                uint8_t* codes, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * (warp & 3) + (lane >> 2);
  // 127 / max(am, 1e-30) as the plain version's torch takes it (a
  // scalar over a tensor: the reciprocal, times 127), so that the codes
  // are its codes.
  const float inv[2] = {__fmul_rn(__frcp_rn(fmaxf(am[0], 1e-30f)), 127.f),
                        __fmul_rn(__frcp_rn(fmaxf(am[1], 1e-30f)), 127.f)};
  float q[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[j][e] = mfa::fi_quant(v[j][e], inv[e >> 1]);
  mfa::fi_store_s8<4, OLD>(q, 16 * (warp & 3), 32 * (warp >> 2), codes);
  if ((lane & 3) == 0 && warp < 4) {
    rs[row] = am[0] * (1.f / 127.f);
    rs[row + 8] = am[1] * (1.f / 127.f);
  }
}

// Level 2's row maxima of an owner thread's values (|v|; P is >= 0) over
// its warp's 32 columns (update: into run, from 0 where reset), and where
// `last` over the slab's two warps through amx ([2][TILE] floats) into
// am.  Every thread calls it where `last` (a barrier).
__device__ __forceinline__ void row_maxima(const float (&v)[4][4],
                                           bool owned, bool update,
                                           bool reset, bool last,
                                           float (&run)[2], float* amx,
                                           float (&am)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * (warp & 3) + (lane >> 2);
  if (owned) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (update) {
        float m = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          m = fmaxf(m, fmaxf(fabsf(v[j][2 * i]), fabsf(v[j][2 * i + 1])));
        m = mfa::quad_max(m);
        run[i] = reset ? m : fmaxf(run[i], m);
      }
      if (last && (lane & 3) == 0)
        amx[(warp >> 2) * TILE + row + 8 * i] = run[i];
    }
  }
  if (!last) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
    am[i] = fmaxf(amx[row + 8 * i], amx[TILE + row + 8 * i]);
}

// The slice [l0, l0 + SLICE) of TILE int8 rows into raw (RLD bytes a row)
// by cp.async, committed as one group (zeros past the rows' limit and D).
__device__ __forceinline__ void fetch_i8_slice(const I8Rows& src, int l0,
                                               uint8_t* raw) {
  for (int i = threadIdx.x; i < TILE * (SLICE / 16); i += 256) {
    const int r = i / (SLICE / 16), p = 16 * (i % (SLICE / 16));
    src.copy16(r, l0 + p, raw + r * RLD + p);
  }
  mfa::cp_async_commit();
}

// Rows [16 s, 16 s + 16) of rs (TILE floats) from their owners (all
// threads), as gather_slabs.
__device__ __forceinline__ void gather_scales(float* rs, const Share& sh) {
  if (sh.C == 1 || threadIdx.x >= TILE) return;
  const int src = owner(threadIdx.x / 16, sh.C);
  if (src != sh.rank)
    rs[threadIdx.x] = *cg::this_cluster().map_shared_rank(rs + threadIdx.x,
                                                          src);
}

// Level 2's output product on s8 mma.sync m16n8k32: the codes [TILE][OLD]
// times bt [SLICE][OLD] over the tile's 64 positions, two k steps, in
// PV<bf16>'s accumulator layout (warp w: rows 16 (w % 4) + [0, 16), lanes
// 128 (w / 4) + [0, 128)).  SPAN: the int32 sums added into isum (scaled
// by the caller at the span's end); else each 16 lanes' int32 product
// times the rows' rs, added to acc.
template <bool SPAN, int N>
__device__ __forceinline__ void mul_s8(const uint8_t* codes,
                                       const uint8_t* bt, const float* rs,
                                       float (&acc)[64], int (&isum)[N]) {
  static_assert(!SPAN || N == 64, "a span's sums: 64 a thread");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = warp & 3, part = warp >> 2;
  uint32_t af[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    mfa::ldsm_x4(af[kk], codes + (16 * slab + mfa::ldsm_a_row(lane)) * OLD +
                             32 * kk + mfa::ldsm_a_byte(lane));
  const float s0 = rs[16 * slab + (lane >> 2)];
  const float s1 = rs[16 * slab + (lane >> 2) + 8];
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2) {
    int c[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (SPAN)
          c[h][e] = isum[8 * n2 + 4 * h + e];
        else
          c[h][e] = 0;
      }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mfa::mma_s8_rows<2, OLD>(af[kk], bt, 128 * part + 16 * n2, 32 * kk, c);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (SPAN)
          isum[8 * n2 + 4 * h + e] = c[h][e];
        else
          acc[8 * n2 + 4 * h + e] += (float)c[h][e] * (e < 2 ? s0 : s1);
      }
  }
}

// acc += isum times the rows' rs (PV<bf16>'s layout), isum back to 0: a
// span's integer product scaled back.
__device__ __forceinline__ void flush_span(float (&acc)[64], int (&isum)[64],
                                           const float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float s0 = rs[16 * (warp & 3) + (lane >> 2)];
  const float s1 = rs[16 * (warp & 3) + (lane >> 2) + 8];
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    acc[k] += (float)isum[k] * ((k & 3) < 2 ? s0 : s1);
    isum[k] = 0;
  }
}

// Replaces _dq_fullint_kernel above D = 576.  One CTA per (64 query rows,
// q head x slice, b), a head's slices in clusters of C (y): each CTA sums
// S and dP over its share of the lanes (ring_pair), the owner of each
// 16-row slab adds the cluster's partials and computes p and dS there, and
// every CTA gathers the owners' dS (level 1: bf16; level 2: codes and row
// scales) and multiplies its own 256-lane slice of K.  Walks every key
// (the path has no mask) in 64-key tiles, a level-2 span of `width` keys
// at a time (a span's tiles end at its end); level 2 keeps each span's
// int32 product and scales it at the span's end, in the plain version's
// order.
template <bool L2>
__global__ void __launch_bounds__(256)
split_d_fullint_dq_kernel(const FullintArgs a) {
  using L = Smem<64, 1>;
  using P = PV<__nv_bfloat16, 64>;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* ks = a.ks ? a.ks + bk * Skv : nullptr;
  const Share sh = share_of(D);
  const bool owned = owner(warp & 3, sh.C) == sh.rank;
  int* part = reinterpret_cast<int*>(smem + L::BYTES / 4);
  uint8_t* ra = reinterpret_cast<uint8_t*>(smem + L::A);
  uint8_t* rb = reinterpret_cast<uint8_t*>(smem + L::B);
  // Level 1: dS (bf16); level 2: the raw K slice, its transpose, the codes,
  // the rows' scales and the slab halves' maxima.
  uint8_t* ptile = reinterpret_cast<uint8_t*>(smem + L::P);
  uint8_t* bt = reinterpret_cast<uint8_t*>(smem + L::H);
  uint8_t* codes = bt + SLICE * OLD;
  float* rs = smem + L::SC;
  float* amx = smem + L::S;

  // An owner thread's rows: r0 + 16 (warp % 4) + lane / 4 + 8 i.
  float qs[2], lrow[2], drow[2], dvs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    const bool live = r < Sq;
    qs[i] = live ? a.qsc[bh * Sq + r] : 0.f;
    lrow[i] = live ? a.lse[bh * Sq + r] : 0.f;
    drow[i] = live ? a.di[bh * Sq + r] : 0.f;
    dvs[i] = live ? a.dovsc[bh * Sq + r] : 0.f;
  }
  typename P::Acc acc;
  P::zero(acc);
  int isum[L2 ? 64 : 1];  // level 2: the span's int32 product
#pragma unroll
  for (int k = 0; k < (L2 ? 64 : 1); ++k) isum[k] = 0;
  const I8Rows qsrc = i8_rows(a.qq, bh, Sq, D, r0, Sq);
  const I8Rows dosrc = i8_rows(a.dov, bh, Sq, D, r0, Sq);
  const int span = L2 ? a.width : max(Skv, 1);

  for (int c0 = 0; c0 < Skv; c0 += span) {
    const int c_end = min(c0 + span, Skv);
    const int passes = L2 && span > TILE ? 2 : 1;
    float run[2] = {0.f, 0.f};
    for (int pass = 0; pass < passes; ++pass) {
      const bool last = pass == passes - 1;
      for (int t0 = c0; t0 < c_end; t0 += TILE) {
        const I8Rows ksrc = i8_rows(a.kq, bk, Skv, D, t0, c_end);
        if (last) {
          if constexpr (L2)
            fetch_i8_slice(ksrc, l0, ptile);
          else
            P::fetch(ksrc, l0, smem + L::H);
        }
        int si[4][4], dpi[4][4];
        ring_pair(sh.nq, sh.lo, ra, rb, qsrc, ksrc, dosrc,
                  i8_rows(a.vq, bk, Skv, D, t0, c_end), si, dpi);
        if (L2 && last) {
          mfa::cp_async_wait<0>();
          __syncthreads();  // the raw slice landed
          mfa::fi_rows_t<SLICE, 256, TILE>(ptile, bt);
        }
        put_partials(part, si, dpi);
        cluster_sync(sh.C);  // every CTA's partials stored
        float ds[4][4];      // [j][e]: row lane / 4 + 8 (e / 2), column
                             // 32 (warp / 4) + 8 j + 2 (lane % 4) + e % 2
        if (owned) {
          float k_s[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col =
                  t0 + 32 * (warp >> 2) + 8 * j + 2 * (lane & 3) + c;
              k_s[j][c] = (ks && col < c_end) ? ks[col] : 1.f;
            }
          if (sh.C > 1) add_partials(part, sh, si, dpi);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              const int col =
                  t0 + 32 * (warp >> 2) + 8 * j + 2 * (lane & 3) + (e & 1);
              const bool in = col < c_end;
              float s = (float)si[j][e] * qs[i];
              if (ks) s *= k_s[j][e & 1];
              const float p = in ? expf(s - lrow[i]) : 0.f;
              // Level 2 rounds dP dovsc before D is taken off, as the
              // plain version's separate products do, so that its codes
              // are the plain version's; level 1 keeps the parent's bits.
              float d;
              if constexpr (L2)
                d = p * (__fmul_rn((float)dpi[j][e], dvs[i]) - drow[i]);
              else
                d = p * ((float)dpi[j][e] * dvs[i] - drow[i]);
              if (ks) d *= k_s[j][e & 1];
              ds[j][e] = d;
            }
          if (!L2 && last) store_bf16_tile(ds, ptile);
        }
        if constexpr (L2) {
          float am[2];
          row_maxima(ds, owned, pass == 0, t0 == c0, last, run, amx, am);
          if (last && owned) store_code_tile(ds, am, codes, rs);
        }
        cluster_sync(sh.C);  // the owners' tiles stored; partials read
        if (!last) continue;
        if constexpr (L2) {
          gather_slabs(codes, OLD, TILE, sh);
          gather_scales(rs, sh);
          __syncthreads();
          mul_s8<true>(codes, bt, rs, acc.v, isum);
          if (t0 + TILE >= c_end) flush_span(acc.v, isum, rs);
        } else {
          gather_slabs(ptile, PRB, 2 * TILE, sh);
          P::slice(reinterpret_cast<float*>(ptile), ksrc, l0, D,
                   smem + L::H, nullptr, ty, tx, acc);
        }
      }
    }
  }

  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r < Sq && l0 + d < D)
      *reinterpret_cast<float2*>(a.out0 + (bh * Sq + r0 + r) * D + l0 + d) =
          make_float2(v0 * a.store, v1 * a.store);
  });
  // A CTA leaves only once its peers have read its tiles.
  if (sh.C > 1) cg::this_cluster().sync();
}

// Replaces _dkv_fullint_kernel above D = 576.  One CTA per (64 keys, kv
// head x slice, b x split), a head's slices in clusters of C (y), owns its
// keys' dK and dV over its slice and walks its split of the GQA group x
// every query row (the path has no mask) in 64-row steps, a level-2 span
// of `width` queries at a time (each tile's int32 products scaled): S^T
// and dP^T split over the cluster as the dQ's S and dP, the owners of each
// 16-key slab computing P^T dorsc and dS^T for every CTA.
template <bool L2>
__global__ void __launch_bounds__(256)
split_d_fullint_dkv_kernel(const FullintArgs a, int splits, float* ws) {
  using L = Smem<64, 2>;
  using P = PV<__nv_bfloat16, 64>;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int c0 = blockIdx.x * 64;
  const int hk = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int group = a.Hq / a.Hkv;
  const int per = (group + splits - 1) / splits;
  const int g_lo = min(sp * per, group);
  const int g_hi = min(g_lo + per, group);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const Share sh = share_of(D);
  const bool owned = owner(warp & 3, sh.C) == sh.rank;
  int* part = reinterpret_cast<int*>(smem + L::BYTES / 4);
  uint8_t* ra = reinterpret_cast<uint8_t*>(smem + L::A);
  uint8_t* rb = reinterpret_cast<uint8_t*>(smem + L::B);
  // Level 1: P' and dS' (bf16, keys x queries) and the slices of dO and Q;
  // level 2: the raw slices of dO and Q, their transposes, the codes of P
  // and dS, their rows' scales and the slab halves' maxima.
  uint8_t* ptile = reinterpret_cast<uint8_t*>(smem + L::P);
  uint8_t* dst = ptile + TILE * L::PLD * 4;
  float* h_do = smem + L::H;
  float* h_q = h_do + TILE * HLD;
  uint8_t* bt_do = reinterpret_cast<uint8_t*>(h_do);
  uint8_t* bt_q = reinterpret_cast<uint8_t*>(h_q);
  uint8_t* codes_p = bt_do + SLICE * OLD;
  uint8_t* codes_s = bt_q + SLICE * OLD;
  float* rs_p = smem + L::SC;
  float* rs_s = rs_p + TILE;
  float* amx_p = smem + L::S;
  float* amx_s = amx_p + 2 * TILE;

  // An owner thread's keys: c0 + 16 (warp % 4) + lane / 4 + 8 i.
  float ksr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    ksr[i] = (a.ks && key < Skv) ? a.ks[bk * Skv + key] : 1.f;
  }
  typename P::Acc dk, dv;
  P::zero(dk);
  P::zero(dv);
  int none[1];
  const I8Rows ksrc = i8_rows(a.kq, bk, Skv, D, c0, Skv);
  const I8Rows vsrc = i8_rows(a.vq, bk, Skv, D, c0, Skv);
  const int span = L2 ? a.width : max(Sq, 1);

  for (int g = g_lo; g < g_hi; ++g) {
    const int hq = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + hq;
    for (int q0 = 0; q0 < Sq; q0 += span) {
      const int q_end = min(q0 + span, Sq);
      const int passes = L2 && span > TILE ? 2 : 1;
      float run_p[2] = {0.f, 0.f}, run_s[2] = {0.f, 0.f};
      for (int pass = 0; pass < passes; ++pass) {
        const bool last = pass == passes - 1;
        for (int r0 = q0; r0 < q_end; r0 += TILE) {
          const I8Rows qsrc = i8_rows(a.qq, bh, Sq, D, r0, q_end);
          const I8Rows dorsrc = i8_rows(a.dor, bh, Sq, D, r0, q_end);
          if (last) {
            if constexpr (L2) {
              fetch_i8_slice(dorsrc, l0, ptile);
              fetch_i8_slice(qsrc, l0, dst);
            } else {
              P::fetch(dorsrc, l0, h_do);
              P::fetch(qsrc, l0, h_q);
            }
          }
          int st[4][4], dpt[4][4];
          ring_pair(sh.nq, sh.lo, ra, rb, ksrc, qsrc, vsrc,
                    i8_rows(a.dov, bh, Sq, D, r0, q_end), st, dpt);
          if (L2 && last) {
            mfa::cp_async_wait<0>();
            __syncthreads();  // the raw slices landed
            mfa::fi_rows_t<SLICE, 256, TILE>(ptile, bt_do);
            mfa::fi_rows_t<SLICE, 256, TILE>(dst, bt_q);
          }
          put_partials(part, st, dpt);
          cluster_sync(sh.C);  // every CTA's partials stored
          float pd[4][4], dsv[4][4];  // [j][e]: key lane / 4 + 8 (e / 2),
                                      // query 32 (warp / 4) + 8 j + 2 (lane
                                      // % 4) + e % 2
          if (owned) {
            float qs[4][2], lcol[4][2], dcol[4][2], dors[4][2], dovs[4][2];
            bool in[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int r =
                    r0 + 32 * (warp >> 2) + 8 * j + 2 * (lane & 3) + c;
                in[j][c] = r < q_end;
                const size_t o = bh * Sq + (in[j][c] ? r : 0);
                qs[j][c] = a.qsc[o];
                lcol[j][c] = a.lse[o];
                dcol[j][c] = a.di[o];
                dors[j][c] = a.dorsc[o];
                dovs[j][c] = a.dovsc[o];
              }
            if (sh.C > 1) add_partials(part, sh, st, dpt);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = e >> 1, c = e & 1;
                float s = (float)st[j][e] * qs[j][c];
                if (a.ks) s *= ksr[i];
                const float p = in[j][c] ? expf(s - lcol[j][c]) : 0.f;
                if constexpr (L2)  // rounded as the dQ's level 2 rounds
                  dsv[j][e] = p *
                              (__fmul_rn((float)dpt[j][e], dovs[j][c]) -
                               dcol[j][c]) *
                              qs[j][c];
                else
                  dsv[j][e] =
                      p * ((float)dpt[j][e] * dovs[j][c] - dcol[j][c]) *
                      qs[j][c];
                pd[j][e] = p * dors[j][c];
              }
            if (!L2 && last) {
              store_bf16_tile(pd, ptile);
              store_bf16_tile(dsv, dst);
            }
          }
          if constexpr (L2) {
            float am_p[2], am_s[2];
            row_maxima(pd, owned, pass == 0, r0 == q0, last, run_p, amx_p,
                       am_p);
            row_maxima(dsv, owned, pass == 0, r0 == q0, last, run_s, amx_s,
                       am_s);
            if (last && owned) {
              store_code_tile(pd, am_p, codes_p, rs_p);
              store_code_tile(dsv, am_s, codes_s, rs_s);
            }
          }
          cluster_sync(sh.C);  // the owners' tiles stored; partials read
          if (!last) continue;
          if constexpr (L2) {
            gather_slabs(codes_p, OLD, TILE, sh);
            gather_slabs(codes_s, OLD, TILE, sh);
            gather_scales(rs_p, sh);
            gather_scales(rs_s, sh);
            __syncthreads();
            mul_s8<false>(codes_p, bt_do, rs_p, dv.v, none);
            mul_s8<false>(codes_s, bt_q, rs_s, dk.v, none);
          } else {
            gather_slabs(ptile, PRB, 2 * TILE, sh);
            gather_slabs(dst, PRB, 2 * TILE, sh);
            P::slice(reinterpret_cast<float*>(ptile), dorsrc, l0, D, h_do,
                     nullptr, ty, tx, dv);
            P::slice(reinterpret_cast<float*>(dst), qsrc, l0, D, h_q,
                     nullptr, ty, tx, dk);
          }
        }
      }
    }
  }

  const size_t n = (size_t)gridDim.z / splits * a.Hkv * Skv * D;
  float* out_k = splits > 1 ? ws + (2 * (size_t)sp) * n : a.out0;
  float* out_v = splits > 1 ? ws + (2 * (size_t)sp + 1) * n : a.out1;
  const auto put = [&](float* out, int r, int d, float v0, float v1) {
    if (c0 + r < Skv && l0 + d < D)
      *reinterpret_cast<float2*>(out + (bk * Skv + c0 + r) * D + l0 + d) =
          make_float2(v0, v1);
  };
  P::each(dk, ty, tx, [&](int r, int d, float v0, float v1) {
    put(out_k, r, d, v0 * a.store, v1 * a.store);
  });
  P::each(dv, ty, tx, [&](int r, int d, float v0, float v1) {
    put(out_v, r, d, v0, v1);
  });
  if (sh.C > 1) cg::this_cluster().sync();
}

// Replaces _dq_kernel's quantized modes above D = 576 (the body:
// split_d_frame.cuh::split_d_dq over PayloadKV; RING: whole payload rows
// through the raw path, bf16 only).
template <typename T, bool RING>
__global__ void __launch_bounds__(256)
split_d_qdq_kernel(const FlashArgs a, const PayloadKV<RING> kv) {
  split_d_dq<T>(a, kv);
}

// Replaces _dkv_kernel's quantized modes above D = 576 (the body:
// split_d_frame.cuh::split_d_dkv over PayloadKV; RING as above; RES_K: K's
// 64 raw rows resident in shared memory past Smem<64, 2>).
template <typename T, bool RING, bool RES_K = false>
__global__ void __launch_bounds__(256)
split_d_qdkv_kernel(const FlashArgs a, const PayloadKV<RING> kv, int splits,
                    float* ws) {
  split_d_dkv<T, PayloadKV<RING>, RES_K>(a, kv, splits, ws);
}

// The shared memory a CTA may have (an H100's 232,448 bytes).
constexpr size_t SMEM_OPTIN = 232448;

// Whether both payloads are whole 16-byte rows (int8; int4 where D is a
// multiple of 32), which a bf16 Q reads through the raw path: the forward's
// test (split_d_quantized.cu::qattn_of).
bool ring_rows(const FlashArgs& a, const QuantKV& q) {
  return a.D % 32 == 0 || (q.bits_k == 8 && q.bits_v == 8);
}

template <typename T>
int qdq_of(const FlashArgs& a, const QuantKV& q, cudaStream_t stream) {
  const dim3 grid((a.Sq + 63) / 64, a.Hq * mfa_sd::slices(a.D),
                  a.B * a.splits);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (ring_rows(a, q))
      return mfa::launch_with_smem(split_d_qdq_kernel<T, true>, grid, 256,
                                   Smem<64, 1>::BYTES, stream, a,
                                   PayloadKV<true>{q});
  return mfa::launch_with_smem(split_d_qdq_kernel<T, false>, grid, 256,
                               Smem<64, 1>::BYTES, stream, a,
                               PayloadKV<false>{q});
}

template <typename T>
int qdkv_of(const FlashArgs& a, const QuantKV& q, int splits, float* ws,
            cudaStream_t stream) {
  const dim3 grid((a.Skv + 63) / 64, a.Hkv * mfa_sd::slices(a.D),
                  a.B * splits);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (ring_rows(a, q)) {
      const size_t res = Smem<64, 2>::BYTES + kv_resident_bytes(q.bits_k,
                                                                a.D);
      if (res <= SMEM_OPTIN)
        return mfa::launch_with_smem(split_d_qdkv_kernel<T, true, true>,
                                     grid, 256, res, stream, a,
                                     PayloadKV<true>{q}, splits, ws);
      return mfa::launch_with_smem(split_d_qdkv_kernel<T, true>, grid, 256,
                                   Smem<64, 2>::BYTES, stream, a,
                                   PayloadKV<true>{q}, splits, ws);
    }
  return mfa::launch_with_smem(split_d_qdkv_kernel<T, false>, grid, 256,
                               Smem<64, 2>::BYTES, stream, a,
                               PayloadKV<false>{q}, splits, ws);
}

// Shared memory of the full-integer pair: the frame's and the int32
// partials of S and dP (put_partials).
constexpr size_t FI_DQ_SMEM = Smem<64, 1>::BYTES + XS_BYTES;
constexpr size_t FI_DKV_SMEM = Smem<64, 2>::BYTES + XS_BYTES;

// Whether the card holds a cluster (1, C, 1) of kern's CTAs with `smem`
// bytes each (cudaOccupancyMaxActiveClusters; above 8 a non-portable
// size).
template <typename K>
bool takes_cluster(K kern, size_t smem, int C) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, C, 1);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const bool ok =
      mfa::set_smem(kern, smem) == cudaSuccess &&
      (C <= 8 || cudaFuncSetAttribute(
                     kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                     1) == cudaSuccess) &&
      cudaOccupancyMaxActiveClusters(&n, (void*)kern, &cfg) == cudaSuccess &&
      n > 0;
  if (!ok) cudaGetLastError();  // the query's error is not the launch's
  return ok;
}

// The cluster size a kernel launches with at head dim D: the plan
// (mfa_sd::fullint_cluster) or, where the card holds no cluster of that
// size, the next smaller divisor of the slices.  known: the card's answers
// for this kernel by size (0 not asked yet).
template <typename K>
int card_cluster(K kern, size_t smem, int D,
                 signed char (&known)[mfa_sd::MAX_FULLINT_CLUSTER + 1]) {
  for (int c = mfa_sd::fullint_cluster(D); c > 1;
       c = mfa_sd::fullint_cluster(D, c - 1)) {
    if (!known[c]) known[c] = takes_cluster(kern, smem, c) ? 1 : -1;
    if (known[c] > 0) return c;
  }
  return 1;
}

template <bool L2>
int dq_cluster(int D) {
  static signed char known[mfa_sd::MAX_FULLINT_CLUSTER + 1];
  return card_cluster(split_d_fullint_dq_kernel<L2>,
                      FI_DQ_SMEM, D, known);
}

template <bool L2>
int dkv_cluster(int D) {
  static signed char known[mfa_sd::MAX_FULLINT_CLUSTER + 1];
  return card_cluster(split_d_fullint_dkv_kernel<L2>, FI_DKV_SMEM, D, known);
}

// kern over `grid` in clusters (1, C, 1) of 256-thread CTAs with `smem`
// bytes each (no cluster where C = 1); the launch's cudaError_t.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kern)(KArgs...), dim3 grid, size_t smem, int C,
                   cudaStream_t stream, const Args&... args) {
  cudaError_t err = mfa::set_smem(kern, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool L2>
int fullint_of(bool dq, const FullintArgs& a, int splits, float* ws,
               cudaStream_t stream) {
  const int nsl = mfa_sd::slices(a.D);
  if (dq)
    return launch_cluster(split_d_fullint_dq_kernel<L2>,
                          dim3((a.Sq + 63) / 64, a.Hq * nsl, a.B),
                          FI_DQ_SMEM, dq_cluster<L2>(a.D), stream, a);
  return launch_cluster(split_d_fullint_dkv_kernel<L2>,
                        dim3((a.Skv + 63) / 64, a.Hkv * nsl, a.B * splits),
                        FI_DKV_SMEM, dkv_cluster<L2>(a.D), stream, a,
                        splits, ws);
}

}  // namespace

namespace mfa_sd {

int launch_qdq(int dtype, const FlashArgs& a, const QuantKV& kv,
               cudaStream_t stream) {
  if (!takes(a.D) || a.splits < 1 || a.splits > MAX_FWD_SPLITS ||
      (a.splits > 1 && !a.ws))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return qdq_of<float>(a, kv, stream);
  if (dtype == 1) return qdq_of<__nv_bfloat16>(a, kv, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_qdkv(int dtype, const FlashArgs& a, const QuantKV& kv, int splits,
                float* ws, cudaStream_t stream) {
  if (!takes(a.D) || splits < 1 || splits > a.Hq / a.Hkv ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return qdkv_of<float>(a, kv, splits, ws, stream);
  if (dtype == 1) return qdkv_of<__nv_bfloat16>(a, kv, splits, ws, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_fullint(bool dq, const FullintArgs& a, int splits, float* ws,
                   cudaStream_t stream) {
  if (!takes(a.D) || a.width < 0 || splits < 1 || splits > a.Hq / a.Hkv ||
      (splits > 1 && (dq || !ws)))
    return (int)cudaErrorInvalidValue;
  if (a.width == 0) return fullint_of<false>(dq, a, splits, ws, stream);
  return fullint_of<true>(dq, a, splits, ws, stream);
}

}  // namespace mfa_sd

extern "C" {

// The cluster size the full-integer dQ (dq 1) or dK/dV (dq 0) launches with
// at level 1 (level2 0) or 2 and head dim D (a multiple of 16 above 576):
// ops/flash_attention_bwd.py::split_d_fullint_cluster's plan where the card
// holds such a cluster; -1 for another D.
int mfa_split_d_fullint_cluster(int D, int dq, int level2) {
  if (!mfa_sd::takes(D)) return -1;
  if (dq) return level2 ? dq_cluster<true>(D) : dq_cluster<false>(D);
  return level2 ? dkv_cluster<true>(D) : dkv_cluster<false>(D);
}

// CTAs an SM the occupancy API gives split_d_qdq_kernel (dkv 0) or
// split_d_qdkv_kernel (dkv 1) for dtype (0 fp32, 1 bf16) and ring (0 the
// staged payloads, 1 the raw path: bf16 only; 2 the dK/dV's raw path with
// K resident, at head dim D for an int8 K); -1 for none.
int mfa_split_d_qbwd_ctas_per_sm(int dkv, int dtype, int ring, int D) {
  if (ring < 0 || ring > 2 || (ring == 2 && !dkv)) return -1;
  if (dtype == 0)
    return ring ? -1
           : dkv ? ctas_per_sm<2>(split_d_qdkv_kernel<float, false>)
                 : ctas_per_sm<1>(split_d_qdq_kernel<float, false>);
  if (dtype != 1) return -1;
  using B16 = __nv_bfloat16;
  if (ring == 2)
    return ctas_per_sm<2>(split_d_qdkv_kernel<B16, true, true>,
                          kv_resident_bytes(8, D));
  if (dkv)
    return ring ? ctas_per_sm<2>(split_d_qdkv_kernel<B16, true>)
                : ctas_per_sm<2>(split_d_qdkv_kernel<B16, false>);
  return ring ? ctas_per_sm<1>(split_d_qdq_kernel<B16, true>)
              : ctas_per_sm<1>(split_d_qdq_kernel<B16, false>);
}

}  // extern "C"

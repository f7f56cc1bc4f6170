// The split-D attention kernels for Hopper (sm_90a): the flash forward, dQ
// and dK/dV and the paged decode and prefill at every head dim above 576,
// with no width table: the head dim is a run-time value.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu) above D = 576:
//   - ops/flash_attention.py::_fwd_kernel        -> split_d_fwd_kernel
//   - ops/flash_attention_bwd.py::_dq_kernel     -> split_d_dq_kernel
//   - ops/flash_attention_bwd.py::_dkv_kernel    -> split_d_dkv_kernel
//     (then csrc/flash_attention.cu::flash_dkv_merge_kernel where the GQA
//     group is split)
//   - serving/paged_attention.py::_decode_kernel_streamed and
//     ::_decode_kernel                            -> split_d_decode_kernel
//     (then csrc/paged_attention.cu::paged_decode_merge_kernel where the KV
//     axis is split)
//   - serving/paged_attention.py::_prefill_kernel -> split_d_prefill_kernel
// The fixed-width kernels of csrc/flash_attention.cu and
// csrc/paged_attention.cu hold Q and whole K / V tiles in shared memory
// (the 576 latent forward uses 230,400 of 232,448 bytes), so nothing wider
// fits them; their routers call the launchers here for D > 576 (split_d.cuh).
//
// The frame, one for all five kernels:
//   - A CTA owns SLICE = 256 lanes of the output (O, dQ, or dK and dV) of
//     64 rows (16 in the decode): grid axis "slices" = ceil(D / 256).  256,
//     not 128: a thread then holds 4 rows x 16 output lanes (64 fp32, 128
//     for dK and dV), and the scores are recomputed ceil(D / 256) times
//     instead of ceil(D / 128).
//   - The scores S = Q.K^T (and, in the backward, dP = dO.V^T) are summed
//     over the WHOLE head dim in 32-lane chunks of the row tile and the
//     key tile: bf16 rows stream through a 4-stage cp.async ring (three
//     chunks in flight while one is multiplied); fp32 rows and the page
//     pools' rows (gathered by page id, int8 / int4 widened) are loaded
//     and stored into one of two buffers, so a fast warp loads the next
//     chunk while a slow one still multiplies this one (one barrier a
//     chunk).  No Q or K tile is ever held whole: nothing bounds D but
//     device memory.
//   - P (or dS) goes to shared memory and multiplies the CTA's own slice
//     of V (dO, K or Q): for bf16 the whole 256-lane slice, fetched at the
//     start of the tile (by cp.async for bf16 rows, under the scores); for
//     fp32 128 lanes at a time.
//   - Every slice of a row tile runs the same score code in the same chunk
//     order, so its m, l, S, P and dS are the same bits in every slice:
//     each slice normalises its own O lanes by the same l, and the
//     decode's merge combines every lane by the same m and l.  Only slice
//     0 writes L (the forward), dbias (dQ) and the decode's m and l.
//   - The price: the scores are recomputed once a slice.  The forward and
//     the paged kernels do 2 * D * slices + 2 * D operations a pair
//     instead of 4 * D (2.5x at D = 1024), dQ 4 * D * slices + 2 * D
//     instead of 6 * D, dK/dV 4 * D * slices + 4 * D instead of 8 * D.
// The products: for bf16 (and the int8 / int4 pools under a bf16 q, whose
// integers bf16 holds exactly) bf16 mma.sync m16n8k16 into fp32, the
// chunks and the slice staged as bf16 rows (scores, PV); for fp32 scalar
// fp32 FMAs (TF32 would break the 2e-5 gate).  The softmax and the masks
// run in one thread layout for both, 4 x 4 scores a thread (rows 4 ty + i,
// keys tx + 16 j), with the tensor-core sums crossing to it through shared
// memory.  What bounds them: the tensor-core operations in bf16 (the flash
// trio, the prefill) and the KV bytes (the decode).
//
// Numerics are those of the fixed-width kernels they extend (the file
// comments of csrc/flash_attention.cu, attention_bwd.cuh and
// csrc/paged_attention.cu), with the plain versions in
// ops/flash_attention.py, ops/flash_attention_bwd.py and
// serving/paged_attention.py: q pre-scaled and rounded to T; the flash
// forward in base 2 with bias * log2(e) then masked scores set to
// mask_value, P rounded to T before P.V, l summing the unrounded p, the
// static-max mode (row_max) without a running max; the backward in base e
// with L = -inf read as 0, dS = P (dP - D), dQ = scale round_T(dS).K, dV =
// round_T(P)^T.dO, dK = round_T(dS)^T.Q_s; the paged kernels in base e,
// the K scale on S, the V scale on P before its rounding, O's lanes from
// dp - vtz zero (P.V skips them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "split_d.cuh"

namespace {

using mfa::Elem;
using mfa::LN2;
using mfa::LOG2E;
using mfa_sd::FlashArgs;
using mfa_sd::PagedArgs;
using mfa_sd::SLICE;

constexpr int TILE = 64;          // keys a tile (query rows in dK/dV)
constexpr int DC = 32;            // head-dim lanes a chunk of the scores
constexpr int HALF = SLICE / 2;   // slice lanes staged at once
constexpr int CLD = DC + 4;       // floats a staged chunk row
constexpr int HLD = HALF + 4;     // floats a staged slice row
constexpr int EB = HALF / 32;     // float2 output steps a thread a half
constexpr int KV_FLOAT = 0, KV_INT8 = 1, KV_INT4 = 2;

constexpr int CRB = 2 * DC + 16;     // bytes a staged bf16 chunk row
constexpr int NS = 4;                // stages of the bf16 chunk ring
constexpr int SRB = 2 * SLICE + 16;  // bytes a staged bf16 slice row

// Shared memory (floats) of a CTA of RT rows: the chunk buffers of the row
// tile and of the key tile (fp32 rows [2][rows][CLD], or NS stages of bf16
// rows of CRB bytes for the tensor-core scores), NP slice buffers ([TILE]
// fp32 rows of HLD floats, half a slice at a time, or the whole slice as
// bf16 rows of SRB bytes), NP score tiles P^T [TILE][RT + 4]
// (column-major: row r of column c at c * (RT + 4) + r; row-major bf16 for
// the tensor cores), the tile's K and V scales [2][TILE], the tensor-core
// scores' exchange tile S [TILE][RT + 4] (column-major) and each row's
// rescale alpha and output multiplier [2][RT].
template <int RT, int NP>
struct Smem {
  static constexpr int PLD = RT + 4;
  static constexpr int A = 0;
  static constexpr int B = A + NS * RT * CRB / 4;
  static constexpr int H = B + NS * TILE * CRB / 4;
  static constexpr int P = H + NP * TILE * HLD;
  static constexpr int SC = P + NP * TILE * PLD;
  static constexpr int S = SC + 2 * TILE;
  static constexpr int E = S + TILE * PLD;  // [RT] alpha, then [RT] 1 / l
  static constexpr size_t BYTES = (E + 2 * RT) * sizeof(float);
  static_assert(NS * CRB >= 2 * CLD * 4 && TILE * SRB <= TILE * HLD * 4,
                "the bf16 layouts and the fp32 ones share each buffer");
};

// ---------------------------------------------------------------------------
// Sources: four lanes [l, l + 4) of a row as fp32, zeros outside
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows [row0, row0 + n) of a [rows, D] matrix of T (D a multiple of 16),
// zeros from row `limit`; SCALE: x -> round_T(x * scale), as
// attention_tiles.cuh::stage_t rounds Q_s.  bf16 rows are ASYNC: copy8
// copies 8 lanes as they are by cp.async and the products scale the
// fragments they read (scale_bf16x2: the same bits).
template <typename T, bool SCALE_>
struct Rows {
  static constexpr bool ASYNC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool SCALE = SCALE_;
  const T* base;
  int row0, limit, D;
  float scale;
  __device__ __forceinline__ void copy8(int r, int l, uint8_t* dst) const {
    const bool ok = row0 + r < limit && l < D;
    mfa::cp_async16(dst, base + (ok ? (size_t)(row0 + r) * D + l : 0),
                    ok ? 16 : 0);
  }
  __device__ __forceinline__ float4 operator()(int r, int l) const {
    if (row0 + r >= limit || l >= D) return make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = load4(base + (size_t)(row0 + r) * D + l);
    if (SCALE) {
      v.x = Elem<T>::round(v.x * scale);
      v.y = Elem<T>::round(v.y * scale);
      v.z = Elem<T>::round(v.z * scale);
      v.w = Elem<T>::round(v.w * scale);
    }
    return v;
  }
};

template <typename T, int MODE>
struct PoolElem {
  using S = T;
};
template <typename T>
struct PoolElem<T, KV_INT8> {
  using S = int8_t;
};
template <typename T>
struct PoolElem<T, KV_INT4> {
  using S = int8_t;
};

// One pool element as its fp32 value: float and int8 as they are; the int4
// byte's K (low nibble, minus 8) or V (the signed high nibble).
template <int MODE, typename S>
__device__ __forceinline__ float pool_value(S x, bool is_v) {
  if constexpr (MODE == KV_INT4) {
    const int b = (int)x;
    return (float)(is_v ? (b >> 4) : ((b & 0xF) - 8));
  } else if constexpr (MODE == KV_INT8) {
    return (float)x;
  } else {
    return Elem<S>::load(&x);
  }
}

// Token rows [t0, t0 + n) of one KV head of a page pool, read as they lie
// (rows of dp elements): K's rows, or V's (is_v: v_row rows on, or the int4
// byte's high nibble); zeros from token `lim` and from lane `lanes` (dp
// for K, dp - vtz for V).  Four-lane vector loads where the pool's rows
// keep them aligned (dp a multiple of 4), else element loads.  WHOLE: a
// bf16 float pool of whole 16-byte rows (dp a multiple of 8), whose rows
// are ASYNC: copy8 copies 8 lanes by cp.async (the piece that straddles
// dp - vtz copies V's lanes past it too: O's lanes there are stored as 0,
// and each O lane reads only its own V lane).
template <typename T, int MODE, bool WHOLE = false>
struct Tokens {
  static constexpr bool ASYNC = WHOLE && MODE == KV_FLOAT &&
                                std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool SCALE = false;
  static constexpr float scale = 1.f;
  using S = typename PoolElem<T, MODE>::S;
  const S* kv;
  const int32_t* table;
  size_t head_base;
  int num_pages_total, PT, rows, dp;
  size_t v_off;  // V's first element from K's (0 when K is V)
  int t0, lim, lanes;
  bool is_v;
  __device__ __forceinline__ void copy8(int t, int l, uint8_t* dst) const {
    const int pos = t0 + t;
    const bool ok = pos < lim && l < lanes;
    const S* p = kv;
    if (ok) {
      const int page = min(max(table[pos / PT], 0), num_pages_total - 1);
      p += ((head_base + page) * rows + pos % PT) * (size_t)dp + l +
           (is_v ? v_off : 0);
    }
    mfa::cp_async16(dst, p, ok ? 16 : 0);
  }
  __device__ __forceinline__ float4 operator()(int t, int l) const {
    const int pos = t0 + t;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (pos < lim && l < lanes) {
      const int page =
          min(max(table[pos / PT], 0), num_pages_total - 1);
      const S* p = kv + ((head_base + page) * rows + pos % PT) * (size_t)dp +
                   l + (is_v && MODE != KV_INT4 ? v_off : 0);
      if ((dp & 3) == 0 && l + 4 <= lanes) {
        if constexpr (MODE == KV_FLOAT) {
          return load4(p);
        } else {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = pool_value<MODE>((S)(int8_t)(w >> (8 * e)), is_v);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (l + e < lanes) f[e] = pool_value<MODE>(p[e], is_v);
      }
    }
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

// ---------------------------------------------------------------------------
// The frame's two steps
// ---------------------------------------------------------------------------

// A bf16x2 register with each value x -> round_bf16(x * scale), the bits
// of Elem<bf16>::round(x * scale) (mma.cuh's bf16_bits).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float scale) {
  const float lo = __fmul_rn(__uint_as_float(w << 16), scale);
  const float hi = __fmul_rn(__uint_as_float(w & 0xFFFF0000u), scale);
  return __byte_perm(mfa::bf16_bits(lo), mfa::bf16_bits(hi), 0x7632);
}

// acc[j] += A[ar0, ar0 + 16) . B[br0 + 8j, br0 + 8j + 8)^T over one DC-lane
// chunk (attention_bwd.cuh::mma_nt, KC = DC / 16, NB = 4), the fragments of
// A (SA) or B (SB) scaled as they are read.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_chunk(const uint8_t* A, int ar0,
                                          const uint8_t* B, int br0,
                                          float (&acc)[4][4], float sa,
                                          float sb) {
  const int lane = threadIdx.x & 31;
  const uint8_t* ap =
      A + (ar0 + mfa::ldsm_a_row(lane)) * CRB + mfa::ldsm_a_byte(lane);
  const uint8_t* bp =
      B + (br0 + mfa::ldsm_b_row(lane)) * CRB + mfa::ldsm_b_byte(lane);
#pragma unroll
  for (int kc = 0; kc < DC / 16; ++kc) {
    uint32_t af[4];
    mfa::ldsm_x4(af, ap + kc * 32);
    if constexpr (SA) {
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = scale_bf16x2(af[e], sa);
    }
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      uint32_t bf[4];
      mfa::ldsm_x4(bf, bp + j2 * 16 * CRB + kc * 32);
      if constexpr (SB) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bf[e] = scale_bf16x2(bf[e], sb);
      }
      mfa::mma_bf16(acc[2 * j2], af, bf[0], bf[1], acc[2 * j2]);
      mfa::mma_bf16(acc[2 * j2 + 1], af, bf[2], bf[3], acc[2 * j2 + 1]);
    }
  }
}

// s[i][j] = sum over lanes [0, nch * DC) of a(4 ty + i, l) * b(tx + 16 j, l):
// each 32-lane chunk of the RT-row tile and of the TILE-row tile staged in
// one of two buffers by all RT * 4 threads, then multiplied (one barrier a
// chunk: a chunk's buffer was last read two chunks back, before the
// barrier of the chunk between).  T = bf16 (every source is bf16 or an
// integer that bf16 holds exactly): the chunks are staged as bf16 rows and
// multiplied by bf16 mma.sync m16n8k16 into fp32, warp w taking rows
// 16 (w % (RT / 16)) + [0, 16) and keys 32 (w / (RT / 16)) + [0, 32); the
// sums cross to the thread layout through sbuf.  Two bf16 row sources
// (the flash kernels) stream through an NS-stage cp.async ring instead,
// Q's scale applied to the fragments as they are read.  T = float: scalar fp32
// FMAs, as the 2e-5 gate wants (TF32 would break it).  The order of the
// sums depends on nothing but the lanes, so every slice's CTA gets the
// same bits.  Ends with a barrier, so the caller may restage either
// buffer.
template <typename T, int RT, typename SA, typename SB>
__device__ __forceinline__ void scores(int nch, float* bufa, float* bufb,
                                       float* sbuf, const SA& sa,
                                       const SB& sb, int ty, int tx,
                                       float (&s)[4][4]) {
  constexpr int NTH = RT * 4;
  constexpr int PR = DC / 4;  // four-lane pieces a chunk row
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  if constexpr (TC) {
    const int warp = threadIdx.x >> 5;
    const int slab = warp % (RT / 16), half = warp / (RT / 16);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    uint8_t* ra = reinterpret_cast<uint8_t*>(bufa);
    uint8_t* rb = reinterpret_cast<uint8_t*>(bufb);
    if constexpr (SA::ASYNC && SB::ASYNC) {
      // Both bf16 rows: an NS-stage cp.async ring, NS - 1 chunks in flight
      // while one is multiplied; Q_s's scale applied to the fragments.
      const auto issue = [&](int c) {
        uint8_t* a = ra + (c % NS) * RT * CRB;
        uint8_t* b = rb + (c % NS) * TILE * CRB;
        const int l0 = c * DC;
        for (int i = threadIdx.x; i < RT * (DC / 8); i += NTH) {
          const int r = i / (DC / 8), l = (i % (DC / 8)) * 8;
          sa.copy8(r, l0 + l, a + r * CRB + 2 * l);
        }
        for (int i = threadIdx.x; i < TILE * (DC / 8); i += NTH) {
          const int r = i / (DC / 8), l = (i % (DC / 8)) * 8;
          sb.copy8(r, l0 + l, b + r * CRB + 2 * l);
        }
      };
#pragma unroll
      for (int c = 0; c < NS - 1; ++c) {
        if (c < nch) issue(c);
        mfa::cp_async_commit();
      }
      for (int c = 0; c < nch; ++c) {
        mfa::cp_async_wait<NS - 2>();
        __syncthreads();  // chunk c landed; chunk c - 1's readers done
        if (c + NS - 1 < nch) issue(c + NS - 1);
        mfa::cp_async_commit();
        mma_chunk<SA::SCALE, SB::SCALE>(
            ra + (c % NS) * RT * CRB, 16 * slab, rb + (c % NS) * TILE * CRB,
            32 * half, acc, sa.scale, sb.scale);
      }
    } else {
      for (int c = 0; c < nch; ++c) {
        uint8_t* a = ra + (c & 1) * RT * CRB;
        uint8_t* b = rb + (c & 1) * TILE * CRB;
        const int l0 = c * DC;
        for (int i = threadIdx.x; i < RT * PR; i += NTH) {
          const int r = i / PR, l = (i % PR) * 4;
          const float4 v = sa(r, l0 + l);
          *reinterpret_cast<uint2*>(a + r * CRB + 2 * l) =
              make_uint2(mfa::pack_bf16(v.x, v.y), mfa::pack_bf16(v.z, v.w));
        }
        for (int i = threadIdx.x; i < TILE * PR; i += NTH) {
          const int r = i / PR, l = (i % PR) * 4;
          const float4 v = sb(r, l0 + l);
          *reinterpret_cast<uint2*>(b + r * CRB + 2 * l) =
              make_uint2(mfa::pack_bf16(v.x, v.y), mfa::pack_bf16(v.z, v.w));
        }
        __syncthreads();
        mma_chunk<false, false>(a, 16 * slab, b, 32 * half, acc, 1.f, 1.f);
      }
    }
    // C fragment (row g, columns 2 t + [0, 2); row g + 8 the same) of
    // block j into sbuf, column-major: 32 distinct banks a store.
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * half + 8 * j + 2 * t, row = 16 * slab + g;
      sbuf[col * (RT + 4) + row] = acc[j][0];
      sbuf[(col + 1) * (RT + 4) + row] = acc[j][1];
      sbuf[col * (RT + 4) + row + 8] = acc[j][2];
      sbuf[(col + 1) * (RT + 4) + row + 8] = acc[j][3];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          sbuf + (tx + 16 * j) * (RT + 4) + 4 * ty);
      s[0][j] = v.x;
      s[1][j] = v.y;
      s[2][j] = v.z;
      s[3][j] = v.w;
    }
    // The next call writes sbuf only after a barrier of its chunk loop,
    // which every thread reaches after these reads.
    return;
  } else {
    for (int c = 0; c < nch; ++c) {
      float* a = bufa + (c & 1) * RT * CLD;
      float* b = bufb + (c & 1) * TILE * CLD;
      const int l0 = c * DC;
      for (int i = threadIdx.x; i < RT * PR; i += NTH) {
        const int r = i / PR, l = (i % PR) * 4;
        *reinterpret_cast<float4*>(a + r * CLD + l) = sa(r, l0 + l);
      }
      for (int i = threadIdx.x; i < TILE * PR; i += NTH) {
        const int r = i / PR, l = (i % PR) * 4;
        *reinterpret_cast<float4*>(b + r * CLD + l) = sb(r, l0 + l);
      }
      __syncthreads();
      // The chunk's own sum, then added: a chain of DC FMAs and one of
      // nch additions, not one of D FMAs (whose rounding, at D = 1088 and
      // a score spread of a few units, reached the 2e-5 fp32 gate).
      float cs[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[i][j] = 0.f;
#pragma unroll 2
      for (int l = 0; l < DC; l += 4) {
        float4 bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] =
              *reinterpret_cast<const float4*>(b + (tx + 16 * j) * CLD + l);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 av =
              *reinterpret_cast<const float4*>(a + (4 * ty + i) * CLD + l);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cs[i][j] = fmaf(av.x, bv[j].x, cs[i][j]);
            cs[i][j] = fmaf(av.y, bv[j].y, cs[i][j]);
            cs[i][j] = fmaf(av.z, bv[j].z, cs[i][j]);
            cs[i][j] = fmaf(av.w, bv[j].w, cs[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += cs[i][j];
    }
    __syncthreads();
  }
}

// Column j of a thread's scores is column tx + 16 j of the tile: stored
// column-major into pt [TILE][RT + 4] as four rows 4 ty + [0, 4).
template <int RT>
__device__ __forceinline__ void store_cols(float* pt, int ty, int tx,
                                           const float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(pt + (tx + 16 * j) * (RT + 4) + 4 * ty) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Lane of the slice a scalar thread's output (e, u) is.
__device__ __forceinline__ int out_lane(int tx, int e, int u) {
  return (e / EB) * HALF + 2 * tx + 32 * (e % EB) + u;
}

constexpr int PRB = 2 * TILE + 16;  // bytes a bf16 score row (64 columns)

// The P.V step: a thread tile's scores (P or dS, rows 4 ty + i, columns
// tx + 16 j, already rounded to T) times the CTA's slice of a source's
// TILE rows (V, K, dO or Q_s: the columns are its rows), accumulated over
// the tiles in 64 fp32 a thread.
//  - T = float: scalar fp32 FMAs.  The score tile column-major fp32
//    [TILE][RT + 4], the slice fp32 rows [TILE][HLD] staged a half at a
//    time; thread (ty, tx) owns rows 4 ty + i, lanes out_lane(tx, e, u).
//  - T = bf16: bf16 mma.sync m16n8k16 into fp32.  The score tile
//    row-major bf16 [RT][PRB] (the A operand by ldmatrix), the whole slice
//    bf16 rows [TILE][SRB] (the B operand by ldmatrix.trans), fetched at
//    the start of the tile (cp.async for bf16 rows, so the copy overlaps
//    the scores); warp w owns rows 16 (w % (RT / 16)) + [0, 16) and lanes
//    128 (w / (RT / 16)) + [0, 128): 16 C fragments.
template <typename T, int RT>
struct PV {
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  struct Acc {
    float v[64];
  };

  static __device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
    for (int k = 0; k < 64; ++k) a.v[k] = 0.f;
  }

  static __device__ __forceinline__ void store(float* ptile, int ty, int tx,
                                               const float (&v)[4][4]) {
    if constexpr (TC) {
      uint8_t* pb = reinterpret_cast<uint8_t*>(ptile);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<__nv_bfloat16*>(pb + (4 * ty + i) * PRB +
                                            2 * (tx + 16 * j)) =
              __float2bfloat16(v[i][j]);
    } else {
      store_cols<RT>(ptile, ty, tx, v);
    }
  }

  // Lanes [l0, l0 + HALF) of TILE rows of src into h (fp32).
  template <typename SRC>
  static __device__ __forceinline__ void stage_half(const SRC& src, int l0,
                                                    float* h) {
    constexpr int PR = HALF / 4;
    for (int i = threadIdx.x; i < TILE * PR; i += RT * 4) {
      const int r = i / PR, l = (i % PR) * 4;
      *reinterpret_cast<float4*>(h + r * HLD + l) = src(r, l0 + l);
    }
  }

  // T = bf16: the slice [l0, l0 + SLICE) of TILE rows of src into h as
  // bf16 rows, by cp.async (committed as one group) where src is ASYNC;
  // a no-op for T = float, whose slice stages in slice().  h must be free:
  // call it after the previous slice()'s last barrier.
  template <typename SRC>
  static __device__ __forceinline__ void fetch(const SRC& src, int l0,
                                               float* h) {
    if constexpr (TC) {
      uint8_t* hb = reinterpret_cast<uint8_t*>(h);
      if constexpr (SRC::ASYNC) {
        for (int i = threadIdx.x; i < TILE * (SLICE / 8); i += RT * 4) {
          const int r = i / (SLICE / 8), l = (i % (SLICE / 8)) * 8;
          src.copy8(r, l0 + l, hb + r * SRB + 2 * l);
        }
        mfa::cp_async_commit();
      } else {
        for (int i = threadIdx.x; i < TILE * (SLICE / 4); i += RT * 4) {
          const int r = i / (SLICE / 4), l = (i % (SLICE / 4)) * 4;
          const float4 v = src(r, l0 + l);
          *reinterpret_cast<uint2*>(hb + r * SRB + 2 * l) =
              make_uint2(mfa::pack_bf16(v.x, v.y), mfa::pack_bf16(v.z, v.w));
        }
      }
    }
  }

  // T = float: acc += the score tile times half HH of the slice.
  template <int HH>
  static __device__ __forceinline__ void mul_half(const float* ptile,
                                                  const float* h, int ty,
                                                  int tx, Acc& a) {
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(ptile + c * (RT + 4) + 4 * ty);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const float2 v =
            *reinterpret_cast<const float2*>(h + c * HLD + 2 * tx + 32 * e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* o = &a.v[(i * 2 * EB + HH * EB + e) * 2];
          o[0] = fmaf(pr[i], v.x, o[0]);
          o[1] = fmaf(pr[i], v.y, o[1]);
        }
      }
    }
  }

  // T = bf16: acc += the score tile times the slice, its fragments scaled
  // as they are read where SB.
  template <bool SB>
  static __device__ __forceinline__ void mul_tc(const float* ptile,
                                                const float* h, float sb,
                                                Acc& a) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slab = warp % (RT / 16), part = warp / (RT / 16);
    const uint8_t* pb = reinterpret_cast<const uint8_t*>(ptile);
    const uint8_t* hb = reinterpret_cast<const uint8_t*>(h);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t pa[4];
      mfa::ldsm_x4(pa, pb + (16 * slab + mfa::ldsm_a_row(lane)) * PRB +
                           kk * 32 + mfa::ldsm_a_byte(lane));
      const uint8_t* bp = hb + (16 * kk + mfa::ldsm_t_k(lane)) * SRB +
                          (128 * part + mfa::ldsm_t_n(lane)) * 2;
#pragma unroll
      for (int n2 = 0; n2 < 8; ++n2) {
        uint32_t bf[4];
        mfa::ldsm_x4_t(bf, bp + n2 * 32);
        if constexpr (SB) {
#pragma unroll
          for (int e = 0; e < 4; ++e) bf[e] = scale_bf16x2(bf[e], sb);
        }
        float(&c0)[4] = *reinterpret_cast<float(*)[4]>(&a.v[8 * n2]);
        float(&c1)[4] = *reinterpret_cast<float(*)[4]>(&a.v[8 * n2 + 4]);
        mfa::mma_bf16(c0, pa, bf[0], bf[1], c0);
        mfa::mma_bf16(c1, pa, bf[2], bf[3], c1);
      }
    }
  }

  // f(row, lane, v0, v1) for each pair of adjacent output lanes (lane even,
  // of the slice) of each row (of the tile) the thread holds.
  template <typename F>
  static __device__ __forceinline__ void each(const Acc& a, int ty, int tx,
                                              F f) {
    if constexpr (TC) {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int slab = warp % (RT / 16), part = warp / (RT / 16);
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int d = 128 * part + 8 * n + 2 * t;
        f(16 * slab + g, d, a.v[4 * n], a.v[4 * n + 1]);
        f(16 * slab + g + 8, d, a.v[4 * n + 2], a.v[4 * n + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2 * EB; ++e)
          f(4 * ty + i, out_lane(tx, e, 0), a.v[(i * 2 * EB + e) * 2],
            a.v[(i * 2 * EB + e) * 2 + 1]);
    }
  }

  // Each row r's outputs times alpha[r] (shared memory).
  static __device__ __forceinline__ void scale(Acc& a, const float* alpha,
                                               int ty) {
    if constexpr (TC) {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int r = 16 * (warp % (RT / 16)) + (lane >> 2);
      const float a0 = alpha[r], a1 = alpha[r + 8];
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        a.v[4 * n] *= a0;
        a.v[4 * n + 1] *= a0;
        a.v[4 * n + 2] *= a1;
        a.v[4 * n + 3] *= a1;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = alpha[4 * ty + i];
#pragma unroll
        for (int k = 0; k < 4 * EB; ++k) a.v[i * 4 * EB + k] *= al;
      }
    }
  }

  // acc = acc (times alpha where given) + the score tile times the slice
  // [l0, l0 + SLICE) of src (lanes from `lanes` zero), which fetch() has
  // staged for T = bf16; the score tile and alpha stored before.  Ends
  // with a barrier.
  template <typename SRC>
  static __device__ __forceinline__ void slice(const float* ptile,
                                               const SRC& src, int l0,
                                               int lanes, float* h,
                                               const float* alpha, int ty,
                                               int tx, Acc& a) {
    if constexpr (TC) {
      if constexpr (SRC::ASYNC) mfa::cp_async_wait<0>();
      __syncthreads();
      if (alpha) scale(a, alpha, ty);
      mul_tc<SRC::ASYNC && SRC::SCALE>(ptile, h, src.scale, a);
      __syncthreads();
    } else {
      stage_half(src, l0, h);
      __syncthreads();
      if (alpha) scale(a, alpha, ty);
      mul_half<0>(ptile, h, ty, tx, a);
      __syncthreads();
      if (l0 + HALF < lanes) {
        stage_half(src, l0 + HALF, h);
        __syncthreads();
        mul_half<1>(ptile, h, ty, tx, a);
        __syncthreads();
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The flash forward
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention.py::_fwd_kernel above D = 576.  One CTA per
// (64 query rows, q head x slice, b), the row tiles last first (a causal
// mask gives the last the most keys); the walk over the live key span is
// the fixed-width kernels'.  STATIC_MAX: m is the caller's row_max and
// each tile only adds to l and O.
template <typename T, bool STATIC_MAX>
__global__ void __launch_bounds__(256)
split_d_fwd_kernel(const FlashArgs a) {
  using L = Smem<64, 1>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lo, s_hi;
  const int nsl = mfa_sd::slices(a.D);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const T* qh = static_cast<const T*>(a.q) + bh * Sq * D;
  const T* kh = static_cast<const T*>(a.k) + bk * Skv * D;
  const T* vh = static_cast<const T*>(a.v) + bk * Skv * D;
  const float* bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;
  using P = PV<T, 64>;
  float* pt = smem + L::P;
  float* alpha_s = smem + L::E;  // each row's rescale this tile
  float* inv_s = alpha_s + 64;   // each row's 1 / l (0 for an empty row)

  mfa::key_span(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_lo = s_lo, c_hi = s_hi;
  int rs[4], re[4];
  float m[4], l[4];
  typename P::Acc acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    mfa::row_range(a.ranges, r, Sq, Skv, rs[i], re[i]);
    m[i] = !STATIC_MAX ? -INFINITY : r < Sq ? a.row_max[bh * Sq + r] : 0.f;
    l[i] = 0.f;
  }
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const Rows<T, true> qsrc{qh, r0, Sq, D, a.scale};

  for (int t0 = c_lo; t0 < c_hi; t0 += TILE) {
    const Rows<T, false> vsrc{vh, t0, c_hi, D, 0.f};
    P::fetch(vsrc, l0, smem + L::H);
    float s[4][4];
    scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc,
                  Rows<T, false>{kh, t0, c_hi, D, 0.f}, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx + 16 * j;
        if (bias && row < Sq && col < c_hi)
          s[i][j] += bias[(size_t)row * Skv + col] * LOG2E;
        if (col < rs[i] || col >= re[i]) s[i][j] = a.mask_value;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are the 16 lanes sharing ty in one warp.
      float m_next = m[i], alpha = 1.f;
      if constexpr (!STATIC_MAX) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        m_next = fmaxf(m[i], mx);
        alpha = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next);
      }
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
      if constexpr (STATIC_MAX) {
        l[i] += sum;
      } else {
        l[i] = alpha * l[i] + sum;
        m[i] = m_next;
        if (tx == 0) alpha_s[4 * ty + i] = alpha;
      }
    }
    P::store(pt, ty, tx, s);
    P::slice(pt, vsrc, l0, D, smem + L::H, STATIC_MAX ? nullptr : alpha_s,
             ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    if (tx == 0) inv_s[4 * ty + i] = live ? 1.f / l[i] : 0.f;
    if (r < Sq && l0 == 0 && tx == 0)
      a.out1[bh * Sq + r] = live ? m[i] * LN2 + logf(l[i]) : -INFINITY;
  }
  __syncthreads();
  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r < Sq && l0 + d < D)
      *reinterpret_cast<float2*>(a.out0 + (bh * Sq + r0 + r) * D + l0 + d) =
          make_float2(v0 * inv_s[r], v1 * inv_s[r]);
  });
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention_bwd.py::_dq_kernel above D = 576 (float
// K/V).  One CTA per (64 query rows, q head x slice, b): per live key tile
// S = Q_s.K^T and dP = dO.V^T over the whole head dim, P and dS on the
// scores, dbias = dS from slice 0, then dQ += round_T(dS).K over the
// slice's K lanes.
template <typename T>
__global__ void __launch_bounds__(256)
split_d_dq_kernel(const FlashArgs a) {
  using L = Smem<64, 1>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lo, s_hi;
  const int nsl = mfa_sd::slices(a.D);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const T* qh = static_cast<const T*>(a.q) + bh * Sq * D;
  const T* doh = static_cast<const T*>(a.dout) + bh * Sq * D;
  const T* kh = static_cast<const T*>(a.k) + bk * Skv * D;
  const T* vh = static_cast<const T*>(a.v) + bk * Skv * D;
  const float* bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;
  float* dbias = l0 == 0 ? a.out1 : nullptr;
  using P = PV<T, 64>;
  float* pt = smem + L::P;

  mfa::key_span(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_lo = s_lo, c_hi = s_hi;
  int rs[4], re[4];
  float lrow[4], drow[4];
  typename P::Acc acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    mfa::row_range(a.ranges, r, Sq, Skv, rs[i], re[i]);
    const float lv = r < Sq ? a.lse[bh * Sq + r] : 0.f;
    lrow[i] = (lv == -INFINITY) ? 0.f : lv;
    drow[i] = r < Sq ? a.di[bh * Sq + r] : 0.f;
  }
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const Rows<T, true> qsrc{qh, r0, Sq, D, a.scale};
  const Rows<T, false> dosrc{doh, r0, Sq, D, 0.f};

  for (int t0 = c_lo; t0 < c_hi; t0 += TILE) {
    const Rows<T, false> ksrc{kh, t0, c_hi, D, 0.f};
    P::fetch(ksrc, l0, smem + L::H);
    float s[4][4], dp[4][4];
    scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc, ksrc, ty,
                  tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx + 16 * j;
        float sv = s[i][j];
        if (bias && row < Sq && col < c_hi)
          sv += bias[(size_t)row * Skv + col];
        s[i][j] = (col < rs[i] || col >= re[i]) ? 0.f : expf(sv - lrow[i]);
      }
    }
    scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, dosrc,
                  Rows<T, false>{vh, t0, c_hi, D, 0.f}, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx + 16 * j;
        const float ds = s[i][j] * (dp[i][j] - drow[i]);
        if (dbias && row < Sq && col < Skv)
          dbias[(bh * Sq + row) * Skv + col] = ds;
        s[i][j] = Elem<T>::round(ds);
      }
    }
    P::store(pt, ty, tx, s);
    P::slice(pt, ksrc, l0, D, smem + L::H, nullptr, ty, tx, acc);
  }

  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r < Sq && l0 + d < D)
      *reinterpret_cast<float2*>(a.out0 + (bh * Sq + r0 + r) * D + l0 + d) =
          make_float2(v0 * a.scale, v1 * a.scale);
  });
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention_bwd.py::_dkv_kernel above D = 576 (float
// K/V).  One CTA per (64 keys, kv head x slice, b x split): it owns its
// keys' dK and dV over its slice and walks the q heads of its split of the
// GQA group (ops/flash_attention_bwd.py::dkv_splits) x the query rows
// whose range meets its keys, 64 a step: S^T = K.Q_s^T and dP^T = V.dO^T
// over the whole head dim, then dV += round_T(P)^T.dO and dK +=
// round_T(dS)^T.Q_s over the slice.  With splits > 1 its partial goes to
// ws [splits, 2, B, Hkv, Skv, D], which flash_dkv_merge_kernel sums.
template <typename T>
__global__ void __launch_bounds__(256)
split_d_dkv_kernel(const FlashArgs a, int splits, float* ws) {
  using L = Smem<64, 2>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_rmin, s_rmax;
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
  const int tx = threadIdx.x & 15;  // query rows r0 + tx + 16 j
  const int ty = threadIdx.x >> 4;  // keys c0 + 4 ty + i
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const T* kh = static_cast<const T*>(a.k) + bk * Skv * D;
  const T* vh = static_cast<const T*>(a.v) + bk * Skv * D;
  using P = PV<T, 64>;
  float* pt = smem + L::P;          // round_T(P^T): rows keys, columns queries
  float* dst = pt + TILE * L::PLD;  // round_T(dS^T)
  float* h_do = smem + L::H;        // the slices of dO and of Q_s
  float* h_q = h_do + TILE * HLD;

  mfa::query_span(a.ranges, Sq, Skv, c0, min(c0 + 64, Skv), &s_rmin,
                  &s_rmax);
  const int row_lo = s_rmin, row_hi = s_rmax + 1;
  typename P::Acc dk, dv;
  P::zero(dk);
  P::zero(dv);
  const int nch = (D + DC - 1) / DC;
  const Rows<T, false> ksrc{kh, c0, Skv, D, 0.f};
  const Rows<T, false> vsrc{vh, c0, Skv, D, 0.f};

  for (int g = g_lo; g < g_hi; ++g) {
    const int h = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + h;
    const float* bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                               : nullptr;
    const T* qh = static_cast<const T*>(a.q) + bh * Sq * D;
    const T* doh = static_cast<const T*>(a.dout) + bh * Sq * D;
    for (int r0 = row_lo; r0 < row_hi; r0 += 64) {
      int rs[4], re[4];
      float lcol[4], dcol[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + tx + 16 * j;
        mfa::row_range(a.ranges, r < row_hi ? r : Sq, Sq, Skv, rs[j], re[j]);
        const float lv = r < row_hi ? a.lse[bh * Sq + r] : 0.f;
        lcol[j] = (lv == -INFINITY) ? 0.f : lv;
        dcol[j] = r < row_hi ? a.di[bh * Sq + r] : 0.f;
      }
      const Rows<T, true> qsrc{qh, r0, row_hi, D, a.scale};
      const Rows<T, false> dosrc{doh, r0, row_hi, D, 0.f};
      P::fetch(dosrc, l0, h_do);
      P::fetch(qsrc, l0, h_q);
      float p[4][4], ds[4][4];  // [key i][query j]
      scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, ksrc,
                    qsrc, ty, tx, p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + tx + 16 * j;
          float sv = p[i][j];
          if (bias && row < row_hi && col < Skv)
            sv += bias[(size_t)row * Skv + col];
          p[i][j] = (col < rs[j] || col >= re[j]) ? 0.f : expf(sv - lcol[j]);
        }
      }
      scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, vsrc,
                    dosrc, ty, tx, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ds[i][j] = Elem<T>::round(p[i][j] * (ds[i][j] - dcol[j]));
          p[i][j] = Elem<T>::round(p[i][j]);
        }
      P::store(pt, ty, tx, p);
      P::store(dst, ty, tx, ds);
      P::slice(pt, dosrc, l0, D, h_do, nullptr, ty, tx, dv);
      P::slice(dst, qsrc, l0, D, h_q, nullptr, ty, tx, dk);
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
    put(out_k, r, d, v0, v1);
  });
  P::each(dv, ty, tx, [&](int r, int d, float v0, float v1) {
    put(out_v, r, d, v0, v1);
  });
}

// ---------------------------------------------------------------------------
// The paged kernels
// ---------------------------------------------------------------------------

// The tile's K and V scales (zeros from token lim) into sc[0, 64) and
// sc[64, 128); the caller's next barrier publishes them.
template <int RT>
__device__ __forceinline__ void stage_scales(const PagedArgs& a,
                                             const int32_t* table,
                                             size_t head_base, int t0,
                                             int lim, float* sc) {
  for (int t = threadIdx.x; t < TILE; t += RT * 4) {
    const int pos = t0 + t;
    float ks = 0.f, vs = 0.f;
    if (pos < lim) {
      const int page =
          min(max(table[pos / a.PT], 0), a.num_pages_total - 1);
      const size_t at = (head_base + page) * a.PT + pos % a.PT;
      ks = a.kscale[at];
      vs = a.vscale[at];
    }
    sc[t] = ks;
    sc[TILE + t] = vs;
  }
}

// One tile's online softmax in base e on a thread's 4 x 4 scores (the
// scalar paged kernels' steps): K scale on S, then masked (vis false) to
// -inf; m, l and each row's rescale into alpha_s (the P.V step applies
// it); P (times the V scale) rounded to T.
template <typename T, bool QUANT, typename VIS>
__device__ __forceinline__ void paged_softmax(float (&s)[4][4], int ty,
                                              int tx, const float* sc,
                                              const VIS& vis, float (&m)[4],
                                              float (&l)[4], float* alpha_s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (QUANT) s[i][j] *= sc[c];
      if (!vis(i, c)) s[i][j] = -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_next = fmaxf(m[i], mx);
    const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_next);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_next);
      sum += p;
      s[i][j] = Elem<T>::round(QUANT ? p * sc[TILE + tx + 16 * j] : p);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = alpha * l[i] + sum;
    m[i] = m_next;
    if (tx == 0) alpha_s[4 * ty + i] = alpha;
  }
}

template <typename T, int MODE, bool WHOLE>
__device__ __forceinline__ Tokens<T, MODE, WHOLE> pool_rows(
    const PagedArgs& a, const int32_t* table, size_t head_base, int t0,
    int lim, bool is_v) {
  return Tokens<T, MODE, WHOLE>{
      static_cast<const typename PoolElem<T, MODE>::S*>(a.kv),
      table, head_base, a.num_pages_total, a.PT, a.rows, a.dp,
      (size_t)a.v_row * a.dp, t0, lim, is_v ? a.dp - a.vtz : a.dp, is_v};
}

// Replaces serving/paged_attention.py::_prefill_kernel above D = 576.  One
// CTA per (64 group-major rows, KV head x slice) of one sequence's chunk:
// rows r = g C + c of q [Hq, C, D] (contiguous for a KV head), causal in
// global positions (column <= offset + r mod C); the key tiles run through
// the page row from position 0.
template <typename T, int MODE, bool WHOLE>
__global__ void __launch_bounds__(256)
split_d_prefill_kernel(const PagedArgs a) {
  using L = Smem<64, 1>;
  constexpr bool QUANT = MODE != KV_FLOAT;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int v_keep = a.dp - a.vtz;
  const int rows = (a.Hq / a.Hkv) * a.C;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = a.D, C = a.C;
  const size_t head_row0 = (size_t)h * rows;
  const size_t head_base = (size_t)h * a.num_pages_total;
  using P = PV<T, 64>;
  float* pt = smem + L::P;
  float* sc = smem + L::SC;
  float* alpha_s = smem + L::E;
  float* inv_s = alpha_s + 64;

  int lim[4];  // the last visible global column of each of the rows
#pragma unroll
  for (int i = 0; i < 4; ++i) lim[i] = a.offset + (r0 + 4 * ty + i) % C;
  const int r_last = min(r0 + 64, rows) - 1;
  const int c_max = (r0 / C == r_last / C) ? (r_last % C) : (C - 1);
  const int kv_end = min(a.offset + c_max + 1, a.max_pages * a.PT);
  float m[4], l[4];
  typename P::Acc acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const Rows<T, true> qsrc{static_cast<const T*>(a.q) + head_row0 * D, r0,
                           rows, D, a.scale};

  for (int t0 = 0; t0 < kv_end; t0 += TILE) {
    if (QUANT) stage_scales<64>(a, a.table, head_base, t0, kv_end, sc);
    const auto ksrc =
        pool_rows<T, MODE, WHOLE>(a, a.table, head_base, t0, kv_end, false);
    const auto vsrc =
        pool_rows<T, MODE, WHOLE>(a, a.table, head_base, t0, kv_end, true);
    if (l0 < v_keep) P::fetch(vsrc, l0, smem + L::H);
    float s[4][4];
    scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc, ksrc, ty,
                  tx, s);
    paged_softmax<T, QUANT>(
        s, ty, tx, sc,
        [&](int i, int c) {
          return t0 + c <= lim[i] && t0 + c < kv_end;
        },
        m, l, alpha_s);
    P::store(pt, ty, tx, s);
    if (l0 < v_keep)
      P::slice(pt, vsrc, l0, v_keep, smem + L::H, alpha_s, ty, tx, acc);
    else
      __syncthreads();  // every thread is done with the scales and alpha
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (tx == 0) inv_s[4 * ty + i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  __syncthreads();
  T* out = static_cast<T*>(a.out) + head_row0 * D + l0;
  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r >= rows || l0 + d >= D) return;
    T* o = out + (size_t)(r0 + r) * D;
    Elem<T>::store(o + d, l0 + d < v_keep ? v0 * inv_s[r] : 0.f);
    Elem<T>::store(o + d + 1, l0 + d + 1 < v_keep ? v1 * inv_s[r] : 0.f);
  });
}

// Replaces serving/paged_attention.py::_decode_kernel_streamed and
// ::_decode_kernel above D = 576.  The fixed-width decode's grid with the
// lanes split too: one CTA of 64 threads per (KV head x 16-row group slice
// x lane slice, sequence, split of the KV axis), the group's rows (up to
// 16) against 64-token tiles of its split.  Every lane slice of a split
// computes the same m and l, so paged_decode_merge_kernel combines each
// lane of the splits' partials by them; slice 0 writes them.
template <typename T, int MODE, bool WHOLE>
__global__ void __launch_bounds__(64)
split_d_decode_kernel(const PagedArgs a) {
  using L = Smem<16, 1>;
  constexpr bool QUANT = MODE != KV_FLOAT;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int l0 = (blockIdx.x % nsl) * SLICE;
  const int hs = blockIdx.x / nsl;
  const int h = hs / a.gslices;
  const int g0 = (hs % a.gslices) * a.gc;
  const int gn = min(a.gc, a.G - g0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = a.D;
  const int v_keep = a.dp - a.vtz;
  const int n_tok = min(a.lengths[b], a.max_pages * a.PT);
  const int t_begin = split * a.per;
  const int t_end = min(t_begin + a.per, n_tok);
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * a.G + g0;
  const size_t part_ld = (size_t)a.splits * (D + 2);
  float* part = a.splits > 1
                    ? a.ws + (qrow0 * a.splits + split) * (size_t)(D + 2)
                    : nullptr;
  if (a.splits > 1 && t_begin >= t_end) {  // past the sequence: empty
    if (l0 == 0 && threadIdx.x < gn) {
      part[threadIdx.x * part_ld] = -INFINITY;
      part[threadIdx.x * part_ld + 1] = 0.f;
    }
    return;
  }
  const int32_t* table = a.table + (size_t)b * a.max_pages;
  const size_t head_base = (size_t)h * a.num_pages_total;
  using P = PV<T, 16>;
  float* pt = smem + L::P;
  float* sc = smem + L::SC;
  float* alpha_s = smem + L::E;
  float* inv_s = alpha_s + 16;
  float m[4], l[4];
  typename P::Acc acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const Rows<T, true> qsrc{static_cast<const T*>(a.q) + qrow0 * D, 0, gn,
                           D, a.scale};

  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    if (QUANT) stage_scales<16>(a, table, head_base, t0, t_end, sc);
    const auto ksrc =
        pool_rows<T, MODE, WHOLE>(a, table, head_base, t0, t_end, false);
    const auto vsrc =
        pool_rows<T, MODE, WHOLE>(a, table, head_base, t0, t_end, true);
    if (l0 < v_keep) P::fetch(vsrc, l0, smem + L::H);
    float s[4][4];
    scores<T, 16>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc, ksrc, ty,
                  tx, s);
    paged_softmax<T, QUANT>(
        s, ty, tx, sc, [&](int, int c) { return t0 + c < t_end; }, m, l,
        alpha_s);
    P::store(pt, ty, tx, s);
    if (l0 < v_keep)
      P::slice(pt, vsrc, l0, v_keep, smem + L::H, alpha_s, ty, tx, acc);
    else
      __syncthreads();  // every thread is done with the scales and alpha
  }

  // One split: O = acc / l (lanes from v_keep 0); else the partial O, and
  // from slice 0 m and l, for paged_decode_merge_kernel.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (tx == 0) inv_s[r] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    if (a.splits > 1 && r < gn && l0 == 0 && tx == 0) {
      part[r * part_ld] = m[i];
      part[r * part_ld + 1] = l[i];
    }
  }
  __syncthreads();
  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r >= gn || l0 + d >= D) return;
    if (a.splits > 1) {
      *reinterpret_cast<float2*>(part + r * part_ld + 2 + l0 + d) =
          make_float2(v0, v1);
      return;
    }
    T* o = static_cast<T*>(a.out) + (qrow0 + r) * D + l0;
    Elem<T>::store(o + d, l0 + d < v_keep ? v0 * inv_s[r] : 0.f);
    Elem<T>::store(o + d + 1, l0 + d + 1 < v_keep ? v1 * inv_s[r] : 0.f);
  });
}

template <typename T>
int fwd_of(const FlashArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Sq + 63) / 64, a.Hq * mfa_sd::slices(a.D), a.B);
  if (a.row_max)
    return mfa::launch_with_smem(split_d_fwd_kernel<T, true>, grid, 256,
                                 Smem<64, 1>::BYTES, stream, a);
  return mfa::launch_with_smem(split_d_fwd_kernel<T, false>, grid, 256,
                               Smem<64, 1>::BYTES, stream, a);
}

// Whether a pool's rows take the cp.async path (Tokens' WHOLE): a bf16
// float pool of whole 16-byte rows.
template <typename T, int MODE>
constexpr bool async_pool() {
  return MODE == KV_FLOAT && std::is_same<T, __nv_bfloat16>::value;
}

template <typename T, int MODE>
int decode_of(const PagedArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(a.Hkv * a.gslices * mfa_sd::slices(a.D), B, a.splits);
  if constexpr (async_pool<T, MODE>())
    if (a.dp % 8 == 0)
      return mfa::launch_with_smem(split_d_decode_kernel<T, MODE, true>, grid,
                                   64, Smem<16, 1>::BYTES, stream, a);
  return mfa::launch_with_smem(split_d_decode_kernel<T, MODE, false>, grid,
                               64, Smem<16, 1>::BYTES, stream, a);
}

template <typename T, int MODE>
int prefill_of(const PagedArgs& a, cudaStream_t stream) {
  const int rows = (a.Hq / a.Hkv) * a.C;
  const dim3 grid((rows + 63) / 64, a.Hkv * mfa_sd::slices(a.D));
  if constexpr (async_pool<T, MODE>())
    if (a.dp % 8 == 0)
      return mfa::launch_with_smem(split_d_prefill_kernel<T, MODE, true>,
                                   grid, 256, Smem<64, 1>::BYTES, stream, a);
  return mfa::launch_with_smem(split_d_prefill_kernel<T, MODE, false>, grid,
                               256, Smem<64, 1>::BYTES, stream, a);
}

template <int MODE>
int decode_mode(int dtype, const PagedArgs& a, int B, cudaStream_t stream) {
  if (dtype == 0) return decode_of<float, MODE>(a, B, stream);
  if (dtype == 1) return decode_of<__nv_bfloat16, MODE>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int prefill_mode(int dtype, const PagedArgs& a, cudaStream_t stream) {
  if (dtype == 0) return prefill_of<float, MODE>(a, stream);
  if (dtype == 1) return prefill_of<__nv_bfloat16, MODE>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace mfa_sd {

int launch_fwd(int dtype, const FlashArgs& a, cudaStream_t stream) {
  if (!takes(a.D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return fwd_of<float>(a, stream);
  if (dtype == 1) return fwd_of<__nv_bfloat16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_dq(int dtype, const FlashArgs& a, cudaStream_t stream) {
  if (!takes(a.D)) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Sq + 63) / 64, a.Hq * slices(a.D), a.B);
  if (dtype == 0)
    return mfa::launch_with_smem(split_d_dq_kernel<float>, grid, 256,
                                 Smem<64, 1>::BYTES, stream, a);
  if (dtype == 1)
    return mfa::launch_with_smem(split_d_dq_kernel<__nv_bfloat16>, grid, 256,
                                 Smem<64, 1>::BYTES, stream, a);
  return (int)cudaErrorInvalidValue;
}

int launch_dkv(int dtype, const FlashArgs& a, int splits, float* ws,
               cudaStream_t stream) {
  if (!takes(a.D) || splits < 1 || splits > a.Hq / a.Hkv ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Skv + 63) / 64, a.Hkv * slices(a.D), a.B * splits);
  if (dtype == 0)
    return mfa::launch_with_smem(split_d_dkv_kernel<float>, grid, 256,
                                 Smem<64, 2>::BYTES, stream, a, splits, ws);
  if (dtype == 1)
    return mfa::launch_with_smem(split_d_dkv_kernel<__nv_bfloat16>, grid,
                                 256, Smem<64, 2>::BYTES, stream, a, splits,
                                 ws);
  return (int)cudaErrorInvalidValue;
}

int launch_paged_decode(int dtype, int mode, const PagedArgs& a, int B,
                        cudaStream_t stream) {
  if (!takes(a.D)) return (int)cudaErrorInvalidValue;
  if (mode == KV_FLOAT) return decode_mode<KV_FLOAT>(dtype, a, B, stream);
  if (mode == KV_INT8) return decode_mode<KV_INT8>(dtype, a, B, stream);
  if (mode == KV_INT4) return decode_mode<KV_INT4>(dtype, a, B, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_paged_prefill(int dtype, int mode, const PagedArgs& a,
                         cudaStream_t stream) {
  if (!takes(a.D)) return (int)cudaErrorInvalidValue;
  if (mode == KV_FLOAT) return prefill_mode<KV_FLOAT>(dtype, a, stream);
  if (mode == KV_INT8) return prefill_mode<KV_INT8>(dtype, a, stream);
  if (mode == KV_INT4) return prefill_mode<KV_INT4>(dtype, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mfa_sd

extern "C" {

// The lanes a split-D CTA owns (ops/flash_attention.py::SPLIT_D_SLICE
// answers the same).
int mfa_split_d_slice() { return SLICE; }

}  // extern "C"

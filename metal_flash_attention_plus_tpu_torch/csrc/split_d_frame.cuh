// The split-D frame (sm_90a), shared by csrc/split_d_attention.cu (the
// flash trio and the paged pair above 576), csrc/split_d_quantized.cu (the
// quantized forward) and csrc/split_d_quantized_bwd.cu (the exact
// quantized dQ and dK/dV and the full-integer pair): the row sources, the
// two steps (the scores over the whole head dim in 32-lane chunks, then P
// times the CTA's 256-lane slice) and the bodies of the forward, dQ and
// dK/dV kernels, which take float rows or quantized payloads by a policy
// (FlashFwd / QuantFwd, FloatKV / PayloadKV); each file's __global__
// kernels are thin wrappers over them, named apart so that a trace tells the
// float and the quantized kernels apart.  split_d_attention.cu's file
// comment describes the frame.  Everything here has internal linkage: each
// file that includes it builds the instances it launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "quantized_tiles.cuh"
#include "split_d.cuh"

namespace {

using mfa::Elem;
using mfa::LN2;
using mfa::LOG2E;
using mfa_sd::FlashArgs;
using mfa_sd::SLICE;

constexpr int TILE = 64;          // keys a tile (query rows in dK/dV)
constexpr int DC = 32;            // head-dim lanes a chunk of the scores
constexpr int HALF = SLICE / 2;   // slice lanes staged at once
constexpr int CLD = DC + 4;       // floats a staged chunk row
constexpr int HLD = HALF + 4;     // floats a staged slice row
constexpr int EB = HALF / 32;     // float2 output steps a thread a half

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
  static constexpr bool RAW = false;
  static constexpr bool WIDEN = false;
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

// int8 rows [row0, row0 + n) of a [rows, D] matrix (D a multiple of 16),
// zeros from row `limit` and lane D: word() four lanes as one int32 of four
// int8 (the s8 scores' operand), operator() the same as fp32.  RAW: copy16
// copies 16 lanes as they lie by cp.async, which are the s8 operand's bytes.
struct I8Rows {
  static constexpr bool ASYNC = false;
  static constexpr bool RAW = true;
  static constexpr bool WIDEN = false;
  static constexpr bool SCALE = false;
  static constexpr float scale = 1.f;
  const int8_t* base;
  int row0, limit, D;
  __device__ __forceinline__ void copy16(int r, int l, uint8_t* dst) const {
    const bool ok = row0 + r < limit && l < D;
    mfa::cp_async16(dst, base + (ok ? (size_t)(row0 + r) * D + l : 0),
                    ok ? 16 : 0);
  }
  __device__ __forceinline__ int word(int r, int l) const {
    if (row0 + r >= limit || l >= D) return 0;
    return *reinterpret_cast<const int*>(base + (size_t)(row0 + r) * D + l);
  }
  __device__ __forceinline__ float4 operator()(int r, int l) const {
    const int w = word(r, l);
    return make_float4(mfa::byte_of(w, 0), mfa::byte_of(w, 1),
                       mfa::byte_of(w, 2), mfa::byte_of(w, 3));
  }
};

// Token rows [t0, t0 + n) of one KV head of a quantized K or V payload
// (csrc/quantized_tiles.cuh's layouts at a run-time head dim D, a multiple
// of 16: int8 [Skv, D], or group-planar int4 [Skv, D/2], whose groups of
// 256 values pack their first half in the low nibbles and their second in
// the high ones; a 256-lane slice is one group, the last group of D mod
// 256 lanes splits at its own midpoint), zeros from token `limit` and lane
// D.  word(): the integers (load_word_at; the s8 scores' operand);
// operator(): the values dequantized in op.mode (dequant_values_at; the
// forward's column, P and store modes read the integers) and left
// unrounded: the bf16 staging rounds them, as dequant_rows_bf16 does.  A
// BLOCK_2D cell is lane / bs of the whole head dim, so a block may
// straddle two slices.  rb: the dequantized values rounded to bf16 here
// (an fp32 Q whose mode rounds to bf16, which the fp32 staging would not
// round).  The raw path (RingPayload, whole rows only): copy16 copies the 16
// bytes that hold lanes [l, l + 16) as they lie, and ints8 / widen_bf16
// widen eight lanes of them once they have landed into word()'s integers /
// operator()'s values.
struct Payload {
  static constexpr bool ASYNC = false;
  static constexpr bool RAW = false;
  static constexpr bool WIDEN = false;
  static constexpr bool SCALE = false;
  static constexpr float scale = 1.f;
  mfa::KVOperand op;
  size_t head;
  int Skv, D, br, bs, t0, limit;
  bool rb;
  // Token row r's first byte.
  __device__ __forceinline__ const uint8_t* row(int r) const {
    return op.pay +
           (head * Skv + t0 + r) * (size_t)(op.bits == 8 ? D : D / 2);
  }
  // The byte of a row that holds lane l (a multiple of 4), and for int4
  // whether its high nibble does (load_word_at's packing).
  __device__ __forceinline__ int byte_of_lane(int l, bool& high) const {
    high = false;
    if (op.bits == 8) return l;
    const int base =
        D > mfa::INT4_GROUP ? l / mfa::INT4_GROUP * mfa::INT4_GROUP : 0;
    const int h = min(mfa::INT4_GROUP, D - base) / 2;
    high = l - base >= h;
    return base / 2 + (high ? l - base - h : l - base);
  }
  __device__ __forceinline__ void copy16(int r, int l, uint8_t* dst) const {
    const bool ok = t0 + r < limit && l < D;
    bool high;
    mfa::cp_async16(dst, ok ? row(r) + byte_of_lane(l, high) : op.pay,
                    ok ? 16 : 0);
  }
  // The TOKEN mode's scale and zero point of token row r (else unused).
  struct Tok {
    float s, z;
  };
  __device__ __forceinline__ Tok token(int r) const {
    const int t = t0 + r;
    if (op.mode != mfa::DQ_TOKEN || t >= limit) return {1.f, 0.f};
    return {op.sc[head * Skv + t], op.zp[head * Skv + t]};
  }
  // The integers of lanes [l, l + 8) (l a multiple of 8) of token row r as
  // two words of four int8, from `raw`, the eight bytes that hold them:
  // int8 as they are, int4 the nibbles minus 8; zeros from `limit` and D.
  __device__ __forceinline__ uint2 ints8(uint2 raw, int r, int l) const {
    if (t0 + r >= limit || l >= D) return make_uint2(0u, 0u);
    if (op.bits == 8) return raw;
    bool high;
    byte_of_lane(l, high);
    const auto nib = [&](unsigned u) {
      return __vsub4(high ? (u >> 4) & 0x0F0F0F0Fu : u & 0x0F0F0F0Fu,
                     0x08080808u);
    };
    return make_uint2(nib(raw.x), nib(raw.y));
  }
  // Lanes [l, l + 8) of token row r as eight bf16, from the raw bytes:
  // operator()'s values (tk: the row's token()), packed as the synchronous
  // staging packs them, so the same bits.
  __device__ __forceinline__ uint4 widen_bf16(uint2 raw, int r, int l,
                                              Tok tk) const {
    const int t = t0 + r;
    if (t >= limit || l >= D) return make_uint4(0u, 0u, 0u, 0u);
    const uint2 w = ints8(raw, r, l);
    float f[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[0][e] = mfa::byte_of((int)w.x, e);
      f[1][e] = mfa::byte_of((int)w.y, e);
    }
    if (op.mode == mfa::DQ_TOKEN) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[0][e] = __fmul_rn(f[0][e] - tk.z, tk.s);
        f[1][e] = __fmul_rn(f[1][e] - tk.z, tk.s);
      }
    } else {
      mfa::dequant_values_at(op, head, Skv, D, br, bs, t, l, f[0]);
      mfa::dequant_values_at(op, head, Skv, D, br, bs, t, l + 4, f[1]);
    }
    if (rb && (op.mode == mfa::DQ_TOKEN || op.mode == mfa::DQ_BLOCK2D ||
               op.mode == mfa::DQ_CHANNEL)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[0][e] = mfa::round_bf16(f[0][e]);
        f[1][e] = mfa::round_bf16(f[1][e]);
      }
    }
    return make_uint4(mfa::pack_bf16(f[0][0], f[0][1]),
                      mfa::pack_bf16(f[0][2], f[0][3]),
                      mfa::pack_bf16(f[1][0], f[1][1]),
                      mfa::pack_bf16(f[1][2], f[1][3]));
  }
  __device__ __forceinline__ int word(int r, int l) const {
    const int t = t0 + r;
    if (t >= limit || l >= D) return 0;
    return mfa::load_word_at(
        op.pay + (head * Skv + t) * (size_t)(op.bits == 8 ? D : D / 2), l,
        op.bits, D);
  }
  __device__ __forceinline__ float4 operator()(int r, int l) const {
    const int t = t0 + r;
    if (t >= limit || l >= D) return make_float4(0.f, 0.f, 0.f, 0.f);
    const int w = word(r, l);
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = mfa::byte_of(w, e);
    mfa::dequant_values_at(op, head, Skv, D, br, bs, t, l, f);
    if (rb && (op.mode == mfa::DQ_TOKEN || op.mode == mfa::DQ_BLOCK2D ||
               op.mode == mfa::DQ_CHANNEL)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = mfa::round_bf16(f[e]);
    }
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

// A Payload of whole 16-byte rows (int8; int4 where D is a multiple of 32),
// which the quantized forward reads through the raw path: the scores' ring
// lands each chunk's raw bytes and widens them (WIDEN), and PV::fetch_raw
// lands V's slice under the scores.
struct RingPayload : Payload {
  static constexpr bool RAW = true;
  static constexpr bool WIDEN = true;
  static constexpr bool RESIDENT = false;
};

// A RingPayload whose TILE rows' raw bytes are resident in shared memory
// (res, `ld` bytes a row, loaded once by the caller): the scores' ring
// copies nothing for it and widens each chunk from there.  The dK/dV's K,
// whose 64 keys every q head and row step of the CTA reads again.
struct ResidentPayload : RingPayload {
  static constexpr bool RESIDENT = true;
  const uint8_t* res;
  int ld;
  // The eight raw bytes that hold lanes [l, l + 8) of row r.
  __device__ __forceinline__ uint2 raw8(int r, int l) const {
    bool high;
    return *reinterpret_cast<const uint2*>(res + r * ld +
                                           byte_of_lane(l, high));
  }
  // Rows [0, TILE) of the payload into res by cp.async (zeros from
  // `limit`), committed as one group.
  template <int NTH>
  __device__ __forceinline__ void load(uint8_t* dst) const {
    for (int i = threadIdx.x; i < TILE * (ld / 16); i += NTH) {
      const int r = i / (ld / 16), p = 16 * (i % (ld / 16));
      const bool ok = t0 + r < limit;
      mfa::cp_async16(dst + r * ld + p, ok ? row(r) + p : op.pay,
                      ok ? 16 : 0);
    }
    mfa::cp_async_commit();
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

// acc[j] += A[ar0, ar0 + 16) . B[br0 + 8j, br0 + 8j + 8)^T over one DC-lane
// chunk of int8 rows (one s8 m16n8k32 k step: the bf16 chunk's 32 bytes a
// row, so the same ldmatrix addresses give its fragments).
__device__ __forceinline__ void mma_chunk_s8(const uint8_t* A, int ar0,
                                             const uint8_t* B, int br0,
                                             int (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t af[4];
  mfa::ldsm_x4(af, A + (ar0 + mfa::ldsm_a_row(lane)) * CRB +
                       mfa::ldsm_a_byte(lane));
  const uint8_t* bp =
      B + (br0 + mfa::ldsm_b_row(lane)) * CRB + mfa::ldsm_b_byte(lane);
#pragma unroll
  for (int j2 = 0; j2 < 2; ++j2) {
    uint32_t bf[4];
    mfa::ldsm_x4(bf, bp + j2 * 16 * CRB);
    mfa::mma_s8(acc[2 * j2], af, bf[0], bf[1], acc[2 * j2]);
    mfa::mma_s8(acc[2 * j2 + 1], af, bf[2], bf[3], acc[2 * j2 + 1]);
  }
}

// Chunk [l0, l0 + DC) of `rows` rows of a source that lands as it lies
// into rows of CRB bytes at dst, by cp.async in 16-byte pieces: copy8's 8
// bf16 lanes (ASYNC), or copy16's 16 int8 lanes (RAW).  Not committed.
template <int NTH, typename SRC>
__device__ __forceinline__ void issue_chunk(const SRC& src, uint8_t* dst,
                                            int rows, int l0) {
  constexpr int LP = SRC::RAW ? 16 : 8;  // lanes a piece
  for (int i = threadIdx.x; i < rows * (DC / LP); i += NTH) {
    const int r = i / (DC / LP), p = i % (DC / LP);
    if constexpr (SRC::RAW)
      src.copy16(r, l0 + LP * p, dst + r * CRB + 16 * p);
    else
      src.copy8(r, l0 + LP * p, dst + r * CRB + 16 * p);
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
// sums cross to the thread layout through sbuf.  T = float: scalar fp32
// FMAs, as the 2e-5 gate wants (TF32 would break it).  T = int8_t: two
// int8 sources (their word()s: an int8 Q, the full-integer operands, an
// int8 or int4 payload's integers), each chunk one s8 mma.sync m16n8k32 k
// step, summed exactly in int32 and read as fp32 at the end.  The cp.async
// ring (NS stages) takes the place of the staging where A lands as it lies
// (bf16 rows, ASYNC; int8 rows, RAW) and B does too or is a payload of
// whole rows (WIDEN: its raw bytes land, then widen into the operand as
// operator() / word() would give it): two bf16 rows (the flash kernels;
// Q's scale applied to the fragments as they are read), a bf16 Q (or dO)
// over a payload (the quantized forward, the exact dQ and dK/dV; a
// ResidentPayload's bytes are in shared memory already and only widen),
// an int8 Q over a payload or int8 rows (the full-integer pair); the other
// sources (the quantized page pools, int4 rows that are not whole 16-byte
// pieces) are staged as above, to the same operand bits.  The order of
// the sums depends on nothing but the lanes, so every slice's CTA gets
// the same bits.  Ends with a barrier, so the caller may restage either
// buffer.  TR (T = bf16,
// RT = TILE): the transpose is read back, s[i][j] = a(tx + 16 j) .
// b(4 ty + i): the dK/dV's S^T and dP^T with the payload on the B side,
// where the ring takes it.
template <typename T, int RT, bool TR = false, typename SA, typename SB>
__device__ __forceinline__ void scores(int nch, float* bufa, float* bufb,
                                       float* sbuf, const SA& sa,
                                       const SB& sb, int ty, int tx,
                                       float (&s)[4][4]) {
  constexpr int NTH = RT * 4;
  constexpr int PR = DC / 4;  // four-lane pieces a chunk row
  constexpr bool S8 = std::is_same<T, int8_t>::value;
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value || S8;
  static_assert(!TR || TC, "the transpose is read back from sbuf");
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
    int iacc[4][4];  // S8: the exact int32 sums
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) iacc[j][e] = 0;
    // One chunk's products: A's rows at a, B's at b (CRB bytes a row).
    const auto mma = [&](const uint8_t* a, const uint8_t* b) {
      if constexpr (S8)
        mma_chunk_s8(a, 16 * slab, b, 32 * half, iacc);
      else
        mma_chunk<SA::SCALE, SB::SCALE>(a, 16 * slab, b, 32 * half, acc,
                                        sa.scale, sb.scale);
    };
    constexpr bool RING = S8 ? SA::RAW && !SA::WIDEN && SB::RAW
                             : SA::ASYNC && (SB::ASYNC || SB::WIDEN);
    if constexpr (RING && SB::WIDEN) {
      // A's rows land as they are; B's (a payload) land as raw bytes, NS
      // stages of TILE rows of 32 bytes, and are widened into one of two
      // operand buffers: chunk c + 1 while chunk c is multiplied, so one
      // barrier a chunk, NS - 2 chunks in flight under the products.
      static_assert(NTH == TILE * 4, "one widened piece a thread");
      uint8_t* raw = rb;
      uint8_t* wb = rb + NS * TILE * 32;
      constexpr bool RES = SB::RESIDENT;
      const auto issue = [&](int c) {
        issue_chunk<NTH>(sa, ra + (c % NS) * RT * CRB, RT, c * DC);
        if constexpr (!RES)
          for (int i = threadIdx.x; i < TILE * 2; i += NTH)
            sb.copy16(i >> 1, c * DC + 16 * (i & 1),
                      raw + (c % NS) * TILE * 32 + 16 * i);
      };
      const int wr = threadIdx.x >> 2, wq = 8 * (threadIdx.x & 3);
      const auto tk = sb.token(wr);
      const auto widen = [&](int c) {
        uint2 v;
        if constexpr (RES)
          v = c * DC + wq < sb.D ? sb.raw8(wr, c * DC + wq)
                                 : make_uint2(0u, 0u);
        else
          v = *reinterpret_cast<const uint2*>(
              raw + (c % NS) * TILE * 32 + wr * 32 + wq);
        uint8_t* w = wb + (c & 1) * TILE * CRB + wr * CRB;
        if constexpr (S8)
          *reinterpret_cast<uint2*>(w + wq) = sb.ints8(v, wr, c * DC + wq);
        else
          *reinterpret_cast<uint4*>(w + 2 * wq) =
              sb.widen_bf16(v, wr, c * DC + wq, tk);
      };
#pragma unroll
      for (int c = 0; c < NS - 1; ++c) {
        if (c < nch) issue(c);
        mfa::cp_async_commit();
      }
      mfa::cp_async_wait<NS - 2>();
      __syncthreads();  // chunk 0 landed
      widen(0);
      for (int c = 0; c < nch; ++c) {
        mfa::cp_async_wait<NS - 3>();
        // Chunk c + 1 landed and chunk c widened; chunk c - 1's readers
        // (its A stage, its operand buffer) and chunk c's widening done.
        __syncthreads();
        if (c + NS - 1 < nch) issue(c + NS - 1);
        mfa::cp_async_commit();
        if (c + 1 < nch) widen(c + 1);
        mma(ra + (c % NS) * RT * CRB, wb + (c & 1) * TILE * CRB);
      }
    } else if constexpr (RING) {
      // Both sources land as they are (bf16 rows; int8 rows, the s8
      // operand): an NS-stage cp.async ring, NS - 1 chunks in flight while
      // one is multiplied; Q_s's scale applied to the fragments.
      const auto issue = [&](int c) {
        issue_chunk<NTH>(sa, ra + (c % NS) * RT * CRB, RT, c * DC);
        issue_chunk<NTH>(sb, rb + (c % NS) * TILE * CRB, TILE, c * DC);
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
        mma(ra + (c % NS) * RT * CRB, rb + (c % NS) * TILE * CRB);
      }
    } else if constexpr (S8) {
      // int8 rows read a word at a time (an int4 payload of unaligned
      // rows): two buffers, one barrier a chunk.
      for (int c = 0; c < nch; ++c) {
        uint8_t* a = ra + (c & 1) * RT * CRB;
        uint8_t* b = rb + (c & 1) * TILE * CRB;
        const int l0 = c * DC;
        for (int i = threadIdx.x; i < RT * PR; i += NTH) {
          const int r = i / PR, l = (i % PR) * 4;
          *reinterpret_cast<int*>(a + r * CRB + l) = sa.word(r, l0 + l);
        }
        for (int i = threadIdx.x; i < TILE * PR; i += NTH) {
          const int r = i / PR, l = (i % PR) * 4;
          *reinterpret_cast<int*>(b + r * CRB + l) = sb.word(r, l0 + l);
        }
        __syncthreads();
        mma_chunk_s8(a, 16 * slab, b, 32 * half, iacc);
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
    if constexpr (S8) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = (float)iacc[j][e];
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
    if constexpr (TR) {
      // Column 4 ty + i of the exchange tile from row tx + 16 j: the two
      // ty of a warp 4 (RT + 4) floats apart, 16 banks, so 32 distinct.
      static_assert(RT == TILE, "the transpose of a square tile");
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = sbuf[(4 * ty + i) * (RT + 4) + tx + 16 * j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            sbuf + (tx + 16 * j) * (RT + 4) + 4 * ty);
        s[0][j] = v.x;
        s[1][j] = v.y;
        s[2][j] = v.z;
        s[3][j] = v.w;
      }
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

  // T = bf16, a payload of whole rows (RingPayload: the quantized
  // forward's V): the raw bytes of the slice [l0, l0 + SLICE) of TILE rows
  // into raw, a row each SLICE bytes (int8: the slice's bytes; int4: its
  // packing group's, G / 2 for a group of G lanes), by cp.async committed
  // as one group; only live rows' bytes.  raw must be free.
  template <typename SRC>
  static __device__ __forceinline__ void fetch_raw(const SRC& src, int l0,
                                                   uint8_t* raw) {
    const int lanes = min(SLICE, src.D - l0);
    const int bytes = src.op.bits == 8 ? lanes : lanes / 2;
    const int first = src.op.bits == 8 ? l0 : l0 / 2;
    for (int i = threadIdx.x; i < TILE * (SLICE / 16); i += RT * 4) {
      const int r = i / (SLICE / 16), p = (i % (SLICE / 16)) * 16;
      if (p < bytes && src.t0 + r < src.limit)
        mfa::cp_async16(raw + r * SLICE + p, src.row(r) + first + p, 16);
    }
    mfa::cp_async_commit();
  }

  // acc = acc (times alpha where given) + the score tile times the slice
  // [l0, l0 + SLICE) of src, whose raw bytes fetch_raw() has issued: they
  // are widened into h as bf16 rows [TILE][SRB] (src's widen_bf16: the
  // values fetch() would stage), then multiplied.  Ends with a barrier.
  template <typename SRC>
  static __device__ __forceinline__ void slice_raw(const float* ptile,
                                                   const SRC& src, int l0,
                                                   const uint8_t* raw,
                                                   float* h,
                                                   const float* alpha,
                                                   Acc& a) {
    mfa::cp_async_wait<0>();
    __syncthreads();  // the raw slice and the score tile landed
    uint8_t* hb = reinterpret_cast<uint8_t*>(h);
    const int g = min(SLICE, src.D - l0), gh = g / 2;
    for (int i = threadIdx.x; i < TILE * (SLICE / 8); i += RT * 4) {
      const int r = i / (SLICE / 8), l = (i % (SLICE / 8)) * 8;
      uint2 v = make_uint2(0u, 0u);
      if (l < g && src.t0 + r < src.limit)
        v = *reinterpret_cast<const uint2*>(
            raw + r * SLICE + (src.op.bits == 8 || l < gh ? l : l - gh));
      *reinterpret_cast<uint4*>(hb + r * SRB + 2 * l) =
          src.widen_bf16(v, r, l0 + l, src.token(r));
    }
    __syncthreads();
    if (alpha) scale(a, alpha, 0);
    mul_tc<false>(ptile, h, 1.f, a);
    __syncthreads();
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
// The backward's K and V: float rows or quantized payloads
// ---------------------------------------------------------------------------

// The flash kernels' K and V: rows of T at FlashArgs::k / v.
template <typename T>
struct FloatKV {
  static constexpr bool QUANT = false;
  __device__ __forceinline__ Rows<T, false> rows(const FlashArgs& a,
                                                 bool is_v, size_t bk,
                                                 int t0, int limit) const {
    return Rows<T, false>{static_cast<const T*>(is_v ? a.v : a.k) +
                              bk * a.Skv * a.D,
                          t0, limit, a.D, 0.f};
  }
};

// The exact quantized kernels' K and V: the payloads at FlashArgs::k / v,
// staged as q's modes say (Payload; T's staging rounds them), and the dQ's
// folds (ksr, vsr, dqsc).  RING: both payloads are whole 16-byte rows,
// read through the raw path (RingPayload), as QuantFwd<.., true> reads
// the forward's.
template <bool RING>
struct PayloadKV {
  static constexpr bool QUANT = true;
  using Src = typename std::conditional<RING, RingPayload, Payload>::type;
  mfa_sd::QuantKV q;
  __device__ __forceinline__ Src rows(const FlashArgs& a, bool is_v,
                                      size_t bk, int t0, int limit) const {
    const Payload p =
        is_v ? Payload{{static_cast<const uint8_t*>(a.v), q.vs, q.vz,
                        q.bits_v, q.v_mode},
                       bk, a.Skv, a.D, q.br, q.bs, t0, limit, false}
             : Payload{{static_cast<const uint8_t*>(a.k), q.ks, q.kz,
                        q.bits_k, q.k_mode},
                       bk, a.Skv, a.D, q.br, q.bs, t0, limit, false};
    return Src{p};
  }
};

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

// The quantized forward's scale modes and flags (QAttnArgs::k_scales,
// v_scales, flags: csrc/quantized_attention.cu's KScales, VScales, Flags).
enum KScales { K_NONE = 0, K_TOKEN = 1, K_BLOCK2D = 2, K_COLUMN = 3 };
enum VScales { V_TOKEN = 1, V_BLOCK2D = 2, V_P = 3, V_STORE = 4 };
enum Flags { ROUND_BF16 = 1, L_ROUNDED = 2, P_INT8 = 4 };
constexpr float LOG2_127 = 6.988684686772166f;
constexpr float LN_127 = 4.844187086458591f;

// The forward's inputs.  FlashFwd: the flash forward's (FlashArgs), rows of
// T, Q scaled by a.scale and rounded to T as it stages, P rounded to T and
// l over the unrounded P, the key tiles from the live span's first key.
template <typename T>
struct FlashFwd {
  static constexpr bool QUANT = false;
  using QT = T;
  using KV = Rows<T, false>;
  FlashArgs a;
  __device__ __forceinline__ Rows<T, true> q(size_t bh, int r0) const {
    return Rows<T, true>{static_cast<const T*>(a.q) + bh * a.Sq * a.D, r0,
                         a.Sq, a.D, a.scale};
  }
  __device__ __forceinline__ Rows<T, false> kv(bool is_v, size_t bk, int t0,
                                               int limit) const {
    return FloatKV<T>{}.rows(a, is_v, bk, t0, limit);
  }
  __device__ __forceinline__ int flags() const {
    return std::is_same<T, __nv_bfloat16>::value ? ROUND_BF16 : 0;
  }
  __device__ __forceinline__ int first_key(int c_lo) const { return c_lo; }
  __device__ __forceinline__ float* o() const { return a.out0; }
  __device__ __forceinline__ float* lse() const { return a.out1; }
};

// QuantFwd: the quantized forward's (QAttnArgs): an int8 Q's words (QT
// int8_t, times its row scale on S) or pre-scaled rows of QT, the K / V
// payloads in the call's modes (Payload: K_TOKEN / V_TOKEN and K_BLOCK2D /
// V_BLOCK2D dequantize, the others read the integers), the call's flags;
// the key tiles aligned to multiples of 64 from key 0 (qattn_body's order).
// RING: the payloads' rows are whole 16-byte pieces, read through the raw
// path (RingPayload).
template <typename QT_, bool RING>
struct QuantFwd {
  static constexpr bool QUANT = true;
  using QT = QT_;
  using KV = typename std::conditional<RING, RingPayload, Payload>::type;
  mfa_sd::QAttnArgs a;
  __device__ __forceinline__ auto q(size_t bh, int r0) const {
    if constexpr (std::is_same<QT, int8_t>::value)
      return I8Rows{static_cast<const int8_t*>(a.q) + bh * a.Sq * a.D, r0,
                    a.Sq, a.D};
    else
      return Rows<QT, false>{static_cast<const QT*>(a.q) + bh * a.Sq * a.D,
                             r0, a.Sq, a.D, 0.f};
  }
  __device__ __forceinline__ KV kv(bool is_v, size_t bk, int t0,
                                   int limit) const {
    const bool rb = a.flags & ROUND_BF16;
    const Payload p =
        is_v ? Payload{{a.vq, a.vs, a.vz, a.bits_v, a.v_scales}, bk, a.Skv,
                       a.D, a.br, a.bs, t0, limit, rb}
             : Payload{{a.kq, a.ks, a.kz, a.bits_k, a.k_scales}, bk, a.Skv,
                       a.D, a.br, a.bs, t0, limit, rb};
    return KV{p};
  }
  __device__ __forceinline__ int flags() const { return a.flags; }
  __device__ __forceinline__ int first_key(int c_lo) const {
    return (c_lo / TILE) * TILE;
  }
  __device__ __forceinline__ float* o() const { return a.o; }
  __device__ __forceinline__ float* lse() const { return a.lse; }
};

// Replaces ops/flash_attention.py::_fwd_kernel (FlashFwd) and
// ops/quantized_attention.py::_qfwd_kernel (QuantFwd) above D = 576; the
// body of split_d_attention.cu::split_d_fwd_kernel and
// split_d_quantized.cu::split_d_qattn_kernel.  One CTA per (64 query rows,
// q head x slice, b), the row tiles last first (a causal mask gives the
// last the most keys).  PT: the type P and V round to before P.V (bf16 where
// the call rounds to bf16, else float); the scores run in int8 for an int8
// Q, else in PT.  The element-wise steps are qattn_body's (the flash
// forward's where it has none of them), in its order: Q's row scale and the
// K column scale (K_COLUMN), bias * log2(e), the mask (to mask_value), the
// base-2 online softmax, V's P scale (V_P), the bf16 or int8 rounding of P,
// l over the rounded or the unrounded P (L_ROUNDED); an int8 Q walks
// kv_span-key spans, with a first pass over each span wider than a tile for
// its row max, so an int8 P rounds against the TPU's block_kv max in every
// slice.  STATIC_MAX (the flash forward's static-max mode): m is the
// caller's row_max and each tile only adds to l and O.
//
// The KV split (a.splits > 1: grid z is b x split): the row tile's live
// span is dealt into a.splits runs of whole 64-key tiles, one CTA each,
// which write m, l and the unnormalised O of their run to a.ws
// (mfa_sd::fwd_partial) for split_d_attention.cu::split_d_fwd_merge_kernel;
// a run may hold no key (m -inf, l 0) or no live key for a row (m the mask
// value, whose weight the merge takes to 0 beside a live run, as the
// running max does).  One walk (splits 1) stores O and L itself.  A
// payload of whole rows (SRC::KV is RingPayload) lands through the raw
// path: the scores' ring, and V's slice issued raw at the start of the
// tile into the P region (idle under the scores), widened after them, with
// the score tile in the A region, which the scores have left.
template <typename PT, bool STATIC_MAX, typename SRC>
__device__ __forceinline__ void split_d_fwd(const SRC& src) {
  using QT = typename SRC::QT;
  constexpr bool QINT = std::is_same<QT, int8_t>::value;
  using ST = typename std::conditional<QINT, int8_t, PT>::type;
  using L = Smem<64, 1>;
  using P = PV<PT, 64>;
  constexpr bool RAW_V = P::TC && SRC::KV::RAW;
  static_assert(!RAW_V || TILE * SLICE <= L::SC * 4 - L::P * 4,
                "the raw V slice fits the P region");
  const auto& a = src.a;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lo, s_hi;
  const int nsl = mfa_sd::slices(a.D);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int splits = a.splits;
  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;
  const int flags = src.flags();
  const bool rb = flags & ROUND_BF16;
  const bool l_rounded = flags & L_ROUNDED;
  const bool p_int8 = flags & P_INT8;
  float* pt = smem + (RAW_V ? L::A : L::P);
  uint8_t* raw_v = reinterpret_cast<uint8_t*>(smem + L::P);
  float* alpha_s = smem + L::E;  // each row's rescale this tile
  float* l_s = alpha_s + 64;     // each row's l (0 for an empty row)

  mfa::key_span(a.ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_lo = s_lo, c_hi = s_hi;
  int rs[4], re[4];
  float m[4], l[4], qsr[4], smax[4];
  typename P::Acc acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    mfa::row_range(a.ranges, r, Sq, Skv, rs[i], re[i]);
    qsr[i] = 1.f;
    if constexpr (QINT) qsr[i] = r < Sq ? a.qs[bh * Sq + r] : 1.f;
    m[i] = -INFINITY;
    if constexpr (STATIC_MAX) m[i] = r < Sq ? a.row_max[bh * Sq + r] : 0.f;
    l[i] = 0.f;
    smax[i] = -INFINITY;
  }
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const auto qsrc = src.q(bh, r0);

  // One 64-key tile t0: the masked, scaled scores; pass 0 only folds them
  // into each row's span max (this thread's columns), pass 1 rounds P
  // against the running max and accumulates P.V over the slice.
  const auto tile = [&](int t0, int pass) {
    const auto vsrc = src.kv(true, bk, t0, c_hi);
    if (pass == 1) {
      if constexpr (RAW_V)
        P::fetch_raw(vsrc, l0, raw_v);
      else
        P::fetch(vsrc, l0, smem + L::H);
    }
    float s[4][4];
    scores<ST, 64>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc,
                   src.kv(false, bk, t0, c_hi), ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
      float mx = smax[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx + 16 * j;
        if (QINT) s[i][j] *= qsr[i];
        if constexpr (SRC::QUANT)
          if (a.k_scales == K_COLUMN && col < Skv)
            s[i][j] *= a.ks[bk * Skv + col];
        if (bias && row < Sq && col < c_hi)
          s[i][j] += bias[(size_t)row * Skv + col] * LOG2E;
        if (col < rs[i] || col >= re[i]) s[i][j] = a.mask_value;
        mx = fmaxf(mx, s[i][j]);
      }
      if (pass == 0) {
        smax[i] = mx;
        continue;
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
        const int col = t0 + tx + 16 * j;
        float raw, p;
        if (s[i][j] == -INFINITY) {
          raw = p = 0.f;
        } else if (p_int8) {
          raw = exp2f(s[i][j] + (LOG2_127 - m_next));
          p = (float)(int)(raw + 0.5f);
        } else {
          raw = p = exp2f(s[i][j] - m_next);
          if constexpr (SRC::QUANT)
            if (a.v_scales == V_P && col < Skv) p *= a.vs[bk * Skv + col];
          if (rb) p = mfa::round_bf16(p);
        }
        sum += l_rounded ? p : raw;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
      if (!STATIC_MAX && tx == 0) alpha_s[4 * ty + i] = alpha;
    }
    if (pass == 0) return;
    P::store(pt, ty, tx, s);
    float* alpha = STATIC_MAX ? nullptr : alpha_s;
    if constexpr (RAW_V)
      P::slice_raw(pt, vsrc, l0, raw_v, smem + L::H, alpha, acc);
    else
      P::slice(pt, vsrc, l0, D, smem + L::H, alpha, ty, tx, acc);
  };

  int span = TILE;
  if constexpr (QINT) span = a.kv_span;
  if (span > TILE) {
    // An int8 P over kv_span-key spans aligned to multiples of it (never
    // split): a first pass over each span's tiles takes each row's max
    // before the second computes P against it.
    for (int sp0 = (c_lo / span) * span; sp0 < c_hi; sp0 += span) {
      const int t_beg = max(sp0, (c_lo / TILE) * TILE);
      const int t_end = min(sp0 + span, c_hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) smax[i] = -INFINITY;
      for (int pass = 0; pass < 2; ++pass)
        for (int t0 = t_beg; t0 < t_end; t0 += TILE) tile(t0, pass);
    }
  } else {
    // This split's run of the span's tiles (all of them at one split).
    const int first = src.first_key(c_lo);
    const int tiles = c_hi > first ? (c_hi - first + TILE - 1) / TILE : 0;
    const int per = (tiles + splits - 1) / splits;
    const int t_end = min(first + (sp + 1) * per * TILE, c_hi);
    for (int t0 = first + sp * per * TILE; t0 < t_end; t0 += TILE)
      tile(t0, 1);
  }

  if (splits > 1) {  // the partials; split_d_fwd_merge_kernel does the rest
    float* part = a.ws + mfa_sd::fwd_partial(bh * Sq + r0, sp, splits, D);
    const size_t row_ld = (size_t)splits * (D + 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r0 + r < Sq && l0 == 0 && tx == 0) {
        part[r * row_ld] = m[i];
        part[r * row_ld + 1] = re[i] > rs[i] ? l[i] : 0.f;
      }
    }
    P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
      if (r0 + r < Sq && l0 + d < D)
        *reinterpret_cast<float2*>(part + r * row_ld + 2 + l0 + d) =
            make_float2(v0, v1);
    });
    return;
  }

  const float l_off = p_int8 ? LN_127 : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    if (tx == 0) l_s[4 * ty + i] = live ? l[i] : 0.f;
    if (r < Sq && l0 == 0 && tx == 0)
      src.lse()[bh * Sq + r] =
          live ? m[i] * LN2 + logf(l[i]) - l_off : -INFINITY;
  }
  __syncthreads();
  const float* vstore = nullptr;
  if constexpr (SRC::QUANT)
    if (a.v_scales == V_STORE) vstore = a.vs + bk * D + l0;
  float* o = src.o();
  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r >= Sq || l0 + d >= D) return;
    const float lv = l_s[r];
    float o0 = lv > 0.f ? v0 / lv : 0.f;
    float o1 = lv > 0.f ? v1 / lv : 0.f;
    if (vstore) {
      o0 *= vstore[d];
      o1 *= vstore[d + 1];
    }
    *reinterpret_cast<float2*>(o + (bh * Sq + r0 + r) * D + l0 + d) =
        make_float2(o0, o1);
  });
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention_bwd.py::_dq_kernel above D = 576, float
// K/V (FloatKV) and quantized (PayloadKV).  One CTA per (64 query rows, q
// head x slice, b): per live key tile S = Q_s.K^T and dP = dO.V^T over the
// whole head dim, P and dS on the scores, dbias = dS from slice 0, then
// dQ += round_T(dS).K over the slice's K lanes.  Quantized: Q arrives
// pre-scaled and folded (a.scale is 1), K and V are the payloads staged as
// the modes say (dequantized and rounded to T, or the integers), the
// per-token ksr multiply S's and dS's columns and vsr dP's, and dQ is
// stored times dqsc (attention_bwd.cuh::dq_body's order of operations).
// The body of split_d_attention.cu::split_d_dq_kernel and
// split_d_quantized_bwd.cu::split_d_qdq_kernel.
//
// A payload of whole rows (KV's rows are RingPayload) lands through the
// raw path, as the forward's does: the scores' ring (Q and dO by cp.async,
// K and V as raw bytes widened a chunk ahead), and K's slice issued raw at
// the start of the tile into the P region (idle under both scores),
// widened after them, with the score tile in the A region.
//
// The KV split (a.splits > 1: grid z is b x run): the row tile's live
// span is dealt into a.splits runs of whole 64-key tiles, one CTA each, as
// split_d_fwd deals it; each writes its unscaled partial dQ to a.ws
// (mfa_sd::dq_partial) for split_d_attention.cu::split_d_dq_merge_kernel,
// which sums the runs in order and applies dqsc or the scale.  A run of no
// key writes zeros.  dbias: slice 0 of each run, its own columns.
template <typename T, typename KV>
__device__ __forceinline__ void split_d_dq(const FlashArgs& a, const KV& kv) {
  using L = Smem<64, 1>;
  using P = PV<T, 64>;
  using KSrc = decltype(kv.rows(a, false, 0, 0, 0));
  constexpr bool RAW_K = P::TC && KSrc::RAW;
  static_assert(!RAW_K || TILE * SLICE <= L::SC * 4 - L::P * 4,
                "the raw K slice fits the P region");
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lo, s_hi;
  const int nsl = mfa_sd::slices(a.D);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int splits = a.splits;
  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const T* qh = static_cast<const T*>(a.q) + bh * Sq * D;
  const T* doh = static_cast<const T*>(a.dout) + bh * Sq * D;
  const float* bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;
  const float* ksr = nullptr;
  const float* vsr = nullptr;
  const float* dqsc = nullptr;
  if constexpr (KV::QUANT) {
    ksr = kv.q.ksr ? kv.q.ksr + bk * Skv : nullptr;
    vsr = kv.q.vsr ? kv.q.vsr + bk * Skv : nullptr;
    dqsc = kv.q.dqsc ? kv.q.dqsc + bk * D : nullptr;
  }
  float* dbias = l0 == 0 ? a.out1 : nullptr;
  float* pt = smem + (RAW_K ? L::A : L::P);
  uint8_t* raw_k = reinterpret_cast<uint8_t*>(smem + L::P);

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
  // This run's tiles of the span (all of them at one run).
  const int tiles = c_hi > c_lo ? (c_hi - c_lo + TILE - 1) / TILE : 0;
  const int per = (tiles + splits - 1) / splits;
  const int t_end = min(c_lo + (sp + 1) * per * TILE, c_hi);

  for (int t0 = c_lo + sp * per * TILE; t0 < t_end; t0 += TILE) {
    const auto ksrc = kv.rows(a, false, bk, t0, c_hi);
    if constexpr (RAW_K)
      P::fetch_raw(ksrc, l0, raw_k);
    else
      P::fetch(ksrc, l0, smem + L::H);
    float s[4][4], dp[4][4], kcol[4];
    scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc, ksrc, ty,
                  tx, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = t0 + tx + 16 * j;
      kcol[j] = (ksr && col < c_hi) ? ksr[col] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx + 16 * j;
        float sv = ksr ? s[i][j] * kcol[j] : s[i][j];
        if (bias && row < Sq && col < c_hi)
          sv += bias[(size_t)row * Skv + col];
        s[i][j] = (col < rs[i] || col >= re[i]) ? 0.f : expf(sv - lrow[i]);
      }
    }
    scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, dosrc,
                  kv.rows(a, true, bk, t0, c_hi), ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx + 16 * j;
        const float vs = (vsr && col < c_hi) ? vsr[col] : 1.f;
        const float dpv = vsr ? dp[i][j] * vs : dp[i][j];
        const float ds = s[i][j] * (dpv - drow[i]);
        if (dbias && row < Sq && col < Skv)
          dbias[(bh * Sq + row) * Skv + col] = ds;
        s[i][j] = Elem<T>::round(ksr ? ds * kcol[j] : ds);
      }
    }
    P::store(pt, ty, tx, s);
    if constexpr (RAW_K)
      P::slice_raw(pt, ksrc, l0, raw_k, smem + L::H, nullptr, acc);
    else
      P::slice(pt, ksrc, l0, D, smem + L::H, nullptr, ty, tx, acc);
  }

  if (splits > 1) {  // the partial; split_d_dq_merge_kernel scales it
    float* part = a.ws + mfa_sd::dq_partial(bh, sp, a.B * a.Hq, Sq, D);
    P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
      if (r0 + r < Sq && l0 + d < D)
        *reinterpret_cast<float2*>(part + (size_t)(r0 + r) * D + l0 + d) =
            make_float2(v0, v1);
    });
    return;
  }
  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r < Sq && l0 + d < D)
      *reinterpret_cast<float2*>(a.out0 + (bh * Sq + r0 + r) * D + l0 + d) =
          make_float2(v0 * (dqsc ? dqsc[l0 + d] : a.scale),
                      v1 * (dqsc ? dqsc[l0 + d + 1] : a.scale));
  });
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention_bwd.py::_dkv_kernel above D = 576, float
// K/V (FloatKV) and quantized (PayloadKV: K and V dequantized and rounded
// to T as they stage, the gradients with respect to the dequantized K/V).
// One CTA per (64 keys, kv head x slice, b x split): it owns its keys' dK
// and dV over its slice and walks the q heads of its split of the GQA
// group (ops/flash_attention_bwd.py::dkv_splits) x the query rows whose
// range meets its keys, 64 a step: S^T = K.Q_s^T and dP^T = V.dO^T over
// the whole head dim, then dV += round_T(P)^T.dO and dK += round_T(dS)^T.Q_s
// over the slice.  With splits > 1 its partial goes to ws [splits, 2, B,
// Hkv, Skv, D], which flash_dkv_merge_kernel sums.  The body of
// split_d_attention.cu::split_d_dkv_kernel and
// split_d_quantized_bwd.cu::split_d_qdkv_kernel.
//
// A payload of whole rows (KV's rows are RingPayload) would be the A
// operand of S^T and dP^T, which the ring does not widen; the scores run
// as S = Q_s.K^T and dP = dO.V^T instead, the payload on the B side of the
// widening ring (Q_s and dO by cp.async, K and V as raw bytes), and the
// transpose is read back from the square exchange tile (scores' TR): the
// same products, summed in the same chunk order.  RES_K (with the ring):
// the CTA's 64 raw K rows stay resident in shared memory past Smem<64, 2>
// (kv_resident_bytes), loaded once and widened from there for every q
// head and row step.
template <typename T, typename KV, bool RES_K = false>
__device__ __forceinline__ void split_d_dkv(const FlashArgs& a, const KV& kv,
                                            int splits, float* ws) {
  using L = Smem<64, 2>;
  using KSrc = decltype(kv.rows(a, false, 0, 0, 0));
  constexpr bool SWAP = std::is_same<T, __nv_bfloat16>::value && KSrc::WIDEN;
  static_assert(!RES_K || SWAP, "a resident K rides the ring");
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
  const auto vsrc = kv.rows(a, true, bk, c0, Skv);
  const auto ksrc = [&] {
    if constexpr (RES_K) {
      const KSrc k = kv.rows(a, false, bk, c0, Skv);
      const ResidentPayload r{k, reinterpret_cast<const uint8_t*>(
                                     smem + L::BYTES / 4),
                              k.op.bits == 8 ? D : D / 2};
      r.template load<256>(reinterpret_cast<uint8_t*>(smem + L::BYTES / 4));
      mfa::cp_async_wait<0>();
      __syncthreads();
      return r;
    } else {
      return kv.rows(a, false, bk, c0, Skv);
    }
  }();

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
      if constexpr (SWAP)
        scores<T, 64, true>(nch, smem + L::A, smem + L::B, smem + L::S,
                            qsrc, ksrc, ty, tx, p);
      else
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
      if constexpr (SWAP)
        scores<T, 64, true>(nch, smem + L::A, smem + L::B, smem + L::S,
                            dosrc, vsrc, ty, tx, ds);
      else
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

// Bytes of shared memory the resident K of split_d_dkv<.., RES_K> takes
// past Smem<64, 2>: its 64 raw rows.
__host__ __device__ inline size_t kv_resident_bytes(int bits, int D) {
  return (size_t)TILE * (bits == 8 ? D : D / 2);
}

// CTAs an SM the occupancy API gives a split-D kernel of 256 threads
// with Smem<64, NP>'s shared memory and `extra` bytes more (-1 where the
// API fails).
template <int NP, typename K>
int ctas_per_sm(K kern, size_t extra = 0) {
  const size_t bytes = Smem<64, NP>::BYTES + extra;
  int n = 0;
  if (mfa::set_smem(kern, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 256, bytes) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

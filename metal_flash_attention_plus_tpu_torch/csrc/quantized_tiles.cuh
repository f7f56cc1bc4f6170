// Quantized K/V and int8 tiles shared by the quantized attention forward and
// backward kernels (csrc/quantized_attention.cu,
// csrc/quantized_attention_bwd.cu), so both read payloads one way.
//
// K and V payloads are int8 [B, Hkv, Skv, D] or group-planar int4 uint8
// [B, Hkv, Skv, D/2]: the values pack in groups of 256 (the last group
// shorter where D is not a multiple of 256), group g's bytes starting at
// byte 128 g, and within a group of width w byte j holds value j in its
// low nibble and value j + w/2 in its high one, each stored + 8 (D <= 256:
// one group, byte j holds values j and j + D/2; MLA's D = 288: bytes
// [0, 128) values j and j + 128, bytes [128, 144) values 256 + j and
// 272 + j; DeepSeek's 576: three groups, bytes [0, 128), [128, 256) and
// [256, 288), the last holding values 512 + j and 544 + j).  They are read
// four values to a 32-bit word and either widened to fp32 (or dequantized)
// while they are staged into the transposed [D][LD] tiles of
// attention_tiles.cuh, or kept as words [D/4][LD] for __dp4a products; the tensor-core bodies
// copy the payload rows with cp.async (stage_raw) and widen them in shared
// memory (to bf16 rows: dequant_rows_bf16), or, at 576, widen them as they
// load (dequant_fill_bf16); the 32-row scalar bodies stage fp32 rows
// (stage_kv32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace mfa {

// How a payload is staged: its integers (NONE; the forward's column, P and
// store scale modes read them so), or dequantized and rounded to the compute
// dtype: TOKEN (w - zp)*s per token, BLOCK2D w*s - zp*s per [br x bs] block,
// CHANNEL w*s per channel.
enum Dequant { DQ_NONE = 0, DQ_TOKEN = 1, DQ_BLOCK2D = 2, DQ_CHANNEL = 5 };

// One K or V operand: the payload, its bit width, its dequantization and
// its scales and zero points in that mode's shapes (per token [B, Hkv, Skv],
// per block [B, Hkv, Skv/br, ceil(D/bs)], per channel [B, Hkv, D]; unused:
// null).  A width padded past the head dim may end in a part block.
struct KVOperand {
  const uint8_t* pay;
  const float* sc;
  const float* zp;
  int bits, mode;
};

__device__ __forceinline__ float round_bf16(float x) {
  return Elem<__nv_bfloat16>::round(x);
}

constexpr int INT4_GROUP = 256;  // values per group-planar int4 group

// Values [e, e + 4) (e a multiple of 4) of one payload row of D values as
// an int32 word of four int8: int8 rows as they are; int4 rows from the
// four bytes of the value's packing group whose low (the group's first
// half) or high nibbles hold them, minus 8 per byte.  A word never
// straddles a group or its halves: both are multiples of 8 values.  D is
// a run-time value here (the split-D kernels) and a constant in load_word.
__device__ __forceinline__ int load_word_at(const uint8_t* row, int e,
                                            int bits, int D) {
  if (bits == 8) return *reinterpret_cast<const int*>(row + e);
  const int base = D > INT4_GROUP ? e / INT4_GROUP * INT4_GROUP : 0;
  const int h = min(INT4_GROUP, D - base) / 2;  // the group's half width
  const int o = e - base;
  const unsigned u = *reinterpret_cast<const unsigned*>(
      row + base / 2 + (o < h ? o : o - h));
  const unsigned nib = o < h ? (u & 0x0F0F0F0Fu) : ((u >> 4) & 0x0F0F0F0Fu);
  return (int)__vsub4(nib, 0x08080808u);
}

// Values [4w, 4w + 4) of one payload row of D values (load_word_at).
template <int D>
__device__ __forceinline__ int load_word(const uint8_t* row, int w, int bits) {
  return load_word_at(row, 4 * w, bits, D);
}

__device__ __forceinline__ float byte_of(int word, int e) {
  return (float)(signed char)((word >> (8 * e)) & 0xFF);
}

// The integers f of values [l, l + 4) of payload row t of kv head `head`
// (D values a row, a run-time value here: the split-D kernels; a constant
// in dequant_values), dequantized in place in op.mode (unrounded; DQ_NONE
// keeps them).  A BLOCK_2D cell is the lane over bs of the whole row.
__device__ __forceinline__ void dequant_values_at(const KVOperand& op,
                                                  size_t head, int Skv, int D,
                                                  int br, int bs, int t,
                                                  int l, float (&f)[4]) {
  if (op.mode == DQ_TOKEN) {
    const float s = op.sc[head * Skv + t];
    const float z = op.zp[head * Skv + t];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __fmul_rn(f[e] - z, s);
  } else if (op.mode == DQ_BLOCK2D) {
    const size_t cell =
        (head * (Skv / br) + t / br) * (size_t)((D + bs - 1) / bs);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t c = cell + (l + e) / bs;
      const float s = op.sc[c];
      f[e] = __fmul_rn(f[e], s) - __fmul_rn(op.zp[c], s);
    }
  } else if (op.mode == DQ_CHANNEL) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __fmul_rn(f[e], op.sc[head * D + l + e]);
  }
}

// The same for values [4w, 4w + 4) of a row of D values.
template <int D>
__device__ __forceinline__ void dequant_values(const KVOperand& op,
                                               size_t head, int Skv, int br,
                                               int bs, int t, int w,
                                               float (&f)[4]) {
  dequant_values_at(op, head, Skv, D, br, bs, t, 4 * w, f);
}

// The values [4w, 4w + 4) of payload row t of kv head `head`, read as the
// int8 word `word`: the integers, or dequantized in op.mode and, with `rb`,
// rounded to bf16.
template <int D>
__device__ __forceinline__ void kv_values(const KVOperand& op, size_t head,
                                          int Skv, int br, int bs, bool rb,
                                          int t, int w, int word,
                                          float (&f)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = byte_of(word, e);
  dequant_values<D>(op, head, Skv, br, bs, t, w, f);
  if (rb && op.mode != DQ_NONE) {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = round_bf16(f[e]);
  }
}

// Stage payload rows [t0, t0 + 64) of kv head `head` (zeros from `limit`)
// transposed into dst[d * LD + r] as fp32: kv_values' values.
template <int D>
__device__ __forceinline__ void stage_kv(const KVOperand& op, size_t head,
                                         int Skv, int br, int bs, bool rb,
                                         int t0, int limit, float* dst) {
  constexpr int W = D / 4;
  const size_t row_bytes = op.bits == 8 ? D : D / 2;
  for (int i = threadIdx.x; i < 64 * W; i += THREADS) {
    const int r = i / W;
    const int w = i % W;
    const int t = t0 + r;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < limit)
      kv_values<D>(op, head, Skv, br, bs, rb, t, w,
                   load_word<D>(op.pay + (head * Skv + t) * row_bytes, w,
                                op.bits),
                   f);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(4 * w + e) * LD + r] = f[e];
  }
}

// cp.async of ROWS rows of CPR 16-byte chunks (16 CPR bytes a row) from
// src into dst (rows RAW_LD bytes apart), rows from `limit` - t0 zeros; NT
// threads, one chunk a thread at a time.  The loop stays rolled: unrolled
// at its constant trip counts it took qattn_fwd_tc_kernel<bf16, 128> from
// 167 registers to 251 and left the D = 288 forward spilling 32 / 44
// bytes (bf16 / int8 Q), none rolled (-Xptxas -v on sm_90a).
template <int CPR, int RAW_LD, int NT, int ROWS>
__device__ __forceinline__ void stage_chunks(const uint8_t* src, int t0,
                                             int limit, uint8_t* dst) {
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = t0 + r < limit;
    cp_async16(dst + r * RAW_LD + c * 16,
               src + (size_t)(ok ? t0 + r : 0) * (16 * CPR) + c * 16,
               ok ? 16 : 0);
  }
}

// cp.async payload rows [t0, t0 + ROWS) of kv head `head` into dst (rows
// RAW_LD bytes apart), NT threads; rows from `limit` are zeros.
template <int D, int RAW_LD, int NT, int ROWS = 64>
__device__ __forceinline__ void stage_raw(const uint8_t* pay, int bits,
                                          size_t head, int Skv, int t0,
                                          int limit, uint8_t* dst) {
  const uint8_t* src = pay + head * Skv * (bits == 8 ? D : D / 2);
  if (bits == 8)
    stage_chunks<D / 16, RAW_LD, NT, ROWS>(src, t0, limit, dst);
  else
    stage_chunks<D / 32, RAW_LD, NT, ROWS>(src, t0, limit, dst);
}

// Raw payload rows (stage_raw's, RAW_LD bytes apart) of keys [t0, t0 +
// ROWS) -> bf16 rows [key][D] of dst (dst_ld bytes apart): kv_values' values
// rounded to bf16, zeros from `limit`; NT threads, 16 values of one row a
// thread at a time (a per-token scale and zero point read once for them).
// The bytes become floats on the FP32 pipe (mma.cuh's s8_f32) and a
// dequantized pair is rounded by one cvt.rn.bf16x2 (the integers, exact in
// bf16, by none), so the conversion unit sees one instruction per two
// values at most: the tensor-core dQ runs this for every key tile of every
// CTA.
template <int D, int RAW_LD, int NT, int ROWS = 64>
__device__ __forceinline__ void dequant_rows_bf16(const KVOperand& op,
                                                  const uint8_t* raw,
                                                  size_t head, int Skv,
                                                  int br, int bs, int t0,
                                                  int limit, uint8_t* dst,
                                                  int dst_ld) {
  constexpr int C = D / 16;  // 16-value chunks a row
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int t = t0 + r;
    uint32_t out[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (t < limit) {
      const bool token = op.mode == DQ_TOKEN;
      const float s = token ? op.sc[head * Skv + t] : 0.f;
      const float z = token ? op.zp[head * Skv + t] : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int w = 4 * c + q;
        const uint32_t x =
            (uint32_t)load_word<D>(raw + r * RAW_LD, w, op.bits) ^ 0x80808080u;
        float f[4] = {s8_f32<0>(x), s8_f32<1>(x), s8_f32<2>(x),
                      s8_f32<3>(x)};
        if (token) {
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = __fmul_rn(f[e] - z, s);
        } else {
          dequant_values<D>(op, head, Skv, br, bs, t, w, f);
        }
        const bool exact = op.mode == DQ_NONE;
        out[2 * q] =
            exact ? pack_bf16_exact(f[0], f[1]) : pack_bf16(f[0], f[1]);
        out[2 * q + 1] =
            exact ? pack_bf16_exact(f[2], f[3]) : pack_bf16(f[2], f[3]);
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * dst_ld + 32 * c);
    d[0] = make_uint4(out[0], out[1], out[2], out[3]);
    d[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// Values [16c, 16c + 16) of one payload row in device memory as four int8
// words (load_word's), by one 16-byte load: int8 rows as they are; int4
// rows from the 16 bytes of the packing group whose low or high nibbles
// hold them (16 values never straddle a group's halves at the built
// widths: each half is a multiple of 16 values, 32 at the tail of 576).
template <int D>
__device__ __forceinline__ void load_chunk(const uint8_t* row, int c,
                                           int bits, int (&wd)[4]) {
  const int e = 16 * c;
  int off = e;
  bool high = false;
  if (bits == 4) {
    const int base = D > INT4_GROUP ? e / INT4_GROUP * INT4_GROUP : 0;
    const int h = min(INT4_GROUP, D - base) / 2;
    const int o = e - base;
    high = o >= h;
    off = base / 2 + (high ? o - h : o);
  }
  const uint4 u = *reinterpret_cast<const uint4*>(row + off);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wd[q] = bits == 8 ? (int)w[q]
                      : (int)__vsub4((high ? w[q] >> 4 : w[q]) & 0x0F0F0F0Fu,
                                     0x08080808u);
}

// Payload rows [t0, t0 + ROWS) of kv head `head`, read from device memory,
// -> bf16 rows [key][D] of dst (dst_ld bytes apart), as dequant_rows_bf16
// makes them from staged rows (bit for bit: the same conversion, repeated
// here so that the staged kernels' code stays as it was), zeros from
// `limit`; NT threads.  A thread starts the loads of G chunks before it
// converts the first of them: G = 2 keeps the 16 words in flight within
// the registers the latent dQ has left beside its accumulator.
template <int D, int NT, int ROWS>
__device__ __forceinline__ void dequant_fill_bf16(const KVOperand& op,
                                                  size_t head, int Skv,
                                                  int br, int bs, int t0,
                                                  int limit, uint8_t* dst,
                                                  int dst_ld) {
  constexpr int C = D / 16;
  constexpr int N = ROWS * C;
  constexpr int G = 2;
  const int row_bytes = op.bits == 8 ? D : D / 2;
  const uint8_t* pay = op.pay + head * Skv * (size_t)row_bytes;
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < N; i0 += G * NT) {
    int wd[G][4];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = i0 + k * NT;
      const int t = t0 + i / C;
      if (i < N && t < limit)
        load_chunk<D>(pay + (size_t)t * row_bytes, i % C, op.bits, wd[k]);
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = i0 + k * NT;
      if (i >= N) break;
      const int r = i / C;
      const int c = i % C;
      const int t = t0 + r;
      uint32_t out[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (t < limit) {
        const bool token = op.mode == DQ_TOKEN;
        const float s = token ? op.sc[head * Skv + t] : 0.f;
        const float z = token ? op.zp[head * Skv + t] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t x = (uint32_t)wd[k][q] ^ 0x80808080u;
          float f[4] = {s8_f32<0>(x), s8_f32<1>(x), s8_f32<2>(x),
                        s8_f32<3>(x)};
          if (token) {
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = __fmul_rn(f[e] - z, s);
          } else {
            dequant_values<D>(op, head, Skv, br, bs, t, 4 * c + q, f);
          }
          const bool exact = op.mode == DQ_NONE;
          out[2 * q] =
              exact ? pack_bf16_exact(f[0], f[1]) : pack_bf16(f[0], f[1]);
          out[2 * q + 1] =
              exact ? pack_bf16_exact(f[2], f[3]) : pack_bf16(f[2], f[3]);
        }
      }
      uint4* d = reinterpret_cast<uint4*>(dst + r * dst_ld + 32 * c);
      d[0] = make_uint4(out[0], out[1], out[2], out[3]);
      d[1] = make_uint4(out[4], out[5], out[6], out[7]);
    }
  }
}

// Payload rows [t0, t0 + 32) of kv head `head` (zeros from `limit`) as
// fp32 kv_values' values in a 32-row layout of attention_tiles.cuh: rows
// dst[r * ld_rows32<D>() + d] (ROWS) or transposed dst[d * LD32 + r]
// (consecutive threads on consecutive rows).
template <int D, bool ROWS>
__device__ __forceinline__ void stage_kv32(const KVOperand& op, size_t head,
                                           int Skv, int br, int bs, bool rb,
                                           int t0, int limit, float* dst) {
  constexpr int W = D / 4;
  const size_t row_bytes = op.bits == 8 ? D : D / 2;
  for (int i = threadIdx.x; i < T32 * W; i += THREADS) {
    const int r = ROWS ? i / W : i % T32;
    const int w = ROWS ? i % W : i / T32;
    const int t = t0 + r;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < limit)
      kv_values<D>(op, head, Skv, br, bs, rb, t, w,
                   load_word<D>(op.pay + (head * Skv + t) * row_bytes, w,
                                op.bits),
                   f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ROWS)
        dst[r * ld_rows32<D>() + 4 * w + e] = f[e];
      else
        dst[(4 * w + e) * LD32 + r] = f[e];
    }
  }
}

// Payload rows [t0, t0 + 64) of kv head `head` (zeros from `limit`) as
// transposed words dst[w * LD + r].
template <int D>
__device__ __forceinline__ void stage_kv_words(const uint8_t* pay, int bits,
                                               size_t head, int Skv, int t0,
                                               int limit, int* dst) {
  constexpr int W = D / 4;
  const size_t row_bytes = bits == 8 ? D : D / 2;
  for (int i = threadIdx.x; i < 64 * W; i += THREADS) {
    const int r = i / W;
    const int w = i % W;
    const int t = t0 + r;
    dst[w * LD + r] =
        t < limit ? load_word<D>(pay + (head * Skv + t) * row_bytes, w, bits)
                  : 0;
  }
}

// int8 rows [r0, r0 + 64) (zeros from `limit`), rows `sr` bytes apart, as
// transposed words dst[w * LD + r].
template <int D>
__device__ __forceinline__ void stage_words(const int8_t* base, long long sr,
                                            int r0, int limit, int* dst) {
  constexpr int W = D / 4;
  for (int i = threadIdx.x; i < 64 * W; i += THREADS) {
    const int r = i / W;
    const int w = i % W;
    dst[w * LD + r] =
        r0 + r < limit
            ? *reinterpret_cast<const int*>(base + (r0 + r) * sr + 4 * w)
            : 0;
  }
}

// Max over the 16 lanes that share a row (the lanes of one ty in a warp,
// in the 64-row tiles' 16 x 16 thread layout).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One value of the full-integer backward's level-2 product: x quantized
// over its row's maximum `am` (signed: +-0.5 then truncation; else x >= 0,
// +0.5 then truncation) and scaled back by am / 127, as
// ops/flash_attention_bwd.py::_rowquant_signed and _rowquant_pos round.
__device__ __forceinline__ float rowquant(float x, float am, bool is_signed) {
  const float inv = 127.f / fmaxf(am, 1e-30f);
  const float xs = x * inv;
  const float q = (float)(int)(xs + (is_signed ? (xs >= 0.f ? 0.5f : -0.5f)
                                               : 0.5f));
  return q * (am * (1.f / 127.f));
}

// acc[i][j] = sum_w dp4a(a[w][ay*4 + i], b[w][bx*4 + j]) over word tiles.
template <int D>
__device__ __forceinline__ void tile_product_i8(const int* a, int ay,
                                                const int* b, int bx,
                                                int (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 4
  for (int w = 0; w < D / 4; ++w) {
    const int4 x = *reinterpret_cast<const int4*>(a + w * LD + ay * 4);
    const int4 y = *reinterpret_cast<const int4*>(b + w * LD + bx * 4);
    const int xv[4] = {x.x, x.y, x.z, x.w};
    const int yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], yv[j], acc[i][j]);
  }
}

}  // namespace mfa

// Quantized K/V and int8 tiles shared by the quantized attention forward and
// backward kernels (csrc/quantized_attention.cu,
// csrc/quantized_attention_bwd.cu), so both read payloads one way.
//
// K and V payloads are int8 [B, Hkv, Skv, D] or group-planar int4 uint8
// [B, Hkv, Skv, D/2] (D <= 256: byte j holds value j in its low nibble and
// value j + D/2 in its high one, each stored + 8).  They are read four
// values to a 32-bit word and either widened to fp32 (or dequantized) while
// they are staged into the transposed [D][LD] tiles of attention_tiles.cuh,
// or kept as words [D/4][LD] for __dp4a products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "common.cuh"

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

// Values [4w, 4w + 4) of one payload row of D values as an int32 word of
// four int8: int8 rows as they are; int4 rows from the four bytes whose
// low (values < D/2) or high nibbles hold them, minus 8 per byte.
template <int D>
__device__ __forceinline__ int load_word(const uint8_t* row, int w, int bits) {
  const int e = 4 * w;
  if (bits == 8) return *reinterpret_cast<const int*>(row + e);
  constexpr int H = D / 2;
  const unsigned u =
      *reinterpret_cast<const unsigned*>(row + (e < H ? e : e - H));
  const unsigned nib = e < H ? (u & 0x0F0F0F0Fu) : ((u >> 4) & 0x0F0F0F0Fu);
  return (int)__vsub4(nib, 0x08080808u);
}

__device__ __forceinline__ float byte_of(int word, int e) {
  return (float)(signed char)((word >> (8 * e)) & 0xFF);
}

// Stage payload rows [t0, t0 + 64) of kv head `head` (zeros from `limit`)
// transposed into dst[d * LD + r] as fp32: the integer values, or
// dequantized and, with `rb`, rounded to bf16.
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
    if (t < limit) {
      const int word =
          load_word<D>(op.pay + (head * Skv + t) * row_bytes, w, op.bits);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = byte_of(word, e);
      if (op.mode == DQ_TOKEN) {
        const float s = op.sc[head * Skv + t];
        const float z = op.zp[head * Skv + t];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __fmul_rn(f[e] - z, s);
          f[e] = rb ? round_bf16(x) : x;
        }
      } else if (op.mode == DQ_BLOCK2D) {
        const size_t cell =
            (head * (Skv / br) + t / br) * (size_t)((D + bs - 1) / bs);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const size_t c = cell + (4 * w + e) / bs;
          const float s = op.sc[c];
          const float x = __fmul_rn(f[e], s) - __fmul_rn(op.zp[c], s);
          f[e] = rb ? round_bf16(x) : x;
        }
      } else if (op.mode == DQ_CHANNEL) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __fmul_rn(f[e], op.sc[head * D + 4 * w + e]);
          f[e] = rb ? round_bf16(x) : x;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(4 * w + e) * LD + r] = f[e];
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

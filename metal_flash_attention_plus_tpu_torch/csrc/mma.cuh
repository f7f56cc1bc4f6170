// Warp-level tensor-core and asynchronous-copy helpers for Hopper (sm_90a),
// as inline PTX: mma.sync (bf16 m16n8k16 into fp32, s8 m16n8k32 into
// int32, s8 m16n8k16 into int32), ldmatrix (plain and transposed) and
// 16-, 8- and 4-byte cp.async with commit and wait groups.  Used by the
// tensor-core bodies of
// csrc/flash_attention.cu, csrc/attention_bwd.cuh,
// csrc/quantized_attention.cu and csrc/quantized_gemm.cu.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k32"), with g = lane / 4 and t = lane % 4:
//   - A (16 rows x 32 bytes of k: 16 bf16 or 32 s8), four 32-bit registers:
//     a0 row g, bytes [4t, 4t + 4); a1 row g + 8, the same bytes; a2 row g,
//     bytes [16 + 4t, 16 + 4t + 4); a3 row g + 8, those bytes;
//   - B (32 bytes of k x 8 columns), two registers: b0 column g, bytes
//     [4t, 4t + 4) of k; b1 column g, bytes [16 + 4t, 16 + 4t + 4);
//   - C / D (16 x 8, fp32 or int32): c0, c1 row g, columns 2t, 2t + 1; c2,
//     c3 row g + 8, the same columns.
// Both products take 32 bytes of k per row, so one operand layout in shared
// memory (rows of k, 32-byte chunks) serves both: ldmatrix.x4 at the
// addresses of ldsm_a_row / ldsm_b_row below returns A, or B for two
// 8-column blocks, for either type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mfa {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) are zeros.
// Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8 bytes global -> shared (both 8-byte aligned); zeros when src_bytes is 0.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (both 4-byte aligned); zeros when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices (rows of 16 bytes); lane l gives the row address
// of matrix l / 8, row l % 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Two 8 x 8 b16 matrices; lanes 0-15 give the row addresses of matrix
// l / 8, row l % 8 (the other lanes' addresses are not read).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// The same as ldsm_x4, each matrix transposed (b16 elements).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Lane offsets for ldsm_x4 over a row-major tile whose rows hold k:
//   A: rows r0 + [0, 16), the 32-byte k chunk at byte k0 -> a0..a3;
//   B: rows (columns of B) n0 + [0, 16), the same chunk -> {b0, b1} of
//      columns n0 + [0, 8) in r[0], r[1] and of n0 + [8, 16) in r[2], r[3].
__device__ __forceinline__ int ldsm_a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int ldsm_a_byte(int lane) { return (lane >> 4) * 16; }
__device__ __forceinline__ int ldsm_b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int ldsm_b_byte(int lane) {
  return ((lane >> 3) & 1) * 16;
}
// ldsm_x4_t over a bf16 tile stored [k][n] (B of m16n8k16 by rows of k):
// k rows k0 + ldsm_t_k(lane), columns n0 + ldsm_t_n(lane) -> {b0, b1} of
// columns n0 + [0, 8) in r[0], r[1] and of n0 + [8, 16) in r[2], r[3].
__device__ __forceinline__ int ldsm_t_k(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int ldsm_t_n(int lane) { return (lane >> 4) * 8; }

// d = a * b + c, bf16 x bf16 -> fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a * b + c, s8 x s8 -> int32 (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1,
                                       const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// d = a * b + c, s8 x s8 -> int32 over 16 bytes of k (m16n8k16): a0 row g
// and a1 row g + 8, bytes [4t, 4t + 4); b0 column g, bytes [4t, 4t + 4).
// The two halves of an m16n8k32 fragment ({a0, a1} / {a2, a3} and b0 / b1)
// are the fragments of its two 16-byte slices.
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b0,
                                           const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// Exact conversions on the FP32 and integer pipes.  Hopper's conversion
// unit (I2F, F2I, F2F: also float <-> bf16) runs 16 lanes a clock per SM,
// the FP32 pipe 128, so the tensor-core bodies keep conversions off it:
//   - s8_f32<e>(x): byte e of a word of four int8, XORed with 0x80808080
//     by the caller (x = w ^ 0x80808080), as a float: the byte becomes
//     the low mantissa of 2^23, then 2^23 + 128 is subtracted;
//   - u8_f32<e>(x): byte e of a word of four unsigned bytes, as a float;
//   - biased_f32(S + I32_BIAS): an int32 sum S with |S| < 2^22, summed
//     from I32_BIAS instead of 0 (an mma's C operand), as a float;
//   - bf16_bits(x): x (finite) rounded to bf16, to nearest even, as the
//     bits of a float; pack_bf16_exact(lo, hi): two floats that bf16
//     represents exactly as a bf16x2 register.
// Each gives the same bits as the conversion instruction.
template <int E>
__device__ __forceinline__ float s8_f32(uint32_t x) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | E)) -
         8388736.0f;
}
template <int E>
__device__ __forceinline__ float u8_f32(uint32_t x) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | E)) -
         8388608.0f;
}
constexpr int I32_BIAS = 0x4B400000;  // 1.5 * 2^23 as a float's bits
__device__ __forceinline__ float biased_f32(int biased) {
  return __int_as_float(biased) - 12582912.0f;
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}
__device__ __forceinline__ uint32_t pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// The low bytes of four floats' bits as one word (a in the low byte).
__device__ __forceinline__ uint32_t low_bytes(float a, float b, float c,
                                              float d) {
  return __byte_perm(
      __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040),
      __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040), 0x5410);
}

// A 4 x 4 byte transpose: y[e] holds byte e of x[0], x[1], x[2], x[3]
// (x[0]'s in its low byte).
__device__ __forceinline__ void transpose_bytes(const unsigned (&x)[4],
                                                unsigned (&y)[4]) {
  const unsigned lo01 = __byte_perm(x[0], x[1], 0x5140);
  const unsigned hi01 = __byte_perm(x[0], x[1], 0x7362);
  const unsigned lo23 = __byte_perm(x[2], x[3], 0x5140);
  const unsigned hi23 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(lo01, lo23, 0x5410);
  y[1] = __byte_perm(lo01, lo23, 0x7632);
  y[2] = __byte_perm(hi01, hi23, 0x5410);
  y[3] = __byte_perm(hi01, hi23, 0x7632);
}

// bar.sync on barrier `id` (1-15; 0 is __syncthreads') for the `n` threads,
// whole warps, that use it.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// 2^x on the special-function unit (ex2.approx.ftz: results below 2^-126
// flushed to 0, 2^-inf = 0).  exp2f adds instructions for the subnormal
// range, which neither a bf16-rounded P nor the row sum l sees; in the
// softmax bodies they cost more than the products.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16x2 register (lo in the low half), rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mfa

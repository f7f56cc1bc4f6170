// Quantized GEMMs for Hopper (sm_90a): the dynamic W8A8 / W4A8 GEMM, the
// two weight-only GEMMs (a float A times a quantized weight), the two
// quantized-A GEMMs (a quantized A times a float B) and the two compensated
// int8 x int8 GEMMs.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/quantized_gemm.py::_dyn_kernel        -> dyn_gemm_kernel
//   - ops/quantized_gemm.py::_wo_folded_kernel  -> wo_tc_kernel (folded)
//   - ops/quantized_gemm.py::_wo_kernel         -> wo_tc_kernel (bf16 A),
//                                                   wo_kernel (fp32 A)
//   - ops/quantized_gemm.py::_qa_folded_kernel  -> qa_tc_kernel (folded)
//   - ops/quantized_gemm.py::_qa_kernel         -> qa_tc_kernel (bf16 B),
//                                                   qa_kernel (fp32 B)
//   - ops/quantized_gemm.py::_comp_kernel       -> comp_tc_kernel
//   - ops/quantized_gemm.py::_comp_small_kernel -> comp_small_kernel
// Each family is described before its kernels.
//
// dyn_gemm_kernel:
// Computes out[m, n] = (float(acc) - rs[m] * zb[n]) * (sa[m] * sb[n]) [+ c]
// with acc = sum_k qa[m, k] * qb[n, k] accumulated exactly in int32:
//   - qa [M, K] int8: activations quantized per row by the wrapper
//     (ops/quantized_gemm.py), sa their scales, rs their row sums (fp32);
//   - qb [N, K] int8, or [N, K/2] uint8 group-planar int4 (BITS == 4):
//     element k lies in group g = k / 256 at offset j = k % 256, in byte
//     g * 128 + j % 128, low nibble if j < 128, high nibble otherwise,
//     stored as value + 8; the kernel unpacks it to int8 on the fly;
//   - sb, zb [N] fp32: the weight's per-output-channel (or broadcast
//     per-tensor) scale and zero point; c [M, N] fp32 or null.
// The epilogue runs once per output element in the JAX kernel's order and
// with its roundings as XLA runs it (XLA fuses a multiply into the add or
// subtract that follows it): d = fma(-rs, zb, float(acc)); out = fma(d,
// sa*sb, c) with C, d * (sa*sb) without.  Every step is an explicitly
// rounded intrinsic, so the compiler contracts nothing else, and the plain
// PyTorch version computes the same numbers exactly.
//
// What bounds it on the H100, and the design.
//   Decode (M = 8) reads every weight byte for 16 multiply-adds per byte:
//   the bound is the weight bytes over 3.35 TB/s.  Per decode step the
//   flagship's int8 weights are 8 x 15.2 M + 33.6 M ~= 155 MB, ~46 us, half
//   of bf16's (int4: a quarter).  A prefill chunk (M = 256) does 512 int8
//   operations per weight byte, above the ~590 op/byte ridge of the int8
//   tensor cores (1,979 TOP/s) only at M >= ~300, so it is near the ridge.
//   This first version is simple and exact: one CTA computes a 64 x 64
//   output tile; each K step stages a 64 x 64-byte tile of A and of B in
//   shared memory as 32-bit words (int4 unpacked to int8 while staging),
//   transposed so that each thread's 4 x 4 block of outputs reads 16-byte
//   vectors, and accumulates with __dp4a (four int8 products per
//   instruction, into int32).  It does not use the tensor cores, and at
//   decode the N / 64 CTAs of a 1024-wide projection leave most SMs idle;
//   mma.sync / wgmma s8, TMA or cp.async staging and split-K for small M
//   are the planned speed work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using mfa::Elem;

constexpr int DG_BM = 64;       // output rows per CTA
constexpr int DG_BN = 64;       // output columns per CTA
constexpr int DG_BK = 64;       // K bytes per step
constexpr int DG_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int DG_KW = DG_BK / 4;  // 32-bit words per staged row
constexpr int DG_PAD = 4;

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) |
         ((uint32_t)(c & 0xFF) << 16) | ((uint32_t)(d & 0xFF) << 24);
}

// 16 int8 values of row `row` from column k (4 words); zero outside the
// row's [0, K) or when row >= rows.  Vector loads need K % 16 == 0.
__device__ __forceinline__ void load_int8_16(const int8_t* __restrict__ base,
                                             int row, int rows, int k, int K,
                                             uint32_t* w) {
  if (row < rows && (K % 16) == 0 && k + 16 <= K) {
    const uint4 u =
        *reinterpret_cast<const uint4*>(base + (size_t)row * K + k);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k + 4 * i + e;
      v[e] = (row < rows && kk < K) ? (int)base[(size_t)row * K + kk] : 0;
    }
    w[i] = pack4(v[0], v[1], v[2], v[3]);
  }
}

// 16 int4 values (as int8) of row `row` from column k; K % 256 == 0 and k
// a multiple of 16, so the 16 elements share one group half and lie in 16
// consecutive bytes.
__device__ __forceinline__ void load_int4_16(const uint8_t* __restrict__ base,
                                             int row, int rows, int k, int K,
                                             uint32_t* w) {
  if (row >= rows) {
    w[0] = w[1] = w[2] = w[3] = 0u;
    return;
  }
  const int j = k % 256;
  const size_t byte = (size_t)row * (K / 2) + (size_t)(k / 256) * 128 + j % 128;
  const uint4 u = *reinterpret_cast<const uint4*>(base + byte);
  const uint32_t src[4] = {u.x, u.y, u.z, u.w};
  const int shift = (j < 128) ? 0 : 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (int)((src[i] >> (8 * e + shift)) & 0xFu) - 8;
    w[i] = pack4(v[0], v[1], v[2], v[3]);
  }
}

// Word-major (transposed) int8 tiles of one K step: as_[kw][m], bs_[kw][n].
typedef uint32_t DgTile[DG_KW][DG_BM + DG_PAD];

// One K step [k0, k0 + DG_BK) of the 64 x 64 output tile at (m0, n0):
// stage A rows and B rows (int8, or int4 B unpacked to int8) as words,
// transposed so that each thread's 4 x 4 block of outputs reads 16-byte
// vectors, then acc[i][j] += their products with __dp4a (four int8
// products per instruction, into int32).
template <int BITS>
__device__ __forceinline__ void dg_step(const int8_t* __restrict__ qa,
                                        const void* __restrict__ qb, int M,
                                        int N, int K, int m0, int n0, int k0,
                                        DgTile& as_, DgTile& bs_,
                                        int (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. +3
  const int ty = tid / 16;  // output rows ty*4 .. +3
  // Staging: thread -> (tile row r, 16-byte chunk q) of both tiles.
  const int sr = tid / 4;
  const int sq = tid % 4;
  uint32_t wa[4], wb[4];
  load_int8_16(qa, m0 + sr, M, k0 + sq * 16, K, wa);
  if (BITS == 8)
    load_int8_16(static_cast<const int8_t*>(qb), n0 + sr, N, k0 + sq * 16, K,
                 wb);
  else
    load_int4_16(static_cast<const uint8_t*>(qb), n0 + sr, N, k0 + sq * 16,
                 K, wb);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    as_[sq * 4 + i][sr] = wa[i];
    bs_[sq * 4 + i][sr] = wb[i];
  }
  __syncthreads();
#pragma unroll
  for (int kw = 0; kw < DG_KW; ++kw) {
    const uint4 a4 = *reinterpret_cast<const uint4*>(&as_[kw][ty * 4]);
    const uint4 b4 = *reinterpret_cast<const uint4*>(&bs_[kw][tx * 4]);
    const int av[4] = {(int)a4.x, (int)a4.y, (int)a4.z, (int)a4.w};
    const int bv[4] = {(int)b4.x, (int)b4.y, (int)b4.z, (int)b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
  __syncthreads();
}

template <int BITS>
__global__ void __launch_bounds__(DG_THREADS)
dyn_gemm_kernel(const int8_t* __restrict__ qa, const void* __restrict__ qb,
                const float* __restrict__ sa, const float* __restrict__ rs,
                const float* __restrict__ sb, const float* __restrict__ zb,
                const float* __restrict__ c, float* __restrict__ out, int M,
                int N, int K) {
  __shared__ __align__(16) DgTile as_;
  __shared__ __align__(16) DgTile bs_;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * DG_BM;
  const int n0 = blockIdx.x * DG_BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += DG_BK)
    dg_step<BITS>(qa, qb, M, N, K, m0, n0, k0, as_, bs_, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const float sam = sa[m];
    const float rsm = rs[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const float d = __fmaf_rn(-rsm, zb[n], __int2float_rn(acc[i][j]));
      const float s = __fmul_rn(sam, sb[n]);
      const size_t idx = (size_t)m * N + n;
      out[idx] = (c != nullptr) ? __fmaf_rn(d, s, c[idx]) : __fmul_rn(d, s);
    }
  }
}

// ---------------------------------------------------------------------------
// Weight-only GEMMs: out [M, N] = A [M, K] x W^T, W the payload [N, K] int8
// or [N, K/2] uint8 group-planar int4 (as dyn_gemm_kernel reads it):
//
//   - the TPU's _wo_folded_kernel (SYMMETRIC TENSOR / ROW weights, a non-fp32
//     A cast to bf16 by the wrapper): acc = sum_k a * w over the integer
//     weights, exact products (bf16 x int8 fits fp32's 24-bit significand)
//     summed in fp32; then out = acc * s[n] and, with C, out + c, each
//     rounded once (the scale multiplies the accumulator once, and C is not
//     scaled).  wo_tc_kernel's FOLDED instances below;
//   - the TPU's _wo_kernel (every other weight, or an fp32 A): each weight
//     element dequantized (w - zp) * s in fp32 with the scale and zero point
//     of its TENSOR (one), ROW (per n) or BLOCK (per k, expanded to [K] by
//     the wrapper) cell, rounded to the compute type AT (fp32 for an fp32 A,
//     else bf16), then acc = sum_k a * deq in fp32; out = acc (+ c).  A bf16
//     A takes wo_tc_kernel below, on the tensor cores; an fp32 A stays on
//     wo_kernel, the scalar tile here (TF32 would break its fp32 gate).
// Both store the caller's type (OutType: fp32, or bf16 / fp16 rounded once
// to nearest), as the TPU kernels' store does, so a bf16 result is the fp32
// one rounded.
//
// What bounds them on the H100.  At MLA's decompression (M = B*S = 4096
// latent rows, N = H*dh = 1024, K = d_c = 256) the work is 2*M*N*K =
// 2.1 GFLOP over ~10.7 MB (A 2 MB bf16, W 0.26 MB int8, out 8.4 MB bf16),
// ~197 flop/byte: below the bf16 ridge (~295), so bytes bound it, at
// ~3.2 us.  At the GEMM bench's shapes (M = 128 or 4096, N = K = 8192) the
// bf16 tensor cores bound M = 4096 at ~0.56 ms and the weight's bytes
// M = 128 at ~0.02 ms (int8).  The scalar tile: one CTA per 64 x 64 output
// tile, 256 threads with 4 x 4 outputs each; each K step stages a 64 x 32
// tile of A and of the weights in shared memory as fp32 (the weights
// dequantized and rounded while staging), transposed so each thread's rows
// and columns are 16-byte vectors, and accumulates with scalar fp32 FMAs
// (67 TFLOP/s peak).
// ---------------------------------------------------------------------------

constexpr int WO_BM = 64;
constexpr int WO_BN = 64;
constexpr int WO_BK = 32;
constexpr int WO_THREADS = 256;
constexpr int WO_LD = 64 + 4;

enum WoScales { WO_TENSOR = 0, WO_ROW = 1, WO_BLOCK = 2 };
enum OutType { OUT_F32 = 0, OUT_BF16 = 1, OUT_F16 = 2 };

// out[idx] = v in `otype`, rounded once to nearest.
__device__ __forceinline__ void store_out(void* out, int otype, size_t idx,
                                          float v) {
  if (otype == OUT_BF16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else if (otype == OUT_F16)
    static_cast<__half*>(out)[idx] = __float2half_rn(v);
  else
    static_cast<float*>(out)[idx] = v;
}

// out[idx], out[idx + 1] = v0, v1: one aligned vector store where `pair`
// (both in range, idx even), else v0 and, where `hi`, v1.
__device__ __forceinline__ void store_out2(void* out, int otype, size_t idx,
                                           float v0, float v1, bool pair,
                                           bool hi) {
  if (!pair) {
    store_out(out, otype, idx, v0);
    if (hi) store_out(out, otype, idx + 1, v1);
  } else if (otype == OUT_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       idx) = __floats2bfloat162_rn(v0, v1);
  } else if (otype == OUT_F16) {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + idx) =
        __floats2half2_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
        make_float2(v0, v1);
  }
}

// Weight element (n, k) as an integer: int8, or the group-planar int4 nibble
// (group k / 256; within it byte j % 128, low nibble for j < 128), - 8.
template <int BITS>
__device__ __forceinline__ int weight_at(const void* w, int n, int k, int K) {
  if (BITS == 8) return static_cast<const int8_t*>(w)[(size_t)n * K + k];
  const int j = k % 256;
  const uint8_t byte = static_cast<const uint8_t*>(
      w)[(size_t)n * (K / 2) + (size_t)(k / 256) * 128 + j % 128];
  return (int)((j < 128) ? (byte & 0xF) : (byte >> 4)) - 8;
}

// Element (r, k) of a quantized operand [R, K], dequantized in fp32 with the
// scale and zero point of its TENSOR (one), ROW (per r) or BLOCK (per k,
// expanded to [K] by the wrapper) cell and rounded to the compute type CT:
// round_CT((q - zp) * s), as the TPU kernels do.
template <typename CT, int BITS>
__device__ __forceinline__ float dequant_at(const void* q,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ zp,
                                            int scales, int r, int k, int K) {
  const int cell = scales == WO_TENSOR ? 0 : (scales == WO_ROW ? r : k);
  const float v = (float)weight_at<BITS>(q, r, k, K);
  return Elem<CT>::round(__fmul_rn(__fsub_rn(v, zp[cell]), scale[cell]));
}

// acc[i][j] += sum over the staged K step of a[m][k] * b[n][k], both tiles
// transposed [BK][LD]: one 16-byte vector of rows and one of columns per k.
__device__ __forceinline__ void wo_step(float (*as)[WO_LD],
                                        float (*bs)[WO_LD], int ty, int tx,
                                        float (&acc)[4][4]) {
#pragma unroll 8
  for (int kk = 0; kk < WO_BK; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Stage the K step [k0, k0 + BK) of an operand stored by rows ([R, K], K
// contiguous: A, or W / B^T), rows [r0, r0 + 64), transposed as fp32:
// t[kk][r] = at(r0 + r, k0 + kk), 0 outside [R) x [K).  Neighbouring
// threads read neighbouring k.
template <typename F>
__device__ __forceinline__ void stage_rows(float (*t)[WO_LD], int R, int K,
                                           int r0, int k0, F at) {
  for (int i = threadIdx.x; i < WO_BM * WO_BK; i += WO_THREADS) {
    const int r = i / WO_BK;
    const int kk = i % WO_BK;
    const int row = r0 + r, k = k0 + kk;
    t[kk][r] = (row < R && k < K) ? at(row, k) : 0.f;
  }
}

// The same step of an operand stored by columns (B [K, N], N contiguous),
// columns [c0, c0 + 64): t[kk][c] = at(k0 + kk, c0 + c).  Neighbouring
// threads read neighbouring n.
template <typename F>
__device__ __forceinline__ void stage_cols(float (*t)[WO_LD], int C, int K,
                                           int c0, int k0, F at) {
  for (int i = threadIdx.x; i < WO_BN * WO_BK; i += WO_THREADS) {
    const int kk = i / WO_BN;
    const int c = i % WO_BN;
    const int col = c0 + c, k = k0 + kk;
    t[kk][c] = (col < C && k < K) ? at(k, col) : 0.f;
  }
}

// Stage A rows [m0, m0 + 64) x columns [k0, k0 + BK) transposed, as fp32.
template <typename AT>
__device__ __forceinline__ void wo_stage_a(const AT* __restrict__ a, int M,
                                           int K, int m0, int k0,
                                           float (*as)[WO_LD]) {
  stage_rows(as, M, K, m0, k0, [=](int m, int k) {
    return Elem<AT>::load(a + (size_t)m * K + k);
  });
}

// wo_kernel's fp32-A instances (the bf16 A runs wo_tc_kernel).
template <int BITS>
__global__ void __launch_bounds__(WO_THREADS)
wo_kernel(const float* __restrict__ a, const void* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ zp,
          int scales, const float* __restrict__ c, void* __restrict__ out,
          int otype, int M, int N, int K) {
  __shared__ __align__(16) float as[WO_BK][WO_LD];
  __shared__ __align__(16) float bs[WO_BK][WO_LD];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * WO_BM;
  const int n0 = blockIdx.x * WO_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += WO_BK) {
    wo_stage_a(a, M, K, m0, k0, as);
    stage_rows(bs, N, K, n0, k0, [=](int n, int k) {
      return dequant_at<float, BITS>(w, scale, zp, scales, n, k, K);
    });
    __syncthreads();
    wo_step(as, bs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const size_t idx = (size_t)m * N + n;
      store_out(out, otype, idx, c ? __fadd_rn(acc[i][j], c[idx]) : acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Quantized-A GEMMs: out [M, N] fp32 = A x B, A the payload [M, K] int8 or
// [M, K/2] uint8 group-planar int4 (read as weight_at reads a weight), B a
// float [K, N]:
//
//   - the TPU's _qa_folded_kernel (SYMMETRIC TENSOR / ROW A, a non-fp32 B
//     cast to bf16 by the wrapper): acc = sum_k q * b over the integers,
//     exact products summed in fp32; out = acc * s[m] (a TENSOR scale
//     repeated over M by the wrapper), rounded once.  qa_tc_kernel's
//     FOLDED instances below;
//   - the TPU's _qa_kernel (every other A, or an fp32 B): each A element
//     dequantized by dequant_at with TENSOR, ROW (per m) or BLOCK (per k)
//     cells and rounded to B's type BT (the compute type), then acc =
//     sum_k deq * b in fp32; out = acc.  A bf16 B (the compute type bf16)
//     takes qa_tc_kernel below, on the tensor cores; an fp32 B stays on
//     qa_kernel, the weight-only pair's scalar tile with the quantized
//     operand on the A side (TF32 would break its fp32 gate).
// C is not read: the GEMM engine adds it after these kernels, in fp32.
//
// What bounds them on the H100, and the design.  At the GEMM bench's
// shapes (M = 128 or 4096, N = K = 8192) the product is 2*M*N*K = 17 or
// 550 GFLOP against 67 + 134 + 4 MB (M = 128: B bf16, out fp32) or 34 +
// 134 + 134 MB (M = 4096): the bf16 tensor cores (989 TFLOP/s) would bound
// M = 4096 at ~0.56 ms and the bytes M = 128 at ~0.06 ms.  The scalar
// tile is the weight-only kernels' fp32 FMAs (67 TFLOP/s peak): ~8 ms at
// best for M = 4096.  qa_tc_kernel runs the bf16 products on mma.sync;
// wgmma with TMA is the next step.
// ---------------------------------------------------------------------------

template <typename BT, int BITS>
__global__ void __launch_bounds__(WO_THREADS)
qa_kernel(const void* __restrict__ a, const BT* __restrict__ b,
          const float* __restrict__ scale, const float* __restrict__ zp,
          int scales, float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float as[WO_BK][WO_LD];
  __shared__ __align__(16) float bs[WO_BK][WO_LD];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * WO_BM;
  const int n0 = blockIdx.x * WO_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += WO_BK) {
    stage_rows(as, M, K, m0, k0, [=](int m, int k) {
      return dequant_at<BT, BITS>(a, scale, zp, scales, m, k, K);
    });
    stage_cols(bs, N, K, n0, k0, [=](int k, int n) {
      return Elem<BT>::load(b + (size_t)k * N + n);
    });
    __syncthreads();
    wo_step(as, bs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// qa_tc_kernel: qa_kernel's bf16-B instances and the folded GEMM on the
// tensor cores.  Each CTA
// computes a BM x 128 output tile (BM = 128, or 64 where 128-row tiles
// would give fewer than two CTAs for each SM, e.g. M = 128) with 8 warps of
// 32 x 64 (or 32 x 32) outputs, over K steps of 32 in a 4-stage cp.async
// ring:
//   - A's payload bytes (32 per row: int8, or the int4 group half's packed
//     bytes) and B's bf16 rows [K, N] (16-byte chunks) are copied into the
//     ring ahead of use (zeros past M, N and K; element loads where a row
//     is not 16-byte aligned: K % 16 or N % 8 not 0);
//   - each step's A tile is dequantized once into bf16 rows, during the
//     previous step's products (two bf16 tiles, one barrier a step), with
//     dequant_at's arithmetic and rounding (round_bf16((q - zp)*s)), zeros
//     past M and K; a thread takes 16 (or 8) k of one row, the same row
//     each step, so a TENSOR or ROW scale stays in registers (BLOCK ones
//     are staged beside the payload); the payload's integers become floats
//     on the FP32 pipe (mma.cuh's s8_f32) and the rounding to bf16 runs on
//     the conversion unit (cvt.rn.bf16x2), so the two share the work;
//   - A by ldmatrix, B by ldmatrix.trans, bf16 m16n8k16 into fp32.  The two
//     products of a step sum into a zeroed fragment that is then added to
//     the accumulator in fp32 (round to nearest), so the tensor core's own
//     accumulation spans 32 products only and the result stays within the
//     fp32 gate of the plain version at K = 8192.
// FOLDED (the folded GEMM): A's integers become bf16 unchanged (exact for
// int8 and int4: no zero point, no scale) and the epilogue multiplies the
// row's scale, out = acc * s[m], rounded once.  wo_tc_kernel below runs the
// weight-only pair on the same frame, the quantized operand on B's side.
// ---------------------------------------------------------------------------

constexpr int QT_BN = 128;
constexpr int QT_BK = 32;
constexpr int QT_THREADS = 256;
constexpr int QT_ARAW_LD = QT_BK + 16;   // bytes per staged A payload row
constexpr int QT_A_LD = 2 * QT_BK + 16;  // bytes per dequantized bf16 A row
constexpr int QT_B_LD = 2 * QT_BN + 16;  // bytes per staged bf16 B row

// The card's SM count (read once).
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

constexpr int QT_STAGES = 4;  // the cp.async ring

// A's payload ring, B's ring, two dequantized A tiles and the ring of
// BLOCK scales and zero points (~80 KB at BM = 128: two CTAs an SM).
template <int BM>
constexpr size_t qa_tc_smem() {
  return (size_t)QT_STAGES * (BM * QT_ARAW_LD + QT_BK * QT_B_LD) +
         2 * (size_t)BM * QT_A_LD + QT_STAGES * 2 * QT_BK * sizeof(float);
}

// Copy the K step [k0, k0 + QT_BK) of payload rows [r0, r0 + R) of a
// quantized operand [rows, K] into one ring stage (R rows of QT_ARAW_LD
// bytes) by cp.async: int8, or int4 (K % 256 == 0: the 32 k share one group
// half, whose 32 packed bytes are copied); zeros past `rows` and K; element
// loads where an int8 row is not 16-byte aligned (`vec` false).
template <int BITS, int R>
__device__ __forceinline__ void stage_payload(uint8_t* dst,
                                              const uint8_t* __restrict__ p,
                                              int r0, int rows, int K, int k0,
                                              bool vec) {
  constexpr int CH = QT_BK / 16;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * CH; i += QT_THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const int row = r0 + r;
    uint8_t* d = dst + r * QT_ARAW_LD + c * 16;
    if (BITS == 4) {
      const size_t off = (size_t)(row < rows ? row : 0) * (K / 2) +
                         (size_t)(k0 / 256) * 128 + (k0 % 256) % 128 + c * 16;
      mfa::cp_async16(d, p + off, row < rows ? 16 : 0);
    } else if (vec) {
      const int kk = k0 + c * 16;
      const bool ok = row < rows && kk < K;
      mfa::cp_async16(d, p + (ok ? (size_t)row * K + kk : 0), ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int kk = k0 + c * 16 + e;
        d[e] = (row < rows && kk < K) ? p[(size_t)row * K + kk] : 0;
      }
    }
  }
}

// The step's BLOCK scales and zero points (per k, 2 * QT_BK floats) beside
// the payload, by cp.async; zeros past K.
__device__ __forceinline__ void stage_block_cells(float* dst,
                                                  const float* __restrict__ s,
                                                  const float* __restrict__ z,
                                                  int K, int k0) {
  const int tid = threadIdx.x;
  if (tid < 2 * QT_BK) {
    const int k = k0 + tid % QT_BK;
    mfa::cp_async4(dst + tid, (tid < QT_BK ? s : z) + (k < K ? k : 0),
                   k < K ? 4 : 0);
  }
}

// EPT consecutive k of one staged payload row (`src`, at the thread's first
// k, which is k0) -> bf16 at `dst`, with dequant_at's arithmetic and
// rounding, round_bf16((q - zp) * s): the row's scale and zero point
// (TENSOR, ROW) in registers, or the step's per-k ones (BLOCK) from `bsc`;
// FOLDED: the integers unchanged (exact in bf16); zeros where the row is
// not live or past K.  The payload's integers become floats on the FP32
// pipe (mma.cuh's s8_f32) and the rounding to bf16 runs on the conversion
// unit (cvt.rn.bf16x2), so the two share the work.  `shift`: 4 for the high
// nibbles of an int4 group's second half.
template <int BITS, int EPT, bool FOLDED>
__device__ __forceinline__ void dequant_bf16(const uint8_t* src,
                                             const float* bsc, int scales,
                                             float row_s, float row_z,
                                             bool live, int k0, int K,
                                             int shift, uint8_t* dst) {
  uint32_t w[EPT / 4];
#pragma unroll
  for (int v = 0; v < EPT / 8; ++v) {
    const uint2 u = *reinterpret_cast<const uint2*>(src + 8 * v);
    w[2 * v] = u.x;
    w[2 * v + 1] = u.y;
  }
  uint32_t out[EPT / 2];
#pragma unroll
  for (int v = 0; v < EPT / 4; ++v) {
    float q[4];
    if (BITS == 8) {
      const uint32_t x = w[v] ^ 0x80808080u;
      q[0] = mfa::s8_f32<0>(x);
      q[1] = mfa::s8_f32<1>(x);
      q[2] = mfa::s8_f32<2>(x);
      q[3] = mfa::s8_f32<3>(x);
    } else {  // nibbles hold q + 8
      const uint32_t x = (w[v] >> shift) & 0x0F0F0F0Fu;
      q[0] = mfa::u8_f32<0>(x) - 8.0f;
      q[1] = mfa::u8_f32<1>(x) - 8.0f;
      q[2] = mfa::u8_f32<2>(x) - 8.0f;
      q[3] = mfa::u8_f32<3>(x) - 8.0f;
    }
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 4 * v + e;
      const float sc = scales == WO_BLOCK ? bsc[4 * v + e] : row_s;
      const float z = scales == WO_BLOCK ? bsc[QT_BK + 4 * v + e] : row_z;
      d[e] = !(live && k < K) ? 0.f
             : FOLDED         ? q[e]
                              : __fmul_rn(__fsub_rn(q[e], z), sc);
    }
    out[2 * v] = mfa::pack_bf16(d[0], d[1]);
    out[2 * v + 1] = mfa::pack_bf16(d[2], d[3]);
  }
#pragma unroll
  for (int v = 0; v < EPT / 8; ++v)
    *reinterpret_cast<uint4*>(dst + 16 * v) = make_uint4(
        out[4 * v], out[4 * v + 1], out[4 * v + 2], out[4 * v + 3]);
}

// One step's 32 products on the tensor core, summed into a zeroed fragment
// and then added to the accumulator in fp32 (round to nearest): af the A
// fragments of 2 x 16 rows, bf the B fragments of NT 8-column blocks, each
// for the step's two 16-k slices.
template <int NT>
__device__ __forceinline__ void mma_step(float (&acc)[2][NT][4],
                                         const uint32_t (&af)[2][2][4],
                                         const uint32_t (&bf)[NT][2][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      mfa::mma_bf16(p, af[mi][0], bf[ni][0][0], bf[ni][0][1], p);
      mfa::mma_bf16(p, af[mi][1], bf[ni][1][0], bf[ni][1][1], p);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], p[e]);
    }
}

template <int BITS, int BM, bool FOLDED>
__global__ void __launch_bounds__(QT_THREADS, 2)
qa_tc_kernel(const void* __restrict__ a, const __nv_bfloat16* __restrict__ b,
             const float* __restrict__ scale, const float* __restrict__ zp,
             int scales, float* __restrict__ out, int M, int N, int K) {
  constexpr int STAGES = QT_STAGES;
  constexpr int WARPS_M = BM / 32;
  constexpr int WN = QT_BN / (8 / WARPS_M);  // columns per warp
  constexpr int NT = WN / 8;                 // 8-column blocks per warp
  constexpr int BCH = QT_BN / 8;             // 16-byte chunks per B row
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* araw = sm;
  uint8_t* bsm = araw + STAGES * BM * QT_ARAW_LD;
  uint8_t* adq = bsm + STAGES * QT_BK * QT_B_LD;  // two tiles
  float* bvec = reinterpret_cast<float*>(adq + 2 * BM * QT_A_LD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp % WARPS_M) * 32;
  const int wn0 = (warp / WARPS_M) * WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * QT_BN;
  const uint8_t* ap = static_cast<const uint8_t*>(a);
  const uint8_t* bp = reinterpret_cast<const uint8_t*>(b);
  const bool a_vec = BITS == 4 || (K % 16 == 0 && ((uintptr_t)a & 15) == 0);
  const bool b_vec = N % 8 == 0 && ((uintptr_t)b & 15) == 0;
  const int nk = (K + QT_BK - 1) / QT_BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * QT_BK;
    stage_payload<BITS, BM>(araw + stage * BM * QT_ARAW_LD, ap, m0, M, K, k0,
                            a_vec);
    if (scales == WO_BLOCK)
      stage_block_cells(bvec + stage * 2 * QT_BK, scale, zp, K, k0);
    uint8_t* bs = bsm + stage * QT_BK * QT_B_LD;
    for (int i = tid; i < QT_BK * BCH; i += QT_THREADS) {
      const int r = i / BCH;
      const int c = i % BCH;
      const int k = k0 + r;
      const int n = n0 + c * 8;
      uint8_t* dst = bs + r * QT_B_LD + c * 16;
      if (b_vec) {
        const bool ok = k < K && n < N;
        mfa::cp_async16(dst, bp + (ok ? ((size_t)k * N + n) * 2 : 0),
                        ok ? 16 : 0);
      } else {
        const uint16_t* bh = reinterpret_cast<const uint16_t*>(b);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          reinterpret_cast<uint16_t*>(dst)[e] =
              (k < K && n + e < N) ? bh[(size_t)k * N + n + e] : 0;
      }
    }
  };

  // A's staged payload -> bf16 rows: each thread dequantizes EPT
  // consecutive k of one row, the same row every step, with that row's
  // scale and zero point (TENSOR, ROW) held in registers or the step's
  // per-k ones (BLOCK) staged beside the payload; zeros past M and K (whose
  // B rows are zeros too).
  constexpr int EPT = BM * QT_BK / QT_THREADS;  // 16 or 8
  const int dr = tid / (QT_BK / EPT);
  const int dk = (tid % (QT_BK / EPT)) * EPT;
  const bool row_live = m0 + dr < M;
  const int row_cell = scales == WO_ROW ? m0 + dr : 0;
  const float row_s = !FOLDED && row_live ? scale[row_cell] : 0.f;
  const float row_z = !FOLDED && row_live ? zp[row_cell] : 0.f;
  auto dequant = [&](int stage, int kt, uint8_t* dst) {
    const int shift = (BITS == 4 && (kt * QT_BK % 256) >= 128) ? 4 : 0;
    dequant_bf16<BITS, EPT, FOLDED>(
        araw + stage * BM * QT_ARAW_LD + dr * QT_ARAW_LD + dk,
        bvec + stage * 2 * QT_BK + dk, scales, row_s, row_z, row_live,
        kt * QT_BK + dk, K, shift, dst + dr * QT_A_LD + 2 * dk);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const uint8_t* a_frag = adq + (wm0 + mfa::ldsm_a_row(lane)) * QT_A_LD +
                          mfa::ldsm_a_byte(lane);
  const int b_frag =
      mfa::ldsm_t_k(lane) * QT_B_LD + (wn0 + mfa::ldsm_t_n(lane)) * 2;

  // Step kt's A is dequantized during step kt - 1's products, into the
  // other of the two bf16 tiles: one barrier a step.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    mfa::cp_async_commit();
  }
  mfa::cp_async_wait<STAGES - 2>();
  __syncthreads();
  dequant(0, 0, adq);
  for (int kt = 0; kt < nk; ++kt) {
    mfa::cp_async_wait<STAGES - 3>();
    __syncthreads();  // step kt + 1 staged, A of step kt dequantized;
                      // step kt - 1's readers done
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    mfa::cp_async_commit();
    if (kt + 1 < nk)
      dequant((kt + 1) % STAGES, kt + 1, adq + ((kt + 1) & 1) * BM * QT_A_LD);
    const uint8_t* as = a_frag + (kt & 1) * BM * QT_A_LD;
    const uint8_t* bs = bsm + (kt % STAGES) * QT_BK * QT_B_LD + b_frag;
    uint32_t af[2][2][4], bf[NT][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the step's two 16-k slices
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mfa::ldsm_x4(af[mi][h], as + mi * 16 * QT_A_LD + h * 32);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t r[4];
        mfa::ldsm_x4_t(r, bs + h * 16 * QT_B_LD + n2 * 32);
        bf[2 * n2][h][0] = r[0];
        bf[2 * n2][h][1] = r[1];
        bf[2 * n2 + 1][h][0] = r[2];
        bf[2 * n2 + 1][h][1] = r[3];
      }
    }
    mma_step<NT>(acc, af, bf);
  }
  mfa::cp_async_wait<0>();

  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + wm0 + 16 * mi + g + 8 * i;
      if (m >= M) continue;
      const float row_scale = FOLDED ? scale[m] : 1.f;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = n0 + wn0 + 8 * ni + 2 * tq;
        float* o = out + (size_t)m * N + n;
        const float v0 = FOLDED ? __fmul_rn(acc[mi][ni][2 * i], row_scale)
                                : acc[mi][ni][2 * i];
        const float v1 = FOLDED ? __fmul_rn(acc[mi][ni][2 * i + 1], row_scale)
                                : acc[mi][ni][2 * i + 1];
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n < N) o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------------
// wo_tc_kernel: the weight-only pair's bf16-A instances on the tensor cores,
// on qa_tc_kernel's frame with the quantized operand on B's side: A [M, K]
// bf16 times W^T, W stored [N, K], K contiguous in both.  Each CTA computes
// a BM x 128 output tile (BM = 128, or 64 for an M of 64 or less, as the
// wrapper's wo_tile chooses) with 8 warps of 32 x 64 (or 32 x 32) outputs,
// over K steps of 32 in a 4-stage cp.async ring:
//   - A's bf16 rows (64 bytes a step) and W's payload bytes (32 a row: int8,
//     or the int4 group half's packed bytes, as weight_at reads them) are
//     copied into the ring ahead of use (zeros past M, N and K; element
//     loads where a row is not 16-byte aligned: K % 8 (A) or K % 16 (int8
//     W) not 0);
//   - each step's W tile is dequantized once into bf16 rows [128][32],
//     during the previous step's products (two bf16 tiles, one barrier a
//     step), by qa_tc_kernel's dequant_bf16: dequant_at's arithmetic and
//     rounding, round_bf16((q - zp) * s) with TENSOR, ROW (per n, in
//     registers) or BLOCK (per k, staged beside the payload) cells, or the
//     integers unchanged (FOLDED: exact in bf16);
//   - A and W both by ldmatrix, non-transposed (W's [n][k] rows are the
//     column-major B fragment m16n8k16 takes), bf16 m16n8k16 into fp32; each
//     step's 32 products sum into a zeroed fragment that is then added to
//     the accumulator in fp32 (round to nearest), which holds K = 8192 to
//     the fp32 gate of the plain version;
//   - the epilogue: FOLDED acc * s[n] rounded once, then + c (unscaled);
//     else acc (+ c); stored in the caller's type (OutType) directly.
// ~85 KB of shared memory at BM = 128 (two CTAs an SM).
// Split K: where the 128-row tiles leave SMs without a CTA (the GEMM bench's
// M = 128: 64 tiles), wo_tile splits the K steps into gridDim.z contiguous
// ranges; each CTA writes its range's fp32 sum to the workspace `part`
// [splits, M, N], and wo_reduce_kernel adds the splits in order and runs
// the epilogue: a fixed-order sum, the same bits from run to run.
// ---------------------------------------------------------------------------

// A's ring (bf16 rows of QT_A_LD bytes), W's payload ring, two dequantized
// W tiles and the ring of BLOCK scales and zero points.
template <int BM>
constexpr size_t wo_tc_smem() {
  return (size_t)QT_STAGES * (BM * QT_A_LD + QT_BN * QT_ARAW_LD) +
         2 * (size_t)QT_BN * QT_A_LD + QT_STAGES * 2 * QT_BK * sizeof(float);
}

template <int BITS, int BM, bool FOLDED>
__global__ void __launch_bounds__(QT_THREADS, 2)
wo_tc_kernel(const __nv_bfloat16* __restrict__ a, const void* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ zp,
             int scales, const float* __restrict__ c, void* __restrict__ out,
             float* __restrict__ part, int otype, int M, int N, int K) {
  constexpr int STAGES = QT_STAGES;
  constexpr int WARPS_M = BM / 32;
  constexpr int WN = QT_BN / (8 / WARPS_M);  // columns per warp
  constexpr int NT = WN / 8;                 // 8-column blocks per warp
  constexpr int ACH = 2 * QT_BK / 16;        // 16-byte chunks per A row
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* asm_ = sm;
  uint8_t* wraw = asm_ + STAGES * BM * QT_A_LD;
  uint8_t* wdq = wraw + STAGES * QT_BN * QT_ARAW_LD;  // two tiles
  float* bvec = reinterpret_cast<float*>(wdq + 2 * QT_BN * QT_A_LD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp % WARPS_M) * 32;
  const int wn0 = (warp / WARPS_M) * WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * QT_BN;
  const uint8_t* ap = reinterpret_cast<const uint8_t*>(a);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const bool a_vec = K % 8 == 0 && ((uintptr_t)a & 15) == 0;
  const bool w_vec = BITS == 4 || (K % 16 == 0 && ((uintptr_t)w & 15) == 0);
  // This CTA's K steps [kt0, kt0 + nk): its split's range.
  const int steps = (K + QT_BK - 1) / QT_BK;
  const int kt0 = (int)((long long)steps * blockIdx.z / gridDim.z);
  const int nk = (int)((long long)steps * (blockIdx.z + 1) / gridDim.z) - kt0;

  // Step kt of the range (0 <= kt < nk) into ring stage `stage`.
  auto load = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * QT_BK;
    uint8_t* as = asm_ + stage * BM * QT_A_LD;
    for (int i = tid; i < BM * ACH; i += QT_THREADS) {
      const int r = i / ACH;
      const int ch = i % ACH;
      const int m = m0 + r;
      const int k = k0 + ch * 8;
      uint8_t* dst = as + r * QT_A_LD + ch * 16;
      if (a_vec) {
        const bool ok = m < M && k < K;
        mfa::cp_async16(dst, ap + (ok ? ((size_t)m * K + k) * 2 : 0),
                        ok ? 16 : 0);
      } else {
        const uint16_t* ah = reinterpret_cast<const uint16_t*>(a);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          reinterpret_cast<uint16_t*>(dst)[e] =
              (m < M && k + e < K) ? ah[(size_t)m * K + k + e] : 0;
      }
    }
    stage_payload<BITS, QT_BN>(wraw + stage * QT_BN * QT_ARAW_LD, wp, n0, N,
                               K, k0, w_vec);
    if (scales == WO_BLOCK)
      stage_block_cells(bvec + stage * 2 * QT_BK, scale, zp, K, k0);
  };

  // W's staged payload -> bf16 rows: each thread dequantizes 16 consecutive
  // k of one row, the same row every step, with that row's scale and zero
  // point (TENSOR, ROW) in registers; zeros past N and K (whose A columns
  // are zeros too).
  constexpr int EPT = QT_BN * QT_BK / QT_THREADS;  // 16
  const int dr = tid / (QT_BK / EPT);
  const int dk = (tid % (QT_BK / EPT)) * EPT;
  const bool row_live = n0 + dr < N;
  const int row_cell = scales == WO_ROW ? n0 + dr : 0;
  const float row_s = !FOLDED && row_live ? scale[row_cell] : 0.f;
  const float row_z = !FOLDED && row_live ? zp[row_cell] : 0.f;
  auto dequant = [&](int stage, int kt, uint8_t* dst) {
    const int k0 = (kt0 + kt) * QT_BK;
    const int shift = (BITS == 4 && (k0 % 256) >= 128) ? 4 : 0;
    dequant_bf16<BITS, EPT, FOLDED>(
        wraw + stage * QT_BN * QT_ARAW_LD + dr * QT_ARAW_LD + dk,
        bvec + stage * 2 * QT_BK + dk, scales, row_s, row_z, row_live,
        k0 + dk, K, shift, dst + dr * QT_A_LD + 2 * dk);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int a_frag =
      (wm0 + mfa::ldsm_a_row(lane)) * QT_A_LD + mfa::ldsm_a_byte(lane);
  const int b_frag =
      (wn0 + mfa::ldsm_b_row(lane)) * QT_A_LD + mfa::ldsm_b_byte(lane);

  // Step kt's W is dequantized during step kt - 1's products, into the
  // other of the two bf16 tiles: one barrier a step.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    mfa::cp_async_commit();
  }
  mfa::cp_async_wait<STAGES - 2>();
  __syncthreads();
  dequant(0, 0, wdq);
  for (int kt = 0; kt < nk; ++kt) {
    mfa::cp_async_wait<STAGES - 3>();
    __syncthreads();  // step kt + 1 staged, W of step kt dequantized;
                      // step kt - 1's readers done
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    mfa::cp_async_commit();
    if (kt + 1 < nk)
      dequant((kt + 1) % STAGES, kt + 1,
              wdq + ((kt + 1) & 1) * QT_BN * QT_A_LD);
    const uint8_t* as = asm_ + (kt % STAGES) * BM * QT_A_LD + a_frag;
    const uint8_t* ws = wdq + (kt & 1) * QT_BN * QT_A_LD + b_frag;
    uint32_t af[2][2][4], bf[NT][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the step's two 16-k slices
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mfa::ldsm_x4(af[mi][h], as + mi * 16 * QT_A_LD + h * 32);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t r[4];
        mfa::ldsm_x4(r, ws + n2 * 16 * QT_A_LD + h * 32);
        bf[2 * n2][h][0] = r[0];
        bf[2 * n2][h][1] = r[1];
        bf[2 * n2 + 1][h][0] = r[2];
        bf[2 * n2 + 1][h][1] = r[3];
      }
    }
    mma_step<NT>(acc, af, bf);
  }
  mfa::cp_async_wait<0>();

  const int g = lane >> 2;
  const int tq = lane & 3;
  if (part != nullptr) {  // split K: the range's sum, for wo_reduce_kernel
    float* p = part + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm0 + 16 * mi + g + 8 * i;
        if (m >= M) continue;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int n = n0 + wn0 + 8 * ni + 2 * tq;
          if (n < N)
            store_out2(p, OUT_F32, (size_t)m * N + n, acc[mi][ni][2 * i],
                       acc[mi][ni][2 * i + 1], n + 1 < N && N % 2 == 0,
                       n + 1 < N);
        }
      }
    return;
  }
  float col_s[NT][2];  // FOLDED: the columns' scales
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn0 + 8 * ni + 2 * tq + e;
      col_s[ni][e] = FOLDED && n < N ? scale[n] : 1.f;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + wm0 + 16 * mi + g + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = n0 + wn0 + 8 * ni + 2 * tq;
        if (n >= N) continue;
        const size_t idx = (size_t)m * N + n;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[mi][ni][2 * i + e];
          if (FOLDED) v[e] = __fmul_rn(v[e], col_s[ni][e]);
          if (c != nullptr && n + e < N) v[e] = __fadd_rn(v[e], c[idx + e]);
        }
        store_out2(out, otype, idx, v[0], v[1], n + 1 < N && N % 2 == 0,
                   n + 1 < N);
      }
    }
}

// out = the epilogue of sum_s part[s] (s = 0, 1, ... in order, fp32 round to
// nearest): with `scale` (folded) the sum times scale[n] rounded once, then
// + c; stored in otype.  One thread per output element.
__global__ void __launch_bounds__(256)
wo_reduce_kernel(const float* __restrict__ part, int splits,
                 const float* __restrict__ scale, const float* __restrict__ c,
                 void* __restrict__ out, int otype, int M, int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (idx >= mn) return;
  float v = part[idx];
  for (int sp = 1; sp < splits; ++sp) v = __fadd_rn(v, part[sp * mn + idx]);
  if (scale != nullptr) v = __fmul_rn(v, scale[idx % N]);
  if (c != nullptr) v = __fadd_rn(v, c[idx]);
  store_out(out, otype, idx, v);
}

// ---------------------------------------------------------------------------
// Compensated int8 x int8 GEMMs: out [M, N] fp32 = dequant(A) x
// dequant(B^T)^T (+ C), A [M, K] and B^T [N, K] int8, both BLOCK-quantized
// along K with one block size bs: per-block scales sa, sb and zero points
// za, zb.
//
//   - comp_tc_kernel (the TPU's _comp_kernel; bs a multiple of 128): per K
//     block b, the exact int32 block product Sqq = A_b . B_b^T on the s8
//     tensor cores, then in int32 comp = Sqq - zb*SqA - za*SqB + bs*za*zb
//     with the wrapper's per-row block sums SqA [M, nb], SqB [N, nb],
//     rounded to fp32, and acc = fma(sa*sb, comp, acc): the fused
//     multiply-add XLA gives the TPU kernel, so the plain version matches
//     bit for bit (integer sums are exact in any order, and the fp32 steps
//     run per block in the same order); C added at the store;
//   - comp_small_kernel (the TPU's _comp_small_kernel; blocks the int8
//     product cannot separate, 16..64): both operands dequantized per
//     element in fp32 as fma(q, s[k], -(z*s)[k]) (the per-block vectors
//     expanded to [K] by the wrapper; the fused form XLA gives the TPU
//     kernel), exact fp32 products summed in fp32, C at the store.
//
// What bounds them on the H100, and the design.  At the GEMM bench's
// shapes the product is 2*M*N*K = 17 or 550 G operations against 67 + 1 +
// 4 MB or 34 + 67 + 134 MB of int8 operands and fp32 output: the int8
// tensor cores (1,979 TOP/s) bound M = 4096 at ~0.28 ms, the bytes M = 128
// at ~0.02 ms.  comp_tc_kernel is qa_tc_kernel's frame for two int8
// operands: a BM x 128 output tile a CTA (BM = 128, or 64 where 128-row
// tiles would give fewer than two CTAs for each SM, e.g. M = 128), 8 warps
// of 32 x 64 (or 32 x 32) outputs; both operands' rows of k, 128 bytes a
// step, copied by cp.async into a 4-stage ring (zeros past M and N; K is
// whole blocks), read by ldmatrix and multiplied by s8 m16n8k32 mma.sync
// into int32 fragments that are zeroed at each block's start; at each
// block's end the compensation and the fp32 fused multiply-add run on the
// fragments.  Two accumulators (the block's int32, the fp32 sum) take 128
// registers a thread at BM = 128, so that tile runs one CTA an SM.  wgmma
// with TMA is the next step.  comp_small_kernel computes what the TPU
// kernel computes, an exact fp32 product of the dequantized operands, on
// the weight-only kernels' scalar fp32 tile.  The fp32 is the TPU's choice
// (a contraction under 128 leaves its MXU part empty), not the H100's
// limit: its operands are int8 too, and s8 mma.sync takes k = 32, so 32-
// and 64-blocks split into int8 block products with the per-block
// compensation, as in comp_tc_kernel.  Its bound is therefore the int8 one
// as well (~0.28 ms at M = 4096).
// ---------------------------------------------------------------------------

constexpr int CT_BN = 128;
constexpr int CT_BK = 128;          // k bytes a step
constexpr int CT_LD = CT_BK + 16;   // bytes a staged row
constexpr int CT_STAGES = 4;        // the cp.async ring
constexpr int CT_THREADS = 256;

// Both operands' rings (144 KB at BM = 128, 108 KB at 64).
template <int BM>
constexpr size_t comp_tc_smem() {
  return (size_t)CT_STAGES * (BM + CT_BN) * CT_LD;
}

template <int BM>
__global__ void __launch_bounds__(CT_THREADS, BM == 128 ? 1 : 2)
comp_tc_kernel(const int8_t* __restrict__ qa, const int8_t* __restrict__ qb,
               const float* __restrict__ sa, const int* __restrict__ za,
               const float* __restrict__ sb, const int* __restrict__ zb,
               const int* __restrict__ sqa, const int* __restrict__ sqb,
               const float* __restrict__ c, float* __restrict__ out, int M,
               int N, int K, int bs) {
  constexpr int STAGES = CT_STAGES;
  constexpr int WARPS_M = BM / 32;
  constexpr int WN = CT_BN / (8 / WARPS_M);  // columns per warp
  constexpr int NT = WN / 8;                 // 8-column blocks per warp
  constexpr int CH = CT_BK / 16;             // 16-byte chunks per row
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* as = sm;                             // [STAGES][BM][CT_LD]
  uint8_t* bsm = sm + STAGES * BM * CT_LD;      // [STAGES][CT_BN][CT_LD]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wm0 = (warp % WARPS_M) * 32;
  const int wn0 = (warp / WARPS_M) * WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * CT_BN;
  const int nk = K / CT_BK;
  const int per_block = bs / CT_BK;
  const int nb = K / bs;

  auto load = [&](int stage, int kt) {
    const size_t k0 = (size_t)kt * CT_BK;
    for (int i = tid; i < (BM + CT_BN) * CH; i += CT_THREADS) {
      const int r = i / CH;
      const int ch = i % CH;
      const bool is_a = r < BM;
      const int row = is_a ? m0 + r : n0 + r - BM;
      const bool ok = row < (is_a ? M : N);
      const int8_t* src = (is_a ? qa : qb) + (ok ? (size_t)row * K : 0) +
                          k0 + ch * 16;
      uint8_t* dst = (is_a ? as + stage * BM * CT_LD + r * CT_LD
                           : bsm + stage * CT_BN * CT_LD + (r - BM) * CT_LD) +
                     ch * 16;
      mfa::cp_async16(dst, src, ok ? 16 : 0);
    }
  };

  int part[2][NT][4];
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[mi][ni][e] = 0;
        acc[mi][ni][e] = 0.f;
      }
  const int a_off = (wm0 + mfa::ldsm_a_row(lane)) * CT_LD +
                    mfa::ldsm_a_byte(lane);
  const int b_off = (wn0 + mfa::ldsm_b_row(lane)) * CT_LD +
                    mfa::ldsm_b_byte(lane);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    mfa::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mfa::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt staged; step kt - 1's readers done
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    mfa::cp_async_commit();
    const uint8_t* a_s = as + (kt % STAGES) * BM * CT_LD + a_off;
    const uint8_t* b_s = bsm + (kt % STAGES) * CT_BN * CT_LD + b_off;
#pragma unroll
    for (int kk = 0; kk < CT_BK / 32; ++kk) {  // 32 bytes of k a product
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mfa::ldsm_x4(af[mi], a_s + mi * 16 * CT_LD + kk * 32);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bf[4];
        mfa::ldsm_x4(bf, b_s + n2 * 16 * CT_LD + kk * 32);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mfa::mma_s8(part[mi][2 * n2], af[mi], bf[0], bf[1],
                      part[mi][2 * n2]);
          mfa::mma_s8(part[mi][2 * n2 + 1], af[mi], bf[2], bf[3],
                      part[mi][2 * n2 + 1]);
        }
      }
    }
    if ((kt + 1) % per_block) continue;
    // The block's end: its compensation, then acc = fma(sa*sb, comp, acc),
    // in int32 and fp32 as the plain version.
    const int blk = (kt + 1) / per_block - 1;
    const float s = __fmul_rn(sa[blk], sb[blk]);
    const int zab = za[blk], zbb = zb[blk];
    const int zz = bs * zab * zbb;
    int rsb[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn0 + 8 * ni + 2 * tq + e;
        rsb[ni][e] = n < N ? sqb[(size_t)n * nb + blk] : 0;
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm0 + 16 * mi + g + 8 * i;
        const int rsa = m < M ? sqa[(size_t)m * nb + blk] : 0;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int& p = part[mi][ni][2 * i + e];
            const int comp = p - zbb * rsa - zab * rsb[ni][e] + zz;
            float& x = acc[mi][ni][2 * i + e];
            x = __fmaf_rn(s, __int2float_rn(comp), x);
            p = 0;
          }
      }
  }
  mfa::cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + wm0 + 16 * mi + g + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = n0 + wn0 + 8 * ni + 2 * tq;
        const size_t idx = (size_t)m * N + n;
        float v0 = acc[mi][ni][2 * i], v1 = acc[mi][ni][2 * i + 1];
        if (c) {
          if (n < N) v0 = __fadd_rn(v0, c[idx]);
          if (n + 1 < N) v1 = __fadd_rn(v1, c[idx + 1]);
        }
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
        } else {
          if (n < N) out[idx] = v0;
          if (n + 1 < N) out[idx + 1] = v1;
        }
      }
    }
}

__global__ void __launch_bounds__(WO_THREADS)
comp_small_kernel(const int8_t* __restrict__ qa,
                  const int8_t* __restrict__ qb,
                  const float* __restrict__ sa, const float* __restrict__ zsa,
                  const float* __restrict__ sb, const float* __restrict__ zsb,
                  const float* __restrict__ c, float* __restrict__ out, int M,
                  int N, int K) {
  __shared__ __align__(16) float as[WO_BK][WO_LD];
  __shared__ __align__(16) float bs[WO_BK][WO_LD];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * WO_BM;
  const int n0 = blockIdx.x * WO_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += WO_BK) {
    stage_rows(as, M, K, m0, k0, [=](int m, int k) {
      return __fmaf_rn((float)qa[(size_t)m * K + k], sa[k], -zsa[k]);
    });
    stage_rows(bs, N, K, n0, k0, [=](int n, int k) {
      return __fmaf_rn((float)qb[(size_t)n * K + k], sb[k], -zsb[k]);
    });
    __syncthreads();
    wo_step(as, bs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const size_t idx = (size_t)m * N + n;
      out[idx] = c ? __fadd_rn(acc[i][j], c[idx]) : acc[i][j];
    }
  }
}

dim3 wo_grid(int M, int N) {
  return dim3((N + WO_BN - 1) / WO_BN, (M + WO_BM - 1) / WO_BM);
}

// qa_tc_kernel<BITS, BM, FOLDED> over [M, N] with 128-row tiles where they
// give two CTAs for each SM, else 64-row ones.
template <bool FOLDED>
int launch_qa_tc(const void* a, const __nv_bfloat16* b, const float* scale,
                 const float* zp, int scales, float* out, int M, int N,
                 int K, int bits, cudaStream_t s) {
  const bool wide = (long long)((M + 127) / 128) * ((N + QT_BN - 1) / QT_BN) >=
                    2LL * sm_count();
#define MFA_QA_TC(BITS, BM)                                                  \
  do {                                                                       \
    auto kern = qa_tc_kernel<BITS, BM, FOLDED>;                              \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
        (int)qa_tc_smem<BM>());                                              \
    if (err != cudaSuccess) return (int)err;                                 \
    kern<<<dim3((N + QT_BN - 1) / QT_BN, (M + BM - 1) / BM), QT_THREADS,     \
           qa_tc_smem<BM>(), s>>>(a, b, scale, zp, scales, out, M, N, K);    \
  } while (0)
  if (bits == 8 && wide)
    MFA_QA_TC(8, 128);
  else if (bits == 8)
    MFA_QA_TC(8, 64);
  else if (bits == 4 && wide)
    MFA_QA_TC(4, 128);
  else if (bits == 4)
    MFA_QA_TC(4, 64);
  else
    return (int)cudaErrorInvalidValue;
#undef MFA_QA_TC
  return (int)cudaGetLastError();
}

// wo_tc_kernel<BITS, BM, FOLDED> over [M, N] with BM-row tiles (64 or 128)
// and K split `splits` ways (1: no workspace; else ws [splits, M, N] fp32,
// summed by wo_reduce_kernel), as the wrapper's wo_tile chose.
template <bool FOLDED>
int launch_wo_tc(const void* a, const void* w, const float* scale,
                 const float* zp, int scales, const float* c, void* out,
                 int otype, int M, int N, int K, int bits, int bm, int splits,
                 float* ws, cudaStream_t s) {
  if (splits < 1 || splits > (K + QT_BK - 1) / QT_BK ||
      (splits > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
#define MFA_WO_TC(BITS, BM)                                                  \
  do {                                                                       \
    auto kern = wo_tc_kernel<BITS, BM, FOLDED>;                              \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
        (int)wo_tc_smem<BM>());                                              \
    if (err != cudaSuccess) return (int)err;                                 \
    kern<<<dim3((N + QT_BN - 1) / QT_BN, (M + BM - 1) / BM, splits),         \
           QT_THREADS, wo_tc_smem<BM>(), s>>>(pa, w, scale, zp, scales, c,   \
                                              out, ws, otype, M, N, K);      \
  } while (0)
  if (bits == 8 && bm == 128)
    MFA_WO_TC(8, 128);
  else if (bits == 8 && bm == 64)
    MFA_WO_TC(8, 64);
  else if (bits == 4 && bm == 128)
    MFA_WO_TC(4, 128);
  else if (bits == 4 && bm == 64)
    MFA_WO_TC(4, 64);
  else
    return (int)cudaErrorInvalidValue;
#undef MFA_WO_TC
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t mn = (size_t)M * N;
    wo_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
        ws, splits, FOLDED ? scale : nullptr, c, out, otype, M, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  bits: 8 or 4.  Returns the
// launch's cudaError_t; cudaErrorInvalidValue for bad bits or shapes.
extern "C" {

int mfa_dyn_gemm(const void* qa, const void* qb, const void* sa,
                 const void* rs, const void* sb, const void* zb,
                 const void* c, void* out, int M, int N, int K, int bits,
                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + DG_BN - 1) / DG_BN, (M + DG_BM - 1) / DG_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qa);
  const float* fsa = static_cast<const float*>(sa);
  const float* frs = static_cast<const float*>(rs);
  const float* fsb = static_cast<const float*>(sb);
  const float* fzb = static_cast<const float*>(zb);
  const float* fc = static_cast<const float*>(c);
  float* o = static_cast<float*>(out);
  if (bits == 8)
    dyn_gemm_kernel<8><<<grid, DG_THREADS, 0, s>>>(a, qb, fsa, frs, fsb, fzb,
                                                   fc, o, M, N, K);
  else if (bits == 4)
    dyn_gemm_kernel<4><<<grid, DG_THREADS, 0, s>>>(a, qb, fsa, frs, fsb, fzb,
                                                   fc, o, M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a: bf16 [M, K]; w: the payload; scale: fp32 [N]; c: fp32 [M, N] or null;
// out: [M, N] of otype (0 float32, 1 bfloat16, 2 float16); bm, splits: the
// tile's rows (64, 128) and the K splits; ws: fp32 [splits, M, N] when
// splits > 1, else null.  Runs wo_tc_kernel's folded tile.
int mfa_wo_folded_gemm(const void* a, const void* w, const void* scale,
                       const void* c, void* out, int M, int N, int K,
                       int bits, int otype, int bm, int splits, void* ws,
                       void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || otype < OUT_F32 || otype > OUT_F16)
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  return launch_wo_tc<true>(a, w, static_cast<const float*>(scale), nullptr,
                            WO_ROW, static_cast<const float*>(c), out, otype,
                            M, N, K, bits, bm, splits,
                            static_cast<float*>(ws),
                            static_cast<cudaStream_t>(stream));
}

// a: [M, K] of atype (0 float32, 1 bfloat16: the compute type); w: the
// payload; scale, zp: fp32 [1] (scales 0, TENSOR), [N] (1, ROW) or [K]
// (2, BLOCK); c: fp32 [M, N] or null; out: [M, N] of otype; bm, splits,
// ws as above (the tensor-core tile's; an fp32 A takes 64 and 1).  Routes
// as mfa_wo_tc_body says.
int mfa_wo_gemm(const void* a, const void* w, const void* scale,
                const void* zp, const void* c, void* out, int M, int N,
                int K, int bits, int scales, int atype, int otype, int bm,
                int splits, void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || scales < WO_TENSOR ||
      scales > WO_BLOCK || otype < OUT_F32 || otype > OUT_F16)
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ps = static_cast<const float*>(scale);
  const float* pz = static_cast<const float*>(zp);
  const float* pc = static_cast<const float*>(c);
  if (atype == 1)  // bf16 A: the tensor-core tile
    return launch_wo_tc<false>(a, w, ps, pz, scales, pc, out, otype, M, N, K,
                               bits, bm, splits, static_cast<float*>(ws), s);
  if (bm != 64 || splits != 1 || ws != nullptr)
    return (int)cudaErrorInvalidValue;
  const float* pa = static_cast<const float*>(a);
  if (atype == 0 && bits == 8)
    wo_kernel<8><<<wo_grid(M, N), WO_THREADS, 0, s>>>(pa, w, ps, pz, scales,
                                                      pc, out, otype, M, N, K);
  else if (atype == 0 && bits == 4)
    wo_kernel<4><<<wo_grid(M, N), WO_THREADS, 0, s>>>(pa, w, ps, pz, scales,
                                                      pc, out, otype, M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Which tile mfa_wo_gemm runs for an A of atype: 1 the tensor-core tile
// (bfloat16), 0 the scalar fp32 one (float32), -1 no A type of the kernel.
int mfa_wo_tc_body(int atype) {
  return atype == 1 ? 1 : (atype == 0 ? 0 : -1);
}

// a: the payload [M, K] (int8) or [M, K/2] (uint8 int4); b: bf16 [K, N];
// scale: fp32 [M]; out: fp32 [M, N].  Runs qa_tc_kernel's folded tile.
int mfa_qa_folded_gemm(const void* a, const void* b, const void* scale,
                       void* out, int M, int N, int K, int bits,
                       void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  return launch_qa_tc<true>(a, static_cast<const __nv_bfloat16*>(b),
                            static_cast<const float*>(scale), nullptr,
                            WO_ROW, static_cast<float*>(out), M, N, K, bits,
                            static_cast<cudaStream_t>(stream));
}

// a: the payload; b: [K, N] of btype (0 float32, 1 bfloat16: the compute
// type); scale, zp: fp32 [1] (scales 0, TENSOR), [M] (1, ROW) or [K] (2,
// BLOCK); out: fp32 [M, N].
int mfa_qa_gemm(const void* a, const void* b, const void* scale,
                const void* zp, void* out, int M, int N, int K, int bits,
                int scales, int btype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || scales < WO_TENSOR || scales > WO_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ps = static_cast<const float*>(scale);
  const float* pz = static_cast<const float*>(zp);
  float* o = static_cast<float*>(out);
  if (btype == 1)  // bf16 B: the tensor-core tile
    return launch_qa_tc<false>(a, static_cast<const __nv_bfloat16*>(b), ps,
                               pz, scales, o, M, N, K, bits, s);
  const dim3 g = wo_grid(M, N);
#define MFA_QA(BT, BITS)                                                   \
  qa_kernel<BT, BITS><<<g, WO_THREADS, 0, s>>>(                           \
      a, static_cast<const BT*>(b), ps, pz, scales, o, M, N, K)
  if (btype == 0 && bits == 8)
    MFA_QA(float, 8);
  else if (btype == 0 && bits == 4)
    MFA_QA(float, 4);
  else
    return (int)cudaErrorInvalidValue;
#undef MFA_QA
  return (int)cudaGetLastError();
}

// qa: int8 [M, K]; qb: int8 [N, K] (B^T), both 16-byte aligned; sa, sb:
// fp32 [K/bs]; za, zb: int32 [K/bs]; sqa, sqb: int32 block sums [M, K/bs],
// [N, K/bs]; c: fp32 [M, N] or null; out: fp32 [M, N].  bs a multiple of
// 128 dividing K.  Runs comp_tc_kernel with 128-row tiles where they give
// two CTAs for each SM, else 64-row ones.
int mfa_comp_gemm(const void* qa, const void* qb, const void* sa,
                  const void* za, const void* sb, const void* zb,
                  const void* sqa, const void* sqb, const void* c, void* out,
                  int M, int N, int K, int bs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bs <= 0 || bs % 128 != 0 || K % bs != 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = (long long)((M + 127) / 128) * ((N + CT_BN - 1) / CT_BN) >=
                    2LL * sm_count();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_COMP_TC(BM)                                                      \
  do {                                                                       \
    auto kern = comp_tc_kernel<BM>;                                          \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
        (int)comp_tc_smem<BM>());                                            \
    if (err != cudaSuccess) return (int)err;                                 \
    kern<<<dim3((N + CT_BN - 1) / CT_BN, (M + BM - 1) / BM), CT_THREADS,     \
           comp_tc_smem<BM>(), s>>>(                                         \
        static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb),      \
        static_cast<const float*>(sa), static_cast<const int*>(za),          \
        static_cast<const float*>(sb), static_cast<const int*>(zb),          \
        static_cast<const int*>(sqa), static_cast<const int*>(sqb),          \
        static_cast<const float*>(c), static_cast<float*>(out), M, N, K,     \
        bs);                                                                 \
  } while (0)
  if (wide)
    MFA_COMP_TC(128);
  else
    MFA_COMP_TC(64);
#undef MFA_COMP_TC
  return (int)cudaGetLastError();
}

// qa: int8 [M, K]; qb: int8 [N, K] (B^T); sa, zsa, sb, zsb: fp32 [K] (the
// per-block scale and z*scale expanded per element); c: fp32 [M, N] or
// null; out: fp32 [M, N].
int mfa_comp_small_gemm(const void* qa, const void* qb, const void* sa,
                        const void* zsa, const void* sb, const void* zsb,
                        const void* c, void* out, int M, int N, int K,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  comp_small_kernel<<<wo_grid(M, N), WO_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb),
      static_cast<const float*>(sa), static_cast<const float*>(zsa),
      static_cast<const float*>(sb), static_cast<const float*>(zsb),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Quantized GEMMs for Hopper (sm_90a): the dynamic W8A8 / W4A8 GEMM, the
// two weight-only GEMMs (a float A times a quantized weight), the two
// quantized-A GEMMs (a quantized A times a float B) and the two compensated
// int8 x int8 GEMMs.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/quantized_gemm.py::_dyn_kernel        -> dyn_tc_kernel
//   - ops/quantized_gemm.py::_wo_folded_kernel  -> wo_tc_kernel (folded)
//   - ops/quantized_gemm.py::_wo_kernel         -> wo_tc_kernel (bf16 A),
//                                                   wo_kernel (fp32 A)
//   - ops/quantized_gemm.py::_qa_folded_kernel  -> qa_tc_kernel (folded)
//   - ops/quantized_gemm.py::_qa_kernel         -> qa_tc_kernel (bf16 B),
//                                                   qa_kernel (fp32 B)
//   - ops/quantized_gemm.py::_comp_kernel       -> comp_tc_kernel
//   - ops/quantized_gemm.py::_comp_small_kernel -> comp_tc_kernel (blocks
//                                                   of a multiple of 16),
//                                                   comp_small_kernel
//                                                   (other blocks)
// Each family is described before its kernels; dyn_tc_kernel and
// comp_tc_kernel share the s8 tile at the end.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using mfa::Elem;

// ---------------------------------------------------------------------------
// Weight-only GEMMs: out [M, N] = A [M, K] x W^T, W the payload [N, K] int8
// or [N, K/2] uint8 group-planar int4 (as weight_at below reads it):
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
//   - the TPU's _comp_kernel (bs a multiple of 128): per K block b, the
//     exact int32 block product Sqq = A_b . B_b^T, then in int32 comp =
//     Sqq - zb*SqA - za*SqB + bs*za*zb with the wrapper's per-row block
//     sums SqA [M, nb], SqB [N, nb], rounded to fp32, and acc = fma(sa*sb,
//     comp, acc): the fused multiply-add XLA gives the TPU kernel, so the
//     plain version matches bit for bit (integer sums are exact in any
//     order, and the fp32 steps run per block in the same order); C added
//     at the store.  comp_tc_kernel, the s8 tile below, with K unsplit (a
//     split would add fp32 partial sums in another order);
//   - the TPU's _comp_small_kernel (blocks that are not a multiple of 128,
//     the reference's 16..64), whose plain version dequantizes both
//     operands per element in fp32 as fma(q, s[k], -(z*s)[k]) and sums
//     exact fp32 products: comp_tc_kernel for a block of a multiple of 16
//     runs the same integer block product and compensation per block
//     instead, one rounding a block rather than one an element, so it is
//     the more exact of the two; comp_small_kernel for the other blocks (8,
//     24, 40, ...: QuantConfig takes any multiple of 8) keeps the
//     per-element dequantization (the per-block vectors expanded to [K] by
//     the wrapper) on the weight-only kernels' scalar fp32 tile.  The
//     wrapper's comp_small_body chooses by the block size.
//
// What bounds them on the H100.  At the GEMM bench's shapes the product is
// 2*M*N*K = 17 or 550 G operations against 67 + 1 + 4 MB or 34 + 67 + 134
// MB of int8 operands and fp32 output: the int8 tensor cores (1,979 TOP/s)
// bound M = 4096 at ~0.28 ms, the bytes M = 128 at ~0.02 ms.  The small
// blocks' fp32 is the TPU's choice (a contraction under 128 leaves its MXU
// part empty), not the H100's limit: their operands are int8 too, so their
// bound is the int8 one as well.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The s8 tensor-core tile: dyn_tc_kernel (the dynamic GEMM) and
// comp_tc_kernel (both compensated GEMMs).  Both multiply
// A [M, K] int8 rows by B^T [N, K] rows of k (int8, or for the dynamic GEMM
// the group-planar int4 payload) with s8 mma.sync into int32 fragments.
//
// dyn_tc_kernel computes out[m, n] = (float(acc) - rs[m] * zb[n]) *
// (sa[m] * sb[n]) [+ c] with acc = sum_k qa[m, k] * qb[n, k], one int32
// accumulator over all of K (exact in any order):
//   - qa [M, K] int8: activations quantized per row by the wrapper
//     (ops/quantized_gemm.py), sa their scales, rs their row sums (fp32);
//   - qb [N, K] int8, or [N, K/2] uint8 group-planar int4 (BITS == 4):
//     element k lies in group g = k / 256 at offset j = k % 256, in byte
//     g * 128 + j % 128, low nibble if j < 128, high nibble otherwise,
//     stored as value + 8;
//   - sb, zb [N] fp32: the weight's per-output-channel (or broadcast
//     per-tensor) scale and zero point; c [M, N] fp32 or null.
// The epilogue runs once per output element in the JAX kernel's order and
// with its roundings as XLA runs it (XLA fuses a multiply into the add or
// subtract that follows it): d = fma(-rs, zb, float(acc)); out = fma(d,
// sa*sb, c) with C, d * (sa*sb) without.  Every step is an explicitly
// rounded intrinsic, so the compiler contracts nothing else, and the plain
// PyTorch version computes the same numbers exactly.
//
// comp_tc_kernel runs the compensated arithmetic per block of bs (a
// multiple of 16; K whole blocks): Sqq summed in int32 over the block,
// at its end comp = Sqq - zb*SqA - za*SqB + bs*za*zb in int32, then acc =
// fma(sa*sb, float(comp), acc) in fp32, C at the store.  A block that is a
// multiple of 32 takes m16n8k32 steps (S8_COMP32), one of 16, 48, 80, ...
// m16n8k16 ones (S8_COMP16), so a block ends between two products.
// float(comp) is exact where |comp| < 2^24; where the block's zero points
// bound |comp| below 2^22 (bs * (128 + |za|) * (128 + |zb|) < 2^22: every
// symmetric block of 16..127, and centered ones near zero) it is formed on
// the integer and FP32 pipes (mma.cuh's biased_f32, the bias folded into
// the column term) instead of the conversion unit, which runs at an eighth
// of their rate.  Per block and output element that is one IADD3, one FADD
// and one FFMA beside bs / 32 (or bs / 16) products; the block's per-row and
// per-column terms (zb * SqA[m], za * SqB[n] - bs*za*zb - bias) are loaded
// once per thread and block, at the previous block's end.
//
// What bounds them on the H100, and the design.  The dynamic GEMM at
// decode (M = 8) reads every weight byte for 16 operations: the weight's
// bytes over 3.35 TB/s bound it (~0.048 ms for one model call's 57 int8
// GEMMs), and at ~1 MB a projection each launch is latency, not bytes.  At
// the fully quantized forward's M = 4096 the int8 tensor cores (1,979
// TOP/s) bound the 57 GEMMs' ~1.27 T operations at ~0.64 ms.  One CTA
// computes a BM x 128 output tile, BM = 128 (8 warps of 32 x 64 outputs),
// 64 (32 x 32) or 16 (16 x 16) as the wrapper's dyn_tile / comp_small_tile
// choose (mfa_comp_gemm: 128 where 128-row tiles give two CTAs for each SM,
// else 64, K unsplit; the compensated tile's two accumulators, int32 and
// fp32, keep its BM = 128 instance to one CTA an SM), over steps of 128 k: A's rows (128 bytes) and B's (128 bytes, or
// int4: the 64 packed bytes of half a group, whose low nibbles are k in
// [j, j + 64) and high ones k + 128, which A stages as two 64-byte pieces)
// copied by cp.async into a ring (3 stages for the dynamic BM = 128 tile,
// which keeps two CTAs an SM, else 4); zeros past M, N and K; element loads
// where a row is not 16-byte aligned (K % 16 != 0).  ldmatrix reads both;
// int4 B's nibbles become int8 in registers after it ((v + 0x78) ^ 0x80 a
// byte: v - 8), each packed fragment giving the fragments of two k slices.
// Split K: where the tiles leave SMs idle (decode, prefill chunks), the K
// steps are split into gridDim.z ranges (whole blocks for the compensated
// GEMM) run by one thread block cluster (1, 1, splits); each CTA leaves its
// partial tile in its shared memory, and after a cluster barrier each adds
// every rank's partials for 1 / splits of the tile's rows through
// distributed shared memory (int32: exact; fp32: in rank order) and runs
// the epilogue on them: one launch a GEMM, no workspace, the same bits
// every run.  Without a split the tile goes through shared memory all the
// same, so every store is a coalesced 16-byte vector.
// ---------------------------------------------------------------------------

constexpr int S8_BN = 128;              // output columns a CTA
constexpr int S8_BK = 128;              // k a step
constexpr int S8_LD = S8_BK + 16;       // bytes a staged A row, int8 B row
constexpr int S8_LD4 = S8_BK / 2 + 16;  // bytes a staged int4 B row
constexpr int S8_THREADS = 256;
constexpr int S8_RLD = S8_BN + 8;       // words a row of the result tile
constexpr int S8_MAX_SPLITS = 8;        // a portable cluster

enum S8Kind { S8_DYN = 0, S8_COMP32 = 1, S8_COMP16 = 2 };

// The steps of 128 k in lcm(bs, 128): the compensated GEMM splits K in
// ranges of whole units, so that no block straddles two CTAs.
__host__ __device__ constexpr int s8_unit(int bs) {
  return bs / ((bs & -bs) < S8_BK ? (bs & -bs) : S8_BK);
}

template <int KIND, int BM>
__host__ __device__ constexpr int s8_stages() {
  return KIND == S8_DYN && BM == 128 ? 3 : 4;
}

template <int BITS, int BM>
__host__ __device__ constexpr int s8_stage_bytes() {
  return BM * S8_LD + S8_BN * (BITS == 4 ? S8_LD4 : S8_LD);
}

// The ring, or the result tile [BM][S8_RLD] of 32-bit words that reuses
// it, whichever is larger.
template <int KIND, int BITS, int BM>
__host__ __device__ constexpr size_t s8_smem() {
  const size_t ring =
      (size_t)s8_stages<KIND, BM>() * s8_stage_bytes<BITS, BM>();
  const size_t res = (size_t)BM * S8_RLD * 4;
  return ring > res ? ring : res;
}

// The arguments of both kernels.  The dynamic GEMM: sa, rs [M], sb, zb [N]
// fp32.  The compensated one: sa, sb [K/bs] fp32 and za, zbi [K/bs] int32
// per block, sqa [M, K/bs] and sqb [N, K/bs] int32 block sums, bs.
struct S8Args {
  const int8_t* qa;
  const void* qb;
  const float* c;
  float* out;
  int M, N, K;
  const float* sa;
  const float* sb;
  const float* rs;
  const float* zb;
  const int* za;
  const int* zbi;
  const int* sqa;
  const int* sqb;
  int bs;
};

// 16 bytes of row `row` of an int8 [rows, K] matrix from column k into d:
// cp.async where `vec` (K % 16 == 0, the base 16-byte aligned; zeros past
// `rows` and K), else element loads.
__device__ __forceinline__ void s8_copy16(uint8_t* d,
                                          const uint8_t* __restrict__ p,
                                          int row, int rows, int k, int K,
                                          bool vec) {
  if (vec) {
    const bool ok = row < rows && k < K;
    mfa::cp_async16(d, p + (ok ? (size_t)row * K + k : 0), ok ? 16 : 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e)
    d[e] = (row < rows && k + e < K) ? p[(size_t)row * K + k + e] : 0;
}

// Copy step kt of A rows [m0, m0 + BM) into `as` and of B rows [n0, n0 +
// 128) into `bs`.  int8: k in [128 kt, 128 kt + 128).  int4 (K % 256 ==
// 0): half h = kt % 2 of group g = kt / 2, i.e. B's packed bytes [128 g +
// 64 h, +64) and A's k [256 g + 64 h, +64) then [256 g + 128 + 64 h, +64),
// so A's byte j meets the low nibble of B's byte j and A's byte 64 + j its
// high nibble.
template <int BITS, int BM>
__device__ __forceinline__ void s8_stage(uint8_t* as, uint8_t* bs,
                                         const uint8_t* __restrict__ qa,
                                         const uint8_t* __restrict__ qb,
                                         int m0, int n0, int M, int N, int K,
                                         int kt, bool vec) {
  constexpr int CH = S8_BK / 16;  // 16-byte chunks an A row
  for (int i = threadIdx.x; i < BM * CH; i += S8_THREADS) {
    const int r = i / CH;
    const int ch = i % CH;
    const int k = BITS == 4 ? (kt >> 1) * 256 + (ch >> 2) * 128 +
                                  (kt & 1) * 64 + (ch & 3) * 16
                            : kt * S8_BK + ch * 16;
    s8_copy16(as + r * S8_LD + ch * 16, qa, m0 + r, M, k, K, vec);
  }
  if (BITS == 4) {
    for (int i = threadIdx.x; i < S8_BN * CH / 2; i += S8_THREADS) {
      const int r = i / (CH / 2);
      const int ch = i % (CH / 2);
      const bool ok = n0 + r < N;
      const size_t off = (size_t)(n0 + r) * (K / 2) +
                         (size_t)(kt >> 1) * 128 + (kt & 1) * 64 + ch * 16;
      mfa::cp_async16(bs + r * S8_LD4 + ch * 16, qb + (ok ? off : 0),
                      ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < S8_BN * CH; i += S8_THREADS) {
      const int r = i / CH;
      const int ch = i % CH;
      s8_copy16(bs + r * S8_LD + ch * 16, qb, n0 + r, N, kt * S8_BK + ch * 16,
                K, vec);
    }
  }
}

// Four int4 weights (the nibbles v = value + 8 of x >> shift) as four int8.
__device__ __forceinline__ uint32_t s8_nibbles(uint32_t x, int shift) {
  return (((x >> shift) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// a + b of two fp32 values held as their bits, rounded to nearest.
__device__ __forceinline__ uint32_t add_f32_bits(uint32_t a, uint32_t b) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}

template <int KIND, int BITS, int BM>
__device__ __forceinline__ void s8_tile(const S8Args& p) {
  namespace cg = cooperative_groups;
  constexpr bool COMP = KIND != S8_DYN;
  constexpr int STAGES = s8_stages<KIND, BM>();
  constexpr int STAGE = s8_stage_bytes<BITS, BM>();
  constexpr int WARPS_M = BM >= 32 ? BM / 32 : 1;
  constexpr int MT = BM >= 32 ? 2 : 1;       // 16-row fragments a warp
  constexpr int WN = S8_BN / (8 / WARPS_M);  // columns a warp
  constexpr int NT = WN / 8;                 // 8-column blocks a warp
  constexpr int BLD = BITS == 4 ? S8_LD4 : S8_LD;
  extern __shared__ __align__(16) uint8_t sm[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wm0 = (warp % WARPS_M) * MT * 16;
  const int wn0 = (warp / WARPS_M) * WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * S8_BN;
  const int M = p.M, N = p.N, K = p.K;
  const uint8_t* qa = reinterpret_cast<const uint8_t*>(p.qa);
  const uint8_t* qb = static_cast<const uint8_t*>(p.qb);
  const bool vec = K % 16 == 0 && ((uintptr_t)qa & 15) == 0 &&
                   ((uintptr_t)qb & 15) == 0;
  // This CTA's steps [kt0, kt0 + nk): its split's range, in units of whole
  // blocks for the compensated GEMM (lcm(bs, 128) / 128 steps).
  const int steps = (K + S8_BK - 1) / S8_BK;
  const int unit = COMP ? s8_unit(p.bs) : 1;
  const int units = (steps + unit - 1) / unit;
  const int kt0 =
      min(steps, (int)((long long)units * blockIdx.z / gridDim.z) * unit);
  const int nk =
      min(steps,
          (int)((long long)units * (blockIdx.z + 1) / gridDim.z) * unit) -
      kt0;

  auto load = [&](int stage, int kt) {
    uint8_t* st = sm + stage * STAGE;
    s8_stage<BITS, BM>(st, st + BM * S8_LD, qa, qb, m0, n0, M, N, K, kt0 + kt,
                       vec);
  };

  int part[MT][NT][4];
  float acc[MT][NT][4];  // the compensated GEMM's fp32 sum
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[mi][ni][e] = 0;
        acc[mi][ni][e] = 0.f;
      }

  // The compensated GEMM's current block: the scale product, whether its
  // conversion may take biased_f32, the row and column terms, and the k at
  // which it ends (INT_MAX past this CTA's range).
  float blk_s = 0.f;
  bool blk_fast = false;
  int rowt[MT][2], colt[NT][2];
  int blk_end = 0x7FFFFFFF;
  auto block_terms = [&](int blk) {
    const int nb = K / p.bs;
    const int za = p.za[blk], zb = p.zbi[blk];
    blk_s = __fmul_rn(p.sa[blk], p.sb[blk]);
    blk_fast = (long long)p.bs * (128 + abs(za)) * (128 + abs(zb)) <
               (1LL << 22);
    const int zz = p.bs * za * zb + (blk_fast ? mfa::I32_BIAS : 0);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm0 + 16 * mi + g + 8 * i;
        rowt[mi][i] = m < M ? zb * p.sqa[(size_t)m * nb + blk] : 0;
      }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn0 + 8 * ni + 2 * tq + e;
        colt[ni][e] = (n < N ? za * p.sqb[(size_t)n * nb + blk] : 0) - zz;
      }
  };
  if constexpr (COMP) {
    if (nk > 0) {
      blk_end = kt0 * S8_BK + p.bs;
      block_terms(kt0 * S8_BK / p.bs);
    }
  }
  // After the products of every k < kend: where a block ends there, its
  // compensation, then the next block's terms.
  auto block_end = [&](int kend) {
    if constexpr (COMP) {
      if (kend != blk_end) return;
      if (blk_fast) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int comp = part[mi][ni][e] - rowt[mi][e >> 1] -
                               colt[ni][e & 1];
              acc[mi][ni][e] =
                  __fmaf_rn(blk_s, mfa::biased_f32(comp), acc[mi][ni][e]);
              part[mi][ni][e] = 0;
            }
      } else {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int comp = part[mi][ni][e] - rowt[mi][e >> 1] -
                               colt[ni][e & 1];
              acc[mi][ni][e] =
                  __fmaf_rn(blk_s, __int2float_rn(comp), acc[mi][ni][e]);
              part[mi][ni][e] = 0;
            }
      }
      const int next = blk_end + p.bs;
      if (next <= K && next <= (kt0 + nk) * S8_BK) {
        blk_end = next;
        block_terms(next / p.bs - 1);
      } else {
        blk_end = 0x7FFFFFFF;
      }
    }
  };

  const int a_off =
      (wm0 + mfa::ldsm_a_row(lane)) * S8_LD + mfa::ldsm_a_byte(lane);
  const int b_off =
      (wn0 + mfa::ldsm_b_row(lane)) * BLD + mfa::ldsm_b_byte(lane);

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
    const uint8_t* a_s = sm + (kt % STAGES) * STAGE + a_off;
    const uint8_t* b_s = sm + (kt % STAGES) * STAGE + BM * S8_LD + b_off;
    if constexpr (BITS == 4) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // 32 packed bytes: two 32-k slices
        uint32_t bp[NT / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2)
          mfa::ldsm_x4(bp[n2], b_s + n2 * 16 * BLD + c * 32);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {  // low nibbles: A's slice c
          uint32_t af[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            mfa::ldsm_x4(af[mi], a_s + mi * 16 * S8_LD + (c + 2 * hi) * 32);
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t bf[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) bf[j] = s8_nibbles(bp[n2][j], 4 * hi);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              mfa::mma_s8(part[mi][2 * n2], af[mi], bf[0], bf[1],
                          part[mi][2 * n2]);
              mfa::mma_s8(part[mi][2 * n2 + 1], af[mi], bf[2], bf[3],
                          part[mi][2 * n2 + 1]);
            }
          }
        }
      }
    } else {
      const int kbase = (kt0 + kt) * S8_BK;
#pragma unroll
      for (int kk = 0; kk < S8_BK / 32; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          mfa::ldsm_x4(af[mi], a_s + mi * 16 * S8_LD + kk * 32);
        uint32_t bf[NT / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2)
          mfa::ldsm_x4(bf[n2], b_s + n2 * 16 * BLD + kk * 32);
        if constexpr (KIND == S8_COMP16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // the slice's two 16-k halves
#pragma unroll
            for (int n2 = 0; n2 < NT / 2; ++n2)
#pragma unroll
              for (int mi = 0; mi < MT; ++mi) {
                mfa::mma_s8_k16(part[mi][2 * n2], af[mi][2 * h],
                                af[mi][2 * h + 1], bf[n2][h],
                                part[mi][2 * n2]);
                mfa::mma_s8_k16(part[mi][2 * n2 + 1], af[mi][2 * h],
                                af[mi][2 * h + 1], bf[n2][2 + h],
                                part[mi][2 * n2 + 1]);
              }
            block_end(kbase + kk * 32 + 16 * (h + 1));
          }
        } else {
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2)
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              mfa::mma_s8(part[mi][2 * n2], af[mi], bf[n2][0], bf[n2][1],
                          part[mi][2 * n2]);
              mfa::mma_s8(part[mi][2 * n2 + 1], af[mi], bf[n2][2],
                          bf[n2][3], part[mi][2 * n2 + 1]);
            }
          block_end(kbase + (kk + 1) * 32);
        }
      }
    }
  }
  mfa::cp_async_wait<0>();
  __syncthreads();  // every ring read done: the result tile reuses it

  // This CTA's tile (the int32 sums, or the fp32 sum) into shared memory.
  uint32_t* res = reinterpret_cast<uint32_t*>(sm);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int r = wm0 + 16 * mi + g + 8 * i;
        const int col = wn0 + 8 * ni + 2 * tq;
        uint2 v;
        if constexpr (COMP)
          v = make_uint2(__float_as_uint(acc[mi][ni][2 * i]),
                         __float_as_uint(acc[mi][ni][2 * i + 1]));
        else
          v = make_uint2((uint32_t)part[mi][ni][2 * i],
                         (uint32_t)part[mi][ni][2 * i + 1]);
        *reinterpret_cast<uint2*>(res + r * S8_RLD + col) = v;
      }
  const int splits = gridDim.z;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();  // every rank's partial tile written
  else
    __syncthreads();

  // Rank z sums rows [z * rows, (z + 1) * rows) of every rank's tile (rank
  // order) and runs the epilogue on them: a warp a row, four columns a lane.
  const int rows = (BM + splits - 1) / splits;
  const int r_hi = min(min(BM, (int)(blockIdx.z + 1) * rows), M - m0);
  const int col = lane * 4;
  const int n = n0 + col;
  const bool out_vec =
      N % 4 == 0 && n + 3 < N && ((uintptr_t)p.out & 15) == 0;
  float col_s[4], col_z[4];  // the dynamic GEMM's s_b, z_b of the columns
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    col_s[e] = !COMP && n + e < N ? p.sb[n + e] : 0.f;
    col_z[e] = !COMP && n + e < N ? p.zb[n + e] : 0.f;
  }
  for (int r = (int)blockIdx.z * rows + warp; r < r_hi; r += 8) {
    uint4 v = *reinterpret_cast<const uint4*>(res + r * S8_RLD + col);
    if (splits > 1) {
      v = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(res, 0) +
                                          r * S8_RLD + col);
      for (int q = 1; q < splits; ++q) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(res, q) + r * S8_RLD + col);
        if constexpr (COMP)
          v = make_uint4(add_f32_bits(v.x, w.x), add_f32_bits(v.y, w.y),
                         add_f32_bits(v.z, w.z), add_f32_bits(v.w, w.w));
        else
          v = make_uint4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
      }
    }
    const int m = m0 + r;
    const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
    float o[4];
    const float sam = COMP ? 0.f : p.sa[m];
    const float rsm = COMP ? 0.f : p.rs[m];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = 0.f;
      if (n + e >= N) continue;
      const size_t idx = (size_t)m * N + n + e;
      if constexpr (COMP) {
        o[e] = __uint_as_float(vv[e]);
        if (p.c != nullptr) o[e] = __fadd_rn(o[e], p.c[idx]);
      } else {
        const float d =
            __fmaf_rn(-rsm, col_z[e], __int2float_rn((int)vv[e]));
        const float s = __fmul_rn(sam, col_s[e]);
        o[e] = p.c != nullptr ? __fmaf_rn(d, s, p.c[idx]) : __fmul_rn(d, s);
      }
    }
    float* dst = p.out + (size_t)m * N + n;
    if (out_vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) dst[e] = o[e];
    }
  }
  if (splits > 1) cluster.sync();  // the other ranks' reads done
}

template <int BITS, int BM>
__global__ void __launch_bounds__(S8_THREADS, 2)
dyn_tc_kernel(const S8Args p) {
  s8_tile<S8_DYN, BITS, BM>(p);
}

template <bool K16, int BM>
__global__ void __launch_bounds__(S8_THREADS, BM == 128 ? 1 : 2)
comp_tc_kernel(const S8Args p) {
  s8_tile<K16 ? S8_COMP16 : S8_COMP32, 8, BM>(p);
}

// One s8 tile kernel over [M, N] with BM-row tiles and K split `splits`
// ways (one cluster (1, 1, splits) a tile when splits > 1).
template <typename Kernel>
int launch_s8(Kernel kern, size_t smem, const S8Args& p, int bm, int splits,
              cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + S8_BN - 1) / S8_BN, (p.M + bm - 1) / bm, splits);
  cfg.blockDim = dim3(S8_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The compensated GEMMs' arguments of the s8 tile.
S8Args comp_args(const void* qa, const void* qb, const void* sa,
                 const void* za, const void* sb, const void* zb,
                 const void* sqa, const void* sqb, const void* c, void* out,
                 int M, int N, int K, int bs) {
  S8Args p = {};
  p.qa = static_cast<const int8_t*>(qa);
  p.qb = qb;
  p.c = static_cast<const float*>(c);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.za = static_cast<const int*>(za);
  p.zbi = static_cast<const int*>(zb);
  p.sqa = static_cast<const int*>(sqa);
  p.sqb = static_cast<const int*>(sqb);
  p.bs = bs;
  return p;
}

// Whether K's steps split `splits` ways in ranges of whole units (`unit`
// steps each) leave every range at least one unit, within a cluster.
bool s8_splits_ok(int K, int unit, int splits) {
  const int units = ((K + S8_BK - 1) / S8_BK + unit - 1) / unit;
  return splits >= 1 && splits <= S8_MAX_SPLITS && splits <= units;
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

// qa: int8 [M, K]; qb: int8 [N, K] or uint8 [N, K/2] (bits 4, K % 256 ==
// 0), both 16-byte aligned; sa, rs: fp32 [M]; sb, zb: fp32 [N]; c: fp32
// [M, N] or null; out: fp32 [M, N]; bm, splits: the tile's rows (16, 64,
// 128) and the K splits (1..8, each at least one step of 128), as the
// wrapper's dyn_tile chose.  Runs dyn_tc_kernel.
int mfa_dyn_gemm(const void* qa, const void* qb, const void* sa,
                 const void* rs, const void* sb, const void* zb,
                 const void* c, void* out, int M, int N, int K, int bits,
                 int bm, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || !s8_splits_ok(K, 1, splits))
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  S8Args p = {};
  p.qa = static_cast<const int8_t*>(qa);
  p.qb = qb;
  p.c = static_cast<const float*>(c);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.rs = static_cast<const float*>(rs);
  p.zb = static_cast<const float*>(zb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_DYN_TC(BITS, BM)                                                  \
  if (bits == BITS && bm == BM)                                               \
    return launch_s8(dyn_tc_kernel<BITS, BM>, s8_smem<S8_DYN, BITS, BM>(), p, \
                     BM, splits, s);
  MFA_DYN_TC(8, 16)
  MFA_DYN_TC(8, 64)
  MFA_DYN_TC(8, 128)
  MFA_DYN_TC(4, 16)
  MFA_DYN_TC(4, 64)
  MFA_DYN_TC(4, 128)
#undef MFA_DYN_TC
  return (int)cudaErrorInvalidValue;
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
// 128 dividing K.  Runs comp_tc_kernel (m16n8k32, K unsplit: bit for bit
// with the plain version's block order) with 128-row tiles where they give
// two CTAs for each SM, else 64-row ones.
int mfa_comp_gemm(const void* qa, const void* qb, const void* sa,
                  const void* za, const void* sb, const void* zb,
                  const void* sqa, const void* sqb, const void* c, void* out,
                  int M, int N, int K, int bs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bs <= 0 || bs % 128 != 0 || K % bs != 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = (long long)((M + 127) / 128) * ((N + S8_BN - 1) / S8_BN) >=
                    2LL * sm_count();
  const S8Args p = comp_args(qa, qb, sa, za, sb, zb, sqa, sqb, c, out, M, N,
                             K, bs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_s8(comp_tc_kernel<false, 128>,
                          s8_smem<S8_COMP32, 8, 128>(), p, 128, 1, s)
              : launch_s8(comp_tc_kernel<false, 64>,
                          s8_smem<S8_COMP32, 8, 64>(), p, 64, 1, s);
}

// The k of the s8 products comp_tc_kernel runs for a block of bs
// (32: m16n8k32, 16: m16n8k16), or 0 where mfa_comp_small_gemm's scalar
// tile takes the block (bs not a multiple of 16).
int mfa_comp_small_body(int bs) {
  return bs <= 0 || bs % 16 != 0 ? 0 : (bs % 32 == 0 ? 32 : 16);
}

// qa: int8 [M, K]; qb: int8 [N, K] (B^T); sa, sb: fp32 [K/bs]; za, zb:
// int32 [K/bs]; sqa, sqb: int32 block sums [M, K/bs], [N, K/bs]; c: fp32
// [M, N] or null; out: fp32 [M, N]; bs a multiple of 16 dividing K; bm,
// splits: the tile's rows (16, 64, 128) and the K splits (1..8, each at
// least one unit of lcm(bs, 128) k), as the wrapper's comp_small_tile
// chose.  Runs comp_tc_kernel.
int mfa_comp_small_tc_gemm(const void* qa, const void* qb, const void* sa,
                           const void* za, const void* sb, const void* zb,
                           const void* sqa, const void* sqb, const void* c,
                           void* out, int M, int N, int K, int bs, int bm,
                           int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || mfa_comp_small_body(bs) == 0 ||
      K % bs != 0 || !s8_splits_ok(K, s8_unit(bs), splits))
    return (int)cudaErrorInvalidValue;
  const S8Args p = comp_args(qa, qb, sa, za, sb, zb, sqa, sqb, c, out, M, N,
                             K, bs);
  const bool k16 = mfa_comp_small_body(bs) == 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_COMP_SMALL_TC(K16, KIND, BM)                                      \
  if (k16 == K16 && bm == BM)                                                 \
    return launch_s8(comp_tc_kernel<K16, BM>, s8_smem<KIND, 8, BM>(), p, BM, \
                     splits, s);
  MFA_COMP_SMALL_TC(false, S8_COMP32, 16)
  MFA_COMP_SMALL_TC(false, S8_COMP32, 64)
  MFA_COMP_SMALL_TC(false, S8_COMP32, 128)
  MFA_COMP_SMALL_TC(true, S8_COMP16, 16)
  MFA_COMP_SMALL_TC(true, S8_COMP16, 64)
  MFA_COMP_SMALL_TC(true, S8_COMP16, 128)
#undef MFA_COMP_SMALL_TC
  return (int)cudaErrorInvalidValue;
}

// qa: int8 [M, K]; qb: int8 [N, K] (B^T); sa, zsa, sb, zsb: fp32 [K] (the
// per-block scale and z*scale expanded per element); c: fp32 [M, N] or
// null; out: fp32 [M, N].  Runs comp_small_kernel, the scalar tile of the
// blocks mfa_comp_small_body gives 0.
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

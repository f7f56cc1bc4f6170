// Quantized GEMMs for Hopper (sm_90a): the dynamic W8A8 / W4A8 GEMM, the
// two weight-only GEMMs (a float A times a quantized weight), the two
// quantized-A GEMMs (a quantized A times a float B) and the two compensated
// int8 x int8 GEMMs.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/quantized_gemm.py::_dyn_kernel        -> dyn_gemm_kernel
//   - ops/quantized_gemm.py::_wo_folded_kernel  -> wo_folded_kernel
//   - ops/quantized_gemm.py::_wo_kernel         -> wo_kernel
//   - ops/quantized_gemm.py::_qa_folded_kernel  -> qa_folded_kernel
//   - ops/quantized_gemm.py::_qa_kernel         -> qa_kernel
//   - ops/quantized_gemm.py::_comp_kernel       -> comp_kernel
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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
// Weight-only GEMMs: out [M, N] fp32 = A [M, K] x W^T, W the payload [N, K]
// int8 or [N, K/2] uint8 group-planar int4 (as dyn_gemm_kernel reads it).
//
//   - wo_folded_kernel (the TPU's _wo_folded_kernel: SYMMETRIC TENSOR / ROW
//     weights, a non-fp32 A cast to bf16 by the wrapper): acc = sum_k a * w
//     over the integer weights, exact products (bf16 x int8 fits fp32's
//     24-bit significand) summed in fp32; then out = acc * s[n] and, with
//     C, out + c, each rounded once (the scale multiplies the accumulator
//     once, and C is not scaled);
//   - wo_kernel (the TPU's _wo_kernel: every other weight, or an fp32 A):
//     each weight element dequantized (w - zp) * s in fp32 with the scale
//     and zero point of its TENSOR (one), ROW (per n) or BLOCK (per k,
//     expanded to [K] by the wrapper) cell, rounded to the compute type AT
//     (fp32 for an fp32 A, else bf16), then acc = sum_k a * deq in fp32;
//     out = acc (+ c).
// The kernel writes fp32; the wrapper rounds it to the caller's dtype once,
// as the TPU kernels' store does.
//
// What bounds them on the H100, and the design.  At MLA's decompression
// (M = B*S = 4096 latent rows, N = H*dh = 1024, K = d_c = 256) the work is
// 2*M*N*K = 2.1 GFLOP over ~10.7 MB (A 2 MB bf16, W 0.26 MB int8, out
// 8.4 MB fp32), ~197 flop/byte: below the bf16 ridge (~295), so bytes bound
// it, at ~3.2 us.  These first versions are simple: one CTA per 64 x 64
// output tile, 256 threads with 4 x 4 outputs each; each K step stages a
// 64 x 32 tile of A and of the weights in shared memory as fp32 (the
// weights widened, or dequantized and rounded, while staging), transposed
// so each thread's rows and columns are 16-byte vectors, and accumulates
// with scalar fp32 FMAs (67 TFLOP/s peak: ~32 us at best).  bf16 mma.sync /
// wgmma with the int8 weights widened in registers is the planned speed
// work.
// ---------------------------------------------------------------------------

constexpr int WO_BM = 64;
constexpr int WO_BN = 64;
constexpr int WO_BK = 32;
constexpr int WO_THREADS = 256;
constexpr int WO_LD = 64 + 4;

enum WoScales { WO_TENSOR = 0, WO_ROW = 1, WO_BLOCK = 2 };

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

template <int BITS>
__global__ void __launch_bounds__(WO_THREADS)
wo_folded_kernel(const __nv_bfloat16* __restrict__ a,
                 const void* __restrict__ w, const float* __restrict__ scale,
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
    wo_stage_a(a, M, K, m0, k0, as);
    stage_rows(bs, N, K, n0, k0, [=](int n, int k) {
      return (float)weight_at<BITS>(w, n, k, K);
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
      const float r = __fmul_rn(acc[i][j], scale[n]);
      out[idx] = c ? __fadd_rn(r, c[idx]) : r;
    }
  }
}

template <typename AT, int BITS>
__global__ void __launch_bounds__(WO_THREADS)
wo_kernel(const AT* __restrict__ a, const void* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ zp,
          int scales, const float* __restrict__ c, float* __restrict__ out,
          int M, int N, int K) {
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
      return dequant_at<AT, BITS>(w, scale, zp, scales, n, k, K);
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
// Quantized-A GEMMs: out [M, N] fp32 = A x B, A the payload [M, K] int8 or
// [M, K/2] uint8 group-planar int4 (read as weight_at reads a weight), B a
// float [K, N].  The transposes of the weight-only pair, on the same tile
// body, with the quantized operand on the A side:
//
//   - qa_folded_kernel (the TPU's _qa_folded_kernel: SYMMETRIC TENSOR / ROW
//     A, a non-fp32 B cast to bf16 by the wrapper): acc = sum_k q * b over
//     the integers, exact products summed in fp32; out = acc * s[m] (a
//     TENSOR scale repeated over M by the wrapper), rounded once;
//   - qa_kernel (the TPU's _qa_kernel: every other A, or an fp32 B): each A
//     element dequantized by dequant_at with TENSOR, ROW (per m) or BLOCK
//     (per k) cells and rounded to B's type BT (the compute type), then
//     acc = sum_k deq * b in fp32; out = acc.
// C is not read: the GEMM engine adds it after these kernels, in fp32.
//
// What bounds them on the H100, and the design.  At the GEMM bench's
// shapes (M = 128 or 4096, N = K = 8192) the product is 2*M*N*K = 17 or
// 550 GFLOP against 67 + 134 + 4 MB (M = 128: B bf16, out fp32) or 34 +
// 134 + 134 MB (M = 4096): the bf16 tensor cores (989 TFLOP/s) would bound
// M = 4096 at ~0.56 ms and the bytes M = 128 at ~0.06 ms.  These first
// versions are the weight-only kernels' scalar fp32 FMAs (67 TFLOP/s peak):
// ~8 ms at best for M = 4096.  bf16 mma.sync / wgmma is the planned speed
// work.
// ---------------------------------------------------------------------------

template <int BITS>
__global__ void __launch_bounds__(WO_THREADS)
qa_folded_kernel(const void* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int M, int N, int K) {
  __shared__ __align__(16) float as[WO_BK][WO_LD];
  __shared__ __align__(16) float bs[WO_BK][WO_LD];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * WO_BM;
  const int n0 = blockIdx.x * WO_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += WO_BK) {
    stage_rows(as, M, K, m0, k0, [=](int m, int k) {
      return (float)weight_at<BITS>(a, m, k, K);
    });
    stage_cols(bs, N, K, n0, k0, [=](int k, int n) {
      return __bfloat162float(b[(size_t)k * N + n]);
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
      if (n < N) out[(size_t)m * N + n] = __fmul_rn(acc[i][j], scale[m]);
    }
  }
}

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
// Compensated int8 x int8 GEMMs: out [M, N] fp32 = dequant(A) x
// dequant(B^T)^T (+ C), A [M, K] and B^T [N, K] int8, both BLOCK-quantized
// along K with one block size bs: per-block scales sa, sb and zero points
// za, zb.
//
//   - comp_kernel (the TPU's _comp_kernel; bs a multiple of 128): per K
//     block b, the exact int32 block product Sqq = A_b . B_b^T (dg_step's
//     __dp4a), then in int32 comp = Sqq - zb*SqA - za*SqB + bs*za*zb with
//     the wrapper's per-row block sums SqA [M, nb], SqB [N, nb], rounded to
//     fp32, and acc = fma(sa*sb, comp, acc): the fused multiply-add XLA
//     gives the TPU kernel, so the plain version matches bit for bit; C
//     added at the store;
//   - comp_small_kernel (the TPU's _comp_small_kernel; blocks the int8
//     product cannot separate, 16..64): both operands dequantized per
//     element in fp32 as fma(q, s[k], -(z*s)[k]) (the per-block vectors
//     expanded to [K] by the wrapper; the fused form XLA gives the TPU
//     kernel), exact fp32 products summed in fp32, C at the store.
//
// What bounds them on the H100, and the design.  At the GEMM bench's
// shapes the product is 2*M*N*K = 17 or 550 G operations against 67 + 1 +
// 4 MB or 34 + 67 + 134 MB of int8 operands and fp32 output.  comp_kernel's
// int8 products would run on the int8 tensor cores (1,979 TOP/s: ~0.28 ms
// at M = 4096); this first version is dyn_gemm_kernel's __dp4a tile, with
// the compensation applied once per block per output in registers.
// comp_small_kernel computes what the TPU kernel computes, an exact fp32
// product of the dequantized operands, on the weight-only kernels' scalar
// fp32 tile.  The fp32 is the TPU's choice (a contraction under 128 leaves
// its MXU part empty), not the H100's limit: its operands are int8 too,
// and s8 mma.sync takes k = 32, so 32- and 64-blocks split into int8
// block products with the per-block compensation, as in comp_kernel.  Its
// bound is therefore the int8 one as well (~0.28 ms at M = 4096).
// s8 mma.sync / wgmma with the compensation in the epilogue of each block
// is the planned speed work for both.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DG_THREADS)
comp_kernel(const int8_t* __restrict__ qa, const int8_t* __restrict__ qb,
            const float* __restrict__ sa, const int* __restrict__ za,
            const float* __restrict__ sb, const int* __restrict__ zb,
            const int* __restrict__ sqa, const int* __restrict__ sqb,
            const float* __restrict__ c, float* __restrict__ out, int M,
            int N, int K, int bs) {
  __shared__ __align__(16) DgTile as_;
  __shared__ __align__(16) DgTile bs_;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * DG_BM;
  const int n0 = blockIdx.x * DG_BN;
  const int nb = K / bs;
  float acc[4][4] = {};
  for (int blk = 0; blk < nb; ++blk) {
    int part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0;
    for (int k0 = blk * bs; k0 < (blk + 1) * bs; k0 += DG_BK)
      dg_step<8>(qa, qb, M, N, K, m0, n0, k0, as_, bs_, part);
    const float s = __fmul_rn(sa[blk], sb[blk]);
    const int zab = za[blk], zbb = zb[blk];
    const int zz = bs * zab * zbb;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      const int rsa = (m < M) ? sqa[(size_t)m * nb + blk] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        const int rsb = (n < N) ? sqb[(size_t)n * nb + blk] : 0;
        const int comp = part[i][j] - zbb * rsa - zab * rsb + zz;
        acc[i][j] = __fmaf_rn(s, __int2float_rn(comp), acc[i][j]);
      }
    }
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
// out: fp32 [M, N].
int mfa_wo_folded_gemm(const void* a, const void* w, const void* scale,
                       const void* c, void* out, int M, int N, int K,
                       int bits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
  const float* ps = static_cast<const float*>(scale);
  const float* pc = static_cast<const float*>(c);
  float* o = static_cast<float*>(out);
  if (bits == 8)
    wo_folded_kernel<8><<<wo_grid(M, N), WO_THREADS, 0, s>>>(pa, w, ps, pc, o,
                                                             M, N, K);
  else if (bits == 4)
    wo_folded_kernel<4><<<wo_grid(M, N), WO_THREADS, 0, s>>>(pa, w, ps, pc, o,
                                                             M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a: [M, K] of atype (0 float32, 1 bfloat16: the compute type); w: the
// payload; scale, zp: fp32 [1] (scales 0, TENSOR), [N] (1, ROW) or [K]
// (2, BLOCK); c: fp32 [M, N] or null; out: fp32 [M, N].
int mfa_wo_gemm(const void* a, const void* w, const void* scale,
                const void* zp, const void* c, void* out, int M, int N,
                int K, int bits, int scales, int atype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || scales < WO_TENSOR || scales > WO_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ps = static_cast<const float*>(scale);
  const float* pz = static_cast<const float*>(zp);
  const float* pc = static_cast<const float*>(c);
  float* o = static_cast<float*>(out);
  const dim3 g = wo_grid(M, N);
#define MFA_WO(AT, BITS)                                                   \
  wo_kernel<AT, BITS><<<g, WO_THREADS, 0, s>>>(                           \
      static_cast<const AT*>(a), w, ps, pz, scales, pc, o, M, N, K)
  if (atype == 0 && bits == 8)
    MFA_WO(float, 8);
  else if (atype == 0 && bits == 4)
    MFA_WO(float, 4);
  else if (atype == 1 && bits == 8)
    MFA_WO(__nv_bfloat16, 8);
  else if (atype == 1 && bits == 4)
    MFA_WO(__nv_bfloat16, 4);
  else
    return (int)cudaErrorInvalidValue;
#undef MFA_WO
  return (int)cudaGetLastError();
}

// a: the payload [M, K] (int8) or [M, K/2] (uint8 int4); b: bf16 [K, N];
// scale: fp32 [M]; out: fp32 [M, N].
int mfa_qa_folded_gemm(const void* a, const void* b, const void* scale,
                       void* out, int M, int N, int K, int bits,
                       void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % 256 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(b);
  const float* ps = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (bits == 8)
    qa_folded_kernel<8><<<wo_grid(M, N), WO_THREADS, 0, s>>>(a, pb, ps, o, M,
                                                             N, K);
  else if (bits == 4)
    qa_folded_kernel<4><<<wo_grid(M, N), WO_THREADS, 0, s>>>(a, pb, ps, o, M,
                                                             N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
  const dim3 g = wo_grid(M, N);
#define MFA_QA(BT, BITS)                                                   \
  qa_kernel<BT, BITS><<<g, WO_THREADS, 0, s>>>(                           \
      a, static_cast<const BT*>(b), ps, pz, scales, o, M, N, K)
  if (btype == 0 && bits == 8)
    MFA_QA(float, 8);
  else if (btype == 0 && bits == 4)
    MFA_QA(float, 4);
  else if (btype == 1 && bits == 8)
    MFA_QA(__nv_bfloat16, 8);
  else if (btype == 1 && bits == 4)
    MFA_QA(__nv_bfloat16, 4);
  else
    return (int)cudaErrorInvalidValue;
#undef MFA_QA
  return (int)cudaGetLastError();
}

// qa: int8 [M, K]; qb: int8 [N, K] (B^T); sa, sb: fp32 [K/bs]; za, zb:
// int32 [K/bs]; sqa, sqb: int32 block sums [M, K/bs], [N, K/bs]; c: fp32
// [M, N] or null; out: fp32 [M, N].  bs a multiple of 128 dividing K.
int mfa_comp_gemm(const void* qa, const void* qb, const void* sa,
                  const void* za, const void* sb, const void* zb,
                  const void* sqa, const void* sqb, const void* c, void* out,
                  int M, int N, int K, int bs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bs <= 0 || bs % 128 != 0 || K % bs != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + DG_BN - 1) / DG_BN, (M + DG_BM - 1) / DG_BM);
  comp_kernel<<<grid, DG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb),
      static_cast<const float*>(sa), static_cast<const int*>(za),
      static_cast<const float*>(sb), static_cast<const int*>(zb),
      static_cast<const int*>(sqa), static_cast<const int*>(sqb),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, bs);
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

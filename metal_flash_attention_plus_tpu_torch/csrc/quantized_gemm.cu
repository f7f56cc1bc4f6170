// Dynamic W8A8 / W4A8 GEMM for Hopper (sm_90a).
//
// Replaces (TPU kernel of metal_flash_attention_plus_tpu):
//   - ops/quantized_gemm.py::_dyn_kernel -> dyn_gemm_kernel
//
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int BITS>
__global__ void __launch_bounds__(DG_THREADS)
dyn_gemm_kernel(const int8_t* __restrict__ qa, const void* __restrict__ qb,
                const float* __restrict__ sa, const float* __restrict__ rs,
                const float* __restrict__ sb, const float* __restrict__ zb,
                const float* __restrict__ c, float* __restrict__ out, int M,
                int N, int K) {
  // Word-major (transposed) tiles: as_[kw][m], bs_[kw][n].
  __shared__ __align__(16) uint32_t as_[DG_KW][DG_BM + DG_PAD];
  __shared__ __align__(16) uint32_t bs_[DG_KW][DG_BN + DG_PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. +3
  const int ty = tid / 16;  // output rows ty*4 .. +3
  const int m0 = blockIdx.y * DG_BM;
  const int n0 = blockIdx.x * DG_BN;
  // Staging: thread -> (tile row r, 16-byte chunk q) of both tiles.
  const int sr = tid / 4;
  const int sq = tid % 4;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += DG_BK) {
    uint32_t wa[4], wb[4];
    load_int8_16(qa, m0 + sr, M, k0 + sq * 16, K, wa);
    if (BITS == 8)
      load_int8_16(static_cast<const int8_t*>(qb), n0 + sr, N, k0 + sq * 16,
                   K, wb);
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

}  // extern "C"

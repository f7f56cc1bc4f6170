// Runtime quantization for Hopper (sm_90a): per-row and per-K-block
// statistics, scale, zero point, int8 codes and Σq, one kernel each.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/runtime_quantization.py::_row_kernel    -> rtq_row_kernel
//   - ops/runtime_quantization.py::_block_kernel  -> rtq_block_kernel
//
// x is [R, K] of T (float or bf16), contiguous.  Codes are int8 [R, K]
// (int4 values in [-8, 7] are packed afterwards by the wrapper); scale fp32,
// zero point and Σq int32, one per row or one per block of `bs` columns.
// Per cell (strategy codes as in ops/runtime_quantization.py):
//   SYMMETRIC   scale = max(absmax, 1e-12) * (1/qmax),       zp = 0
//   CENTERED    mean = sum * (1/count),
//               scale = max(max|x - mean|, 1e-12) * (1/qmax), zp = rint(-mean/scale)
//   ASYMMETRIC  scale = max(max - min, 1e-12) * (1/(qmax - qmin)),
//               zp = qmin - rint(min / scale)
//   q = clip(rint(x / scale + zp), qmin, qmax)
// The constant divisors are fp32 reciprocals, rounded once, as XLA compiles
// the JAX kernels (the JAX package's CPU reference agrees to the bit); the
// divisions by a scale are IEEE divisions (__fdiv_rn; the build has no
// fast-math); rintf rounds half to even (as jnp.round and torch.round); no
// multiply-add is contracted.  So the codes, scales and zero points are
// bit-identical with the plain versions.  CENTERED's sum takes one fixed
// order, which the plain versions repeat:
//   - a row: one warp; lane l sums x[l], x[l + 32], ... from 0.0 in order,
//     then the lanes combine by xor butterfly over offsets 16, 8, 4, 2, 1;
//   - a block: 1024 threads; thread t sums the slab's elements t, t + 1024,
//     ... (row-major over [R, bs]) from 0.0 in order, then a[t] += a[t + s]
//     for s = 512, 256, ..., 1.
//
// What bounds them on the H100, and the design.  The work is a few
// operations per element: bytes bound (read x once, write one int8 code per
// element).  The TPU kernels hold a cell in VMEM and make one pass; here
// each cell is read from device memory once and the later passes over it
// (the centred absmax, the codes) hit L1 (a row) or L2 (a block's slab).
// The row kernel gives each row one warp, 8 rows per CTA; the block kernel
// gives each block one CTA of 1024 threads, so a [4096, 1024] activation at
// bs = 64 fills only 16 SMs: a later version splits the slab over CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mfa::Elem;

constexpr int ROW_THREADS = 256;  // 8 warps, one row each
constexpr int BLOCK_THREADS = 1024;
constexpr float EPS = 1e-12f;

enum Strategy { SYMMETRIC = 0, CENTERED = 1, ASYMMETRIC = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 1/x in fp32, rounded once: the constant divisors of the statistics (the
// count, qmax, qmax - qmin) are multiplies by their reciprocals, as XLA
// compiles the JAX kernels; divisions by a scale stay IEEE divisions.
__device__ __forceinline__ float recip(float x) { return __fdiv_rn(1.f, x); }

// One cell's scale and zero point from its statistics: absmax (SYMMETRIC),
// the centred absmax and the mean (CENTERED), or max and min (ASYMMETRIC).
__device__ __forceinline__ void cell_params(int strategy, float qmax,
                                            float qmin, float a, float b,
                                            float& scale, float& zp) {
  if (strategy == SYMMETRIC) {
    scale = __fmul_rn(fmaxf(a, EPS), recip(qmax));
    zp = 0.f;
  } else if (strategy == CENTERED) {  // a = max|x - mean|, b = mean
    scale = __fmul_rn(fmaxf(a, EPS), recip(qmax));
    zp = rintf(__fdiv_rn(-b, scale));
  } else {  // a = max, b = min
    scale = __fmul_rn(fmaxf(__fsub_rn(a, b), EPS),
                      recip(__fsub_rn(qmax, qmin)));
    zp = __fsub_rn(qmin, rintf(__fdiv_rn(b, scale)));
  }
}

__device__ __forceinline__ int code(float x, float scale, float zp,
                                    float qmax, float qmin) {
  const float v = rintf(__fadd_rn(__fdiv_rn(x, scale), zp));
  return (int)fminf(fmaxf(v, qmin), qmax);
}

// Replaces ops/runtime_quantization.py::_row_kernel: one warp per row.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rtq_row_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
               float* __restrict__ scale, int32_t* __restrict__ zero_point,
               int32_t* __restrict__ sums, int R, int K, int strategy,
               float qmax, float qmin) {
  using E = Elem<T>;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (ROW_THREADS / 32) + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp leaves together
  const T* xr = x + (size_t)row * K;
  float a, b = 0.f;
  if (strategy == SYMMETRIC) {
    a = 0.f;
    for (int c = lane; c < K; c += 32) a = fmaxf(a, fabsf(E::load(xr + c)));
    a = warp_max(a);
  } else if (strategy == CENTERED) {
    float sum = 0.f;
    for (int c = lane; c < K; c += 32) sum = __fadd_rn(sum, E::load(xr + c));
    b = __fmul_rn(warp_sum(sum), recip((float)K));
    a = 0.f;
    for (int c = lane; c < K; c += 32)
      a = fmaxf(a, fabsf(__fsub_rn(E::load(xr + c), b)));
    a = warp_max(a);
  } else {
    a = -INFINITY;
    b = INFINITY;
    for (int c = lane; c < K; c += 32) {
      const float v = E::load(xr + c);
      a = fmaxf(a, v);
      b = fminf(b, v);
    }
    a = warp_max(a);
    b = warp_min(b);
  }
  float s, z;
  cell_params(strategy, qmax, qmin, a, b, s, z);
  int total = 0;
  int8_t* cr = codes + (size_t)row * K;
  for (int c = lane; c < K; c += 32) {
    const int q = code(E::load(xr + c), s, z, qmax, qmin);
    cr[c] = (int8_t)q;
    total += q;
  }
  if (sums) total = warp_isum(total);
  if (lane == 0) {
    scale[row] = s;
    zero_point[row] = (int)z;
    if (sums) sums[row] = total;
  }
}

// Block-wide combine of one value per thread: red[t] = op(red[t],
// red[t + s]) for s = 512 down to 1; returns red[0] to every thread.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, V* red, Op op) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = BLOCK_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = op(red[t], red[t + s]);
    __syncthreads();
  }
  const V out = red[0];
  __syncthreads();  // before red is reused
  return out;
}

// Replaces ops/runtime_quantization.py::_block_kernel: one CTA per block
// of bs columns; statistics over its [R, bs] slab.
template <typename T>
__global__ void __launch_bounds__(BLOCK_THREADS)
rtq_block_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                 float* __restrict__ scale, int32_t* __restrict__ zero_point,
                 int32_t* __restrict__ sums, int R, int K, int bs,
                 int strategy, float qmax, float qmin) {
  using E = Elem<T>;
  __shared__ float fred[BLOCK_THREADS];
  __shared__ int ired[BLOCK_THREADS];
  const int blk = blockIdx.x;
  const long long n = (long long)R * bs;
  auto at = [&](long long e) {
    return (size_t)(e / bs) * K + (size_t)blk * bs + e % bs;
  };
  auto fmax_op = [](float p, float q) { return fmaxf(p, q); };
  auto fmin_op = [](float p, float q) { return fminf(p, q); };
  float a, b = 0.f;
  if (strategy == SYMMETRIC) {
    a = 0.f;
    for (long long e = threadIdx.x; e < n; e += BLOCK_THREADS)
      a = fmaxf(a, fabsf(E::load(x + at(e))));
    a = block_reduce(a, fred, fmax_op);
  } else if (strategy == CENTERED) {
    float sum = 0.f;
    for (long long e = threadIdx.x; e < n; e += BLOCK_THREADS)
      sum = __fadd_rn(sum, E::load(x + at(e)));
    sum = block_reduce(sum, fred,
                       [](float p, float q) { return __fadd_rn(p, q); });
    b = __fmul_rn(sum, recip((float)n));
    a = 0.f;
    for (long long e = threadIdx.x; e < n; e += BLOCK_THREADS)
      a = fmaxf(a, fabsf(__fsub_rn(E::load(x + at(e)), b)));
    a = block_reduce(a, fred, fmax_op);
  } else {
    a = -INFINITY;
    b = INFINITY;
    for (long long e = threadIdx.x; e < n; e += BLOCK_THREADS) {
      const float v = E::load(x + at(e));
      a = fmaxf(a, v);
      b = fminf(b, v);
    }
    a = block_reduce(a, fred, fmax_op);
    b = block_reduce(b, fred, fmin_op);
  }
  float s, z;
  cell_params(strategy, qmax, qmin, a, b, s, z);
  int total = 0;
  for (long long e = threadIdx.x; e < n; e += BLOCK_THREADS) {
    const size_t i = at(e);
    const int q = code(E::load(x + i), s, z, qmax, qmin);
    codes[i] = (int8_t)q;
    total += q;
  }
  if (sums) total = block_reduce(total, ired, [](int p, int q) { return p + q; });
  if (threadIdx.x == 0) {
    scale[blk] = s;
    zero_point[blk] = (int)z;
    if (sums) sums[blk] = total;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported dtype (0 float32,
// 1 bfloat16) or shape.  `sums` may be null.
extern "C" {

int mfa_rtq_rows(const void* x, void* codes, void* scale, void* zero_point,
                 void* sums, int dtype, int R, int K, int strategy,
                 float qmax, float qmin, void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scale);
  int32_t* zp = static_cast<int32_t*>(zero_point);
  int32_t* sm = static_cast<int32_t*>(sums);
  if (dtype == 0) {
    rtq_row_kernel<float><<<grid, ROW_THREADS, 0, s>>>(
        static_cast<const float*>(x), c, sc, zp, sm, R, K, strategy, qmax,
        qmin);
  } else if (dtype == 1) {
    rtq_row_kernel<__nv_bfloat16><<<grid, ROW_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), c, sc, zp, sm, R, K, strategy,
        qmax, qmin);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int mfa_rtq_blocks(const void* x, void* codes, void* scale, void* zero_point,
                   void* sums, int dtype, int R, int K, int bs, int strategy,
                   float qmax, float qmin, void* stream) {
  if (R <= 0 || bs <= 0 || K % bs) return (int)cudaErrorInvalidValue;
  const dim3 grid(K / bs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scale);
  int32_t* zp = static_cast<int32_t*>(zero_point);
  int32_t* sm = static_cast<int32_t*>(sums);
  if (dtype == 0) {
    rtq_block_kernel<float><<<grid, BLOCK_THREADS, 0, s>>>(
        static_cast<const float*>(x), c, sc, zp, sm, R, K, bs, strategy,
        qmax, qmin);
  } else if (dtype == 1) {
    rtq_block_kernel<__nv_bfloat16><<<grid, BLOCK_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), c, sc, zp, sm, R, K, bs,
        strategy, qmax, qmin);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

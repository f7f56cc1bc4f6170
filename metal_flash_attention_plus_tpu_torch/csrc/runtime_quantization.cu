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
// bit-identical with the plain versions.
//
// CENTERED's sum takes one fixed order, which the plain versions repeat.  A
// chunk is 8 consecutive columns of one row (columns past the row's or the
// block's end count as absent); a lane or a thread sums its chunks' columns
// in order, from 0.0, chunk after chunk.
//   - A row of K columns has n = ceil(K / 8) chunks and is held by a group
//     of G lanes of a warp, G the power of two >= n, at most 32.  Lane j
//     sums chunks j, j + G, j + 2G, ...; then the G lanes combine by xor
//     butterfly over offsets G/2, ..., 1.
//   - A block's [R, bs] slab is split over a cluster of C CTAs: rank r
//     takes the band of rows [r*B, min(R, (r+1)*B)), B = ceil(R / C).  A
//     band's chunks are numbered row-major, ceil(bs / 8) to a row; thread
//     t of the CTA's 512 sums chunks t, t + 512, ...  The 512 sums combine
//     by xor butterfly over offsets 16, ..., 1 within each warp, then the
//     16 warp sums (in warp order) over offsets 8, ..., 1; the C band sums
//     add in rank order, ((b0 + b1) + b2) + ...
// Both orders depend on the shape alone (K; R, bs and C), not on T: bf16
// input quantizes as its fp32 values do.
//
// What bounds them on the H100, and the design.  The work is a few
// operations per element: bytes bound (read x once, write one int8 code per
// element).  So each thread loads its chunks once, with 16-byte loads (one
// a chunk in bf16, two in fp32), keeps them in registers and makes both
// passes from there: the statistics (sum, max and min at once) and the
// codes, which go out 8 bytes a chunk.
//   - rtq_row_kernel: sub-warp rows (at the facade's K = 64, G = 8 and a
//     warp holds 4 rows), so the shuffle trees run log2 G levels.  A lane
//     holds NH chunks (1, 2 or 4, by the row's width); wider rows re-read
//     the rest from L1 in each pass.
//   - rtq_block_kernel: one cluster of C CTAs per block (grid K/bs x C,
//     C from the wrapper: two 512-thread CTAs an SM's worth, 256 CTAs, up
//     to C = 16, a non-portable cluster size: at K = 1024, 16 blocks x 16
//     at bs 64 and 8 x 16 at bs 128).  A CTA loads its band once, walking
//     (row, chunk) without a division per element; each thread holds 4
//     chunks, so a band of up to 16384 elements (a slab of up to C x 16384:
//     R*bs <= 262144 at C = 16) is read from device memory once; larger
//     bands re-read the chunks past the fourth from L2 in each pass.  One
//     pass takes the sum, max and min, which give every strategy's
//     statistic; each CTA's partial goes into a slot of every rank's
//     shared memory (distributed shared memory), and after one cluster
//     barrier each CTA combines the C slots in rank order, so all compute
//     the same statistic with the same bits.  Σq is exchanged the same way
//     while the held chunks' codes wait in registers, so the barrier does
//     not wait for their stores.  No atomics: two calls give the same
//     bits.  At the main path's size the cluster launch, not the bytes,
//     sets the time (PERF.md §6).
// Inputs whose rows are not 16-byte multiples, or whose base is not 16-byte
// aligned, take masked scalar loads (the VEC = false instances) under the
// same orders.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using mfa::Elem;

constexpr int CHUNK = 8;           // columns a chunk
constexpr int ROW_THREADS = 256;   // 8 warps; 256 / G rows a CTA
constexpr int BLOCK_THREADS = 512;
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
constexpr int BLOCK_HOLD = 4;      // chunks a block thread holds
constexpr int MAX_CLUSTER = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-12f;

enum Strategy { SYMMETRIC = 0, CENTERED = 1, ASYMMETRIC = 2 };

// The lanes that hold one row of K columns (see the header).
__host__ __device__ __forceinline__ int row_group(int K) {
  const int n = (K + CHUNK - 1) / CHUNK;
  int g = 1;
  while (g < n && g < 32) g *= 2;
  return g;
}

// One chunk's 8 values as stored (zero where absent).
template <typename T>
struct alignas(16) Chunk {
  T v[CHUNK];
};

// Loads the n (0..8) present columns at p; VEC: 16-byte loads (a load is
// whole or absent: the wrapper takes VEC only where n is a multiple of a
// load's elements).
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* p, int n) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < CHUNK / V; ++i)
    *reinterpret_cast<uint4*>(&c.v[i * V]) = make_uint4(0, 0, 0, 0);
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < CHUNK / V; ++i)
      if (i * V < n)
        *reinterpret_cast<uint4*>(&c.v[i * V]) =
            __ldg(reinterpret_cast<const uint4*>(p + i * V));
  } else {
#pragma unroll
    for (int e = 0; e < CHUNK; ++e)
      if (e < n) c.v[e] = p[e];
  }
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

// A cell's statistics: the sum (CENTERED's, in the fixed order) and the
// max and min of its values.  Every strategy takes its statistic from the
// max and min, exactly: rounding is monotonic and symmetric, so
// max|x| = max(|max|, |min|) and max|x - mean| = max(|max - mean|,
// |min - mean|), each difference rounded once as the plain versions round
// x - mean.  So one pass and one reduction serve every strategy.
struct Stats {
  float sum, hi, lo;
};

__device__ __forceinline__ Stats no_stats() {
  return {0.f, -INFINITY, INFINITY};
}

// Adds a chunk to s: all 8 values to the sum, in order (absent ones are
// 0.0), where `centered`; the n present ones to the max and min.
template <typename T>
__device__ __forceinline__ void chunk_stats(const Chunk<T>& c, int n,
                                            bool centered, Stats& s) {
#pragma unroll
  for (int e = 0; e < CHUNK; ++e) {
    const float v = Elem<T>::load(&c.v[e]);
    if (centered) s.sum = __fadd_rn(s.sum, v);
    if (e < n) {
      s.hi = fmaxf(s.hi, v);
      s.lo = fminf(s.lo, v);
    }
  }
}

// A cell's scale and zero point from its statistics over `count` values.
__device__ __forceinline__ void stats_params(int strategy, float qmax,
                                             float qmin, const Stats& t,
                                             float count, float& scale,
                                             float& zp) {
  float a, b = 0.f;
  if (strategy == SYMMETRIC) {
    a = fmaxf(fabsf(t.hi), fabsf(t.lo));
  } else if (strategy == CENTERED) {
    b = __fmul_rn(t.sum, recip(count));
    a = fmaxf(fabsf(__fsub_rn(t.hi, b)), fabsf(__fsub_rn(t.lo, b)));
  } else {
    a = t.hi;
    b = t.lo;
  }
  cell_params(strategy, qmax, qmin, a, b, scale, zp);
}

// The codes of a chunk's n present values as 8 bytes (0 where absent);
// returns their sum.
template <typename T>
__device__ __forceinline__ int chunk_codes(const Chunk<T>& c, int n, float s,
                                           float z, float qmax, float qmin,
                                           uint2& bytes) {
  uint32_t w[2] = {0, 0};
  int total = 0;
#pragma unroll
  for (int e = 0; e < CHUNK; ++e) {
    const int q = e < n ? code(Elem<T>::load(&c.v[e]), s, z, qmax, qmin) : 0;
    total += q;
    w[e / 4] |= (uint32_t)(q & 0xff) << (8 * (e % 4));
  }
  bytes = make_uint2(w[0], w[1]);
  return total;
}

// Stores a chunk's n codes at dst: 8 bytes at once where the chunk is whole
// and dst 8-byte aligned.
__device__ __forceinline__ void store_codes(int8_t* dst, uint2 bytes, int n,
                                            bool aligned8) {
  if (n == CHUNK && aligned8) {
    *reinterpret_cast<uint2*>(dst) = bytes;
  } else {
    const uint32_t w[2] = {bytes.x, bytes.y};
#pragma unroll
    for (int e = 0; e < CHUNK; ++e)
      if (e < n) dst[e] = (int8_t)(w[e / 4] >> (8 * (e % 4)));
  }
}

// ---------------------------------------------------------------------------
// Rows
// ---------------------------------------------------------------------------

__device__ __forceinline__ float group_fsum(float v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float group_fmax(float v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float group_fmin(float v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int group_isum(int v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Replaces ops/runtime_quantization.py::_row_kernel: a group of G lanes a
// row, each lane holding NH chunks in registers.  Every lane of a warp
// runs every shuffle: rows past R compute on absent chunks and store
// nothing.
template <typename T, int NH, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
rtq_row_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
               float* __restrict__ scale, int32_t* __restrict__ zero_point,
               int32_t* __restrict__ sums, int R, int K, int strategy,
               float qmax, float qmin) {
  const int G = row_group(K);
  const int j = threadIdx.x & (G - 1);
  const int row = blockIdx.x * (ROW_THREADS / G) + threadIdx.x / G;
  const bool live = row < R;
  const int passes = ((K + CHUNK - 1) / CHUNK + G - 1) / G;
  const T* xr = x + (size_t)row * K;
  int8_t* cr = codes + (size_t)row * K;
  const bool aligned8 = K % CHUNK == 0;
  auto col = [&](int p) { return (p * G + j) * CHUNK; };
  auto present = [&](int p) {
    return live ? max(0, min(CHUNK, K - col(p))) : 0;
  };
  Chunk<T> held[NH];
#pragma unroll
  for (int p = 0; p < NH; ++p)
    load_chunk<T, VEC>(held[p], xr + col(p), present(p));
  // f(chunk, first column, present columns) over this lane's chunks, in
  // order: the held ones, then the rest re-read.
  auto visit = [&](auto&& f) {
#pragma unroll
    for (int p = 0; p < NH; ++p) f(held[p], col(p), present(p));
    for (int p = NH; p < passes; ++p) {
      Chunk<T> c;
      load_chunk<T, VEC>(c, xr + col(p), present(p));
      f(c, col(p), present(p));
    }
  };
  const bool centered = strategy == CENTERED;
  Stats t = no_stats();
  visit([&](const Chunk<T>& c, int, int n) {
    chunk_stats(c, n, centered, t);
  });
  if (centered) t.sum = group_fsum(t.sum, G);
  t.hi = group_fmax(t.hi, G);
  t.lo = group_fmin(t.lo, G);
  float s, z;
  stats_params(strategy, qmax, qmin, t, (float)K, s, z);
  int total = 0;
  visit([&](const Chunk<T>& c, int c0, int n) {
    uint2 bytes;
    total += chunk_codes(c, n, s, z, qmax, qmin, bytes);
    store_codes(cr + c0, bytes, n, aligned8);
  });
  if (sums) total = group_isum(total, G);
  if (live && j == 0) {
    scale[row] = s;
    zero_point[row] = (int)z;
    if (sums) sums[row] = total;
  }
}

// ---------------------------------------------------------------------------
// Blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ Stats shfl_xor(const Stats& v, int off) {
  return {__shfl_xor_sync(FULL, v.sum, off), __shfl_xor_sync(FULL, v.hi, off),
          __shfl_xor_sync(FULL, v.lo, off)};
}
__device__ __forceinline__ int shfl_xor(int v, int off) {
  return __shfl_xor_sync(FULL, v, off);
}

// CENTERED's sum in the fixed order; the max and min in any.
__device__ __forceinline__ Stats add_stats(const Stats& p, const Stats& q) {
  return {__fadd_rn(p.sum, q.sum), fmaxf(p.hi, q.hi), fminf(p.lo, q.lo)};
}

// The cluster barrier split in two: every CTA arrives as it starts and
// waits before its first access to another CTA's shared memory, which then
// exists.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_fence() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// One value of every thread of the cluster combined in the block order
// (the header): warps by xor butterfly, the CTA's warps by xor butterfly
// in warp 0, whose lane q puts the CTA's partial into slot `rank` of rank
// q's `parts` (this reduction's own array); after the cluster barrier every
// thread combines its CTA's C slots in rank order.  No CTA reads another's
// shared memory, so none has to wait for the others before it leaves.
template <typename V, typename Op>
__device__ __forceinline__ V cluster_reduce(V v, Op op, V* warp_part,
                                            V* parts, int C, int rank,
                                            cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, shfl_xor(v, off));
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_part[lane % BLOCK_WARPS];
#pragma unroll
    for (int off = BLOCK_WARPS / 2; off > 0; off >>= 1)
      v = op(v, shfl_xor(v, off));
    if (lane < C) {
      (C > 1 ? cluster.map_shared_rank(parts, lane) : parts)[rank] = v;
      // Released by this lane alone: the barrier then waits for no other
      // store of the CTA (its codes stream out meanwhile).
      if (C > 1) cluster_fence();
    }
  }
  if (C > 1) {  // every rank's partial delivered
    cluster_arrive_relaxed();
    cluster_wait();
  } else {
    __syncthreads();
  }
  V s = parts[0];
  for (int q = 1; q < C; ++q) s = op(s, parts[q]);
  return s;
}

// Replaces ops/runtime_quantization.py::_block_kernel: cluster `rank` of C
// for block blockIdx.x / C, over its band of the [R, bs] slab.
template <typename T, bool VEC>
__global__ void __launch_bounds__(BLOCK_THREADS)
rtq_block_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                 float* __restrict__ scale, int32_t* __restrict__ zero_point,
                 int32_t* __restrict__ sums, int R, int K, int bs, int C,
                 int strategy, float qmax, float qmin) {
  __shared__ Stats warp_s[BLOCK_WARPS], part_s[MAX_CLUSTER];
  __shared__ int warp_i[BLOCK_WARPS], part_i[MAX_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  if (C > 1) cluster_arrive_relaxed();
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int blk = blockIdx.x / C;
  const int band = (R + C - 1) / C;
  const int r0 = min(R, rank * band);
  const int rows = min(R, r0 + band) - r0;
  const int cpr = (bs + CHUNK - 1) / CHUNK;  // chunks a row
  const int passes =
      (int)(((long long)rows * cpr + BLOCK_THREADS - 1) / BLOCK_THREADS);
  const size_t base = (size_t)r0 * K + (size_t)blk * bs;
  const bool aligned8 = K % CHUNK == 0 && bs % CHUNK == 0;
  // This thread's chunks t, t + 512, ... as (band row, chunk of the row),
  // stepped by (dr, dc) without a division.
  const int t = threadIdx.x;
  const int lr0 = t / cpr, c00 = t - lr0 * cpr;
  const int dr = BLOCK_THREADS / cpr, dc = BLOCK_THREADS - dr * cpr;
  auto present = [&](int lr, int c) {
    return lr < rows ? min(CHUNK, bs - c * CHUNK) : 0;
  };
  auto offset = [&](int lr, int c) {
    return base + (size_t)lr * K + c * CHUNK;
  };
  auto step = [&](int& lr, int& c) {
    lr += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++lr;
    }
  };
  Chunk<T> held[BLOCK_HOLD];
  {
    int lr = lr0, c = c00;
#pragma unroll
    for (int p = 0; p < BLOCK_HOLD; ++p) {
      load_chunk<T, VEC>(held[p], x + offset(lr, c), present(lr, c));
      step(lr, c);
    }
  }
  // f(chunk, offset, present columns) over this thread's chunks, in order:
  // the held ones, then the rest re-read.
  auto visit = [&](auto&& f) {
    int lr = lr0, c = c00;
#pragma unroll
    for (int p = 0; p < BLOCK_HOLD; ++p) {
      f(held[p], offset(lr, c), present(lr, c));
      step(lr, c);
    }
    for (int p = BLOCK_HOLD; p < passes; ++p) {
      Chunk<T> ch;
      load_chunk<T, VEC>(ch, x + offset(lr, c), present(lr, c));
      f(ch, offset(lr, c), present(lr, c));
      step(lr, c);
    }
  };
  const bool centered = strategy == CENTERED;
  Stats st = no_stats();
  visit([&](const Chunk<T>& ch, size_t, int n) {
    chunk_stats(ch, n, centered, st);
  });
  if (C > 1) cluster_wait();  // every rank has started
  st = cluster_reduce(
      st, [](const Stats& p, const Stats& q) { return add_stats(p, q); },
      warp_s, part_s, C, rank, cluster);
  float s, z;
  stats_params(strategy, qmax, qmin, st, (float)((long long)R * bs), s, z);
  // The held chunks' codes stay in registers until Σq is exchanged; the
  // rest go out as they are made.
  int total = 0;
  uint2 held_codes[BLOCK_HOLD];
  {
    int lr = lr0, c = c00;
#pragma unroll
    for (int p = 0; p < BLOCK_HOLD; ++p) {
      total += chunk_codes(held[p], present(lr, c), s, z, qmax, qmin,
                           held_codes[p]);
      step(lr, c);
    }
    for (int p = BLOCK_HOLD; p < passes; ++p) {
      Chunk<T> ch;
      load_chunk<T, VEC>(ch, x + offset(lr, c), present(lr, c));
      uint2 bytes;
      total += chunk_codes(ch, present(lr, c), s, z, qmax, qmin, bytes);
      store_codes(codes + offset(lr, c), bytes, present(lr, c), aligned8);
      step(lr, c);
    }
  }
  if (sums)
    total = cluster_reduce(total, [](int p, int q) { return p + q; }, warp_i,
                           part_i, C, rank, cluster);
  {
    int lr = lr0, c = c00;
#pragma unroll
    for (int p = 0; p < BLOCK_HOLD; ++p) {
      store_codes(codes + offset(lr, c), held_codes[p], present(lr, c),
                  aligned8);
      step(lr, c);
    }
  }
  if (rank == 0 && t == 0) {
    scale[blk] = s;
    zero_point[blk] = (int)z;
    if (sums) sums[blk] = total;
  }
}

template <typename T, int NH, bool VEC>
int launch_rows(const void* x, int8_t* c, float* sc, int32_t* zp,
                int32_t* sm, int R, int K, int strategy, float qmax,
                float qmin, cudaStream_t s) {
  const int per_cta = ROW_THREADS / row_group(K);
  rtq_row_kernel<T, NH, VEC><<<(R + per_cta - 1) / per_cta, ROW_THREADS, 0,
                               s>>>(static_cast<const T*>(x), c, sc, zp, sm,
                                    R, K, strategy, qmax, qmin);
  return (int)cudaGetLastError();
}

template <typename T>
int rows_of(const void* x, int8_t* c, float* sc, int32_t* zp, int32_t* sm,
            int R, int K, int strategy, float qmax, float qmin,
            cudaStream_t s) {
  const bool vec = ((uintptr_t)x & 15) == 0 && (K * sizeof(T)) % 16 == 0;
  const int G = row_group(K);
  const int passes = ((K + CHUNK - 1) / CHUNK + G - 1) / G;
#define MFA_RTQ_ROWS(NH)                                                     \
  return vec ? launch_rows<T, NH, true>(x, c, sc, zp, sm, R, K, strategy,    \
                                        qmax, qmin, s)                       \
             : launch_rows<T, NH, false>(x, c, sc, zp, sm, R, K, strategy,   \
                                         qmax, qmin, s)
  if (passes <= 1) MFA_RTQ_ROWS(1);
  if (passes <= 2) MFA_RTQ_ROWS(2);
  MFA_RTQ_ROWS(4);
#undef MFA_RTQ_ROWS
}

template <typename T, bool VEC>
int launch_blocks(const void* x, int8_t* c, float* sc, int32_t* zp,
                  int32_t* sm, int R, int K, int bs, int C, int strategy,
                  float qmax, float qmin, cudaStream_t s) {
  auto kern = rtq_block_kernel<T, VEC>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K / bs) * (unsigned)C);
  cfg.blockDim = dim3(BLOCK_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  if (C > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), c, sc, zp, sm,
                         R, K, bs, C, strategy, qmax, qmin);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int blocks_of(const void* x, int8_t* c, float* sc, int32_t* zp, int32_t* sm,
              int R, int K, int bs, int C, int strategy, float qmax,
              float qmin, cudaStream_t s) {
  const bool vec = ((uintptr_t)x & 15) == 0 && (K * sizeof(T)) % 16 == 0 &&
                   (bs * sizeof(T)) % 16 == 0;
  return vec ? launch_blocks<T, true>(x, c, sc, zp, sm, R, K, bs, C,
                                      strategy, qmax, qmin, s)
             : launch_blocks<T, false>(x, c, sc, zp, sm, R, K, bs, C,
                                       strategy, qmax, qmin, s);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported dtype (0 float32,
// 1 bfloat16) or shape.  `sums` may be null.
extern "C" {

// The lanes that hold one row of K columns in rtq_row_kernel
// (ops/runtime_quantization.py::row_group mirrors it).
int mfa_rtq_row_group(int K) { return K > 0 ? row_group(K) : 0; }

int mfa_rtq_rows(const void* x, void* codes, void* scale, void* zero_point,
                 void* sums, int dtype, int R, int K, int strategy,
                 float qmax, float qmin, void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scale);
  int32_t* zp = static_cast<int32_t*>(zero_point);
  int32_t* sm = static_cast<int32_t*>(sums);
  if (dtype == 0)
    return rows_of<float>(x, c, sc, zp, sm, R, K, strategy, qmax, qmin, s);
  if (dtype == 1)
    return rows_of<__nv_bfloat16>(x, c, sc, zp, sm, R, K, strategy, qmax,
                                  qmin, s);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` bf16 block-kernel CTAs the card holds at
// once (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
int mfa_rtq_max_clusters(int cluster) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return -(int)cudaErrorInvalidValue;
  auto kern = rtq_block_kernel<__nv_bfloat16, true>;
  if (cluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(BLOCK_THREADS);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, (void*)kern, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// `cluster`: the CTAs that share a block's slab (1 to 16; the wrapper's
// block_cluster), each taking a band of ceil(R / cluster) rows.
int mfa_rtq_blocks(const void* x, void* codes, void* scale, void* zero_point,
                   void* sums, int dtype, int R, int K, int bs, int strategy,
                   float qmax, float qmin, int cluster, void* stream) {
  if (R <= 0 || bs <= 0 || K % bs || cluster < 1 || cluster > MAX_CLUSTER ||
      (long long)(K / bs) * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  float* sc = static_cast<float*>(scale);
  int32_t* zp = static_cast<int32_t*>(zero_point);
  int32_t* sm = static_cast<int32_t*>(sums);
  if (dtype == 0)
    return blocks_of<float>(x, c, sc, zp, sm, R, K, bs, cluster, strategy,
                            qmax, qmin, s);
  if (dtype == 1)
    return blocks_of<__nv_bfloat16>(x, c, sc, zp, sm, R, K, bs, cluster,
                                    strategy, qmax, qmin, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

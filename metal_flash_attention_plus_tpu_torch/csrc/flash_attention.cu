// Flash attention for Hopper (sm_90a): the forward, the dQ backward and the
// dK/dV backward, each one CUDA kernel over BHSD tensors.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/flash_attention.py::_fwd_kernel         -> flash_fwd_kernel
//   - ops/flash_attention_bwd.py::_dq_kernel      -> flash_dq_kernel
//   - ops/flash_attention_bwd.py::_dkv_kernel     -> flash_dkv_kernel
//
// Layouts: q/dO [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] of T (float or bf16),
// contiguous; L and D (= rowsum(dO*O)) fp32 [B, Hq, Sq]; O, dQ fp32
// [B, Hq, Sq, D]; dK, dV fp32 [B, Hkv, Skv, D].  GQA: q head h reads kv
// head h / (Hq/Hkv), or h % Hkv when interleaved.  Every mask arrives as
// one int32 [Sq, 2] table of per-row [start, end) key ranges
// (ops/flash_attention.py::compute_row_ranges); a row with end <= start
// is empty.  The optional additive bias is fp32 [Bb, Hb, Sq, Skv] with
// batch/head strides (0 where broadcast); the dQ kernel can also write
// dbias = dS, fp32 [B, Hq, Sq, Skv].
//
// Numerics, shared with the plain PyTorch versions in ops/flash_attention.py
// and ops/flash_attention_bwd.py so the two can be held to a tight
// tolerance:
//   - forward: q pre-scaled by scale*log2(e) and rounded back to T; base-2
//     online softmax in fp32; bias*log2(e) added, then masked scores set to
//     mask_value; P rounded to T before P.V; l sums the unrounded p;
//     O = acc / l, L = m*ln2 + log(l); an empty row gives O = 0, L = -inf;
//   - backward: q pre-scaled by scale (natural base) and rounded to T;
//     L = -inf read as 0; P = exp(S + bias - L), 0 where masked;
//     dP = dO.V^T; dS = P*(dP - D); dQ = scale * round_T(dS).K;
//     dV = round_T(P)^T.dO; dK = round_T(dS)^T.Q_s.
//
// What bounds them on the H100, and the design.
//   At the training shapes (B=4, Hq=16, Hkv=4, S=2048, D=64, causal) each
//   kernel does 2-4 products of 64x64 tiles per KV tile with D = 64 deep:
//   ~70 GFLOP for the forward, i.e. compute bound on the tensor cores
//   (989 TFLOP/s bf16) by a wide margin over the ~40 MB of bytes.  These
//   first versions do the products with scalar fp32 FMAs (67 TFLOP/s peak),
//   so they cannot reach that bound; they are the right-and-simple step
//   before mma/wgmma, TMA and warp specialisation.  All three use 256
//   threads on a 64 x 64 tile, 4 x 4 scores per thread; operands are staged
//   in shared memory as fp32, transposed ([D][64 + 4]) so a thread's four
//   rows and four columns are 16-byte vectors and the products read two
//   vectors per 16 FMAs.
//   - forward: one CTA per (64 query rows, b, q head).  The TPU's sequential
//     grid carried m, l and the accumulator from KV block to KV block; here
//     one CTA loops over its KV tiles and keeps them in registers.  The CTA
//     reduces its rows' ranges to the live key span [min start, max end)
//     and visits only the tiles in it (causal: about half), so no padded
//     copy is made and dead tiles cost nothing.
//   - dQ: one CTA per (64 query rows, b, q head); Q_s^T and dO^T stay in
//     shared memory; per KV tile V^T then K^T are staged in one buffer, and
//     K^T serves both S = Q_s.K^T and dQ += dS.K.
//   - dK/dV: one CTA per (64 keys, b, kv head) owns its tile's dK and dV,
//     looping over the GQA group's q heads x the live query rows (the span
//     of rows whose range meets the tile), so the group reduction needs no
//     atomics and no second pass.  K^T and V^T stay resident for D <= 128;
//     at D = 256 they share one buffer, restaged per query tile, to keep
//     shared memory under 227 KB; at D = 288 Q_s^T and dO^T share one too
//     (dQ likewise restages Q_s^T and dO^T per key tile there).  The bf16
//     instances up to D = 256 run the same grid and walk on the tensor
//     cores instead (flash_dkv_tc_kernel: attention_bwd.cuh::dkv_tc_body,
//     bf16 mma.sync over bf16 tiles, K and V resident at every width).
//   Head dims: the kernels are built for D = 32, 64, 128, 256 and 288
//   (MLAConfig's latent width d_c + d_r); the wrappers run any other
//   multiple of 16 up to 288 at the next of these, its Q/K/V/dO lanes
//   zero-padded, which adds nothing to S, O or any gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"

namespace {

using mfa::BM;
using mfa::BN;
using mfa::BwdArgs;
using mfa::Elem;
using mfa::LD;
using mfa::LN2;
using mfa::LOG2E;
using mfa::THREADS;
using mfa::accumulate_pm;
using mfa::key_span;
using mfa::row_range;
using mfa::launch_with_smem;
using mfa::set_smem;
using mfa::stage_t;
using mfa::store_t;
using mfa::tile_product;

template <int D>
constexpr size_t fwd_smem_floats() {
  return 2 * (size_t)D * LD + (size_t)BN * LD;  // Q^T, K^T|V^T, P^T
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention.py::_fwd_kernel.  Bound: tensor-core
// operations (4*D per live query-key pair), not bytes; this scalar-FMA
// version runs at a fraction of it.  One CTA per 64 query rows loops over
// the live key tiles with m, l and the accumulator in registers.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ ranges,
                 const float* __restrict__ bias, long long bias_sb,
                 long long bias_sh, float* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 int interleaved, float qscale, float mask_value) {
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;          // [D][LD]  Q_s^T
  float* kvt = qt + D * LD;  // [D][LD]  K^T, then V^T
  float* pt = kvt + D * LD;  // [BN][LD] P^T
  __shared__ int s_lo, s_hi;

  const int r0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int hk = interleaved ? h % Hkv : h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = (size_t)b * Hq + h;
  const T* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  const float* bh_bias =
      bias ? bias + b * bias_sb + h * bias_sh : nullptr;

  stage_t<T, D, true>(q + bh * Sq * D, r0, Sq, qt, qscale);
  key_span(ranges, r0, Sq, Skv, &s_lo, &s_hi);  // syncs: Q^T staged too
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_range(ranges, r0 + ty * 4 + i, Sq, Skv, rs[i], re[i]);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += BN) {
    stage_t<T, D, false>(kh, t0, c_hi, kvt, 0.f);
    __syncthreads();
    float s[4][4];
    tile_product<D>(qt, ty, kvt, tx, s);
    __syncthreads();  // every thread is done with K^T
    stage_t<T, D, false>(vh, t0, c_hi, kvt, 0.f);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx * 4 + j;
        if (bh_bias && row < Sq && col < c_hi)
          s[i][j] += bh_bias[(size_t)row * Skv + col] * LOG2E;
        if (col < rs[i] || col >= re[i]) s[i][j] = mask_value;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are the 16 lanes sharing ty in one warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            (s[i][j] == -INFINITY) ? 0.f : exp2f(s[i][j] - m_next);
        sum += p;
        s[i][j] = Elem<T>::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[i][e] *= alpha;
    }
    store_t(pt, ty, tx, s);
    __syncthreads();  // V^T and P^T staged
    accumulate_pm<D>(pt, ty, kvt, tx, acc);
    __syncthreads();  // before the next tile overwrites them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    float* orow = o + (bh * Sq + r) * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) orow[tx + 16 * e] = acc[i][e] * inv;
    if (tx == 0) lse[bh * Sq + r] = live ? m[i] * LN2 + logf(l[i]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// dQ and dK / dV: the bodies of attention_bwd.cuh over float K/V
// ---------------------------------------------------------------------------

// K or V rows of T, staged as they are.
template <typename T, int D>
struct FloatKV {
  const T* k;
  const T* v;
  int Skv;
  __device__ __forceinline__ void stage(bool is_v, size_t head, int t0,
                                        int limit, float* dst) const {
    stage_t<T, D, false>((is_v ? v : k) + head * Skv * D, t0, limit, dst,
                         0.f);
  }
  // dkv_tc_body's staging (T = bf16): the rows as they are, by cp.async.
  template <int NT, int ROW>
  __device__ __forceinline__ void tc_load(bool is_v, size_t head, int t0,
                                          int limit, uint8_t* dst,
                                          uint8_t*) const {
    mfa::stage_rows_async<D, ROW, NT>((is_v ? v : k) + head * Skv * D, t0,
                                      limit, dst);
  }
  template <int NT, int ROW>
  __device__ __forceinline__ void tc_convert(bool, size_t, int, int,
                                             uint8_t*,
                                             const uint8_t*) const {}
};

// Replaces ops/flash_attention_bwd.py::_dq_kernel.  Bound: operations
// (6*D per live pair: S, dP, dQ).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const BwdArgs a, const FloatKV<T, D> kv) {
  mfa::dq_body<T, D, true>(a, kv);
}

// Replaces ops/flash_attention_bwd.py::_dkv_kernel.  Bound: operations
// (8*D per live pair: S, dP, dV, dK).  The fp32 instances and bf16 at
// D = 288; the other bf16 ones take flash_dkv_tc_kernel (mfa::dkv_tc).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const BwdArgs a, const FloatKV<T, D> kv) {
  mfa::dkv_body<T, D>(a, kv);
}

// The same on the tensor cores: bf16 up to D = 256 (attention_bwd.cuh).
template <int D>
__global__ void __launch_bounds__(mfa::dkv_tc_threads<D>(),
                           mfa::dkv_tc_min_blocks<D>())
flash_dkv_tc_kernel(const BwdArgs a, const FloatKV<__nv_bfloat16, D> kv) {
  mfa::dkv_tc_body<D>(a, kv);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Shape {
  int B, Hq, Hkv, Sq, Skv, interleaved;
};

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* ranges, const void* bias, long long sb,
               long long sh, void* o, void* lse, Shape sp, float qscale,
               float mask_value, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((sp.Sq + BM - 1) / BM, sp.Hq, sp.B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(ranges),
      static_cast<const float*>(bias), sb, sh, static_cast<float*>(o),
      static_cast<float*>(lse), sp.Hq, sp.Hkv, sp.Sq, sp.Skv, sp.interleaved,
      qscale, mask_value);
  return (int)cudaGetLastError();
}

// dQ (out0 = dQ, out1 = dbias or null) or dK/dV (out0 = dK, out1 = dV).
template <typename T, int D, bool DQ>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, const void* ranges,
               const void* bias, long long sb, long long sh, void* out0,
               void* out1, Shape sp, float scale, cudaStream_t stream) {
  const BwdArgs a{q, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(di),
                  static_cast<const int32_t*>(ranges),
                  static_cast<const float*>(bias), sb, sh, nullptr, nullptr,
                  nullptr, static_cast<float*>(out0),
                  static_cast<float*>(out1), sp.Hq, sp.Hkv, sp.Sq, sp.Skv,
                  sp.interleaved, scale};
  const FloatKV<T, D> kv{static_cast<const T*>(k), static_cast<const T*>(v),
                         sp.Skv};
  const dim3 grid(DQ ? (sp.Sq + BM - 1) / BM : (sp.Skv + BN - 1) / BN,
                  DQ ? sp.Hq : sp.Hkv, sp.B);
  if constexpr (DQ)
    return launch_with_smem(flash_dq_kernel<T, D>, grid, THREADS,
                            mfa::dq_smem_floats<D>() * sizeof(float), stream,
                            a, kv);
  else if constexpr (mfa::dkv_tc<T, D>())
    return launch_with_smem(flash_dkv_tc_kernel<D>, grid,
                            mfa::dkv_tc_threads<D>(), mfa::DkvTcSmem<D>::BYTES,
                            stream, a, kv);
  else
    return launch_with_smem(flash_dkv_kernel<T, D>, grid, THREADS,
                            mfa::dkv_smem_floats<D>() * sizeof(float), stream,
                            a, kv);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, const void* ranges,
              const void* bias, long long sb, long long sh, void* dq,
              void* dbias, Shape sp, float scale, cudaStream_t stream) {
  return launch_bwd<T, D, true>(q, k, v, dout, lse, di, ranges, bias, sb, sh,
                                dq, dbias, sp, scale, stream);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* di,
               const void* ranges, const void* bias, long long sb,
               long long sh, void* dk, void* dv, Shape sp, float scale,
               cudaStream_t stream) {
  return launch_bwd<T, D, false>(q, k, v, dout, lse, di, ranges, bias, sb,
                                 sh, dk, dv, sp, scale, stream);
}

// Returns LAUNCH<T, D>(args...) for the runtime dtype (0 = float32,
// 1 = bfloat16) and head dim (32, 64, 128, 256, 288).
#define MFA_DIMS(LAUNCH, T, ...)                                   \
  do {                                                             \
    if (D == 32) return LAUNCH<T, 32>(__VA_ARGS__);                \
    if (D == 64) return LAUNCH<T, 64>(__VA_ARGS__);                \
    if (D == 128) return LAUNCH<T, 128>(__VA_ARGS__);              \
    if (D == 256) return LAUNCH<T, 256>(__VA_ARGS__);              \
    if (D == 288) return LAUNCH<T, 288>(__VA_ARGS__);              \
  } while (0)
#define MFA_DISPATCH(LAUNCH, ...)                                  \
  if (dtype == 0) {                                                \
    MFA_DIMS(LAUNCH, float, __VA_ARGS__);                          \
  } else if (dtype == 1) {                                         \
    MFA_DIMS(LAUNCH, __nv_bfloat16, __VA_ARGS__);                  \
  }                                                                \
  return (int)cudaErrorInvalidValue

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported dtype or head dim,
// or a group that does not divide Hq.
extern "C" {

int mfa_flash_fwd(const void* q, const void* k, const void* v,
                  const void* ranges, const void* bias, long long bias_sb,
                  long long bias_sh, void* o, void* lse, int dtype, int B,
                  int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                  float qscale, float mask_value, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_fwd, q, k, v, ranges, bias, bias_sb, bias_sh, o, lse,
               sp, qscale, mask_value, s);
}

int mfa_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* di,
                 const void* ranges, const void* bias, long long bias_sb,
                 long long bias_sh, void* dq, void* dbias, int dtype, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                 float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_dq, q, k, v, dout, lse, di, ranges, bias, bias_sb,
               bias_sh, dq, dbias, sp, scale, s);
}

int mfa_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di,
                  const void* ranges, const void* bias, long long bias_sb,
                  long long bias_sh, void* dk, void* dv, int dtype, int B,
                  int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                  float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MFA_DISPATCH(launch_dkv, q, k, v, dout, lse, di, ranges, bias, bias_sb,
               bias_sh, dk, dv, sp, scale, s);
}

}  // extern "C"

// Flash attention for Hopper (sm_90a): the forward, the dQ backward and the
// dK/dV backward, each one CUDA kernel over BHSD tensors.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/flash_attention.py::_fwd_kernel         -> flash_fwd_tc_kernel
//     (bf16 up to D = 256), flash_fwd_wide_kernel (bf16 at D = 288),
//     flash_fwd_latent_kernel (bf16 at D = 576), flash_fwd_kernel (fp32)
//   - ops/flash_attention_bwd.py::_dq_kernel      -> flash_dq_tc_kernel
//     (bf16 up to D = 256), flash_dq_wide_kernel (bf16 at D = 288),
//     flash_dq_latent_kernel (bf16 at D = 576), flash_dq_kernel (fp32)
//   - ops/flash_attention_bwd.py::_dkv_kernel     -> flash_dkv_tc_kernel
//     (bf16 up to D = 256), flash_dkv_wide_kernel then
//     flash_dkv_merge_kernel (bf16 at D = 288), flash_dkv_latent_kernel
//     then flash_dkv_merge_kernel (bf16 at D = 576), flash_dkv_kernel (fp32)
//   and above D = 576, in both dtypes, the split-D kernels of
//   csrc/split_d_attention.cu (split_d_fwd_kernel, split_d_dq_kernel,
//   split_d_dkv_kernel then flash_dkv_merge_kernel), which the entry points
//   below hand such a head dim to.
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
//   - the forward's static-max mode (STATIC_MAX; the TPU kernel's
//     static_max, reached through flash_attention_forward(row_max=...)):
//     the caller gives each row's subtrahend M (base 2, fp32 [B, Hq, Sq]);
//     p = 2^(s - M) with no running max and no rescale, l += sum(p),
//     acc += P.V, L = M*ln2 + log(l) where l > 0, else -inf with O = 0;
//   - backward: q pre-scaled by scale (natural base) and rounded to T;
//     L = -inf read as 0; P = exp(S + bias - L), 0 where masked;
//     dP = dO.V^T; dS = P*(dP - D); dQ = scale * round_T(dS).K;
//     dV = round_T(P)^T.dO; dK = round_T(dS)^T.Q_s.
//
// What bounds them on the H100, and the design.
//   At the training shapes (B=4, Hq=16, Hkv=4, S=2048, D=64, causal) each
//   kernel does 2-4 products of 64x64 tiles per KV tile with D = 64 deep:
//   4*D operations per live query-key pair for the forward (~34 G), 6*D
//   for dQ, 8*D for dK/dV, i.e. compute bound on the tensor cores (989
//   TFLOP/s bf16) by a wide margin over the ~40 MB of bytes.  So the bf16
//   forward, dQ and dK/dV up to D = 256 run on the tensor cores (bf16
//   mma.sync into fp32, operands staged by cp.async): flash_fwd_tc_kernel
//   below, flash_dq_tc_kernel (attention_bwd.cuh::dq_tc_body) and
//   flash_dkv_tc_kernel (attention_bwd.cuh::dkv_tc_body); so do the bf16
//   forward, dQ and dK/dV at MLA's D = 288, with tiles cut for that width
//   (flash_fwd_wide_kernel: the forward's body in 32-key tiles, two CTAs
//   an SM; flash_dq_wide_kernel, flash_dkv_wide_kernel:
//   attention_bwd.cuh::dq_wide_body, ::dkv_wide_body; the dK/dV's GQA
//   group split over CTAs and summed by flash_dkv_merge_kernel); and at
//   DeepSeek's absorbed D = 576 (flash_fwd_latent_kernel: O's lanes split
//   over two warp groups that share each tile's scores;
//   flash_dq_latent_kernel, flash_dkv_latent_kernel:
//   attention_bwd.cuh::dq_latent_body, ::dkv_latent_body).  fp32 stays on
//   scalar fp32 FMAs (67 TFLOP/s peak): TF32 keeps ~3 digits and the fp32
//   instances are held to 2e-5.  The scalar kernels use 256 threads on a
//   64 x 64 tile, 4 x 4 scores per thread; operands are staged in shared
//   memory as fp32, transposed ([D][64 + 4]) so a thread's four rows and
//   four columns are 16-byte vectors and the products read two vectors per
//   16 FMAs.  Above D = 288 they take 32-row tiles instead, 4 x 1 scores a
//   thread (mfa::scalar32: fwd_body32 below, attention_bwd.cuh::dq_body32,
//   ::dkv_body32).
//   - forward: one CTA per (64 query rows, b, q head).  The TPU's sequential
//     grid carried m, l and the accumulator from KV block to KV block; here
//     one CTA loops over its KV tiles and keeps them in registers.  The CTA
//     reduces its rows' ranges to the live key span [min start, max end)
//     and visits only the tiles in it (causal: about half), so no padded
//     copy is made and dead tiles cost nothing.  The tensor-core forward
//     keeps that grid and walk as FlashAttention-2 does on mma.sync (see
//     its comment).
//   - dQ: one CTA per (64 query rows, b, q head); Q_s^T and dO^T stay in
//     shared memory; per KV tile V^T then K^T are staged in one buffer, and
//     K^T serves both S = Q_s.K^T and dQ += dS.K.  The bf16 instances keep
//     that grid on the tensor cores (flash_dq_tc_kernel:
//     attention_bwd.cuh::dq_tc_body, Q and dO resident as bf16 rows, K and
//     V double-buffered by cp.async; at D = 288 flash_dq_wide_kernel, the
//     same in 32-key tiles).
//   - dK/dV: one CTA per (64 keys, b, kv head) owns its tile's dK and dV,
//     looping over the GQA group's q heads x the live query rows (the span
//     of rows whose range meets the tile), so the group reduction needs no
//     atomics and no second pass.  K^T and V^T stay resident for D <= 128;
//     at D = 256 they share one buffer, restaged per query tile, to keep
//     shared memory under 227 KB; at D = 288 Q_s^T and dO^T share one too
//     (dQ likewise restages Q_s^T and dO^T per key tile there).  The bf16
//     instances up to D = 256 run the same grid and walk on the tensor
//     cores instead (flash_dkv_tc_kernel: attention_bwd.cuh::dkv_tc_body,
//     bf16 mma.sync over bf16 tiles, K and V resident at every width).  At
//     D = 288 flash_dkv_wide_kernel (attention_bwd.cuh::dkv_wide_body)
//     walks 48-row query steps and deals the GQA group over `splits` CTAs
//     a key tile, whose fp32 partials flash_dkv_merge_kernel sums in split
//     order (ops/flash_attention_bwd.py::dkv_splits plans the split).
//   Head dims: the kernels are built for D = 32, 64, 128, 256, 288
//   (MLAConfig's latent width d_c + d_r) and 576 (DeepSeek-V2's absorbed
//   kv_lora_rank + qk_rope_head_dim, 512 + 64); the wrappers run any other
//   multiple of 16 up to 576 at the next of these (304 to 560 at 576), its
//   Q/K/V/dO lanes zero-padded, which adds nothing to S, O or any gradient.
//   Above 576 the entry points below hand every multiple of 16 (the
//   wrappers zero-pad to one) to the split-D kernels of
//   csrc/split_d_attention.cu (split_d.cuh), which take the head dim at
//   run time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "attention_bwd.cuh"
#include "attention_tiles.cuh"
#include "common.cuh"
#include "split_d.cuh"

namespace {

using mfa::BM;
using mfa::BN;
using mfa::BwdArgs;
using mfa::LD;
using mfa::LD32;
using mfa::LN2;
using mfa::LOG2E;
using mfa::THREADS;
using mfa::accumulate_pm;
using mfa::key_span;
using mfa::row_range;
using mfa::launch_with_smem;
using mfa::stage_t;
using mfa::store_t;
using mfa::T32;
using mfa::tile_product;

template <int D>
constexpr size_t fwd_smem_floats() {
  return 2 * (size_t)D * LD + (size_t)BN * LD;  // Q^T, K^T|V^T, P^T
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The fp32 forward's body up to D = 288 (flash_fwd_kernel below wraps it;
// every bf16 instance runs on the tensor cores: flash_fwd_tc_kernel,
// flash_fwd_wide_kernel, flash_fwd_latent_kernel).  Bound: operations
// (4*D per live query-key pair), not bytes; this scalar-FMA version runs
// at a fraction of it.  One CTA per 64 query rows loops over the live key
// tiles with m, l and the accumulator in registers.  STATIC_MAX: m is the
// caller's row_max, loaded once, and each tile only adds to l and the
// accumulator (no row max, no rescale).
template <int D, bool STATIC_MAX>
__device__ __forceinline__ void fwd_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int32_t* __restrict__ ranges,
    const float* __restrict__ bias, long long bias_sb, long long bias_sh,
    float* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Sq,
    int Skv, int interleaved, float qscale, float mask_value,
    const float* __restrict__ row_max) {
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
  const float* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  const float* bh_bias =
      bias ? bias + b * bias_sb + h * bias_sh : nullptr;

  stage_t<float, D, true>(q + bh * Sq * D, r0, Sq, qt, qscale);
  key_span(ranges, r0, Sq, Skv, &s_lo, &s_hi);  // syncs: Q^T staged too
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_range(ranges, r, Sq, Skv, rs[i], re[i]);
    m[i] = !STATIC_MAX ? -INFINITY : r < Sq ? row_max[bh * Sq + r] : 0.f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += BN) {
    stage_t<float, D, false>(kh, t0, c_hi, kvt, 0.f);
    __syncthreads();
    float s[4][4];
    tile_product<D>(qt, ty, kvt, tx, s);
    __syncthreads();  // every thread is done with K^T
    stage_t<float, D, false>(vh, t0, c_hi, kvt, 0.f);

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
      float m_next = m[i], alpha = 1.f;
      if constexpr (!STATIC_MAX) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        m_next = fmaxf(m[i], mx);
        alpha = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            (s[i][j] == -INFINITY) ? 0.f : exp2f(s[i][j] - m_next);
        sum += p;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (STATIC_MAX) {
        l[i] += sum;
      } else {
        l[i] = alpha * l[i] + sum;
        m[i] = m_next;
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[i][e] *= alpha;
      }
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

// fwd_body above D = 288, in 32-row tiles (mfa::scalar32; the layout and
// thread map of attention_bwd.cuh::dq_body32): Q_s^T transposed, each key
// tile's K rows then V rows in one row tile, P^T in the score tile; thread
// (ty, tx) holds rows 4 ty + [0, 4), their scores against key tx (the row
// max and sum reduce over the warp) and O's lanes tx + 32 e.
template <int D, bool STATIC_MAX>
__device__ __forceinline__ void fwd_body32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int32_t* __restrict__ ranges,
    const float* __restrict__ bias, long long bias_sb, long long bias_sh,
    float* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Sq,
    int Skv, int interleaved, float qscale, float mask_value,
    const float* __restrict__ row_max) {
  constexpr int DE = D / T32;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                             // [D][LD32]  Q_s^T
  float* kvr = qt + D * LD32;                   // [32][D + 1]  K, then V
  float* pt = kvr + T32 * mfa::ld_rows32<D>();  // [32][LD32]  P^T
  __shared__ int s_lo, s_hi;

  const int r0 = blockIdx.x * T32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = interleaved ? h % Hkv : h / (Hq / Hkv);
  const int tx = threadIdx.x % T32;
  const int ty = threadIdx.x / T32;
  const size_t bh = (size_t)b * Hq + h;
  const float* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  const float* bh_bias =
      bias ? bias + b * bias_sb + h * bias_sh : nullptr;

  mfa::stage32<D, true, false>(q + bh * Sq * D, r0, Sq, qt, qscale);
  key_span<T32>(ranges, r0, Sq, Skv, &s_lo, &s_hi);  // syncs: Q^T staged
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float m[4], l[4], acc[4][DE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_range(ranges, r, Sq, Skv, rs[i], re[i]);
    m[i] = !STATIC_MAX ? -INFINITY : r < Sq ? row_max[bh * Sq + r] : 0.f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = c_lo; t0 < c_hi; t0 += T32) {
    mfa::stage32<D, false, true>(kh, t0, c_hi, kvr, 0.f);
    __syncthreads();
    float s[4];
    mfa::tile_product32<D>(qt, ty, kvr, tx, s);
    __syncthreads();  // every thread is done with K
    mfa::stage32<D, false, true>(vh, t0, c_hi, kvr, 0.f);

    const int col = t0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      if (bh_bias && row < Sq && col < c_hi)
        s[i] += bh_bias[(size_t)row * Skv + col] * LOG2E;
      if (col < rs[i] || col >= re[i]) s[i] = mask_value;
      // A row's 32 scores are the 32 lanes of one warp.
      float m_next = m[i], alpha = 1.f;
      if constexpr (!STATIC_MAX) {
        float mx = s[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        m_next = fmaxf(m[i], mx);
        alpha = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next);
      }
      const float p = (s[i] == -INFINITY) ? 0.f : exp2f(s[i] - m_next);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (STATIC_MAX) {
        l[i] += sum;
      } else {
        l[i] = alpha * l[i] + sum;
        m[i] = m_next;
#pragma unroll
        for (int e = 0; e < DE; ++e) acc[i][e] *= alpha;
      }
      s[i] = p;
    }
    *reinterpret_cast<float4*>(pt + tx * LD32 + ty * 4) =
        make_float4(s[0], s[1], s[2], s[3]);
    __syncthreads();  // V and P^T staged
    mfa::accumulate_pm32<D>(pt, ty, kvr, tx, acc);
    __syncthreads();  // before the next tile overwrites them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    float* orow = o + (bh * Sq + r) * D + tx;
#pragma unroll
    for (int e = 0; e < DE; ++e) orow[32 * e] = acc[i][e] * inv;
    if (tx == 0) lse[bh * Sq + r] = live ? m[i] * LN2 + logf(l[i]) : -INFINITY;
  }
}

// Replaces ops/flash_attention.py::_fwd_kernel for fp32: fwd_body up to
// D = 288, fwd_body32 above (mfa::scalar32).
template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int32_t* __restrict__ ranges,
                 const float* __restrict__ bias, long long bias_sb,
                 long long bias_sh, float* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 int interleaved, float qscale, float mask_value,
                 const float* __restrict__ row_max) {
  if constexpr (mfa::scalar32<D>())
    fwd_body32<D, STATIC_MAX>(q, k, v, ranges, bias, bias_sb, bias_sh, o,
                              lse, Hq, Hkv, Sq, Skv, interleaved, qscale,
                              mask_value, row_max);
  else
    fwd_body<D, STATIC_MAX>(q, k, v, ranges, bias, bias_sb, bias_sh, o, lse,
                            Hq, Hkv, Sq, Skv, interleaved, qscale,
                            mask_value, row_max);
}

// ---------------------------------------------------------------------------
// The forward on the tensor cores: every bf16 instance.
//
// FlashAttention-2's forward on mma.sync.  One CTA per (64 query rows, b,
// q head), as flash_fwd_kernel, with 4 warps of 16 query rows each: no
// warp shares a row, so the row max and sum reduce over the 4 lanes of a
// quad.  S and the O accumulator live in mma fragments; m and l per
// fragment row.
//   1. Q's rows arrive once by cp.async and are scaled in shared memory,
//      x -> round_bf16(x * qscale), bit for bit as stage_t<T, D, true>.
//   2. The CTA walks its live key span [c_lo, c_hi) in tiles of KS keys
//      (FwdTcSmem: 64, 32 at D = 288) aligned to multiples of KS from key
//      0 (flash_fwd_kernel's start at c_lo); cp.async brings the next
//      tile's K and V rows into the other of two buffers while this one
//      runs.  The plain version is one pass over each row's final max, so
//      only P's bf16 rounding against the running max differs with the
//      tile boundaries, which the bf16 gate already covers.
//   3. S = Q_s.K^T by bf16 m16n8k16 into fp32 (mma_nt; Q by ldmatrix from
//      shared memory each tile, which keeps D = 288 in registers).
//   4. The scalar kernel's element-wise steps in its order on the
//      fragments: bias * log2(e) (a float2 a fragment pair where aligned),
//      masked scores set to mask_value, the running max, exp2, l summing
//      the unrounded p, P rounded to bf16, alpha rescaling l and O.  A row
//      whose first tiles are fully masked carries p = 1 against m =
//      mask_value until its first live key, whose alpha (exp2 of mask_value
//      minus a real score) wipes it, as in the scalar kernel.  At D = 64
//      these steps, not the products, hold the kernel, so they are kept
//      short: a tile inside every row's range of the warp skips the mask
//      selects; p is ex2.approx.ftz (exp2f's extra range handling cost
//      more than the products; it only differs where p < 2^-126, far below
//      P's bf16 rounding); P rounds by cvt.rn.bf16x2, two values an
//      instruction.
//   5. O += P.V with P taken from the S fragments as the A operand in
//      registers and V read by ldmatrix.trans (mma_rn).
// Rows in shared memory are padded by 16 bytes, so ldmatrix's eight row
// addresses fall in distinct banks.  The CTAs walk the row tiles last
// first (under a causal mask the last walk the most keys).  Shared memory
// is Q plus two buffers each of K and V: 5 x 64 rows, 165 KB at D = 256
// (one CTA an SM), 85 KB at D = 128, 45 KB at D = 64.
//
// flash_fwd_wide_kernel: the same body at MLA's D = 288 (fwd_wide), its
// tiles cut for that width.  The function is the one above, at the same
// rounding points, for any K and V (no zero tail of V and no lanes shared
// by K and V are assumed).
//   - Registers.  4 warps x 16 rows hold O's 16 x 288 fp32 in 144
//     registers a thread.  64-key tiles would add S's 32 and the products'
//     fragments (flash_fwd_tc_kernel at D = 256, 128 + 32, already takes
//     245 / 253); 32-key tiles hold S at 16: -Xptxas -v on sm_90a reports
//     243 registers (251 with STATIC_MAX), no spill, no stack frame.
//   - Shared memory.  Q (64 rows, 37,888 bytes) and two buffers each of 32
//     K and 32 V rows (75,776): 113,664 bytes, so two CTAs share an SM's
//     228 KB (8 warps; __launch_bounds__ asks for 2), where the 64-key
//     layout (189,440) left one CTA of 4 warps.
//   - Not taken: O's lanes split over 8 warps (dq_wide_body's way), each
//     pair of warps splitting a tile's keys.  Its row max and row sum would
//     cross warps through shared memory and P would go there as a bf16
//     tile: two more barriers a tile, for about the same ldmatrix traffic
//     per key (reckoned: Q's 18 fragments a warp a tile, K's, V's and P's;
//     not measured).  At 576, where O no longer fits 4 warps' registers,
//     flash_fwd_latent_kernel takes that design.
//   - The grid stays one CTA per (64 query rows, b, q head): 1,024 CTAs at
//     MLA's training shape (B=2, Hq=16, S=2048), ~4 waves of 264.
// ---------------------------------------------------------------------------

// Whether the forward of T at head dim D runs on the tensor cores (every
// bf16 width: flash_fwd_tc_kernel, or flash_fwd_wide_kernel where
// fwd_wide, or flash_fwd_latent_kernel where fwd_latent), else
// flash_fwd_kernel; ops/flash_attention.py::fwd_body answers the same.
template <typename T, int D>
constexpr bool fwd_tc() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Whether a tensor-core forward at head dim D takes flash_fwd_wide_kernel
// (MLA's 288), whose tiles are cut for that width.
template <int D>
constexpr bool fwd_wide() {
  return D > 256 && D <= 288;
}

// Whether a tensor-core forward at head dim D takes flash_fwd_latent_kernel
// (DeepSeek's absorbed 576), whose O lanes are split over two warp groups.
template <int D>
constexpr bool fwd_latent() {
  return D > 288;
}

constexpr int FWD_TC_THREADS = 128;  // 4 warps x 16 query rows

// Byte offsets of the tensor-core forward's shared memory.
template <int D>
struct FwdTcSmem {
  static constexpr int KS = fwd_wide<D>() ? 32 : BN;  // keys a tile
  static constexpr int ROW = 2 * D + 16;  // a bf16 row [.., D]
  static constexpr int QTILE = BM * ROW;  // 64 query rows
  static constexpr int KTILE = KS * ROW;  // KS keys
  static constexpr int Q = 0;
  static constexpr int K = QTILE;            // two buffers
  static constexpr int V = K + 2 * KTILE;    // two buffers
  static constexpr size_t BYTES = V + 2 * (size_t)KTILE;
  static_assert(KS % 16 == 0 && D % 16 == 0,
                "S's keys and O's lanes are whole 16-wide steps");
};

// The tensor-core forward's body (the kernels below wrap it).  Bound:
// tensor-core operations (4*D per live query-key pair).  STATIC_MAX: each
// fragment row's m is the caller's row_max, loaded once; a tile skips step
// 4's running max, alpha and the rescale of l and O (and the warp vote
// that skips it), so only l += sum(p) and O += P.V remain.
template <int D, bool STATIC_MAX>
__device__ __forceinline__ void fwd_tc_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ ranges,
    const float* __restrict__ bias, long long bias_sb, long long bias_sh,
    float* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Sq,
    int Skv, int interleaved, float qscale, float mask_value,
    const float* __restrict__ row_max) {
  using L = FwdTcSmem<D>;
  constexpr int NT = FWD_TC_THREADS;
  constexpr int KS = L::KS;
  constexpr int NKB = KS / 8;  // 8-key blocks of S
  constexpr int NB = D / 8;    // 8-lane blocks of O
  extern __shared__ __align__(16) uint8_t smem_fwd[];
  __shared__ int s_lo, s_hi;

  // The last row tiles first: under a causal mask they walk the most keys.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = interleaved ? h % Hkv : h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = (size_t)b * Hq + h;
  const __nv_bfloat16* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  const float* bh_bias = bias ? bias + b * bias_sb + h * bias_sh : nullptr;
  uint8_t* sq = smem_fwd + L::Q;

  mfa::stage_rows_async<D, L::ROW, NT>(q + bh * Sq * D, r0, Sq, sq);
  mfa::cp_async_commit();
  key_span(ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_hi = s_hi;
  auto prefetch = [&](int t0, int buf) {
    mfa::stage_rows_async<D, L::ROW, NT, KS>(
        kh, t0, c_hi, smem_fwd + L::K + buf * L::KTILE);
    mfa::stage_rows_async<D, L::ROW, NT, KS>(
        vh, t0, c_hi, smem_fwd + L::V + buf * L::KTILE);
  };
  int t0 = (s_lo / KS) * KS;
  if (t0 < c_hi) prefetch(t0, 0);
  mfa::cp_async_commit();
  mfa::cp_async_wait<1>();
  __syncthreads();  // Q's rows landed
  mfa::scale_rows_bf16<D, L::ROW, NT>(sq, qscale);

  int row[2], rs[2], re[2];
  float m[2], l[2], acc[NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + warp * 16 + g + 8 * i;
    row_range(ranges, row[i], Sq, Skv, rs[i], re[i]);
    m[i] = !STATIC_MAX    ? -INFINITY
           : row[i] < Sq ? row_max[bh * Sq + row[i]]
                         : 0.f;
    l[i] = 0.f;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  // Keys [live_lo, live_hi) are live in every row of this warp: a tile
  // inside them needs no mask.
  int live_lo = max(rs[0], rs[1]), live_hi = min(re[0], re[1]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    live_lo = max(live_lo, __shfl_xor_sync(0xffffffffu, live_lo, off));
    live_hi = min(live_hi, __shfl_xor_sync(0xffffffffu, live_hi, off));
  }

  for (int buf = 0; t0 < c_hi; t0 += KS, buf ^= 1) {
    mfa::cp_async_wait<0>();
    __syncthreads();  // this tile staged, Q scaled; the last tile's readers
                      // done with the other buffer
    if (t0 + KS < c_hi) prefetch(t0 + KS, buf ^ 1);
    mfa::cp_async_commit();
    const uint8_t* sk = smem_fwd + L::K + buf * L::KTILE;
    const uint8_t* sv = smem_fwd + L::V + buf * L::KTILE;

    // S = Q_s.K^T for this warp's 16 rows and the tile's KS keys: element
    // (row[i], key t0 + 8j + 2tq + c) at s[j][2i + c].
    float s[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mfa::mma_nt<D / 16, NKB, L::ROW, L::ROW>(sq, warp * 16, sk, 0, s);

    if (bh_bias) {
#pragma unroll
      for (int j = 0; j < NKB; ++j) {
        const int col = t0 + 8 * j + 2 * tq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row[i] >= Sq || col >= c_hi) continue;
          const float* bp = bh_bias + (size_t)row[i] * Skv + col;
          float2 bv;
          if (col + 1 < c_hi && !(reinterpret_cast<uintptr_t>(bp) & 7)) {
            bv = *reinterpret_cast<const float2*>(bp);
          } else {
            bv.x = bp[0];
            bv.y = col + 1 < c_hi ? bp[1] : 0.f;
          }
          s[j][2 * i] += bv.x * LOG2E;
          s[j][2 * i + 1] += bv.y * LOG2E;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
    if (t0 >= live_lo && t0 + KS <= live_hi) {
      if constexpr (!STATIC_MAX) {
#pragma unroll
        for (int j = 0; j < NKB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = t0 + 8 * j + 2 * tq + c;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = s[j][2 * i + c];
            x = (col < rs[i] || col >= re[i]) ? mask_value : x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
    }
    float alpha[2] = {1.f, 1.f}, m_next[2] = {m[0], m[1]};
    float sum[2] = {0.f, 0.f};
    if constexpr (!STATIC_MAX) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m_next[i] = fmaxf(m[i], mx[i]);
        alpha[i] = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next[i]);
      }
    }
    // P = 2^(s - m) (mma.cuh's ex2_approx); l sums it unrounded, P.V takes it
    // rounded to bf16.  A row whose max is still -inf (every score -inf)
    // subtracts 0 instead, so its P is 2^-inf = 0, not NaN.
    const float mref[2] = {m_next[0] == -INFINITY ? 0.f : m_next[0],
                           m_next[1] == -INFINITY ? 0.f : m_next[1]};
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = mfa::ex2_approx(s[j][e] - mref[e >> 1]);
        sum[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = alpha[i] * l[i] + sum[i];
      m[i] = m_next[i];
    }
    if constexpr (!STATIC_MAX) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          acc[nb][0] *= alpha[0];
          acc[nb][1] *= alpha[0];
          acc[nb][2] *= alpha[1];
          acc[nb][3] *= alpha[1];
        }
      }
    }

    // O += P.V, 16 keys a step, P's A fragment from the S fragments,
    // rounded to bf16 two at a time (cvt.rn.bf16x2).
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const int j = 2 * kk;
      const uint32_t pa[4] = {mfa::pack_bf16(s[j][0], s[j][1]),
                              mfa::pack_bf16(s[j][2], s[j][3]),
                              mfa::pack_bf16(s[j + 1][0], s[j + 1][1]),
                              mfa::pack_bf16(s[j + 1][2], s[j + 1][3])};
      mfa::mma_rn<NB, L::ROW>(pa, sv, 16 * kk, 0, acc);
    }
  }
  mfa::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    float* orow = o + (bh * Sq + row[i]) * D + 2 * tq;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<float2*>(orow + 8 * nb) =
          make_float2(acc[nb][2 * i] * inv, acc[nb][2 * i + 1] * inv);
    if (tq == 0)
      lse[bh * Sq + row[i]] = live ? m[i] * LN2 + logf(l[i]) : -INFINITY;
  }
}

// Replaces ops/flash_attention.py::_fwd_kernel for bf16 up to D = 256.
// Two kernels wrap fwd_tc_body only because __launch_bounds__ takes its
// CTAs an SM as an explicit minimum, and no one value serves every width:
// a minimum of one raises the D <= 128 instances' registers over the ones
// ptxas picks with none (D = 64: 146 against 127, D = 128: 178 against
// 166), and minima at those occupancies spill (D = 64 at four: 128
// registers and a 16-byte spill); -Xptxas -v on sm_90a.
template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(FWD_TC_THREADS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int32_t* __restrict__ ranges,
                    const float* __restrict__ bias, long long bias_sb,
                    long long bias_sh, float* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Sq,
                    int Skv, int interleaved, float qscale,
                    float mask_value, const float* __restrict__ row_max) {
  fwd_tc_body<D, STATIC_MAX>(q, k, v, ranges, bias, bias_sb, bias_sh, o,
                             lse, Hq, Hkv, Sq, Skv, interleaved, qscale,
                             mask_value, row_max);
}

// Replaces ops/flash_attention.py::_fwd_kernel for bf16 at D = 288
// (fwd_wide): 32-key tiles, two CTAs an SM.
template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(FWD_TC_THREADS, 2)
flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int32_t* __restrict__ ranges,
                      const float* __restrict__ bias, long long bias_sb,
                      long long bias_sh, float* __restrict__ o,
                      float* __restrict__ lse, int Hq, int Hkv, int Sq,
                      int Skv, int interleaved, float qscale,
                      float mask_value, const float* __restrict__ row_max) {
  fwd_tc_body<D, STATIC_MAX>(q, k, v, ranges, bias, bias_sb, bias_sh, o,
                             lse, Hq, Hkv, Sq, Skv, interleaved, qscale,
                             mask_value, row_max);
}

// ---------------------------------------------------------------------------
// flash_fwd_latent_kernel: the bf16 forward at DeepSeek's absorbed D = 576
// (fwd_latent), the same function at the same rounding points as
// fwd_tc_body for any K and V: all 576 lanes of O are computed (no zero
// tail of V and no lanes shared by K and V are assumed).
//   - Why flash_fwd_wide_kernel's body does not stretch: 4 warps x 16 rows
//     hold O's 16 x 576 fp32 in 288 registers a thread, past the 255 a
//     thread may have.
//   - Warps: 8, as the design flash_fwd_wide_kernel's comment passed over
//     at 288 (and paged_prefill_wide_kernel's at 512 kept lanes).  Warp w
//     holds rows r0 + 16 (w % 4) + [0, 16) of O and lanes 288 (w / 4) +
//     [0, 288) (144 registers a thread).  The two warps of a row slab split
//     each 32-key tile's scores instead: each computes S over its 16 keys
//     and all 576 lanes, they trade row maxima and row sums through shared
//     memory under a named barrier (one a slab), and each writes its half
//     of the slab's bf16 P, which both read as the A operand of O += P.V
//     over their own lanes.  Both keep the same m and l (the maximum of the
//     halves' maxima, the halves' sums added in one order).
//   - Shared memory (230,400 bytes): Q (64 rows, 74,752) and two buffers
//     each of 32 K and 32 V rows (149,504), each slab's P [16][32] (5,120)
//     and its exchanged row statistics (1,024): one CTA an SM.
//   - The grid stays one CTA per (64 query rows, b, q head): 1,024 CTAs at
//     DeepSeek-V2-Lite's training shape (B=2, Hq=16, S=2048), ~8 waves of
//     132.
// ---------------------------------------------------------------------------

constexpr int FWD_LATENT_THREADS = 256;  // 4 row slabs x 2 lane halves

// Byte offsets of flash_fwd_latent_kernel's shared memory.
template <int D>
struct FwdLatentSmem {
  static constexpr int KS = 32;             // keys a tile
  static constexpr int HALF = D / 2;        // O lanes a warp holds
  static constexpr int ROW = 2 * D + 16;    // a bf16 row [.., D]
  static constexpr int P_LD = 2 * KS + 16;  // a bf16 P row [16][32 keys]
  static constexpr int QTILE = BM * ROW;    // 64 query rows
  static constexpr int KTILE = KS * ROW;    // KS keys
  static constexpr int Q = 0;
  static constexpr int K = QTILE;            // two buffers
  static constexpr int V = K + 2 * KTILE;    // two buffers
  static constexpr int P = V + 2 * KTILE;    // [4 slabs][16][P_LD]
  static constexpr int RED = P + 4 * 16 * P_LD;  // [4][2 warps][max, sum][16]
  static constexpr size_t BYTES = RED + 4 * 2 * 2 * 16 * sizeof(float);
  static_assert(HALF % 16 == 0 && KS == 32,
                "a warp's lanes are whole 16-wide steps; 16 keys a warp");
};

// Replaces ops/flash_attention.py::_fwd_kernel for bf16 above D = 288
// (fwd_latent; see above).  Bound: tensor-core operations (4*D per live
// query-key pair).  STATIC_MAX: each fragment row's m is the caller's
// row_max; a tile skips the row maxima's exchange, alpha and the rescale,
// so only l += sum(p) and O += P.V remain.
template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(FWD_LATENT_THREADS, 1)
flash_fwd_latent_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int32_t* __restrict__ ranges,
                        const float* __restrict__ bias, long long bias_sb,
                        long long bias_sh, float* __restrict__ o,
                        float* __restrict__ lse, int Hq, int Hkv, int Sq,
                        int Skv, int interleaved, float qscale,
                        float mask_value, const float* __restrict__ row_max) {
  using L = FwdLatentSmem<D>;
  constexpr int NT = FWD_LATENT_THREADS;
  constexpr int KS = L::KS;
  constexpr int NB = L::HALF / 8;  // 8-lane blocks of O a warp holds
  extern __shared__ __align__(16) uint8_t smem_fwd[];
  __shared__ int s_lo, s_hi;

  // The last row tiles first: under a causal mask they walk the most keys.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = interleaved ? h % Hkv : h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = warp & 3;   // rows r0 + 16 slab + [0, 16)
  const int half = warp >> 2;  // keys 16 half + [0, 16) of a tile in S,
                               // lanes HALF half + [0, HALF) of O
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = (size_t)b * Hq + h;
  const __nv_bfloat16* kh = k + ((size_t)b * Hkv + hk) * Skv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Hkv + hk) * Skv * D;
  const float* bh_bias = bias ? bias + b * bias_sb + h * bias_sh : nullptr;
  uint8_t* sq = smem_fwd + L::Q;
  uint8_t* sp = smem_fwd + L::P + slab * 16 * L::P_LD;
  // This slab's [warp half][max, sum][16 rows].
  float* red = reinterpret_cast<float*>(smem_fwd + L::RED) + slab * 64;

  mfa::stage_rows_async<D, L::ROW, NT>(q + bh * Sq * D, r0, Sq, sq);
  mfa::cp_async_commit();
  key_span(ranges, r0, Sq, Skv, &s_lo, &s_hi);
  const int c_hi = s_hi;
  auto prefetch = [&](int t0, int buf) {
    mfa::stage_rows_async<D, L::ROW, NT, KS>(
        kh, t0, c_hi, smem_fwd + L::K + buf * L::KTILE);
    mfa::stage_rows_async<D, L::ROW, NT, KS>(
        vh, t0, c_hi, smem_fwd + L::V + buf * L::KTILE);
  };
  int t0 = (s_lo / KS) * KS;
  if (t0 < c_hi) prefetch(t0, 0);
  mfa::cp_async_commit();
  mfa::cp_async_wait<1>();
  __syncthreads();  // Q's rows landed
  mfa::scale_rows_bf16<D, L::ROW, NT>(sq, qscale);

  int row[2], rs[2], re[2];
  float m[2], l[2], acc[NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + slab * 16 + g + 8 * i;
    row_range(ranges, row[i], Sq, Skv, rs[i], re[i]);
    m[i] = !STATIC_MAX    ? -INFINITY
           : row[i] < Sq ? row_max[bh * Sq + row[i]]
                         : 0.f;
    l[i] = 0.f;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  // Keys [live_lo, live_hi) are live in every row of this slab: a warp's
  // 16 keys inside them need no mask.
  int live_lo = max(rs[0], rs[1]), live_hi = min(re[0], re[1]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    live_lo = max(live_lo, __shfl_xor_sync(0xffffffffu, live_lo, off));
    live_hi = min(live_hi, __shfl_xor_sync(0xffffffffu, live_hi, off));
  }
  const int k0 = 16 * half;  // this warp's keys of a tile

  for (int buf = 0; t0 < c_hi; t0 += KS, buf ^= 1) {
    mfa::cp_async_wait<0>();
    __syncthreads();  // this tile staged, Q scaled; the last tile's readers
                      // done with the other buffer
    if (t0 + KS < c_hi) prefetch(t0 + KS, buf ^ 1);
    mfa::cp_async_commit();
    const uint8_t* sk = smem_fwd + L::K + buf * L::KTILE;
    const uint8_t* sv = smem_fwd + L::V + buf * L::KTILE;

    // S = Q_s.K^T for this slab's 16 rows and this warp's 16 keys: element
    // (row[i], key t0 + k0 + 8j + 2tq + c) at s[j][2i + c].
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mfa::mma_nt<D / 16, 2, L::ROW, L::ROW>(sq, slab * 16, sk, k0, s);

    if (bh_bias) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = t0 + k0 + 8 * j + 2 * tq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row[i] >= Sq || col >= c_hi) continue;
          const float* bp = bh_bias + (size_t)row[i] * Skv + col;
          float2 bv;
          if (col + 1 < c_hi && !(reinterpret_cast<uintptr_t>(bp) & 7)) {
            bv = *reinterpret_cast<const float2*>(bp);
          } else {
            bv.x = bp[0];
            bv.y = col + 1 < c_hi ? bp[1] : 0.f;
          }
          s[j][2 * i] += bv.x * LOG2E;
          s[j][2 * i + 1] += bv.y * LOG2E;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
    const int c0 = t0 + k0;
    if (c0 >= live_lo && c0 + 16 <= live_hi) {
      if constexpr (!STATIC_MAX) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * j + 2 * tq + c;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = s[j][2 * i + c];
            x = (col < rs[i] || col >= re[i]) ? mask_value : x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
    }
    float alpha[2] = {1.f, 1.f}, m_next[2] = {m[0], m[1]};
    if constexpr (!STATIC_MAX) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (tq == 0) red[half * 32 + g + 8 * i] = mx[i];
      }
      mfa::named_barrier(1 + slab, 64);  // both warps' row maxima
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = g + 8 * i;
        m_next[i] = fmaxf(m[i], fmaxf(red[r], red[32 + r]));
        alpha[i] = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next[i]);
      }
    }
    // P = 2^(s - m) (mma.cuh's ex2_approx); l sums it unrounded, P.V takes
    // it rounded to bf16 from the slab's P tile.  A row whose max is still
    // -inf subtracts 0 instead, so its P is 2^-inf = 0, not NaN.
    const float mref[2] = {m_next[0] == -INFINITY ? 0.f : m_next[0],
                           m_next[1] == -INFINITY ? 0.f : m_next[1]};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = mfa::ex2_approx(s[j][2 * i] - mref[i]);
        const float p1 = mfa::ex2_approx(s[j][2 * i + 1] - mref[i]);
        sum[i] += p0 + p1;
        *reinterpret_cast<uint32_t*>(sp + (g + 8 * i) * L::P_LD +
                                     2 * (k0 + 8 * j + 2 * tq)) =
            mfa::pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      if (tq == 0) red[half * 32 + 16 + g + 8 * i] = sum[i];
    }
    mfa::named_barrier(1 + slab, 64);  // the slab's P and both row sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 + g + 8 * i;
      l[i] = alpha[i] * l[i] + (red[r] + red[32 + r]);
      m[i] = m_next[i];
    }
    if constexpr (!STATIC_MAX) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          acc[nb][0] *= alpha[0];
          acc[nb][1] *= alpha[0];
          acc[nb][2] *= alpha[1];
          acc[nb][3] *= alpha[1];
        }
      }
    }

    // O += P.V over this warp's lanes, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t pa[4];
      mfa::ldsm_x4(pa, sp + mfa::ldsm_a_row(lane) * L::P_LD + kk * 32 +
                           mfa::ldsm_a_byte(lane));
      mfa::mma_rn<NB, L::ROW>(pa, sv, 16 * kk, half * L::HALF, acc);
    }
  }
  mfa::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    float* orow = o + (bh * Sq + row[i]) * D + half * L::HALF + 2 * tq;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<float2*>(orow + 8 * nb) =
          make_float2(acc[nb][2 * i] * inv, acc[nb][2 * i + 1] * inv);
    if (half == 0 && tq == 0)
      lse[bh * Sq + row[i]] = live ? m[i] * LN2 + logf(l[i]) : -INFINITY;
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
  // The tensor-core bodies' staging (T = bf16): ROWS rows as they are, by
  // cp.async.
  template <int NT, int ROW, int ROWS = 64>
  __device__ __forceinline__ void tc_load(bool is_v, size_t head, int t0,
                                          int limit, uint8_t* dst,
                                          uint8_t*) const {
    mfa::stage_rows_async<D, ROW, NT, ROWS>((is_v ? v : k) + head * Skv * D,
                                            t0, limit, dst);
  }
  template <int NT, int ROW, int ROWS = 64>
  __device__ __forceinline__ void tc_convert(bool, size_t, int, int,
                                             uint8_t*,
                                             const uint8_t*) const {}
  static constexpr bool RAW = false;  // tc_load fills the bf16 tile
  // The 32-row scalar bodies' staging (T = float; attention_tiles.cuh's
  // stage32): 32 rows as rows (ROWS) or transposed.
  template <bool ROWS>
  __device__ __forceinline__ void stage32(bool is_v, size_t head, int t0,
                                          int limit, float* dst) const {
    mfa::stage32<D, false, ROWS>((is_v ? v : k) + head * Skv * D, t0, limit,
                                 dst, 0.f);
  }
};

// Replaces ops/flash_attention_bwd.py::_dq_kernel.  Bound: operations
// (6*D per live pair: S, dP, dQ).  The fp32 instances (in 32-row tiles
// above D = 288: mfa::scalar32); bf16 takes flash_dq_tc_kernel,
// flash_dq_wide_kernel or flash_dq_latent_kernel (mfa::dq_tc,
// mfa::bwd_wide, mfa::bwd_latent).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const BwdArgs a, const FloatKV<T, D> kv) {
  if constexpr (mfa::scalar32<D>()) {
    static_assert(std::is_same<T, float>::value, "fp32 only above 288");
    mfa::dq_body32<D>(a, kv);
  } else {
    mfa::dq_body<T, D, true>(a, kv);
  }
}

// The same on the tensor cores: bf16 up to D = 256 (attention_bwd.cuh).
template <int D>
__global__ void __launch_bounds__(mfa::dq_tc_threads<D>(),
                           mfa::dq_tc_min_blocks<D>())
flash_dq_tc_kernel(const BwdArgs a, const FloatKV<__nv_bfloat16, D> kv) {
  mfa::dq_tc_body<D, true>(a, kv);
}

// The same on the tensor cores at D = 288 (attention_bwd.cuh::dq_wide_body:
// 32-key tiles, 8 warps, one CTA an SM).
template <int D>
__global__ void __launch_bounds__(mfa::DQ_WIDE_THREADS, 1)
flash_dq_wide_kernel(const BwdArgs a, const FloatKV<__nv_bfloat16, D> kv) {
  mfa::dq_wide_body<D, true>(a, kv);
}

// The same on the tensor cores at D = 576 (attention_bwd.cuh::
// dq_latent_body: 32-key tiles, K and V single-buffered and staggered, 8
// warps, one CTA an SM).
template <int D>
__global__ void __launch_bounds__(mfa::DQ_LATENT_THREADS, 1)
flash_dq_latent_kernel(const BwdArgs a, const FloatKV<__nv_bfloat16, D> kv) {
  mfa::dq_latent_body<D, true>(a, kv);
}

// Replaces ops/flash_attention_bwd.py::_dkv_kernel.  Bound: operations
// (8*D per live pair: S, dP, dV, dK).  The fp32 instances (in 32-key tiles
// above D = 288: mfa::scalar32); bf16 takes flash_dkv_tc_kernel,
// flash_dkv_wide_kernel or flash_dkv_latent_kernel (mfa::dkv_tc,
// mfa::bwd_wide, mfa::bwd_latent).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const BwdArgs a, const FloatKV<T, D> kv) {
  if constexpr (mfa::scalar32<D>()) {
    static_assert(std::is_same<T, float>::value, "fp32 only above 288");
    mfa::dkv_body32<D>(a, kv);
  } else {
    mfa::dkv_body<T, D>(a, kv);
  }
}

// The same on the tensor cores: bf16 up to D = 256 (attention_bwd.cuh).
template <int D>
__global__ void __launch_bounds__(mfa::dkv_tc_threads<D>(),
                           mfa::dkv_tc_min_blocks<D>())
flash_dkv_tc_kernel(const BwdArgs a, const FloatKV<__nv_bfloat16, D> kv) {
  mfa::dkv_tc_body<D>(a, kv);
}

// The same on the tensor cores at D = 288 (attention_bwd.cuh::
// dkv_wide_body: 48-row query steps, 12 warps, one CTA an SM), the GQA
// group dealt over gridDim.z / B = splits CTAs a key tile; with splits > 1
// each writes its partial dK and dV into ws [splits, 2, B, Hkv, Skv, D].
template <int D>
__global__ void __launch_bounds__(mfa::DKV_WIDE_THREADS, 1)
flash_dkv_wide_kernel(const BwdArgs a, const FloatKV<__nv_bfloat16, D> kv,
                      int splits, float* __restrict__ ws) {
  mfa::dkv_wide_body<D>(a, kv, splits, ws);
}

// The same on the tensor cores at D = 576 (attention_bwd.cuh::
// dkv_latent_body: 32-key CTAs, 32-row query steps, 8 warps, one CTA an
// SM), the GQA group split and merged as flash_dkv_wide_kernel's.
template <int D>
__global__ void __launch_bounds__(mfa::DKV_LATENT_THREADS, 1)
flash_dkv_latent_kernel(const BwdArgs a, const FloatKV<__nv_bfloat16, D> kv,
                        int splits, float* __restrict__ ws) {
  mfa::dkv_latent_body<D>(a, kv, splits, ws);
}

// The second launch of a split dK/dV: dk[i] = ws[0][0][i] + ws[1][0][i] +
// ... and dv from ws[.][1], the splits summed in order from split 0 (the
// plain version, ops/flash_attention_bwd.py::merge_dkv_splits_plain,
// sums in the same order: bit for bit).  n4 = B * Hkv * Skv * D / 4.
// Bound: bytes (the workspace read once, dK and dV written once).
__global__ void __launch_bounds__(256)
flash_dkv_merge_kernel(const float4* __restrict__ ws,
                       float4* __restrict__ dk, float4* __restrict__ dv,
                       int splits, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < 2 * n4; i += (long long)gridDim.x * blockDim.x) {
    const long long which = i / n4;  // 0: dK, 1: dV
    const long long e = i - which * n4;
    float4 acc = ws[which * n4 + e];
    for (int sp = 1; sp < splits; ++sp) {
      const float4 x = ws[(2 * (long long)sp + which) * n4 + e];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    (which ? dv : dk)[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Shape {
  int B, Hq, Hkv, Sq, Skv, interleaved;
};

// The forward of T at head dim D: flash_fwd_tc_kernel where fwd_tc says
// so (flash_fwd_wide_kernel where fwd_wide too, flash_fwd_latent_kernel
// where fwd_latent), else flash_fwd_kernel (32-row CTAs where
// mfa::scalar32); their STATIC_MAX instances where row_max is given.
template <typename T, int D, bool STATIC_MAX>
int launch_fwd_mode(const void* q, const void* k, const void* v,
                    const void* ranges, const void* bias, long long sb,
                    long long sh, void* o, void* lse, Shape sp, float qscale,
                    float mask_value, const void* row_max,
                    cudaStream_t stream) {
  constexpr int ROWS = !fwd_tc<T, D>() && mfa::scalar32<D>() ? T32 : BM;
  const dim3 grid((sp.Sq + ROWS - 1) / ROWS, sp.Hq, sp.B);
  const auto* rr = static_cast<const int32_t*>(ranges);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  const auto* mp = static_cast<const float*>(row_max);
  const auto launch = [&](auto kern, int threads, size_t smem) {
    return launch_with_smem(kern, grid, threads, smem, stream,
                            static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), rr, bp, sb, sh, op, lp,
                            sp.Hq, sp.Hkv, sp.Sq, sp.Skv, sp.interleaved,
                            qscale, mask_value, mp);
  };
  if constexpr (fwd_tc<T, D>() && fwd_latent<D>())
    return launch(flash_fwd_latent_kernel<D, STATIC_MAX>, FWD_LATENT_THREADS,
                  FwdLatentSmem<D>::BYTES);
  else if constexpr (fwd_tc<T, D>() && fwd_wide<D>())
    return launch(flash_fwd_wide_kernel<D, STATIC_MAX>, FWD_TC_THREADS,
                  FwdTcSmem<D>::BYTES);
  else if constexpr (fwd_tc<T, D>())
    return launch(flash_fwd_tc_kernel<D, STATIC_MAX>, FWD_TC_THREADS,
                  FwdTcSmem<D>::BYTES);
  else if constexpr (mfa::scalar32<D>())  // T = float
    return launch(flash_fwd_kernel<D, STATIC_MAX>, THREADS,
                  mfa::smem32_bytes<D>());
  else  // T = float
    return launch(flash_fwd_kernel<D, STATIC_MAX>, THREADS,
                  fwd_smem_floats<D>() * sizeof(float));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* ranges, const void* bias, long long sb,
               long long sh, void* o, void* lse, Shape sp, float qscale,
               float mask_value, const void* row_max, cudaStream_t stream) {
  if (row_max)
    return launch_fwd_mode<T, D, true>(q, k, v, ranges, bias, sb, sh, o, lse,
                                       sp, qscale, mask_value, row_max,
                                       stream);
  return launch_fwd_mode<T, D, false>(q, k, v, ranges, bias, sb, sh, o, lse,
                                      sp, qscale, mask_value, nullptr,
                                      stream);
}

// dQ (out0 = dQ, out1 = dbias or null) or dK/dV (out0 = dK, out1 = dV;
// on the wide and latent bodies its group split over `splits` CTAs a key
// tile, into the workspace ws where splits > 1; every other body takes
// splits = 1).
template <typename T, int D, bool DQ>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, const void* ranges,
               const void* bias, long long sb, long long sh, void* out0,
               void* out1, Shape sp, float scale, int splits, void* ws,
               cudaStream_t stream) {
  const BwdArgs a{q, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(di),
                  static_cast<const int32_t*>(ranges),
                  static_cast<const float*>(bias), sb, sh, nullptr, nullptr,
                  nullptr, static_cast<float*>(out0),
                  static_cast<float*>(out1), sp.Hq, sp.Hkv, sp.Sq, sp.Skv,
                  sp.interleaved, scale};
  const FloatKV<T, D> kv{static_cast<const T*>(k), static_cast<const T*>(v),
                         sp.Skv};
  constexpr bool TC = DQ ? mfa::dq_tc<T, D>() : mfa::dkv_tc<T, D>();
  constexpr bool WIDE = TC && mfa::bwd_wide<D>();
  constexpr bool LATENT = TC && mfa::bwd_latent<D>();
  constexpr bool SCALAR32 = !TC && mfa::scalar32<D>();
  // Query rows (dQ) or keys (dK/dV) a CTA: 32 on the latent dK/dV and the
  // 32-row scalar bodies, else 64 (BM = BN).
  constexpr int TILE = SCALAR32 || (LATENT && !DQ) ? T32 : BM;
  const dim3 grid(((DQ ? sp.Sq : sp.Skv) + TILE - 1) / TILE,
                  DQ ? sp.Hq : sp.Hkv, sp.B);
  if (splits < 1 || (splits > 1 && (!(WIDE || LATENT) || DQ || !ws)) ||
      splits > sp.Hq / sp.Hkv)
    return (int)cudaErrorInvalidValue;
  if constexpr (DQ && LATENT)
    return launch_with_smem(flash_dq_latent_kernel<D>, grid,
                            mfa::DQ_LATENT_THREADS,
                            mfa::DqLatentSmem<D>::BYTES, stream, a, kv);
  else if constexpr (DQ && WIDE)
    return launch_with_smem(flash_dq_wide_kernel<D>, grid,
                            mfa::DQ_WIDE_THREADS,
                            mfa::DqWideSmem<D, false>::BYTES,
                            stream, a, kv);
  else if constexpr (DQ && TC)
    return launch_with_smem(flash_dq_tc_kernel<D>, grid,
                            mfa::dq_tc_threads<D>(),
                            mfa::DqTcSmem<D, false>::BYTES, stream, a, kv);
  else if constexpr (DQ)
    return launch_with_smem(flash_dq_kernel<T, D>, grid, THREADS,
                            SCALAR32 ? mfa::smem32_bytes<D>()
                                     : mfa::dq_smem_floats<D>() *
                                           sizeof(float),
                            stream, a, kv);
  else if constexpr (LATENT)
    return launch_with_smem(
        flash_dkv_latent_kernel<D>, dim3(grid.x, grid.y, grid.z * splits),
        mfa::DKV_LATENT_THREADS, mfa::DkvLatentSmem<D>::BYTES, stream, a, kv,
        splits, static_cast<float*>(ws));
  else if constexpr (WIDE)
    return launch_with_smem(
        flash_dkv_wide_kernel<D>, dim3(grid.x, grid.y, grid.z * splits),
        mfa::DKV_WIDE_THREADS, mfa::DkvWideSmem<D>::BYTES, stream, a, kv,
        splits, static_cast<float*>(ws));
  else if constexpr (TC)
    return launch_with_smem(flash_dkv_tc_kernel<D>, grid,
                            mfa::dkv_tc_threads<D>(), mfa::DkvTcSmem<D>::BYTES,
                            stream, a, kv);
  else
    return launch_with_smem(flash_dkv_kernel<T, D>, grid, THREADS,
                            SCALAR32 ? mfa::smem32_bytes<D>()
                                     : mfa::dkv_smem_floats<D>() *
                                           sizeof(float),
                            stream, a, kv);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, const void* ranges,
              const void* bias, long long sb, long long sh, void* dq,
              void* dbias, Shape sp, float scale, cudaStream_t stream) {
  return launch_bwd<T, D, true>(q, k, v, dout, lse, di, ranges, bias, sb, sh,
                                dq, dbias, sp, scale, 1, nullptr, stream);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* di,
               const void* ranges, const void* bias, long long sb,
               long long sh, void* dk, void* dv, Shape sp, float scale,
               int splits, void* ws, cudaStream_t stream) {
  return launch_bwd<T, D, false>(q, k, v, dout, lse, di, ranges, bias, sb,
                                 sh, dk, dv, sp, scale, splits, ws, stream);
}

// Returns LAUNCH<T, D>(args...) for the runtime dtype (0 = float32,
// 1 = bfloat16) and head dim (32, 64, 128, 256, 288, 576).
#define MFA_DIMS(LAUNCH, T, ...)                                   \
  do {                                                             \
    if (D == 32) return LAUNCH<T, 32>(__VA_ARGS__);                \
    if (D == 64) return LAUNCH<T, 64>(__VA_ARGS__);                \
    if (D == 128) return LAUNCH<T, 128>(__VA_ARGS__);              \
    if (D == 256) return LAUNCH<T, 256>(__VA_ARGS__);              \
    if (D == 288) return LAUNCH<T, 288>(__VA_ARGS__);              \
    if (D == 576) return LAUNCH<T, 576>(__VA_ARGS__);              \
  } while (0)
#define MFA_DISPATCH(LAUNCH, ...)                                  \
  if (dtype == 0) {                                                \
    MFA_DIMS(LAUNCH, float, __VA_ARGS__);                          \
  } else if (dtype == 1) {                                         \
    MFA_DIMS(LAUNCH, __nv_bfloat16, __VA_ARGS__);                  \
  }                                                                \
  return (int)cudaErrorInvalidValue

// The split-D kernels' arguments (D > 576).
mfa_sd::FlashArgs split_d_args(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* di, const void* ranges,
                               const void* bias, long long sb, long long sh,
                               const void* row_max, void* out0, void* out1,
                               int B, int Hq, int Hkv, int Sq, int Skv,
                               int D, int interleaved, float scale,
                               float mask_value) {
  return mfa_sd::FlashArgs{q, k, v, dout, static_cast<const float*>(lse),
                           static_cast<const float*>(di),
                           static_cast<const int32_t*>(ranges),
                           static_cast<const float*>(bias), sb, sh,
                           static_cast<const float*>(row_max),
                           static_cast<float*>(out0),
                           static_cast<float*>(out1), B, Hq, Hkv, Sq, Skv, D,
                           interleaved, scale, mask_value};
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported dtype or head dim,
// or a group that does not divide Hq.  D: a built width, or above 576 any
// multiple of 16 (the split-D kernels).
extern "C" {

// row_max: null for the running-max forward; else the static-max mode's
// fp32 [B, Hq, Sq] subtrahends (base 2), which takes no bias.  splits: the
// split-D forward's runs of the KV axis (above 576, ops/flash_attention.py::
// split_d_fwd_splits; 1 elsewhere); with splits > 1 the kernel leaves its
// partials in ws, fp32 [B * Hq * Sq, splits, D + 2], and
// mfa_split_d_fwd_merge makes o and lse.
int mfa_flash_fwd(const void* q, const void* k, const void* v,
                  const void* ranges, const void* bias, long long bias_sb,
                  long long bias_sh, void* o, void* lse, int dtype, int B,
                  int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                  float qscale, float mask_value, const void* row_max,
                  int splits, void* ws, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || (row_max && bias) || (D <= 576 && splits != 1))
    return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 576) {
    mfa_sd::FlashArgs a = split_d_args(
        q, k, v, nullptr, nullptr, nullptr, ranges, bias, bias_sb, bias_sh,
        row_max, o, lse, B, Hq, Hkv, Sq, Skv, D, interleaved, qscale,
        mask_value);
    a.splits = splits;
    a.ws = static_cast<float*>(ws);
    return mfa_sd::launch_fwd(dtype, a, s);
  }
  MFA_DISPATCH(launch_fwd, q, k, v, ranges, bias, bias_sb, bias_sh, o, lse,
               sp, qscale, mask_value, row_max, s);
}


// splits: the runs of the KV axis above 576 (ops/flash_attention_bwd.py::
// split_d_dq_splits; 1 at and below 576); with splits > 1 the unscaled
// partials go to ws, fp32 [splits, B, Hq, Sq, D], and mfa_split_d_dq_merge
// makes dq.
int mfa_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* di,
                 const void* ranges, const void* bias, long long bias_sb,
                 long long bias_sh, void* dq, void* dbias, int dtype, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                 float scale, int splits, void* ws, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || (D <= 576 && splits != 1))
    return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 576) {
    mfa_sd::FlashArgs a = split_d_args(
        q, k, v, dout, lse, di, ranges, bias, bias_sb, bias_sh, nullptr, dq,
        dbias, B, Hq, Hkv, Sq, Skv, D, interleaved, scale, 0.f);
    a.splits = splits;
    a.ws = static_cast<float*>(ws);
    return mfa_sd::launch_dq(dtype, a, s);
  }
  MFA_DISPATCH(launch_dq, q, k, v, dout, lse, di, ranges, bias, bias_sb,
               bias_sh, dq, dbias, sp, scale, s);
}

// splits: the CTAs that share a key tile's GQA group (bf16 at D = 288 and
// 576, and both dtypes above 576, ops/flash_attention_bwd.py::dkv_splits;
// 1 elsewhere); with
// splits > 1 the partials go to ws, fp32 [splits, 2, B, Hkv, Skv, D], and
// mfa_flash_dkv_merge sums them into dk and dv.
int mfa_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di,
                  const void* ranges, const void* bias, long long bias_sb,
                  long long bias_sh, void* dk, void* dv, int dtype, int B,
                  int Hq, int Hkv, int Sq, int Skv, int D, int interleaved,
                  float scale, int splits, void* ws, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const Shape sp{B, Hq, Hkv, Sq, Skv, interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 576)
    return mfa_sd::launch_dkv(
        dtype, split_d_args(q, k, v, dout, lse, di, ranges, bias, bias_sb,
                            bias_sh, nullptr, dk, dv, B, Hq, Hkv, Sq, Skv, D,
                            interleaved, scale, 0.f),
        splits, static_cast<float*>(ws), s);
  MFA_DISPATCH(launch_dkv, q, k, v, dout, lse, di, ranges, bias, bias_sb,
               bias_sh, dk, dv, sp, scale, splits, ws, s);
}

// dk, dv (fp32, n elements each, n a multiple of 4) = the sums over the
// splits of ws [splits, 2, n], in split order (flash_dkv_merge_kernel).
int mfa_flash_dkv_merge(const void* ws, void* dk, void* dv, int splits,
                        long long n, void* stream) {
  if (splits < 1 || n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  // Grid-stride: at most 8 blocks for each of an H100's 132 SMs.
  const int blocks = (int)std::min<long long>((2 * n4 + 255) / 256, 132 * 8);
  flash_dkv_merge_kernel<<<blocks, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(dk),
      static_cast<float4*>(dv), splits, n4);
  return (int)cudaGetLastError();
}

// Which of the forward (bit 0), dQ (bit 1) and dK/dV (bit 2) kernels of
// dtype at the built head dim D run on the tensor cores (fwd_tc, dq_tc,
// dkv_tc: at D = 288 the forward on flash_fwd_wide_kernel, the dQ and
// dK/dV on the wide bodies, at 576 on flash_fwd_latent_kernel and the
// latent bodies; the quantized launchers route by dq_tc, dkv_tc and
// bwd_wide too); above 576, for every multiple of 16, bits 3, 4 and 5
// instead: the forward, dQ and dK/dV on the split-D kernels
// (mfa_sd::takes); -1 for a dtype or head dim without kernels.
int mfa_flash_tc_bodies(int dtype, int D) {
  if ((dtype == 0 || dtype == 1) && mfa_sd::takes(D)) return 8 | 16 | 32;
#define MFA_BODIES(T, DD)                                          \
  if (D == DD)                                                     \
    return (int)fwd_tc<T, DD>() | (int)mfa::dq_tc<T, DD>() << 1 |  \
           (int)mfa::dkv_tc<T, DD>() << 2
#define MFA_BODIES_ALL(T) \
  MFA_BODIES(T, 32);      \
  MFA_BODIES(T, 64);      \
  MFA_BODIES(T, 128);     \
  MFA_BODIES(T, 256);     \
  MFA_BODIES(T, 288);     \
  MFA_BODIES(T, 576)
  if (dtype == 0) {
    MFA_BODIES_ALL(float);
  } else if (dtype == 1) {
    MFA_BODIES_ALL(__nv_bfloat16);
  }
#undef MFA_BODIES_ALL
#undef MFA_BODIES
  return -1;
}

// Which forward kernel the static-max mode (mfa_flash_fwd with row_max)
// runs for dtype at the built head dim D: 1 the tensor cores
// (flash_fwd_tc_kernel, flash_fwd_wide_kernel at D = 288 or
// flash_fwd_latent_kernel at 576), 0
// flash_fwd_kernel, 2 split_d_fwd_kernel (above 576), -1 none
// (ops/flash_attention.py::fwd_body answers the same for both modes).
int mfa_flash_static_max_body(int dtype, int D) {
  const int bodies = mfa_flash_tc_bodies(dtype, D);
  return bodies < 0 ? -1 : (bodies & 8) ? 2 : (bodies & 1);
}

}  // extern "C"

// The quantized attention backward above head dim 576 for Hopper (sm_90a):
// the exact quantized dQ and dK/dV and the full-integer pair on the
// split-D frame (csrc/split_d_frame.cuh), the head dim a run-time value.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu,
// ops/flash_attention_bwd.py) above D = 576:
//   - _dq_kernel, quantized modes  -> split_d_qdq_kernel (the frame's dQ
//                                     body over PayloadKV)
//   - _dkv_kernel, quantized modes -> split_d_qdkv_kernel (its dK/dV body)
//                                     (then flash_attention.cu's
//                                     flash_dkv_merge_kernel)
//   - _dq_fullint_kernel           -> split_d_fullint_dq_kernel
//   - _dkv_fullint_kernel          -> split_d_fullint_dkv_kernel (then
//                                     flash_dkv_merge_kernel)
// csrc/quantized_attention_bwd.cu's router (mfa_qflash_bwd, mfa_fullint_bwd)
// calls the launchers here for D > 576 (split_d.cuh).
//
// The exact pair is the flash dQ and dK/dV of the frame with the payloads
// as K and V (PayloadKV: dequantized per token, BLOCK_2D block or channel
// as they stage, or the integers for the folded dQ, rounded to T by the
// staging bit for bit with dequant_rows_bf16), the folded dQ's per-token
// column scales (ksr on S and dS, vsr on dP) and its store multipliers
// (dqsc), in attention_bwd.cuh::dq_body's order.
//
// The full-integer pair (csrc/quantized_attention_bwd.cu's file comment has
// its numerics; the plain versions are ops/flash_attention_bwd.py's
// fullint_dq_plain and fullint_dkv_plain): S = Q_int.K_int^T and dP =
// dOv_int.V_int^T over the whole head dim on s8 mma.sync, one k step a
// 32-lane chunk, exact in int32 and so the same in every slice; p =
// exp(S qsc (ks) - L), dS = p (dP dovsc - D) (ks) in the frame's thread
// layout; then the output products over the CTA's 256-lane slice:
//   - level 1: round_bf16(dS).K_int (dQ), round_bf16(P dorsc).dO_int and
//     round_bf16(dS^T qsc).Q_int (dV, dK) on bf16 mma.sync (the integers
//     are exact in bf16);
//   - level 2: each row of dS (P, dS^T) quantized to int8 over spans of
//     `width` keys (queries) by its |max| over the span (+-0.5 then
//     truncation) and scaled back by max / 127, times the integers in fp32
//     FMAs (every width from 1 up: a span of one tile or less is taken in
//     one pass, a wider one in two, its row maxima first, so the integers
//     are the plain version's whatever the tiles).
// dK is stored times `store`; the dK/dV's GQA group is dealt over `splits`
// CTAs a key tile (ops/flash_attention_bwd.py::fullint_dkv_splits) into a
// workspace that flash_dkv_merge_kernel sums in split order.
// What bounds them: the tensor-core operations (the exact dQ (4 s + 2) D a
// live pair, dK/dV (4 s + 4) D, s = slices: the scores recomputed once a
// slice; the full-integer pair the same counts, S and dP in int8, level 2
// twice over spans wider than a tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "split_d_frame.cuh"

namespace {

using mfa::row_max16;
using mfa::rowquant;
using mfa_sd::FullintArgs;

// int8 rows of head `head` of a [.., n, D] tensor from row r0, zeros from
// `limit`.
__device__ __forceinline__ I8Rows i8_rows(const int8_t* x, size_t head,
                                          int n, int D, int r0, int limit) {
  return I8Rows{x + head * n * (size_t)D, r0, limit, D};
}

// Replaces _dq_fullint_kernel above D = 576.  One CTA per (64 query rows,
// q head x slice, b) walks every key (the path has no mask) in 64-key
// tiles, a level-2 span of `width` keys at a time.
template <bool L2>
__global__ void __launch_bounds__(256)
split_d_fullint_dq_kernel(const FullintArgs a) {
  using L = Smem<64, 1>;
  using P = PV<typename std::conditional<L2, float, __nv_bfloat16>::type, 64>;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const float* ks = a.ks ? a.ks + bk * Skv : nullptr;
  float* pt = smem + L::P;

  float qs[4], lrow[4], drow[4], dvs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    const bool live = r < Sq;
    qs[i] = live ? a.qsc[bh * Sq + r] : 0.f;
    lrow[i] = live ? a.lse[bh * Sq + r] : 0.f;
    drow[i] = live ? a.di[bh * Sq + r] : 0.f;
    dvs[i] = live ? a.dovsc[bh * Sq + r] : 0.f;
  }
  typename P::Acc acc;
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const I8Rows qsrc = i8_rows(a.qq, bh, Sq, D, r0, Sq);
  const I8Rows dosrc = i8_rows(a.dov, bh, Sq, D, r0, Sq);
  const int span = L2 ? a.width : max(Skv, 1);

  for (int c0 = 0; c0 < Skv; c0 += span) {
    const int c_end = min(c0 + span, Skv);
    const int passes = L2 && span > TILE ? 2 : 1;
    float amax[4] = {0.f, 0.f, 0.f, 0.f};
    for (int pass = 0; pass < passes; ++pass) {
      const bool last = pass == passes - 1;
      for (int t0 = c0; t0 < c_end; t0 += TILE) {
        const I8Rows ksrc = i8_rows(a.kq, bk, Skv, D, t0, c_end);
        if (last) P::fetch(ksrc, l0, smem + L::H);
        float si[4][4], dpi[4][4], ds[4][4];
        scores<int8_t, 64>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc,
                           ksrc, ty, tx, si);
        scores<int8_t, 64>(nch, smem + L::A, smem + L::B, smem + L::S, dosrc,
                           i8_rows(a.vq, bk, Skv, D, t0, c_end), ty, tx,
                           dpi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = t0 + tx + 16 * j;
          const bool in = col < c_end;
          const float k_s = (ks && in) ? ks[col] : 1.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float s = si[i][j] * qs[i];
            if (ks) s *= k_s;
            const float p = in ? expf(s - lrow[i]) : 0.f;
            float d = p * (dpi[i][j] * dvs[i] - drow[i]);
            if (ks) d *= k_s;
            ds[i][j] = d;
          }
        }
        if constexpr (L2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float mx = row_max16(
                fmaxf(fmaxf(fabsf(ds[i][0]), fabsf(ds[i][1])),
                      fmaxf(fabsf(ds[i][2]), fabsf(ds[i][3]))));
            amax[i] = passes == 1 ? mx : fmaxf(amax[i], mx);
          }
          if (!last) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              ds[i][j] = rowquant(ds[i][j], amax[i], true);
        }
        P::store(pt, ty, tx, ds);  // level 1: rounded to bf16 here
        P::slice(pt, ksrc, l0, D, smem + L::H, nullptr, ty, tx, acc);
      }
    }
  }

  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r < Sq && l0 + d < D)
      *reinterpret_cast<float2*>(a.out0 + (bh * Sq + r0 + r) * D + l0 + d) =
          make_float2(v0 * a.store, v1 * a.store);
  });
}

// Replaces _dkv_fullint_kernel above D = 576.  One CTA per (64 keys, kv
// head x slice, b x split) owns its keys' dK and dV over its slice and
// walks its split of the GQA group x every query row (the path has no
// mask) in 64-row steps, a level-2 span of `width` queries at a time.
template <bool L2>
__global__ void __launch_bounds__(256)
split_d_fullint_dkv_kernel(const FullintArgs a, int splits, float* ws) {
  using L = Smem<64, 2>;
  using P = PV<typename std::conditional<L2, float, __nv_bfloat16>::type, 64>;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int c0 = blockIdx.x * 64;
  const int hk = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int group = a.Hq / a.Hkv;
  const int per = (group + splits - 1) / splits;
  const int g_lo = min(sp * per, group);
  const int g_hi = min(g_lo + per, group);
  const int tx = threadIdx.x & 15;  // query rows r0 + tx + 16 j
  const int ty = threadIdx.x >> 4;  // keys c0 + 4 ty + i
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const size_t bk = (size_t)b * a.Hkv + hk;
  float* ptile = smem + L::P;             // P' (keys x queries)
  float* dst = ptile + TILE * L::PLD;     // dS'
  float* h_do = smem + L::H;              // the slices of dO and of Q
  float* h_q = h_do + TILE * HLD;

  float ksr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + 4 * ty + i;
    ksr[i] = (a.ks && key < Skv) ? a.ks[bk * Skv + key] : 1.f;
  }
  typename P::Acc dk, dv;
  P::zero(dk);
  P::zero(dv);
  const int nch = (D + DC - 1) / DC;
  const I8Rows ksrc = i8_rows(a.kq, bk, Skv, D, c0, Skv);
  const I8Rows vsrc = i8_rows(a.vq, bk, Skv, D, c0, Skv);
  const int span = L2 ? a.width : max(Sq, 1);

  for (int g = g_lo; g < g_hi; ++g) {
    const int h = a.interleaved ? g * a.Hkv + hk : hk * group + g;
    const size_t bh = (size_t)b * a.Hq + h;
    for (int q0 = 0; q0 < Sq; q0 += span) {
      const int q_end = min(q0 + span, Sq);
      const int passes = L2 && span > TILE ? 2 : 1;
      float am_p[4] = {0.f, 0.f, 0.f, 0.f};
      float am_s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pass = 0; pass < passes; ++pass) {
        const bool last = pass == passes - 1;
        for (int r0 = q0; r0 < q_end; r0 += TILE) {
          bool in[4];
          float qs[4], lcol[4], dcol[4], dors[4], dovs[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + tx + 16 * j;
            in[j] = r < q_end;
            const size_t o = bh * Sq + (in[j] ? r : 0);
            qs[j] = a.qsc[o];
            lcol[j] = a.lse[o];
            dcol[j] = a.di[o];
            dors[j] = a.dorsc[o];
            dovs[j] = a.dovsc[o];
          }
          const I8Rows qsrc = i8_rows(a.qq, bh, Sq, D, r0, q_end);
          const I8Rows dorsrc = i8_rows(a.dor, bh, Sq, D, r0, q_end);
          if (last) {
            P::fetch(dorsrc, l0, h_do);
            P::fetch(qsrc, l0, h_q);
          }
          float pd[4][4], dsv[4][4];  // [key i][query j]
          scores<int8_t, 64>(nch, smem + L::A, smem + L::B, smem + L::S,
                             ksrc, qsrc, ty, tx, pd);
          scores<int8_t, 64>(nch, smem + L::A, smem + L::B, smem + L::S,
                             vsrc, i8_rows(a.dov, bh, Sq, D, r0, q_end), ty,
                             tx, dsv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float st = pd[i][j] * qs[j];
              if (a.ks) st *= ksr[i];
              const float p = in[j] ? expf(st - lcol[j]) : 0.f;  // P^T
              dsv[i][j] = p * (dsv[i][j] * dovs[j] - dcol[j]) * qs[j];
              pd[i][j] = p * dors[j];
            }
          if constexpr (L2) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float mp = 0.f, ms = 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                mp = fmaxf(mp, pd[i][j]);
                ms = fmaxf(ms, fabsf(dsv[i][j]));
              }
              mp = row_max16(mp);
              ms = row_max16(ms);
              am_p[i] = passes == 1 ? mp : fmaxf(am_p[i], mp);
              am_s[i] = passes == 1 ? ms : fmaxf(am_s[i], ms);
            }
            if (!last) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                pd[i][j] = rowquant(pd[i][j], am_p[i], false);
                dsv[i][j] = rowquant(dsv[i][j], am_s[i], true);
              }
          }
          P::store(ptile, ty, tx, pd);  // level 1: rounded to bf16 here
          P::store(dst, ty, tx, dsv);
          P::slice(ptile, dorsrc, l0, D, h_do, nullptr, ty, tx, dv);
          P::slice(dst, qsrc, l0, D, h_q, nullptr, ty, tx, dk);
        }
      }
    }
  }

  const size_t n = (size_t)gridDim.z / splits * a.Hkv * Skv * D;
  float* out_k = splits > 1 ? ws + (2 * (size_t)sp) * n : a.out0;
  float* out_v = splits > 1 ? ws + (2 * (size_t)sp + 1) * n : a.out1;
  const auto put = [&](float* out, int r, int d, float v0, float v1) {
    if (c0 + r < Skv && l0 + d < D)
      *reinterpret_cast<float2*>(out + (bk * Skv + c0 + r) * D + l0 + d) =
          make_float2(v0, v1);
  };
  P::each(dk, ty, tx, [&](int r, int d, float v0, float v1) {
    put(out_k, r, d, v0 * a.store, v1 * a.store);
  });
  P::each(dv, ty, tx, [&](int r, int d, float v0, float v1) {
    put(out_v, r, d, v0, v1);
  });
}

// Replaces _dq_kernel's quantized modes above D = 576 (the body:
// split_d_frame.cuh::split_d_dq over PayloadKV).
template <typename T>
__global__ void __launch_bounds__(256)
split_d_qdq_kernel(const FlashArgs a, const PayloadKV kv) {
  split_d_dq<T>(a, kv);
}

// Replaces _dkv_kernel's quantized modes above D = 576 (the body:
// split_d_frame.cuh::split_d_dkv over PayloadKV).
template <typename T>
__global__ void __launch_bounds__(256)
split_d_qdkv_kernel(const FlashArgs a, const PayloadKV kv, int splits,
                    float* ws) {
  split_d_dkv<T>(a, kv, splits, ws);
}

template <typename T>
int qdq_of(const FlashArgs& a, const PayloadKV& kv, cudaStream_t stream) {
  const dim3 grid((a.Sq + 63) / 64, a.Hq * mfa_sd::slices(a.D), a.B);
  return mfa::launch_with_smem(split_d_qdq_kernel<T>, grid, 256,
                               Smem<64, 1>::BYTES, stream, a, kv);
}

template <typename T>
int qdkv_of(const FlashArgs& a, const PayloadKV& kv, int splits, float* ws,
            cudaStream_t stream) {
  const dim3 grid((a.Skv + 63) / 64, a.Hkv * mfa_sd::slices(a.D),
                  a.B * splits);
  return mfa::launch_with_smem(split_d_qdkv_kernel<T>, grid, 256,
                               Smem<64, 2>::BYTES, stream, a, kv, splits, ws);
}

template <bool L2>
int fullint_of(bool dq, const FullintArgs& a, int splits, float* ws,
               cudaStream_t stream) {
  const int nsl = mfa_sd::slices(a.D);
  if (dq)
    return mfa::launch_with_smem(split_d_fullint_dq_kernel<L2>,
                                 dim3((a.Sq + 63) / 64, a.Hq * nsl, a.B),
                                 256, Smem<64, 1>::BYTES, stream, a);
  return mfa::launch_with_smem(split_d_fullint_dkv_kernel<L2>,
                               dim3((a.Skv + 63) / 64, a.Hkv * nsl,
                                    a.B * splits),
                               256, Smem<64, 2>::BYTES, stream, a, splits,
                               ws);
}

}  // namespace

namespace mfa_sd {

int launch_qdq(int dtype, const FlashArgs& a, const QuantKV& kv,
               cudaStream_t stream) {
  if (!takes(a.D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return qdq_of<float>(a, PayloadKV{kv}, stream);
  if (dtype == 1) return qdq_of<__nv_bfloat16>(a, PayloadKV{kv}, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_qdkv(int dtype, const FlashArgs& a, const QuantKV& kv, int splits,
                float* ws, cudaStream_t stream) {
  if (!takes(a.D) || splits < 1 || splits > a.Hq / a.Hkv ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return qdkv_of<float>(a, PayloadKV{kv}, splits, ws, stream);
  if (dtype == 1)
    return qdkv_of<__nv_bfloat16>(a, PayloadKV{kv}, splits, ws, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_fullint(bool dq, const FullintArgs& a, int splits, float* ws,
                   cudaStream_t stream) {
  if (!takes(a.D) || a.width < 0 || splits < 1 || splits > a.Hq / a.Hkv ||
      (splits > 1 && (dq || !ws)))
    return (int)cudaErrorInvalidValue;
  if (a.width == 0) return fullint_of<false>(dq, a, splits, ws, stream);
  return fullint_of<true>(dq, a, splits, ws, stream);
}

}  // namespace mfa_sd

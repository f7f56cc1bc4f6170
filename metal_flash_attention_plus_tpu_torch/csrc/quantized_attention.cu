// Quantized attention forward for Hopper (sm_90a): attention over int8 or
// group-planar int4 K/V, in every mode of the JAX package's quantized
// forward, and the same computation over the packed d = 64 head-pair layout.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/quantized_attention.py::_qfwd_kernel   -> qattn_fwd_kernel
//   - ops/quantized_attention.py::_hpack_kernel  -> hpack_fwd_kernel
//
// Layouts.  Q is [B, Hq, Sq, D] of T (float or bf16, pre-scaled by the
// wrapper) or int8 with per-row fp32 scales qs [B, Hq, Sq]; the element of
// (b, h, r) sits at b*q_sb + (h/2)*q_spair + (h%2)*q_shalf + r*q_sr, which
// covers the natural layout and the packed [B, Hq/2, Sq, 128] one (head 2p
// in lanes [0, 64) of pair p, head 2p + 1 in [64, 128)).  O is fp32 in Q's
// layout; L fp32 [B, Hq, Sq].  K and V payloads are int8 [B, Hkv, Skv, D] or
// group-planar int4 uint8 [B, Hkv, Skv, D/2] (D <= 256: byte j holds value j
// in its low nibble and value j + D/2 in its high one, each stored + 8).
// GQA as in the flash kernels; every mask is the [Sq, 2] row-range table.
//
// Scale modes (what the TPU kernel's flags select):
//   K: NONE (folded into Q by the wrapper), TOKEN (dequantize (w - zp)*s per
//      token), BLOCK2D (w*s - zp*s per [br x bs] block), COLUMN (per-token
//      scale on the score column);
//   V: TOKEN, BLOCK2D (dequantize), P (per-token scale on P, after l has
//      summed it), STORE (per-channel scale on O at the store).
// Flags: ROUND_BF16 (the compute dtype is bf16: dequantized K/V and P are
//   rounded to bf16 before their products), L_ROUNDED (l sums the rounded P,
//   as the TPU kernel's ones-lane rowsum does), P_INT8 (P in 1/127 units,
//   round(127 * 2^(s - m)) by +0.5 and truncation, times integer V; L drops
//   ln 127).
// An int8 Q runs the score product with __dp4a (int8 x int8 -> int32, times
// the row's Q scale); a float Q with fp32 FMAs over the staged values.
// Numerics, shared with the plain versions in ops/quantized_attention.py:
// base-2 online softmax in fp32; bias*log2(e) added after the K column
// scale, then masked scores set to mask_value; O = acc / l (x the V channel
// scale at STORE); L = m*ln2 + log(l); an empty row gives O = 0, L = -inf.
// The CTA walks its live keys in 64-key tiles aligned to multiples of 64
// from key 0, P rounded against the running row max.  An int8 Q (the only
// Q of the int8 P of P_INT8, whose integers depend on that max) walks them
// inside spans of kv_span keys (a multiple of 64) aligned the same way, as
// the TPU kernel walks its block_kv tiles: with kv_span > 64 a first pass
// over each span takes the span's row max, so P rounds against the TPU's
// max whatever the CUDA tile (the wrapper passes the TPU's block_kv).  The
// other instances compile no span loop and take kv_span = 64 only.
//
// What bounds them on the H100, and the design.
//   At the flagship's attention shapes (B=2, Hq=16, Hkv=4, S=2048, D=64,
//   causal) the work is ~34 G products (4*D per live query-key pair), i.e.
//   operation bound on the tensor cores by far over its ~20 MB of bytes.
//   These first versions take the flash forward's shape (one CTA per 64
//   query rows, b, q head; 256 threads, 4 x 4 scores each; m, l and the
//   accumulator in registers; only the tiles of the CTA's live key span) and
//   its scalar fp32 FMAs, with __dp4a for int8 x int8 scores, so they sit
//   far from that bound.  The payload is widened (and dequantized) while it
//   is staged into shared memory, 4 values per 32-bit load, so device memory
//   sees only the integer bytes.  The head-pair kernel keeps the TPU's packed
//   I/O (Q read and O written in [B, Hq/2, S, 128] through strides, no
//   pack/unpack pass) but not its block-diagonal product: one CTA per (64
//   rows, b, head of the pair) needs none on Hopper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "common.cuh"
#include "quantized_tiles.cuh"

namespace {

using mfa::BM;
using mfa::BN;
using mfa::Elem;
using mfa::KVOperand;
using mfa::LD;
using mfa::LN2;
using mfa::LOG2E;
using mfa::THREADS;
using mfa::accumulate_pm;
using mfa::key_span;
using mfa::round_bf16;
using mfa::row_range;
using mfa::set_smem;
using mfa::stage_kv;
using mfa::stage_kv_words;
using mfa::stage_words;
using mfa::store_t;
using mfa::tile_product;
using mfa::tile_product_i8;

enum KScales { K_NONE = 0, K_TOKEN = 1, K_BLOCK2D = 2, K_COLUMN = 3 };
enum VScales { V_TOKEN = 1, V_BLOCK2D = 2, V_P = 3, V_STORE = 4 };
enum Flags { ROUND_BF16 = 1, L_ROUNDED = 2, P_INT8 = 4 };
constexpr float LOG2_127 = 6.988684686772166f;
constexpr float LN_127 = 4.844187086458591f;

struct Args {
  const void* q;
  const float* qs;
  const uint8_t* kq;
  const float* ks;
  const float* kz;
  const uint8_t* vq;
  const float* vs;
  const float* vz;
  const int32_t* ranges;
  const float* bias;
  long long bias_sb, bias_sh;
  float* o;
  float* lse;
  long long q_sb, q_spair, q_shalf, q_sr;  // Q and O element strides
  int Hq, Hkv, Sq, Skv, interleaved;
  int bits_k, bits_v, k_scales, v_scales, flags, br, bs;
  int kv_span;  // keys per span of the running max (a multiple of BN)
  float mask_value;
};

// Stage Q rows [r0, r0 + 64) of one head (zeros from Sq) transposed into
// dst[d * LD + r] as fp32; rows `sr` elements apart.
template <typename T, int D>
__device__ __forceinline__ void stage_q(const T* qh, long long sr, int r0,
                                        int Sq, float* dst) {
  using E = Elem<T>;
  constexpr int VPR = D / E::VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = i % VPR;
    float f[E::VEC];
    if (r0 + r < Sq) {
      E::unpack(*reinterpret_cast<const uint4*>(qh + (r0 + r) * sr +
                                                c * E::VEC),
                f);
    } else {
#pragma unroll
      for (int e = 0; e < E::VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E::VEC; ++e) dst[(c * E::VEC + e) * LD + r] = f[e];
  }
}

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)D * LD + (size_t)BN * LD;  // Q^T, K^T|V^T, P^T
}

// The forward over one (64 query rows, b, q head): a.q of QT (float, bf16
// or int8).  Bound: operations (4*D per live pair); see the file comment.
template <typename QT, int D>
__device__ __forceinline__ void qattn_body(const Args& a) {
  constexpr bool QINT = std::is_same<QT, int8_t>::value;
  constexpr int DV = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;          // [D][LD]  Q^T (fp32), or [D/4][LD] Q words
  float* kvt = qt + D * LD;  // [D][LD]  K^T (fp32 or words), then V^T
  float* pt = kvt + D * LD;  // [BN][LD] P^T
  __shared__ int s_lo, s_hi;

  const int r0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int hk = a.interleaved ? h % a.Hkv : h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const long long qoff =
      b * a.q_sb + (h >> 1) * a.q_spair + (h & 1) * a.q_shalf;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  const bool rb = a.flags & ROUND_BF16;
  const bool l_rounded = a.flags & L_ROUNDED;
  const bool p_int8 = a.flags & P_INT8;

  if constexpr (QINT) {
    stage_words<D>(static_cast<const int8_t*>(a.q) + qoff, a.q_sr, r0, a.Sq,
                   reinterpret_cast<int*>(qt));
  } else {
    stage_q<QT, D>(static_cast<const QT*>(a.q) + qoff, a.q_sr, r0, a.Sq, qt);
  }
  key_span(a.ranges, r0, a.Sq, a.Skv, &s_lo, &s_hi);  // syncs: Q staged too
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float m[4], l[4], qsr[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_range(a.ranges, r, a.Sq, a.Skv, rs[i], re[i]);
    qsr[i] = (QINT && r < a.Sq) ? a.qs[bh * a.Sq + r] : 1.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.f;
  }

  // One 64-key tile t0: the masked, scaled scores; pass 0 only folds them
  // into each row's span max (this thread's columns), pass 1 rounds P
  // against the running max and accumulates P.V.
  float smax[4];
  auto tile = [&](int t0, int pass) {
    float s[4][4];
    if constexpr (QINT) {
      stage_kv_words<D>(a.kq, a.bits_k, bk, a.Skv, t0, c_hi,
                        reinterpret_cast<int*>(kvt));
      __syncthreads();
      int si[4][4];
      tile_product_i8<D>(reinterpret_cast<const int*>(qt), ty,
                         reinterpret_cast<const int*>(kvt), tx, si);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = (float)si[i][j] * qsr[i];
    } else {
      stage_kv<D>(KVOperand{a.kq, a.ks, a.kz, a.bits_k, a.k_scales}, bk,
                  a.Skv, a.br, a.bs, rb, t0, c_hi, kvt);
      __syncthreads();
      tile_product<D>(qt, ty, kvt, tx, s);
    }
    __syncthreads();  // every thread is done with K^T
    if (pass == 1)
      stage_kv<D>(KVOperand{a.vq, a.vs, a.vz, a.bits_v, a.v_scales}, bk,
                  a.Skv, a.br, a.bs, rb, t0, c_hi, kvt);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      float mx = smax[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx * 4 + j;
        if (a.k_scales == K_COLUMN && col < a.Skv)
          s[i][j] *= a.ks[bk * a.Skv + col];
        if (bh_bias && row < a.Sq && col < c_hi)
          s[i][j] += bh_bias[(size_t)row * a.Skv + col] * LOG2E;
        if (col < rs[i] || col >= re[i]) s[i][j] = a.mask_value;
        mx = fmaxf(mx, s[i][j]);
      }
      if (pass == 0) {
        smax[i] = mx;
        continue;
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
        const int col = t0 + tx * 4 + j;
        float raw, p;
        if (s[i][j] == -INFINITY) {
          raw = p = 0.f;
        } else if (p_int8) {
          raw = exp2f(s[i][j] + (LOG2_127 - m_next));
          p = (float)(int)(raw + 0.5f);
        } else {
          raw = p = exp2f(s[i][j] - m_next);
          if (a.v_scales == V_P && col < a.Skv) p *= a.vs[bk * a.Skv + col];
          if (rb) p = round_bf16(p);
        }
        sum += l_rounded ? p : raw;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[i][e] *= alpha;
    }
    if (pass == 0) return;
    store_t(pt, ty, tx, s);
    __syncthreads();  // V^T and P^T staged
    accumulate_pm<D>(pt, ty, kvt, tx, acc);
    __syncthreads();  // before the next tile overwrites them
  };

#pragma unroll
  for (int i = 0; i < 4; ++i) smax[i] = -INFINITY;
  if constexpr (QINT) {
    // Spans of kv_span keys aligned to multiples of it (only an int8 Q
    // rounds an int8 P); with kv_span > BN a first pass over the span's
    // tiles takes each row's max before the second computes P against it.
    const int span = a.kv_span;
    for (int sp0 = (c_lo / span) * span; sp0 < c_hi; sp0 += span) {
      const int t_beg = max(sp0, (c_lo / BN) * BN);
      const int t_end = min(sp0 + span, c_hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) smax[i] = -INFINITY;
      for (int pass = span > BN ? 0 : 1; pass < 2; ++pass)
        for (int t0 = t_beg; t0 < t_end; t0 += BN) tile(t0, pass);
    }
  } else {
    for (int t0 = (c_lo / BN) * BN; t0 < c_hi; t0 += BN) tile(t0, 1);
  }

  const float l_off = p_int8 ? LN_127 : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= a.Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    float* orow = a.o + qoff + r * a.q_sr;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      const int d = tx + 16 * e;
      float out = live ? acc[i][e] / l[i] : 0.f;
      if (a.v_scales == V_STORE) out *= a.vs[bk * D + d];
      orow[d] = out;
    }
    if (tx == 0)
      a.lse[bh * a.Sq + r] =
          live ? m[i] * LN2 + logf(l[i]) - l_off : -INFINITY;
  }
}

// Replaces ops/quantized_attention.py::_qfwd_kernel.
template <typename QT, int D>
__global__ void __launch_bounds__(THREADS) qattn_fwd_kernel(const Args a) {
  qattn_body<QT, D>(a);
}

// Replaces ops/quantized_attention.py::_hpack_kernel: d = 64, Q and O in the
// packed head-pair layout, K/V scales folded (K into Q, V at the store).
template <typename QT>
__global__ void __launch_bounds__(THREADS) hpack_fwd_kernel(const Args a) {
  qattn_body<QT, 64>(a);
}

template <typename K>
int launch(K kern, const Args& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((a.Sq + BM - 1) / BM, a.Hq, B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename QT, int D>
int launch_qattn(const Args& a, int B, cudaStream_t stream) {
  return launch(qattn_fwd_kernel<QT, D>, a, B, smem_floats<D>() * sizeof(float),
                stream);
}

template <typename QT>
int launch_qattn_d(const Args& a, int B, int D, cudaStream_t stream) {
  if (D == 32) return launch_qattn<QT, 32>(a, B, stream);
  if (D == 64) return launch_qattn<QT, 64>(a, B, stream);
  if (D == 128) return launch_qattn<QT, 128>(a, B, stream);
  if (D == 256) return launch_qattn<QT, 256>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

bool valid_bits(int bits) { return bits == 8 || bits == 4; }

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported type, head dim,
// bit width or head grouping.  qtype: 0 float32, 1 bfloat16, 2 int8.
extern "C" {

int mfa_qattn_fwd(const void* q, const void* qs, const void* kq,
                  const void* ks, const void* kz, const void* vq,
                  const void* vs, const void* vz, const void* ranges,
                  const void* bias, long long bias_sb, long long bias_sh,
                  void* o, void* lse, int qtype, int B, int Hq, int Hkv,
                  int Sq, int Skv, int D, int interleaved, int bits_k,
                  int bits_v, int k_scales, int v_scales, int flags, int br,
                  int bs, int kv_span, float mask_value, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || !valid_bits(bits_k) || !valid_bits(bits_v) ||
      kv_span <= 0 || kv_span % BN || (qtype != 2 && kv_span != BN))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)Sq * D;
  const Args a{q, static_cast<const float*>(qs),
               static_cast<const uint8_t*>(kq), static_cast<const float*>(ks),
               static_cast<const float*>(kz), static_cast<const uint8_t*>(vq),
               static_cast<const float*>(vs), static_cast<const float*>(vz),
               static_cast<const int32_t*>(ranges),
               static_cast<const float*>(bias), bias_sb, bias_sh,
               static_cast<float*>(o), static_cast<float*>(lse),
               Hq * plane, 2 * plane, plane, D,
               Hq, Hkv, Sq, Skv, interleaved, bits_k, bits_v, k_scales,
               v_scales, flags, br, bs, kv_span, mask_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qtype == 0) return launch_qattn_d<float>(a, B, D, s);
  if (qtype == 1) return launch_qattn_d<__nv_bfloat16>(a, B, D, s);
  if (qtype == 2) return launch_qattn_d<int8_t>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}

int mfa_hpack_fwd(const void* q, const void* kq, const void* vq,
                  const void* vsc, const void* ranges, void* o, void* lse,
                  int qtype, int B, int H2, int Hkv, int Sq, int Skv,
                  int interleaved, int bits_k, int bits_v, float mask_value,
                  void* stream) {
  const int Hq = 2 * H2;
  if (Hkv <= 0 || Hq % Hkv || !valid_bits(bits_k) || !valid_bits(bits_v))
    return (int)cudaErrorInvalidValue;
  const long long pair = (long long)Sq * 128;
  const Args a{q, nullptr, static_cast<const uint8_t*>(kq), nullptr, nullptr,
               static_cast<const uint8_t*>(vq),
               static_cast<const float*>(vsc), nullptr,
               static_cast<const int32_t*>(ranges), nullptr, 0, 0,
               static_cast<float*>(o), static_cast<float*>(lse),
               H2 * pair, pair, 64, 128,
               Hq, Hkv, Sq, Skv, interleaved, bits_k, bits_v, K_NONE,
               V_STORE, ROUND_BF16, 1, 1, BN, mask_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_floats<64>() * sizeof(float);
  if (qtype == 0) return launch(hpack_fwd_kernel<float>, a, B, smem, s);
  if (qtype == 1)
    return launch(hpack_fwd_kernel<__nv_bfloat16>, a, B, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

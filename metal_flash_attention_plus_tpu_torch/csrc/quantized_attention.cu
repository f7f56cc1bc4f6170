// Quantized attention forward for Hopper (sm_90a): attention over int8 or
// group-planar int4 K/V, in every mode of the JAX package's quantized
// forward, and the same computation over the packed d = 64 head-pair layout.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - ops/quantized_attention.py::_qfwd_kernel   -> qattn_fwd_tc_kernel (a
//     bf16 or int8 Q up to D = 256), qattn_fwd_wide_kernel (a bf16 or int8
//     Q at MLA's D = 288), qattn_fwd_latent_kernel (a bf16 or int8 Q at
//     DeepSeek's absorbed D = 576), qattn_fwd_kernel (an fp32 Q; in 32-row
//     tiles at 576)
//   - ops/quantized_attention.py::_hpack_kernel  -> qattn_fwd_tc_kernel<bf16,
//     64> (a bf16 Q), qattn_fwd_kernel<float, 64> (an fp32 Q), launched by
//     mfa_hpack_fwd through the packed strides
//
// Layouts.  Q is [B, Hq, Sq, D] of T (float or bf16, pre-scaled by the
// wrapper) or int8 with per-row fp32 scales qs [B, Hq, Sq]; the element of
// (b, h, r) sits at b*q_sb + (h/2)*q_spair + (h%2)*q_shalf + r*q_sr, which
// covers the natural layout and the packed [B, Hq/2, Sq, 128] one (head 2p
// in lanes [0, 64) of pair p, head 2p + 1 in [64, 128)).  O is fp32 in Q's
// layout; L fp32 [B, Hq, Sq].  K and V payloads are int8 [B, Hkv, Skv, D] or
// group-planar int4 uint8 [B, Hkv, Skv, D/2]: groups of 256 values (the last
// one shorter), within a group of width w byte j holding value j in its low
// nibble and value j + w/2 in its high one, each stored + 8 (D <= 256: byte
// j holds values j and j + D/2; D = 288: bytes [0, 128) values j and
// j + 128, bytes [128, 144) values 256 + j and 272 + j; D = 576: three
// groups; quantized_tiles.cuh reads them all).  Head dims: built for 32,
// 64, 128, 256, 288 and 576; the other multiples of 16 up to 576 run
// zero-padded at the next (ops/quantized_attention.py::qattn_width); above
// 576 every multiple of 16 runs csrc/split_d_quantized.cu's
// split_d_qattn_kernel, which mfa_qattn_fwd launches.
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
// Two bodies compute it.  A bf16 or int8 Q with ROUND_BF16 (every such call
// of the port's forward, and every bf16 head-pair call) takes the
// tensor-core body, qattn_fwd_tc_kernel: mma.sync s8 or bf16 products over
// K/V staged with cp.async (see its comment below).  An fp32 Q (also
// quantized to int8: ROUND_BF16 off; also in the head-pair layout) takes
// the scalar body: scores with __dp4a (int8 x int8 -> int32, times the
// row's Q scale) or fp32 FMAs over the staged values, P.V with fp32 FMAs.
// fp32 stays off the tensor cores: TF32 keeps ~3 digits, and the fp32
// modes are held to 2e-5.
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
//   operation bound on the tensor cores by far over its ~20 MB of bytes; so
//   is the north-star (B=4, H=4, S=4096, D=256: 275 G int8 operations).  The
//   scalar body takes the flash forward's shape (one CTA per 64 query rows,
//   b, q head; 256 threads, 4 x 4 scores each; m, l and the accumulator in
//   registers; only the tiles of the CTA's live key span) and runs at ~1/60
//   of the int8 peak.  The tensor-core body keeps the grid and the walk and
//   moves both products onto mma.sync, with the payload staged as its
//   integer bytes (cp.async, double-buffered) and widened once per tile in
//   shared memory, so device memory sees only the integer bytes.  The
//   head-pair call is these bodies in one mode (K_NONE: the K scales folded
//   into Q; V_STORE: the V channel scales at the store; ROUND_BF16) with
//   the TPU's packed I/O (Q read and O written in [B, Hq/2, S, 128]
//   through the strides, no pack/unpack pass) but not its block-diagonal
//   product: one CTA per (64 rows, b, head of the pair) needs none on
//   Hopper.  The odd head's lanes start 128 bytes (bf16 Q) or 256 bytes
//   (fp32 O) into the packed row, so its 16-byte Q copies and float2 O
//   stores stay aligned, and the shared memory takes 64 lanes a row as
//   for an unpacked Q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "quantized_tiles.cuh"
#include "split_d.cuh"

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
using mfa::load_word;
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

// qattn_body above D = 288 (an fp32 Q, or an int8 Q without ROUND_BF16,
// at DeepSeek's 576), in 32-row tiles (the layout and thread map of
// attention_tiles.cuh's 32-row helpers; flash_attention.cu's fwd_body32):
// two [D][64 + 4] fp32 tiles alone pass 227 KB there.  Q^T (fp32) or Q's
// words transposed; each 32-key tile's K rows (fp32 values, or words for
// an int8 Q's __dp4a scores) then V rows (fp32 values) in one row tile;
// P^T in the score tile.  Thread (ty, tx) holds rows 4 ty + [0, 4), their
// scores against key tx (the row max and sum reduce over the warp) and
// O's lanes tx + 32 e.  The function, its order of operations and the
// spans are qattn_body's, in 32-key tiles (an int8 P's spans in two
// passes, as the tensor-core bodies' 32-key steps walk them).  Shared
// memory 161,408 bytes at 576 (mfa::smem32_bytes).  Bound: operations.
template <typename QT, int D>
__device__ __forceinline__ void qattn_body32(const Args& a) {
  constexpr bool QINT = std::is_same<QT, int8_t>::value;
  constexpr int DE = D / mfa::T32;
  constexpr int W = D / 4;
  constexpr int T32 = mfa::T32;
  constexpr int LD32 = mfa::LD32;
  constexpr int KW_LD = W + 1;  // a row of K words (an int8 Q)
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                               // [D][LD32] Q^T, or words
  float* kvr = qt + D * LD32;                     // [32][D + 1] K, then V
  float* pt = kvr + T32 * mfa::ld_rows32<D>();    // [32][LD32] P^T
  int* qw = reinterpret_cast<int*>(qt);           // [W][LD32] Q words
  int* kw = reinterpret_cast<int*>(kvr);          // [32][W + 1] K words
  __shared__ int s_lo, s_hi;

  const int r0 = blockIdx.x * T32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tx = threadIdx.x % T32;
  const int ty = threadIdx.x / T32;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const long long qoff =
      b * a.q_sb + (h >> 1) * a.q_spair + (h & 1) * a.q_shalf;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  const bool rb = a.flags & ROUND_BF16;
  const bool l_rounded = a.flags & L_ROUNDED;
  const bool p_int8 = a.flags & P_INT8;
  const KVOperand kop_d{a.kq, a.ks, a.kz, a.bits_k, a.k_scales};
  const KVOperand vop_d{a.vq, a.vs, a.vz, a.bits_v, a.v_scales};

  if constexpr (QINT) {  // consecutive threads on consecutive rows
    const int8_t* qh = static_cast<const int8_t*>(a.q) + qoff;
    for (int i = threadIdx.x; i < T32 * W; i += THREADS) {
      const int r = i % T32;
      const int w = i / T32;
      qw[w * LD32 + r] =
          r0 + r < a.Sq
              ? *reinterpret_cast<const int*>(qh + (r0 + r) * a.q_sr + 4 * w)
              : 0;
    }
  } else {  // the natural layout: rows D apart
    mfa::stage32<D, false, false>(static_cast<const float*>(a.q) + qoff, r0,
                                  a.Sq, qt, 0.f);
  }
  key_span<T32>(a.ranges, r0, a.Sq, a.Skv, &s_lo, &s_hi);  // syncs
  const int c_lo = s_lo;
  const int c_hi = s_hi;

  int rs[4], re[4];
  float m[4], l[4], qsr[4], smax[4], acc[4][DE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_range(a.ranges, r, a.Sq, a.Skv, rs[i], re[i]);
    qsr[i] = (QINT && r < a.Sq) ? a.qs[bh * a.Sq + r] : 1.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
    smax[i] = -INFINITY;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[i][e] = 0.f;
  }

  // One 32-key tile t0: the masked, scaled scores; pass 0 only folds them
  // into each row's span max (this thread's column), pass 1 rounds P
  // against the running max and accumulates P.V.
  auto tile = [&](int t0, int pass) {
    float s[4];
    if constexpr (QINT) {
      const size_t rbytes = a.bits_k == 8 ? D : D / 2;
      for (int i = threadIdx.x; i < T32 * W; i += THREADS) {
        const int r = i / W;
        const int w = i % W;
        kw[r * KW_LD + w] =
            t0 + r < c_hi
                ? load_word<D>(a.kq + (bk * a.Skv + t0 + r) * rbytes, w,
                               a.bits_k)
                : 0;
      }
      __syncthreads();
      int si[4] = {0, 0, 0, 0};
      const int* krow = kw + tx * KW_LD;
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        const int4 x = *reinterpret_cast<const int4*>(qw + w * LD32 + ty * 4);
        const int y = krow[w];
        si[0] = __dp4a(x.x, y, si[0]);
        si[1] = __dp4a(x.y, y, si[1]);
        si[2] = __dp4a(x.z, y, si[2]);
        si[3] = __dp4a(x.w, y, si[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = (float)si[i] * qsr[i];
    } else {
      mfa::stage_kv32<D, true>(kop_d, bk, a.Skv, a.br, a.bs, rb, t0, c_hi,
                               kvr);
      __syncthreads();
      mfa::tile_product32<D>(qt, ty, kvr, tx, s);
    }
    __syncthreads();  // every thread is done with K
    if (pass == 1)
      mfa::stage_kv32<D, true>(vop_d, bk, a.Skv, a.br, a.bs, rb, t0, c_hi,
                               kvr);

    const int col = t0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      if (a.k_scales == K_COLUMN && col < a.Skv)
        s[i] *= a.ks[bk * a.Skv + col];
      if (bh_bias && row < a.Sq && col < c_hi)
        s[i] += bh_bias[(size_t)row * a.Skv + col] * LOG2E;
      if (col < rs[i] || col >= re[i]) s[i] = a.mask_value;
      float mx = fmaxf(smax[i], s[i]);
      if (pass == 0) {
        smax[i] = mx;
        continue;
      }
      // A row's 32 scores are the 32 lanes of one warp.
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next);
      float raw, p;
      if (s[i] == -INFINITY) {
        raw = p = 0.f;
      } else if (p_int8) {
        raw = exp2f(s[i] + (LOG2_127 - m_next));
        p = (float)(int)(raw + 0.5f);
      } else {
        raw = p = exp2f(s[i] - m_next);
        if (a.v_scales == V_P && col < a.Skv) p *= a.vs[bk * a.Skv + col];
        if (rb) p = round_bf16(p);
      }
      float sum = l_rounded ? p : raw;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
#pragma unroll
      for (int e = 0; e < DE; ++e) acc[i][e] *= alpha;
      s[i] = p;
    }
    if (pass == 0) return;
    *reinterpret_cast<float4*>(pt + tx * LD32 + ty * 4) =
        make_float4(s[0], s[1], s[2], s[3]);
    __syncthreads();  // V and P^T staged
    mfa::accumulate_pm32<D>(pt, ty, kvr, tx, acc);
    __syncthreads();  // before the next tile overwrites them
  };

  if constexpr (QINT) {
    // Spans of kv_span keys aligned to multiples of it; with a span wider
    // than a tile (an int8 P's) a first pass over the span's tiles takes
    // each row's max before the second computes P against it.
    const int span = a.kv_span == BN && !p_int8 ? T32 : a.kv_span;
    for (int sp0 = (c_lo / span) * span; sp0 < c_hi; sp0 += span) {
      const int t_beg = max(sp0, (c_lo / T32) * T32);
      const int t_end = min(sp0 + span, c_hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) smax[i] = -INFINITY;
      for (int pass = span > T32 ? 0 : 1; pass < 2; ++pass)
        for (int t0 = t_beg; t0 < t_end; t0 += T32) tile(t0, pass);
    }
  } else {
    for (int t0 = (c_lo / T32) * T32; t0 < c_hi; t0 += T32) tile(t0, 1);
  }

  const float l_off = p_int8 ? LN_127 : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= a.Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    float* orow = a.o + qoff + r * a.q_sr;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = tx + 32 * e;
      float out = live ? acc[i][e] / l[i] : 0.f;
      if (a.v_scales == V_STORE) out *= a.vs[bk * D + d];
      orow[d] = out;
    }
    if (tx == 0)
      a.lse[bh * a.Sq + r] =
          live ? m[i] * LN2 + logf(l[i]) - l_off : -INFINITY;
  }
}

// Replaces ops/quantized_attention.py::_qfwd_kernel for an fp32 Q (and an
// int8 Q without ROUND_BF16): qattn_body up to D = 288, qattn_body32 above
// (mfa::scalar32); and _hpack_kernel for an fp32 packed Q.
template <typename QT, int D>
__global__ void __launch_bounds__(THREADS) qattn_fwd_kernel(const Args a) {
  if constexpr (mfa::scalar32<D>())
    qattn_body32<QT, D>(a);
  else
    qattn_body<QT, D>(a);
}

// ---------------------------------------------------------------------------
// The tensor-core body: qattn_fwd_kernel's bf16 and int8 Q instances with
// ROUND_BF16 (every call of the port's forward whose Q is not fp32, and
// the head-pair call for a bf16 packed Q).
//
// One CTA per (64 query rows, b, q head), as the scalar body, with 4 warps
// of 16 query rows each (FlashAttention-2's split: no warp shares a row, so
// the row max and sum reduce over the 4 lanes of a quad).  S and the O
// accumulator live in mma fragments; m and l per fragment row.  Per 64-key
// step of the walk (the same tiles and spans as the scalar body):
//   1. cp.async brings the next step's raw payload rows (int8, or packed
//      int4; K, and V in pass 1) and the per-token scales and zero points
//      the mode reads into the other of two buffers while this step runs;
//      Q was brought once at the start;
//   2. the payload becomes an operand tile in shared memory: K as int8 rows
//      (an int8 Q: used in place when K is int8, unpacked when int4) or as
//      bf16 rows (a bf16 Q: the integers, or stage_kv's dequantized and
//      bf16-rounded values, bit for bit); V as bf16 rows, or for the int8
//      P of P_INT8 over integer V (V_P / V_STORE) as int8 V^T;
//   3. S = Q.K^T on mma.sync: s8 m16n8k32 into int32 (exactly the __dp4a
//      scores, times the row's Q scale) or bf16 m16n8k16 into fp32;
//   4. the element-wise steps in the scalar body's order (K column scale,
//      bias, mask, max, exp2, V_P's scale, the bf16 or int8 rounding of P,
//      l) on the fragments, the mode's branches outside the loops and
//      selects inside; pass 0 of an int8-P span only folds the max, and in
//      pass 1 alpha is 1 after a span's first tile, so O is not rescaled;
//   5. P.V with P taken from the S fragments as the A operand in registers:
//      bf16 m16n8k16 into the fp32 accumulator, or s8 m16n8k32 of the int8
//      P by int8 V into int32 per 64-key tile, added as acc*alpha +
//      float(tile).  The s8 A operand holds a lane's own S columns, so the
//      keys of each 16-key group are permuted (position 4j + i holds key 2j
//      + i for i < 2, 8 + 2j + i - 2 otherwise) and V^T is stored in that
//      order; k is summed over, so the product is unchanged.
// Integer-to-float and float-to-bf16 conversions go through the FP32 and
// integer pipes (mma.cuh): the conversion unit runs at an eighth of their
// rate and would bound the body.  Shared memory rows are padded by 16
// bytes, so ldmatrix's eight row addresses fall in distinct banks.  The
// CTAs walk the row tiles last first (under a causal mask the last walk
// the most keys).  At D=256 the accumulator is 128 fp32 registers a
// thread: two CTAs an SM.
//
// qattn_fwd_wide_kernel: the same body at MLA's D = 288 (qattn_wide), its
// tiles cut as flash_attention.cu cuts flash_fwd_wide_kernel's.
//   - Registers.  O's 16 x 288 fp32 a warp are 144 registers a thread;
//     steps of KS = 32 keys hold S at 16 (64 keys: 32, beside the mode's
//     scales, spans and the products' fragments).  An int8 Q's S takes 9
//     s8 k steps of 32; its int32 sums start from 0 (|S| may pass 2^22).
//   - Spans.  A 32-key step walks the TPU's block_kv spans of an int8 P
//     (P_INT8, kv_span >= 64) in two passes, as the 64-key body walks
//     spans wider than its tile, so the integers of P round against the
//     same row max; the other modes (kv_span = 64) walk single 32-key
//     steps, where P's bf16 rounding against the running max is the only
//     difference the tiles make (within the bf16 gate, as in the flash
//     forward).  The int8 P by int8 V product is one s8 k step a 32-key
//     step.
//   - Shared memory.  A bf16 Q: Q (64 rows, 37,888 bytes), two buffers of
//     the step's K and V payload rows (36,864, unpadded: the conversion
//     reads them a word a lane), the per-token vectors (1,024), one bf16
//     tile each of K and V (37,888): 113,664 bytes, so two CTAs share an
//     SM's 228 KB (8 warps; __launch_bounds__ asks for 2).  An int8 Q: at
//     most 88,064.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

// Whether a tensor-core forward at head dim D takes qattn_fwd_wide_kernel
// (MLA's 288), whose steps are cut to 32 keys.
template <int D>
__host__ __device__ constexpr bool qattn_wide() {
  return D > 256 && D <= 288;
}

// The per-token vectors a step stages beside its payload rows: K's scale
// (TOKEN, COLUMN) and zero point (TOKEN), V's scale (TOKEN, P) and zero
// point (TOKEN).
enum TokVec { TK_SCALE = 0, TK_ZP = 1, TV_SCALE = 2, TV_ZP = 3, TOK_VECS = 4 };

// Byte offsets of the tensor-core body's shared memory.
template <typename QT, int D>
struct TcSmem {
  static constexpr bool QINT = std::is_same<QT, int8_t>::value;
  static constexpr int KS = qattn_wide<D>() ? 32 : BN;  // keys a step
  static constexpr int QB = sizeof(QT);
  static constexpr int Q_LD = D * QB + 16;  // a Q row (int8 or bf16)
  // A raw payload row: padded by 16 bytes (ldmatrix reads it for an int8 Q
  // over int8 K) except for a bf16 Q at D = 288, where those bytes would
  // keep a second CTA off the SM.
  static constexpr int RAW_LD = qattn_wide<D>() && !QINT ? D : D + 16;
  static constexpr int K_LD = D * QB + 16;  // a K operand row
  static constexpr int VB_LD = 2 * D + 16;  // a bf16 V row [key][d]
  static constexpr int VT_LD = KS + 16;     // an int8 V^T row [d][key]
  // tok: two buffers of the step's per-token vectors, TOK_VECS x KS fp32.
  int kraw, vraw, kop, vop, total;
  static constexpr int TOK = BM * Q_LD;
  __host__ __device__ TcSmem(bool k_direct, bool pv_s8) {
    kraw = TOK + 2 * TOK_VECS * KS * 4;
    vraw = kraw + 2 * KS * RAW_LD;
    kop = vraw + 2 * KS * RAW_LD;
    vop = kop + (k_direct ? 0 : KS * K_LD);
    total = vop + (pv_s8 ? D * VT_LD : KS * VB_LD);
  }
};

// P.V runs s8 x s8 for the int8 P over integer V; K is used as staged for
// an int8 Q over int8 K.
__host__ __device__ inline bool tc_pv_s8(int flags, int v_scales) {
  return (flags & P_INT8) && (v_scales == V_P || v_scales == V_STORE);
}

// The walk over one CTA's live keys [c_lo, c_hi): spans of `span` keys
// aligned to multiples of it, each in KS-key tiles, with a first pass
// (pass 0, K only: the span's row max) when span > KS.
template <int KS>
struct Walk {
  int span, c_hi, lo_tile, sp0, t_beg, t_end, pass, t0;
  __device__ void start_span() {
    t_beg = max(sp0, lo_tile);
    t_end = min(sp0 + span, c_hi);
    pass = span > KS ? 0 : 1;
    t0 = t_beg;
  }
  __device__ Walk(int span_, int c_lo, int c_hi_)
      : span(span_), c_hi(c_hi_), lo_tile((c_lo / KS) * KS),
        sp0((c_lo / span_) * span_) {
    if (live()) start_span();
  }
  __device__ bool live() const { return sp0 < c_hi; }
  // The first tile of a span's first pass: the span's max starts anew.
  __device__ bool fresh() const {
    return t0 == t_beg && pass == (span > KS ? 0 : 1);
  }
  __device__ void advance() {
    t0 += KS;
    if (t0 < t_end) return;
    if (pass == 0) {
      pass = 1;
      t0 = t_beg;
    } else {
      sp0 += span;
      if (live()) start_span();
    }
  }
};

// cp.async the per-token vectors of keys [t0, t0 + KS) of kv head `head`
// that the mode reads into tok[v * KS + r]; zeros from `limit`; NT threads.
template <int KS, int NT = TC_THREADS>
__device__ __forceinline__ void stage_tok(const Args& a, size_t head, int t0,
                                          int limit, float* tok) {
  constexpr int N = TOK_VECS * KS;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (N % NT && i >= N) break;
    const int v = i / KS;
    const int r = i % KS;
    const bool need =
        v == TK_SCALE ? a.k_scales == K_TOKEN || a.k_scales == K_COLUMN
        : v == TK_ZP  ? a.k_scales == K_TOKEN
        : v == TV_SCALE ? a.v_scales == V_TOKEN || a.v_scales == V_P
                        : a.v_scales == V_TOKEN;
    if (!need) continue;
    const float* src = v == TK_SCALE ? a.ks
                       : v == TK_ZP  ? a.kz
                       : v == TV_SCALE ? a.vs
                                       : a.vz;
    const bool ok = t0 + r < limit;
    mfa::cp_async4(tok + i, src + head * a.Skv + (ok ? t0 + r : 0),
                   ok ? 4 : 0);
  }
}

// The values [4w, 4w + 4) of payload row t, read as the int8 word `word`,
// as stage_kv stages them with rounding to bf16 (bit for bit): the
// integers, or dequantized in op.mode (TOKEN, with the row's scale and
// zero point ts, tz; BLOCK2D; the forward's other modes keep the
// integers), as two bf16x2 registers.  Its conversions run on the FP32 and
// integer pipes (mma.cuh).
template <int D>
__device__ __forceinline__ uint2 dequant_bf16(const KVOperand& op,
                                              size_t head, int Skv, int br,
                                              int bs, int t, int w, int word,
                                              float ts, float tz) {
  const uint32_t x = (uint32_t)word ^ 0x80808080u;
  float f[4] = {mfa::s8_f32<0>(x), mfa::s8_f32<1>(x), mfa::s8_f32<2>(x),
                mfa::s8_f32<3>(x)};
  if (op.mode == mfa::DQ_TOKEN) {
    const float s = ts;
    const float z = tz;
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __fmul_rn(f[e] - z, s);
  } else if (op.mode == mfa::DQ_BLOCK2D) {
    const size_t cell =
        (head * (Skv / br) + t / br) * (size_t)((D + bs - 1) / bs);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t c = cell + (4 * w + e) / bs;
      const float s = op.sc[c];
      f[e] = __fmul_rn(f[e], s) - __fmul_rn(op.zp[c], s);
    }
  }
  return make_uint2(__byte_perm(mfa::bf16_bits(f[0]), mfa::bf16_bits(f[1]),
                                0x7632),
                    __byte_perm(mfa::bf16_bits(f[2]), mfa::bf16_bits(f[3]),
                                0x7632));
}

// Raw payload rows (KS keys) -> bf16 rows [key][d] (dst_ld bytes apart):
// dequant_bf16's values, zeros from `limit`; ts, tz the staged per-token
// scale and zero point; NT threads.
template <int D, int RAW_LD, int KS, int NT = TC_THREADS>
__device__ __forceinline__ void convert_bf16(const KVOperand& op,
                                             const uint8_t* raw, size_t head,
                                             int Skv, int br, int bs, int t0,
                                             int limit, const float* ts,
                                             const float* tz, uint8_t* dst,
                                             int dst_ld) {
  constexpr int W = D / 4;
  static_assert(KS * W % NT == 0, "whole items a thread");
#pragma unroll 2
  for (int it = 0; it < KS * W / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / W;
    const int w = i % W;
    *reinterpret_cast<uint2*>(dst + r * dst_ld + 8 * w) =
        t0 + r < limit
            ? dequant_bf16<D>(op, head, Skv, br, bs, t0 + r, w,
                              load_word<D>(raw + r * RAW_LD, w, op.bits),
                              ts[r], tz[r])
            : make_uint2(0u, 0u);
  }
}

// Raw payload rows (KS keys) -> int8 rows [key][d] (int4 unpacked), zeros
// from `limit`; NT threads.
template <int D, int RAW_LD, int DST_LD, int KS, int NT = TC_THREADS>
__device__ __forceinline__ void convert_s8(const uint8_t* raw, int bits,
                                           int t0, int limit, uint8_t* dst) {
  constexpr int W = D / 4;
  static_assert(KS * W % NT == 0, "whole items a thread");
#pragma unroll 2
  for (int it = 0; it < KS * W / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / W;
    const int w = i % W;
    *reinterpret_cast<int*>(dst + r * DST_LD + 4 * w) =
        t0 + r < limit ? load_word<D>(raw + r * RAW_LD, w, bits) : 0;
  }
}

// Raw payload rows (KS keys) -> int8 V^T [d][key position] (VT_LD bytes a
// row), keys permuted within each 16-key group as the s8 P operand holds
// them; NT threads.
template <int D, int RAW_LD, int VT_LD, int KS, int NT = TC_THREADS>
__device__ __forceinline__ void convert_vt(const uint8_t* raw, int bits,
                                           int t0, int limit, uint8_t* dst) {
  constexpr int W = D / 4;
  constexpr int QUADS = KS / 4;  // 4-position groups a row
  constexpr int N = QUADS * W;   // items
#pragma unroll 2
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (N % NT && i >= N) break;
    const int quad = i % QUADS;  // positions [4 quad, 4 quad + 4)
    const int w = i / QUADS;     // (neighbouring threads store to one row)
    const int k0 = 16 * (quad >> 2) + 2 * (quad & 3);
    const int keys[4] = {k0, k0 + 1, k0 + 8, k0 + 9};
    unsigned x[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = t0 + keys[j] < limit
                 ? (unsigned)load_word<D>(raw + keys[j] * RAW_LD, w, bits)
                 : 0u;
    mfa::transpose_bytes(x, y);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<unsigned*>(dst + (4 * w + e) * VT_LD + 4 * quad) =
          y[e];
  }
}

// The tensor-core body (the kernels below wrap it).  Bound: operations
// (4*D per live pair, int8 or bf16).
template <typename QT, int D>
__device__ __forceinline__ void qattn_tc_body(const Args& a) {
  constexpr bool QINT = std::is_same<QT, int8_t>::value;
  using L = TcSmem<QT, D>;
  constexpr int KS = L::KS;    // keys a step
  constexpr int NKB = KS / 8;  // 8-key blocks of S
  constexpr int NB = D / 8;    // 8-column blocks of O
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ int s_lo, s_hi;

  const bool p_int8 = a.flags & P_INT8;
  const bool l_rounded = a.flags & L_ROUNDED;
  const bool pv_s8 = tc_pv_s8(a.flags, a.v_scales);
  const bool k_direct = QINT && a.bits_k == 8;
  const L lay(k_direct, pv_s8);
  uint8_t* qsm = sm;
  float* tok = reinterpret_cast<float*>(sm + L::TOK);
  uint8_t* kraw = sm + lay.kraw;
  uint8_t* vraw = sm + lay.vraw;
  uint8_t* kop = sm + lay.kop;
  uint8_t* vop = sm + lay.vop;

  // The last row tiles first: under a causal mask they walk the most keys.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const long long qoff =
      b * a.q_sb + (h >> 1) * a.q_spair + (h & 1) * a.q_shalf;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;

  {  // Q rows [r0, r0 + 64), zeros from Sq
    constexpr int CPR = D * L::QB / 16;
    const uint8_t* qg = static_cast<const uint8_t*>(a.q);
    for (int i = tid; i < BM * CPR; i += TC_THREADS) {
      const int r = i / CPR;
      const int c = i % CPR;
      const bool ok = r0 + r < a.Sq;
      mfa::cp_async16(
          qsm + r * L::Q_LD + c * 16,
          qg + (size_t)(qoff + (long long)(ok ? r0 + r : 0) * a.q_sr) * L::QB +
              c * 16,
          ok ? 16 : 0);
    }
  }
  key_span(a.ranges, r0, a.Sq, a.Skv, &s_lo, &s_hi);
  const int c_hi = s_hi;

  int row[2], rs[2], re[2];
  float m[2], l[2], qsr[2], smax[2], acc[NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + warp * 16 + g + 8 * i;
    row_range(a.ranges, row[i], a.Sq, a.Skv, rs[i], re[i]);
    qsr[i] = (QINT && row[i] < a.Sq) ? a.qs[bh * a.Sq + row[i]] : 1.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
    smax[i] = -INFINITY;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const KVOperand kop_d{a.kq, a.ks, a.kz, a.bits_k, a.k_scales};
  const KVOperand vop_d{a.vq, a.vs, a.vz, a.bits_v, a.v_scales};
  auto prefetch = [&](const Walk<KS>& w, int buf) {
    stage_tok<KS>(a, bk, w.t0, c_hi, tok + buf * TOK_VECS * KS);
    mfa::stage_raw<D, L::RAW_LD, TC_THREADS, KS>(
        a.kq, a.bits_k, bk, a.Skv, w.t0, c_hi, kraw + buf * KS * L::RAW_LD);
    if (w.pass == 1)
      mfa::stage_raw<D, L::RAW_LD, TC_THREADS, KS>(
          a.vq, a.bits_v, bk, a.Skv, w.t0, c_hi,
          vraw + buf * KS * L::RAW_LD);
  };

  // Spans of kv_span keys; a narrower step than BN walks BN-key spans
  // (every mode but the int8 P's) in single steps.
  const int span = KS < BN && a.kv_span == BN && !p_int8 ? KS : a.kv_span;
  Walk<KS> w(span, s_lo, c_hi);
  int buf = 0;
  if (w.live()) prefetch(w, 0);
  mfa::cp_async_commit();  // Q and the first step
  while (w.live()) {
    const Walk<KS> cur = w;
    w.advance();
    mfa::cp_async_wait<0>();
    __syncthreads();  // this step staged; the last one's readers done
    const uint8_t* kr = kraw + buf * KS * L::RAW_LD;
    const uint8_t* vr = vraw + buf * KS * L::RAW_LD;
    const float* tk = tok + buf * TOK_VECS * KS;
    buf ^= 1;
    if (w.live()) prefetch(w, buf);
    mfa::cp_async_commit();
    if constexpr (QINT) {
      if (!k_direct)
        convert_s8<D, L::RAW_LD, L::K_LD, KS>(kr, a.bits_k, cur.t0, c_hi,
                                              kop);
    } else {
      convert_bf16<D, L::RAW_LD, KS>(kop_d, kr, bk, a.Skv, a.br, a.bs,
                                     cur.t0, c_hi, tk + TK_SCALE * KS,
                                     tk + TK_ZP * KS, kop, L::K_LD);
    }
    if (cur.pass == 1) {
      if (pv_s8)
        convert_vt<D, L::RAW_LD, L::VT_LD, KS>(vr, a.bits_v, cur.t0, c_hi,
                                               vop);
      else
        convert_bf16<D, L::RAW_LD, KS>(vop_d, vr, bk, a.Skv, a.br, a.bs,
                                       cur.t0, c_hi, tk + TV_SCALE * KS,
                                       tk + TV_ZP * KS, vop, L::VB_LD);
    }
    if (!k_direct || cur.pass == 1) __syncthreads();  // operand tiles ready

    // S = Q.K^T for this warp's 16 rows and the step's KS keys.
    float s[NKB][4];
    {
      const uint8_t* kt = k_direct ? kr : kop;
      const int k_ld = k_direct ? L::RAW_LD : L::K_LD;
      const uint8_t* qp = qsm + (warp * 16 + mfa::ldsm_a_row(lane)) * L::Q_LD +
                          mfa::ldsm_a_byte(lane);
      const uint8_t* kp =
          kt + mfa::ldsm_b_row(lane) * k_ld + mfa::ldsm_b_byte(lane);
      if constexpr (QINT) {
        // |S| < 2^22 for D <= 128: summed from mma.cuh's I32_BIAS.
        constexpr int S0 = D <= 128 ? mfa::I32_BIAS : 0;
        int si[NKB][4];
#pragma unroll
        for (int j = 0; j < NKB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) si[j][e] = S0;
#pragma unroll
        for (int kc = 0; kc < D / 32; ++kc) {
          uint32_t af[4];
          mfa::ldsm_x4(af, qp + kc * 32);
#pragma unroll
          for (int j2 = 0; j2 < NKB / 2; ++j2) {
            uint32_t bf[4];
            mfa::ldsm_x4(bf, kp + j2 * 16 * k_ld + kc * 32);
            mfa::mma_s8(si[2 * j2], af, bf[0], bf[1], si[2 * j2]);
            mfa::mma_s8(si[2 * j2 + 1], af, bf[2], bf[3], si[2 * j2 + 1]);
          }
        }
#pragma unroll
        for (int j = 0; j < NKB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = (S0 ? mfa::biased_f32(si[j][e]) : (float)si[j][e]) *
                      qsr[e >> 1];
      } else {
#pragma unroll
        for (int j = 0; j < NKB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t af[4];
          mfa::ldsm_x4(af, qp + kc * 32);
#pragma unroll
          for (int j2 = 0; j2 < NKB / 2; ++j2) {
            uint32_t bf[4];
            mfa::ldsm_x4(bf, kp + j2 * 16 * k_ld + kc * 32);
            mfa::mma_bf16(s[2 * j2], af, bf[0], bf[1], s[2 * j2]);
            mfa::mma_bf16(s[2 * j2 + 1], af, bf[2], bf[3], s[2 * j2 + 1]);
          }
        }
      }
    }

    // The scalar body's element-wise steps, in its order; the mode's
    // branches outside the loops over the fragment, selects inside.
    if (cur.fresh()) smax[0] = smax[1] = -INFINITY;
    if (a.k_scales == K_COLUMN) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = cur.t0 + 8 * j + 2 * tq + c;
          const float cs = tk[TK_SCALE * KS + 8 * j + 2 * tq + c];
          if (col < a.Skv) {
            s[j][c] *= cs;
            s[j][2 + c] *= cs;
          }
        }
    }
    if (bh_bias) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = cur.t0 + 8 * j + 2 * tq + c;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (row[i] < a.Sq && col < c_hi)
              s[j][2 * i + c] +=
                  bh_bias[(size_t)row[i] * a.Skv + col] * LOG2E;
        }
    }
    float mx[2] = {smax[0], smax[1]};
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = cur.t0 + 8 * j + 2 * tq + c;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[j][2 * i + c];
          x = (col < rs[i] || col >= re[i]) ? a.mask_value : x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    if (cur.pass == 0) {
      smax[0] = mx[0];
      smax[1] = mx[1];
      continue;
    }
    float alpha[2], m_next[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_next[i] = fmaxf(m[i], mx[i]);
      alpha[i] = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next[i]);
    }
    // P = 2^(s - m) (mma.cuh's ex2_approx).  A row whose max is still
    // -inf (every score -inf) subtracts 0 instead, so its P is 0, not NaN.
    const float mref[2] = {m_next[0] == -INFINITY ? 0.f : m_next[0],
                           m_next[1] == -INFINITY ? 0.f : m_next[1]};
    if (p_int8) {  // (float)(int)(raw + 0.5f), raw < 2^23
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float raw = mfa::ex2_approx(x + (LOG2_127 - mref[e >> 1]));
          const float p = __fadd_rz(raw + 0.5f, 8388608.0f) - 8388608.0f;
          sum[e >> 1] += l_rounded ? p : raw;
          s[j][e] = p;
        }
    } else {
      const bool v_p = a.v_scales == V_P;
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = cur.t0 + 8 * j + 2 * tq + c;
          const float vsc = v_p && col < a.Skv
                                ? tk[TV_SCALE * KS + 8 * j + 2 * tq + c]
                                : 1.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float x = s[j][2 * i + c];
            const float raw = mfa::ex2_approx(x - mref[i]);
            const float p = __uint_as_float(mfa::bf16_bits(raw * vsc));
            sum[i] += l_rounded ? p : raw;
            s[j][2 * i + c] = p;
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = alpha[i] * l[i] + sum[i];
      m[i] = m_next[i];
    }
    // alpha is 1 after a span's first tile (its max came from pass 0).
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[nb][0] *= alpha[0];
        acc[nb][1] *= alpha[0];
        acc[nb][2] *= alpha[1];
        acc[nb][3] *= alpha[1];
      }
    }

    // O += P.V, P from the S fragments.
    if (pv_s8) {
      constexpr int KK = KS / 32;  // s8 k steps a step
      uint32_t pa[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int j = 4 * kk;
        // P is an integer in [0, 127]: the low byte of P + 2^23's bits.
        constexpr float B23 = 8388608.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r)  // a0 / a1: keys of blocks j, j + 1
          pa[kk][r] = mfa::low_bytes(s[j][2 * r] + B23, s[j][2 * r + 1] + B23,
                                     s[j + 1][2 * r] + B23,
                                     s[j + 1][2 * r + 1] + B23);
#pragma unroll
        for (int r = 0; r < 2; ++r)  // a2 / a3: blocks j + 2, j + 3
          pa[kk][2 + r] = mfa::low_bytes(
              s[j + 2][2 * r] + B23, s[j + 2][2 * r + 1] + B23,
              s[j + 3][2 * r] + B23, s[j + 3][2 * r + 1] + B23);
      }
      const uint8_t* vt =
          vop + mfa::ldsm_b_row(lane) * L::VT_LD + mfa::ldsm_b_byte(lane);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t b[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          mfa::ldsm_x4(b[kk], vt + n2 * 16 * L::VT_LD + 32 * kk);
        // |P.V| <= 64 * 127 * 128 < 2^22: summed from I32_BIAS, as above.
        constexpr int M0 = mfa::I32_BIAS;
        int c0[4] = {M0, M0, M0, M0}, c1[4] = {M0, M0, M0, M0};
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          mfa::mma_s8(c0, pa[kk], b[kk][0], b[kk][1], c0);
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          mfa::mma_s8(c1, pa[kk], b[kk][2], b[kk][3], c1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * n2][e] += mfa::biased_f32(c0[e]);
          acc[2 * n2 + 1][e] += mfa::biased_f32(c1[e]);
        }
      }
    } else {
      const uint8_t* vb = vop + mfa::ldsm_t_k(lane) * L::VB_LD +
                          mfa::ldsm_t_n(lane) * 2;
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const int j = 2 * kk;
        // P is exact in bf16: rounded to it, or an integer up to 127.
        const uint32_t pa[4] = {
            mfa::pack_bf16_exact(s[j][0], s[j][1]),
            mfa::pack_bf16_exact(s[j][2], s[j][3]),
            mfa::pack_bf16_exact(s[j + 1][0], s[j + 1][1]),
            mfa::pack_bf16_exact(s[j + 1][2], s[j + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          uint32_t bf[4];
          mfa::ldsm_x4_t(bf, vb + kk * 16 * L::VB_LD + n2 * 32);
          mfa::mma_bf16(acc[2 * n2], pa, bf[0], bf[1], acc[2 * n2]);
          mfa::mma_bf16(acc[2 * n2 + 1], pa, bf[2], bf[3], acc[2 * n2 + 1]);
        }
      }
    }
  }
  mfa::cp_async_wait<0>();

  const float l_off = p_int8 ? LN_127 : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    float* orow = a.o + qoff + (long long)row[i] * a.q_sr;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int d = 8 * nb + 2 * tq;
      float o0 = live ? acc[nb][2 * i] / l[i] : 0.f;
      float o1 = live ? acc[nb][2 * i + 1] / l[i] : 0.f;
      if (a.v_scales == V_STORE) {
        o0 *= a.vs[bk * D + d];
        o1 *= a.vs[bk * D + d + 1];
      }
      *reinterpret_cast<float2*>(orow + d) = make_float2(o0, o1);
    }
    if (tq == 0)
      a.lse[bh * a.Sq + row[i]] =
          live ? m[i] * LN2 + logf(l[i]) - l_off : -INFINITY;
  }
}

// Replaces ops/quantized_attention.py::_qfwd_kernel for a bf16 or int8 Q
// with ROUND_BF16 up to D = 256, and _hpack_kernel for a bf16 packed Q
// (D = 64).
template <typename QT, int D>
__global__ void __launch_bounds__(TC_THREADS)
    qattn_fwd_tc_kernel(const Args a) {
  qattn_tc_body<QT, D>(a);
}

// Replaces ops/quantized_attention.py::_qfwd_kernel for a bf16 or int8 Q
// with ROUND_BF16 at D = 288 (qattn_wide): 32-key steps, two CTAs an SM.
template <typename QT, int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    qattn_fwd_wide_kernel(const Args a) {
  qattn_tc_body<QT, D>(a);
}

// ---------------------------------------------------------------------------
// qattn_fwd_latent_kernel: the tensor-core body at DeepSeek's absorbed
// D = 576 (qattn_latent), the same function at the same rounding points as
// qattn_tc_body in every mode (int8 / int4 payloads; TOKEN, COLUMN,
// BLOCK2D, P and STORE scales; an int8 Q and the int8 P over block_kv
// spans with their first pass; bias, masks, GQA), for any K and V (no zero
// tail of V is assumed).
//   - Why qattn_fwd_wide_kernel's body does not stretch: 4 warps x 16 rows
//     hold O's 16 x 576 fp32 in 288 registers a thread, past the 255 a
//     thread may have.  So the body takes flash_fwd_latent_kernel's frame:
//     8 warps; warp w holds rows r0 + 16 (w % 4) + [0, 16) of O and lanes
//     288 (w / 4) + [0, 288) (144 registers a thread).  The two warps of a
//     row slab split each 32-key step's scores: each computes S over its
//     16 keys and all 576 lanes, they trade row maxima and row sums through
//     shared memory under a named barrier (one a slab), and each writes its
//     half of the slab's P tile, which both read as the A operand of
//     O += P.V over their own lanes: bf16 P [16][32 keys], or for the int8
//     P over integer V int8 P [16][32 positions], each warp's 16 keys one
//     16-key group in convert_vt's permuted order (the word a lane of the
//     288 body packs from its S fragments), against V^T in that order.
//   - Steps and spans as in qattn_fwd_wide_kernel (32 keys; an int8 P's
//     spans in two passes, pass 0 folding each warp's half of the span's
//     row max, which pass 1 exchanges with the first step's).
//   - Shared memory (bf16 Q, 230,400 bytes): Q (64 rows, 74,752), the
//     per-token vectors (1,024), two buffers of the step's K and V payload
//     rows (73,728), one bf16 tile each of K and V (74,752), the slabs' P
//     tiles (5,120) and exchanged row statistics (1,024): one CTA an SM.
//     An int8 Q at most 177,152.
//   - The grid stays one CTA per (64 query rows, b, q head): 1,024 CTAs at
//     DeepSeek-V2-Lite's training shape (B=2, Hq=16, S=2048).
// ---------------------------------------------------------------------------

constexpr int LATENT_THREADS = 256;  // 4 row slabs x 2 lane halves

// Whether a tensor-core forward at head dim D takes qattn_fwd_latent_kernel
// (DeepSeek's 576), whose O lanes are split over two warp groups.
template <int D>
__host__ __device__ constexpr bool qattn_latent() {
  return D > 288;
}

// Byte offsets of qattn_fwd_latent_kernel's shared memory.
template <typename QT, int D>
struct LatentSmem {
  static constexpr bool QINT = std::is_same<QT, int8_t>::value;
  static constexpr int KS = 32;             // keys a step
  static constexpr int HALF = D / 2;        // O lanes a warp holds
  static constexpr int QB = sizeof(QT);
  static constexpr int Q_LD = D * QB + 16;  // a Q row (int8 or bf16)
  // A raw payload row: padded by 16 bytes where ldmatrix reads it (an int8
  // Q over int8 K), else not (a bf16 Q's 230,400 bytes have no room).
  static constexpr int RAW_LD = QINT ? D + 16 : D;
  static constexpr int K_LD = D * QB + 16;  // a K operand row
  static constexpr int VB_LD = 2 * D + 16;  // a bf16 V row [key][d]
  static constexpr int VT_LD = KS + 16;     // an int8 V^T row [d][key]
  static constexpr int P_LD = 2 * KS + 16;  // a P row (bf16, or int8)
  static constexpr int TOK = BM * Q_LD;
  int kraw, vraw, kop, vop, p, red, total;
  __host__ __device__ LatentSmem(bool k_direct, bool pv_s8) {
    kraw = TOK + 2 * TOK_VECS * KS * 4;
    vraw = kraw + 2 * KS * RAW_LD;
    kop = vraw + 2 * KS * RAW_LD;
    vop = kop + (k_direct ? 0 : KS * K_LD);
    p = vop + (pv_s8 ? D * VT_LD : KS * VB_LD);  // [4 slabs][16][P_LD]
    red = p + 4 * 16 * P_LD;  // [4 slabs][2 warps][max, sum][16] fp32
    total = red + 4 * 2 * 2 * 16 * 4;
  }
  static_assert(HALF % 16 == 0, "a warp's lanes are whole 16-wide steps");
};

// Replaces ops/quantized_attention.py::_qfwd_kernel for a bf16 or int8 Q
// with ROUND_BF16 above D = 288 (qattn_latent; see above).  Bound:
// operations (4*D per live pair, int8 or bf16).
template <typename QT, int D>
__global__ void __launch_bounds__(LATENT_THREADS, 1)
    qattn_fwd_latent_kernel(const Args a) {
  constexpr bool QINT = std::is_same<QT, int8_t>::value;
  using L = LatentSmem<QT, D>;
  constexpr int NT = LATENT_THREADS;
  constexpr int KS = L::KS;
  constexpr int NB = L::HALF / 8;  // 8-lane blocks of O a warp holds
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ int s_lo, s_hi;

  const bool p_int8 = a.flags & P_INT8;
  const bool l_rounded = a.flags & L_ROUNDED;
  const bool pv_s8 = tc_pv_s8(a.flags, a.v_scales);
  const bool k_direct = QINT && a.bits_k == 8;
  const L lay(k_direct, pv_s8);
  uint8_t* qsm = sm;
  float* tok = reinterpret_cast<float*>(sm + L::TOK);
  uint8_t* kraw = sm + lay.kraw;
  uint8_t* vraw = sm + lay.vraw;
  uint8_t* kop = sm + lay.kop;
  uint8_t* vop = sm + lay.vop;

  // The last row tiles first: under a causal mask they walk the most keys.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = a.interleaved ? h % a.Hkv : h / (a.Hq / a.Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = warp & 3;   // rows r0 + 16 slab + [0, 16)
  const int half = warp >> 2;  // keys 16 half + [0, 16) of a step in S,
                               // lanes HALF half + [0, HALF) of O
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int k0 = 16 * half;
  const size_t bh = (size_t)b * a.Hq + h;
  const size_t bk = (size_t)b * a.Hkv + hk;
  const long long qoff =
      b * a.q_sb + (h >> 1) * a.q_spair + (h & 1) * a.q_shalf;
  const float* bh_bias =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  uint8_t* sp = sm + lay.p + slab * 16 * L::P_LD;
  // This slab's [warp half][max, sum][16 rows].
  float* red = reinterpret_cast<float*>(sm + lay.red) + slab * 64;

  {  // Q rows [r0, r0 + 64), zeros from Sq
    constexpr int CPR = D * L::QB / 16;
    const uint8_t* qg = static_cast<const uint8_t*>(a.q);
    for (int i = threadIdx.x; i < BM * CPR; i += NT) {
      const int r = i / CPR;
      const int c = i % CPR;
      const bool ok = r0 + r < a.Sq;
      mfa::cp_async16(
          qsm + r * L::Q_LD + c * 16,
          qg + (size_t)(qoff + (long long)(ok ? r0 + r : 0) * a.q_sr) * L::QB +
              c * 16,
          ok ? 16 : 0);
    }
  }
  key_span(a.ranges, r0, a.Sq, a.Skv, &s_lo, &s_hi);
  const int c_hi = s_hi;

  int row[2], rs[2], re[2];
  float m[2], l[2], qsr[2], smax[2], acc[NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + slab * 16 + g + 8 * i;
    row_range(a.ranges, row[i], a.Sq, a.Skv, rs[i], re[i]);
    qsr[i] = (QINT && row[i] < a.Sq) ? a.qs[bh * a.Sq + row[i]] : 1.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
    smax[i] = -INFINITY;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const KVOperand kop_d{a.kq, a.ks, a.kz, a.bits_k, a.k_scales};
  const KVOperand vop_d{a.vq, a.vs, a.vz, a.bits_v, a.v_scales};
  auto prefetch = [&](const Walk<KS>& w, int buf) {
    stage_tok<KS, NT>(a, bk, w.t0, c_hi, tok + buf * TOK_VECS * KS);
    mfa::stage_raw<D, L::RAW_LD, NT, KS>(a.kq, a.bits_k, bk, a.Skv, w.t0,
                                         c_hi, kraw + buf * KS * L::RAW_LD);
    if (w.pass == 1)
      mfa::stage_raw<D, L::RAW_LD, NT, KS>(a.vq, a.bits_v, bk, a.Skv, w.t0,
                                           c_hi,
                                           vraw + buf * KS * L::RAW_LD);
  };

  // Spans of kv_span keys; every mode but the int8 P's walks single steps.
  const int span = a.kv_span == BN && !p_int8 ? KS : a.kv_span;
  Walk<KS> w(span, s_lo, c_hi);
  int buf = 0;
  if (w.live()) prefetch(w, 0);
  mfa::cp_async_commit();  // Q and the first step
  while (w.live()) {
    const Walk<KS> cur = w;
    w.advance();
    mfa::cp_async_wait<0>();
    __syncthreads();  // this step staged; the last one's readers done
    const uint8_t* kr = kraw + buf * KS * L::RAW_LD;
    const uint8_t* vr = vraw + buf * KS * L::RAW_LD;
    const float* tk = tok + buf * TOK_VECS * KS;
    buf ^= 1;
    if (w.live()) prefetch(w, buf);
    mfa::cp_async_commit();
    if constexpr (QINT) {
      if (!k_direct)
        convert_s8<D, L::RAW_LD, L::K_LD, KS, NT>(kr, a.bits_k, cur.t0, c_hi,
                                                  kop);
    } else {
      convert_bf16<D, L::RAW_LD, KS, NT>(kop_d, kr, bk, a.Skv, a.br, a.bs,
                                         cur.t0, c_hi, tk + TK_SCALE * KS,
                                         tk + TK_ZP * KS, kop, L::K_LD);
    }
    if (cur.pass == 1) {
      if (pv_s8)
        convert_vt<D, L::RAW_LD, L::VT_LD, KS, NT>(vr, a.bits_v, cur.t0,
                                                   c_hi, vop);
      else
        convert_bf16<D, L::RAW_LD, KS, NT>(vop_d, vr, bk, a.Skv, a.br, a.bs,
                                           cur.t0, c_hi, tk + TV_SCALE * KS,
                                           tk + TV_ZP * KS, vop, L::VB_LD);
    }
    if (!k_direct || cur.pass == 1) __syncthreads();  // operand tiles ready

    // S = Q.K^T for this slab's 16 rows and this warp's 16 keys: element
    // (row[i], key cur.t0 + k0 + 8j + 2tq + c) at s[j][2i + c].
    float s[2][4];
    {
      const uint8_t* kt = k_direct ? kr : kop;
      const int k_ld = k_direct ? L::RAW_LD : L::K_LD;
      const uint8_t* qp = qsm +
                          (slab * 16 + mfa::ldsm_a_row(lane)) * L::Q_LD +
                          mfa::ldsm_a_byte(lane);
      const uint8_t* kp =
          kt + (k0 + mfa::ldsm_b_row(lane)) * k_ld + mfa::ldsm_b_byte(lane);
      if constexpr (QINT) {
        int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};  // |S| may pass 2^22
#pragma unroll 6
        for (int kc = 0; kc < D / 32; ++kc) {
          uint32_t af[4], bf[4];
          mfa::ldsm_x4(af, qp + kc * 32);
          mfa::ldsm_x4(bf, kp + kc * 32);
          mfa::mma_s8(si[0], af, bf[0], bf[1], si[0]);
          mfa::mma_s8(si[1], af, bf[2], bf[3], si[1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = (float)si[j][e] * qsr[e >> 1];
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 6
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t af[4], bf[4];
          mfa::ldsm_x4(af, qp + kc * 32);
          mfa::ldsm_x4(bf, kp + kc * 32);
          mfa::mma_bf16(s[0], af, bf[0], bf[1], s[0]);
          mfa::mma_bf16(s[1], af, bf[2], bf[3], s[1]);
        }
      }
    }

    // The scalar body's element-wise steps, in its order.
    if (cur.fresh()) smax[0] = smax[1] = -INFINITY;
    if (a.k_scales == K_COLUMN) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kk = k0 + 8 * j + 2 * tq + c;
          const float cs = tk[TK_SCALE * KS + kk];
          if (cur.t0 + kk < a.Skv) {
            s[j][c] *= cs;
            s[j][2 + c] *= cs;
          }
        }
    }
    if (bh_bias) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = cur.t0 + k0 + 8 * j + 2 * tq + c;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (row[i] < a.Sq && col < c_hi)
              s[j][2 * i + c] +=
                  bh_bias[(size_t)row[i] * a.Skv + col] * LOG2E;
        }
    }
    float mx[2] = {smax[0], smax[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = cur.t0 + k0 + 8 * j + 2 * tq + c;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[j][2 * i + c];
          x = (col < rs[i] || col >= re[i]) ? a.mask_value : x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    if (cur.pass == 0) {  // this warp's half of the span's row max
      smax[0] = mx[0];
      smax[1] = mx[1];
      continue;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (tq == 0) red[half * 32 + g + 8 * i] = mx[i];
    }
    mfa::named_barrier(1 + slab, 64);  // both warps' row maxima
    float alpha[2], m_next[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      m_next[i] = fmaxf(m[i], fmaxf(red[r], red[32 + r]));
      alpha[i] = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_next[i]);
    }
    // P = 2^(s - m) (mma.cuh's ex2_approx).  A row whose max is still
    // -inf (every score -inf) subtracts 0 instead, so its P is 0, not NaN.
    const float mref[2] = {m_next[0] == -INFINITY ? 0.f : m_next[0],
                           m_next[1] == -INFINITY ? 0.f : m_next[1]};
    if (p_int8) {  // (float)(int)(raw + 0.5f), raw < 2^23
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float raw =
              mfa::ex2_approx(s[j][e] + (LOG2_127 - mref[e >> 1]));
          const float p = __fadd_rz(raw + 0.5f, 8388608.0f) - 8388608.0f;
          sum[e >> 1] += l_rounded ? p : raw;
          s[j][e] = p;
        }
    } else {
      const bool v_p = a.v_scales == V_P;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kk = k0 + 8 * j + 2 * tq + c;
          const float vsc = v_p && cur.t0 + kk < a.Skv
                                ? tk[TV_SCALE * KS + kk]
                                : 1.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float raw = mfa::ex2_approx(s[j][2 * i + c] - mref[i]);
            const float p = __uint_as_float(mfa::bf16_bits(raw * vsc));
            sum[i] += l_rounded ? p : raw;
            s[j][2 * i + c] = p;
          }
        }
    }
    // This warp's half of the slab's P tile: P is exact in bf16 (rounded
    // to it, or an integer up to 127); the int8 P as the bytes of
    // P + 2^23, one word a row in convert_vt's key order.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (pv_s8) {
        constexpr float B23 = 8388608.0f;
        *reinterpret_cast<uint32_t*>(sp + (g + 8 * i) * L::P_LD + k0 +
                                     4 * tq) =
            mfa::low_bytes(s[0][2 * i] + B23, s[0][2 * i + 1] + B23,
                           s[1][2 * i] + B23, s[1][2 * i + 1] + B23);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<uint32_t*>(sp + (g + 8 * i) * L::P_LD +
                                       2 * (k0 + 8 * j + 2 * tq)) =
              mfa::pack_bf16_exact(s[j][2 * i], s[j][2 * i + 1]);
      }
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
    // alpha is 1 after a span's first step (its max came from pass 0).
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[nb][0] *= alpha[0];
        acc[nb][1] *= alpha[0];
        acc[nb][2] *= alpha[1];
        acc[nb][3] *= alpha[1];
      }
    }

    // O += P.V over this warp's lanes, P from the slab's tile.
    const uint8_t* pa_p =
        sp + mfa::ldsm_a_row(lane) * L::P_LD + mfa::ldsm_a_byte(lane);
    if (pv_s8) {
      uint32_t pa[4];
      mfa::ldsm_x4(pa, pa_p);  // one s8 k step: the step's 32 positions
      const uint8_t* vt = vop +
                          (half * L::HALF + mfa::ldsm_b_row(lane)) * L::VT_LD +
                          mfa::ldsm_b_byte(lane);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t bb[4];
        mfa::ldsm_x4(bb, vt + n2 * 16 * L::VT_LD);
        // |P.V| <= 32 * 127 * 128 < 2^22: summed from I32_BIAS.
        constexpr int M0 = mfa::I32_BIAS;
        int c0[4] = {M0, M0, M0, M0}, c1[4] = {M0, M0, M0, M0};
        mfa::mma_s8(c0, pa, bb[0], bb[1], c0);
        mfa::mma_s8(c1, pa, bb[2], bb[3], c1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * n2][e] += mfa::biased_f32(c0[e]);
          acc[2 * n2 + 1][e] += mfa::biased_f32(c1[e]);
        }
      }
    } else {
      const uint8_t* vb = vop + mfa::ldsm_t_k(lane) * L::VB_LD +
                          (half * L::HALF + mfa::ldsm_t_n(lane)) * 2;
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t pa[4];
        mfa::ldsm_x4(pa, pa_p + kk * 32);
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          uint32_t bf[4];
          mfa::ldsm_x4_t(bf, vb + kk * 16 * L::VB_LD + n2 * 32);
          mfa::mma_bf16(acc[2 * n2], pa, bf[0], bf[1], acc[2 * n2]);
          mfa::mma_bf16(acc[2 * n2 + 1], pa, bf[2], bf[3], acc[2 * n2 + 1]);
        }
      }
    }
  }
  mfa::cp_async_wait<0>();

  const float l_off = p_int8 ? LN_127 : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
    const bool live = re[i] > rs[i] && l[i] > 0.f;
    float* orow = a.o + qoff + (long long)row[i] * a.q_sr;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int d = half * L::HALF + 8 * nb + 2 * tq;
      float o0 = live ? acc[nb][2 * i] / l[i] : 0.f;
      float o1 = live ? acc[nb][2 * i + 1] / l[i] : 0.f;
      if (a.v_scales == V_STORE) {
        o0 *= a.vs[bk * D + d];
        o1 *= a.vs[bk * D + d + 1];
      }
      *reinterpret_cast<float2*>(orow + d) = make_float2(o0, o1);
    }
    if (half == 0 && tq == 0)
      a.lse[bh * a.Sq + row[i]] =
          live ? m[i] * LN2 + logf(l[i]) - l_off : -INFINITY;
  }
}

template <typename K>
int launch(K kern, const Args& a, int B, int threads, size_t smem,
           cudaStream_t stream, int rows = BM) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((a.Sq + rows - 1) / rows, a.Hq, B), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The body a call takes (ops/quantized_attention.py::qattn_body gives the
// same answer): the tensor-core one for a bf16 or int8 Q with ROUND_BF16
// (qattn_fwd_tc_kernel up to D = 256, qattn_fwd_wide_kernel at 288,
// qattn_fwd_latent_kernel at 576), the scalar one for an fp32 Q and for an
// int8 Q without it (an fp32 Q quantized to int8 keeps fp32 products; in
// 32-row CTAs at 576); a bf16 Q always rounds to bf16.
// The head-pair call (mfa_hpack_fwd, always ROUND_BF16) routes the same
// way: bf16 to the tensor cores, fp32 to the scalar body.
template <typename QT, int D>
int launch_qattn(const Args& a, int B, cudaStream_t stream) {
  if constexpr (!std::is_same<QT, float>::value) {
    if (a.flags & ROUND_BF16) {
      const bool k_direct = std::is_same<QT, int8_t>::value && a.bits_k == 8;
      const bool pv_s8 = tc_pv_s8(a.flags, a.v_scales);
      if constexpr (qattn_latent<D>())
        return launch(qattn_fwd_latent_kernel<QT, D>, a, B, LATENT_THREADS,
                      LatentSmem<QT, D>(k_direct, pv_s8).total, stream);
      else if constexpr (qattn_wide<D>())
        return launch(qattn_fwd_wide_kernel<QT, D>, a, B, TC_THREADS,
                      TcSmem<QT, D>(k_direct, pv_s8).total, stream);
      else
        return launch(qattn_fwd_tc_kernel<QT, D>, a, B, TC_THREADS,
                      TcSmem<QT, D>(k_direct, pv_s8).total, stream);
    }
  }
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
    return (int)cudaErrorInvalidValue;
  } else if constexpr (mfa::scalar32<D>()) {
    return launch(qattn_fwd_kernel<QT, D>, a, B, THREADS,
                  mfa::smem32_bytes<D>(), stream, mfa::T32);
  } else {
    return launch(qattn_fwd_kernel<QT, D>, a, B, THREADS,
                  smem_floats<D>() * sizeof(float), stream);
  }
}

template <typename QT>
int launch_qattn_d(const Args& a, int B, int D, cudaStream_t stream) {
  if (D == 32) return launch_qattn<QT, 32>(a, B, stream);
  if (D == 64) return launch_qattn<QT, 64>(a, B, stream);
  if (D == 128) return launch_qattn<QT, 128>(a, B, stream);
  if (D == 256) return launch_qattn<QT, 256>(a, B, stream);
  if (D == 288) return launch_qattn<QT, 288>(a, B, stream);
  if (D == 576) return launch_qattn<QT, 576>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

bool valid_bits(int bits) { return bits == 8 || bits == 4; }

}  // namespace

// Plain C interface (loaded with ctypes).  Returns the launch's
// cudaError_t; cudaErrorInvalidValue for an unsupported type, head dim,
// bit width or head grouping, or a bf16 Q without ROUND_BF16.  qtype: 0
// float32, 1 bfloat16, 2 int8.  D: a built width, or above 576 any
// multiple of 16 (csrc/split_d_quantized.cu).
extern "C" {

// splits, ws: mfa_flash_fwd's (the split-D forward's runs of the KV axis;
// 1 with an int8 P or kv_span > 64, and at D <= 576).
int mfa_qattn_fwd(const void* q, const void* qs, const void* kq,
                  const void* ks, const void* kz, const void* vq,
                  const void* vs, const void* vz, const void* ranges,
                  const void* bias, long long bias_sb, long long bias_sh,
                  void* o, void* lse, int qtype, int B, int Hq, int Hkv,
                  int Sq, int Skv, int D, int interleaved, int bits_k,
                  int bits_v, int k_scales, int v_scales, int flags, int br,
                  int bs, int kv_span, float mask_value, int splits, void* ws,
                  void* stream) {
  if (Hkv <= 0 || Hq % Hkv || !valid_bits(bits_k) || !valid_bits(bits_v) ||
      kv_span <= 0 || kv_span % BN || (qtype != 2 && kv_span != BN) ||
      (D <= 576 && splits != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 576)
    return mfa_sd::launch_qattn(
        qtype,
        mfa_sd::QAttnArgs{q, static_cast<const float*>(qs),
                          static_cast<const uint8_t*>(kq),
                          static_cast<const float*>(ks),
                          static_cast<const float*>(kz),
                          static_cast<const uint8_t*>(vq),
                          static_cast<const float*>(vs),
                          static_cast<const float*>(vz),
                          static_cast<const int32_t*>(ranges),
                          static_cast<const float*>(bias), bias_sb, bias_sh,
                          static_cast<float*>(o), static_cast<float*>(lse), B,
                          Hq, Hkv, Sq, Skv, D, interleaved, bits_k, bits_v,
                          k_scales, v_scales, flags, br, bs, kv_span,
                          mask_value, splits, static_cast<float*>(ws)},
        s);
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
  if (qtype == 0) return launch_qattn<float, 64>(a, B, s);
  if (qtype == 1) return launch_qattn<__nv_bfloat16, 64>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel mfa_qattn_fwd launches for qtype at head dim D with `flags`:
// 4 split_d_qattn_kernel (above 576, every multiple of 16), 3
// qattn_fwd_latent_kernel, 2 qattn_fwd_wide_kernel, 1 qattn_fwd_tc_kernel,
// 0 qattn_fwd_kernel, -1 none (ops/quantized_attention.py::qattn_body
// gives the same answer).
int mfa_qattn_body(int qtype, int D, int flags) {
  if (qtype < 0 || qtype > 2 || (qtype == 1 && !(flags & ROUND_BF16)))
    return -1;
  if (mfa_sd::takes(D)) return 4;
  if (D != 32 && D != 64 && D != 128 && D != 256 && D != 288 && D != 576)
    return -1;
  if (qtype == 0 || !(flags & ROUND_BF16)) return 0;
  return D > 288 ? 3 : D > 256 ? 2 : 1;
}

}  // extern "C"

// The split-D attention kernels for Hopper (sm_90a): the flash forward, dQ
// and dK/dV and the paged decode and prefill at every head dim above 576,
// with no width table: the head dim is a run-time value.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu) above D = 576:
//   - ops/flash_attention.py::_fwd_kernel        -> split_d_fwd_kernel
//     (then split_d_fwd_merge_kernel where the KV axis splits:
//     ops/flash_attention.py::split_d_fwd_splits, for few row tiles; the
//     quantized forward's split merges here too)
//   - ops/flash_attention_bwd.py::_dq_kernel     -> split_d_dq_kernel
//     (then split_d_dq_merge_kernel where the KV axis splits:
//     ops/flash_attention_bwd.py::split_d_dq_splits; the exact quantized
//     dQ's split merges here too)
//   - ops/flash_attention_bwd.py::_dkv_kernel    -> split_d_dkv_kernel
//     (then csrc/flash_attention.cu::flash_dkv_merge_kernel where the GQA
//     group is split); the three are split_d_frame.cuh's bodies over float
//     rows (FlashFwd, FloatKV), which split_d_quantized.cu and
//     split_d_quantized_bwd.cu run over quantized payloads
//   - serving/paged_attention.py::_decode_kernel_streamed and
//     ::_decode_kernel                            -> split_d_decode_kernel
//     (then csrc/paged_attention.cu::paged_decode_merge_kernel where the KV
//     axis is split)
//   - serving/paged_attention.py::_prefill_kernel -> split_d_prefill_kernel
// The frame's sources, two steps and the forward / dQ / dK/dV bodies live
// in split_d_frame.cuh, which csrc/split_d_quantized.cu and
// csrc/split_d_quantized_bwd.cu share.
// The fixed-width kernels of csrc/flash_attention.cu and
// csrc/paged_attention.cu hold Q and whole K / V tiles in shared memory
// (the 576 latent forward uses 230,400 of 232,448 bytes), so nothing wider
// fits them; their routers call the launchers here for D > 576 (split_d.cuh).
//
// The frame, one for all five kernels:
//   - A CTA owns SLICE = 256 lanes of the output (O, dQ, or dK and dV) of
//     64 rows (16 in the decode): grid axis "slices" = ceil(D / 256).  256,
//     not 128: a thread then holds 4 rows x 16 output lanes (64 fp32, 128
//     for dK and dV), and the scores are recomputed ceil(D / 256) times
//     instead of ceil(D / 128).
//   - The scores S = Q.K^T (and, in the backward, dP = dO.V^T) are summed
//     over the WHOLE head dim in 32-lane chunks of the row tile and the
//     key tile: bf16 rows stream through a 4-stage cp.async ring (three
//     chunks in flight while one is multiplied); fp32 rows and the page
//     pools' rows (gathered by page id, int8 / int4 widened) are loaded
//     and stored into one of two buffers, so a fast warp loads the next
//     chunk while a slow one still multiplies this one (one barrier a
//     chunk).  No Q or K tile is ever held whole: nothing bounds D but
//     device memory.
//   - P (or dS) goes to shared memory and multiplies the CTA's own slice
//     of V (dO, K or Q): for bf16 the whole 256-lane slice, fetched at the
//     start of the tile (by cp.async for bf16 rows, under the scores); for
//     fp32 128 lanes at a time.
//   - Every slice of a row tile runs the same score code in the same chunk
//     order, so its m, l, S, P and dS are the same bits in every slice:
//     each slice normalises its own O lanes by the same l, and the
//     decode's merge combines every lane by the same m and l.  Only slice
//     0 writes L (the forward), dbias (dQ) and the decode's m and l.
//   - The price: the scores are recomputed once a slice.  The forward and
//     the paged kernels do 2 * D * slices + 2 * D operations a pair
//     instead of 4 * D (2.5x at D = 1024), dQ 4 * D * slices + 2 * D
//     instead of 6 * D, dK/dV 4 * D * slices + 4 * D instead of 8 * D.
// The products: for bf16 (and the int8 / int4 pools under a bf16 q, whose
// integers bf16 holds exactly) bf16 mma.sync m16n8k16 into fp32, the
// chunks and the slice staged as bf16 rows (scores, PV); for fp32 scalar
// fp32 FMAs (TF32 would break the 2e-5 gate).  The softmax and the masks
// run in one thread layout for both, 4 x 4 scores a thread (rows 4 ty + i,
// keys tx + 16 j), with the tensor-core sums crossing to it through shared
// memory.  What bounds them: the tensor-core operations in bf16 (the flash
// trio, the prefill) and the KV bytes (the decode).
//
// Numerics are those of the fixed-width kernels they extend (the file
// comments of csrc/flash_attention.cu, attention_bwd.cuh and
// csrc/paged_attention.cu), with the plain versions in
// ops/flash_attention.py, ops/flash_attention_bwd.py and
// serving/paged_attention.py: q pre-scaled and rounded to T; the flash
// forward in base 2 with bias * log2(e) then masked scores set to
// mask_value, P rounded to T before P.V, l summing the unrounded p, the
// static-max mode (row_max) without a running max; the backward in base e
// with L = -inf read as 0, dS = P (dP - D), dQ = scale round_T(dS).K, dV =
// round_T(P)^T.dO, dK = round_T(dS)^T.Q_s; the paged kernels in base e,
// the K scale on S, the V scale on P before its rounding, O's lanes from
// dp - vtz zero (P.V skips them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "split_d_frame.cuh"

namespace {

using mfa_sd::PagedArgs;

constexpr int KV_FLOAT = 0, KV_INT8 = 1, KV_INT4 = 2;

template <typename T, int MODE>
struct PoolElem {
  using S = T;
};
template <typename T>
struct PoolElem<T, KV_INT8> {
  using S = int8_t;
};
template <typename T>
struct PoolElem<T, KV_INT4> {
  using S = int8_t;
};

// One pool element as its fp32 value: float and int8 as they are; the int4
// byte's K (low nibble, minus 8) or V (the signed high nibble).
template <int MODE, typename S>
__device__ __forceinline__ float pool_value(S x, bool is_v) {
  if constexpr (MODE == KV_INT4) {
    const int b = (int)x;
    return (float)(is_v ? (b >> 4) : ((b & 0xF) - 8));
  } else if constexpr (MODE == KV_INT8) {
    return (float)x;
  } else {
    return Elem<S>::load(&x);
  }
}

// Token rows [t0, t0 + n) of one KV head of a page pool, read as they lie
// (rows of dp elements): K's rows, or V's (is_v: v_row rows on, or the int4
// byte's high nibble); zeros from token `lim` and from lane `lanes` (dp
// for K, dp - vtz for V).  Four-lane vector loads where the pool's rows
// keep them aligned (dp a multiple of 4), else element loads.  WHOLE: a
// bf16 float pool of whole 16-byte rows (dp a multiple of 8), whose rows
// are ASYNC: copy8 copies 8 lanes by cp.async (the piece that straddles
// dp - vtz copies V's lanes past it too: O's lanes there are stored as 0,
// and each O lane reads only its own V lane).
template <typename T, int MODE, bool WHOLE = false>
struct Tokens {
  static constexpr bool ASYNC = WHOLE && MODE == KV_FLOAT &&
                                std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool RAW = false;
  static constexpr bool WIDEN = false;
  static constexpr bool SCALE = false;
  static constexpr float scale = 1.f;
  using S = typename PoolElem<T, MODE>::S;
  const S* kv;
  const int32_t* table;
  size_t head_base;
  int num_pages_total, PT, rows, dp;
  size_t v_off;  // V's first element from K's (0 when K is V)
  int t0, lim, lanes;
  bool is_v;
  __device__ __forceinline__ void copy8(int t, int l, uint8_t* dst) const {
    const int pos = t0 + t;
    const bool ok = pos < lim && l < lanes;
    const S* p = kv;
    if (ok) {
      const int page = min(max(table[pos / PT], 0), num_pages_total - 1);
      p += ((head_base + page) * rows + pos % PT) * (size_t)dp + l +
           (is_v ? v_off : 0);
    }
    mfa::cp_async16(dst, p, ok ? 16 : 0);
  }
  __device__ __forceinline__ float4 operator()(int t, int l) const {
    const int pos = t0 + t;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (pos < lim && l < lanes) {
      const int page =
          min(max(table[pos / PT], 0), num_pages_total - 1);
      const S* p = kv + ((head_base + page) * rows + pos % PT) * (size_t)dp +
                   l + (is_v && MODE != KV_INT4 ? v_off : 0);
      if ((dp & 3) == 0 && l + 4 <= lanes) {
        if constexpr (MODE == KV_FLOAT) {
          return load4(p);
        } else {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = pool_value<MODE>((S)(int8_t)(w >> (8 * e)), is_v);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (l + e < lanes) f[e] = pool_value<MODE>(p[e], is_v);
      }
    }
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

// ---------------------------------------------------------------------------
// The flash trio: split_d_frame.cuh's bodies over float rows
// ---------------------------------------------------------------------------

// Replaces ops/flash_attention.py::_fwd_kernel above D = 576 (the body:
// split_d_frame.cuh::split_d_fwd).  STATIC_MAX: m is the caller's row_max
// and each tile only adds to l and O.
template <typename T, bool STATIC_MAX>
__global__ void __launch_bounds__(256)
split_d_fwd_kernel(const FlashFwd<T> src) {
  split_d_fwd<T, STATIC_MAX>(src);
}

// Replaces ops/flash_attention_bwd.py::_dq_kernel above D = 576 (the body:
// split_d_frame.cuh::split_d_dq).
template <typename T>
__global__ void __launch_bounds__(256) split_d_dq_kernel(const FlashArgs a) {
  split_d_dq<T>(a, FloatKV<T>{});
}

// Replaces ops/flash_attention_bwd.py::_dkv_kernel above D = 576 (the body:
// split_d_frame.cuh::split_d_dkv).
template <typename T>
__global__ void __launch_bounds__(256)
split_d_dkv_kernel(const FlashArgs a, int splits, float* ws) {
  split_d_dkv<T>(a, FloatKV<T>{}, splits, ws);
}

// ---------------------------------------------------------------------------
// The paged kernels
// ---------------------------------------------------------------------------

// The tile's K and V scales (zeros from token lim) into sc[0, 64) and
// sc[64, 128); the caller's next barrier publishes them.
template <int RT>
__device__ __forceinline__ void stage_scales(const PagedArgs& a,
                                             const int32_t* table,
                                             size_t head_base, int t0,
                                             int lim, float* sc) {
  for (int t = threadIdx.x; t < TILE; t += RT * 4) {
    const int pos = t0 + t;
    float ks = 0.f, vs = 0.f;
    if (pos < lim) {
      const int page =
          min(max(table[pos / a.PT], 0), a.num_pages_total - 1);
      const size_t at = (head_base + page) * a.PT + pos % a.PT;
      ks = a.kscale[at];
      vs = a.vscale[at];
    }
    sc[t] = ks;
    sc[TILE + t] = vs;
  }
}

// One tile's online softmax in base e on a thread's 4 x 4 scores (the
// scalar paged kernels' steps): K scale on S, then masked (vis false) to
// -inf; m, l and each row's rescale into alpha_s (the P.V step applies
// it); P (times the V scale) rounded to T.
template <typename T, bool QUANT, typename VIS>
__device__ __forceinline__ void paged_softmax(float (&s)[4][4], int ty,
                                              int tx, const float* sc,
                                              const VIS& vis, float (&m)[4],
                                              float (&l)[4], float* alpha_s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (QUANT) s[i][j] *= sc[c];
      if (!vis(i, c)) s[i][j] = -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_next = fmaxf(m[i], mx);
    const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_next);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_next);
      sum += p;
      s[i][j] = Elem<T>::round(QUANT ? p * sc[TILE + tx + 16 * j] : p);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = alpha * l[i] + sum;
    m[i] = m_next;
    if (tx == 0) alpha_s[4 * ty + i] = alpha;
  }
}

template <typename T, int MODE, bool WHOLE>
__device__ __forceinline__ Tokens<T, MODE, WHOLE> pool_rows(
    const PagedArgs& a, const int32_t* table, size_t head_base, int t0,
    int lim, bool is_v) {
  return Tokens<T, MODE, WHOLE>{
      static_cast<const typename PoolElem<T, MODE>::S*>(a.kv),
      table, head_base, a.num_pages_total, a.PT, a.rows, a.dp,
      (size_t)a.v_row * a.dp, t0, lim, is_v ? a.dp - a.vtz : a.dp, is_v};
}

// Replaces serving/paged_attention.py::_prefill_kernel above D = 576.  One
// CTA per (64 group-major rows, KV head x slice) of one sequence's chunk:
// rows r = g C + c of q [Hq, C, D] (contiguous for a KV head), causal in
// global positions (column <= offset + r mod C); the key tiles run through
// the page row from position 0.
template <typename T, int MODE, bool WHOLE>
__global__ void __launch_bounds__(256)
split_d_prefill_kernel(const PagedArgs a) {
  using L = Smem<64, 1>;
  constexpr bool QUANT = MODE != KV_FLOAT;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int h = blockIdx.y / nsl;
  const int l0 = (blockIdx.y % nsl) * SLICE;
  const int v_keep = a.dp - a.vtz;
  const int rows = (a.Hq / a.Hkv) * a.C;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = a.D, C = a.C;
  const size_t head_row0 = (size_t)h * rows;
  const size_t head_base = (size_t)h * a.num_pages_total;
  using P = PV<T, 64>;
  float* pt = smem + L::P;
  float* sc = smem + L::SC;
  float* alpha_s = smem + L::E;
  float* inv_s = alpha_s + 64;

  int lim[4];  // the last visible global column of each of the rows
#pragma unroll
  for (int i = 0; i < 4; ++i) lim[i] = a.offset + (r0 + 4 * ty + i) % C;
  const int r_last = min(r0 + 64, rows) - 1;
  const int c_max = (r0 / C == r_last / C) ? (r_last % C) : (C - 1);
  const int kv_end = min(a.offset + c_max + 1, a.max_pages * a.PT);
  float m[4], l[4];
  typename P::Acc acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const Rows<T, true> qsrc{static_cast<const T*>(a.q) + head_row0 * D, r0,
                           rows, D, a.scale};

  for (int t0 = 0; t0 < kv_end; t0 += TILE) {
    if (QUANT) stage_scales<64>(a, a.table, head_base, t0, kv_end, sc);
    const auto ksrc =
        pool_rows<T, MODE, WHOLE>(a, a.table, head_base, t0, kv_end, false);
    const auto vsrc =
        pool_rows<T, MODE, WHOLE>(a, a.table, head_base, t0, kv_end, true);
    if (l0 < v_keep) P::fetch(vsrc, l0, smem + L::H);
    float s[4][4];
    scores<T, 64>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc, ksrc, ty,
                  tx, s);
    paged_softmax<T, QUANT>(
        s, ty, tx, sc,
        [&](int i, int c) {
          return t0 + c <= lim[i] && t0 + c < kv_end;
        },
        m, l, alpha_s);
    P::store(pt, ty, tx, s);
    if (l0 < v_keep)
      P::slice(pt, vsrc, l0, v_keep, smem + L::H, alpha_s, ty, tx, acc);
    else
      __syncthreads();  // every thread is done with the scales and alpha
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (tx == 0) inv_s[4 * ty + i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  __syncthreads();
  T* out = static_cast<T*>(a.out) + head_row0 * D + l0;
  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r0 + r >= rows || l0 + d >= D) return;
    T* o = out + (size_t)(r0 + r) * D;
    Elem<T>::store(o + d, l0 + d < v_keep ? v0 * inv_s[r] : 0.f);
    Elem<T>::store(o + d + 1, l0 + d + 1 < v_keep ? v1 * inv_s[r] : 0.f);
  });
}

// Replaces serving/paged_attention.py::_decode_kernel_streamed and
// ::_decode_kernel above D = 576.  The fixed-width decode's grid with the
// lanes split too: one CTA of 64 threads per (KV head x 16-row group slice
// x lane slice, sequence, split of the KV axis), the group's rows (up to
// 16) against 64-token tiles of its split.  Every lane slice of a split
// computes the same m and l, so paged_decode_merge_kernel combines each
// lane of the splits' partials by them; slice 0 writes them.
template <typename T, int MODE, bool WHOLE>
__global__ void __launch_bounds__(64)
split_d_decode_kernel(const PagedArgs a) {
  using L = Smem<16, 1>;
  constexpr bool QUANT = MODE != KV_FLOAT;
  extern __shared__ __align__(16) float smem[];
  const int nsl = mfa_sd::slices(a.D);
  const int l0 = (blockIdx.x % nsl) * SLICE;
  const int hs = blockIdx.x / nsl;
  const int h = hs / a.gslices;
  const int g0 = (hs % a.gslices) * a.gc;
  const int gn = min(a.gc, a.G - g0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = a.D;
  const int v_keep = a.dp - a.vtz;
  const int n_tok = min(a.lengths[b], a.max_pages * a.PT);
  const int t_begin = split * a.per;
  const int t_end = min(t_begin + a.per, n_tok);
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * a.G + g0;
  const size_t part_ld = (size_t)a.splits * (D + 2);
  float* part = a.splits > 1
                    ? a.ws + (qrow0 * a.splits + split) * (size_t)(D + 2)
                    : nullptr;
  if (a.splits > 1 && t_begin >= t_end) {  // past the sequence: empty
    if (l0 == 0 && threadIdx.x < gn) {
      part[threadIdx.x * part_ld] = -INFINITY;
      part[threadIdx.x * part_ld + 1] = 0.f;
    }
    return;
  }
  const int32_t* table = a.table + (size_t)b * a.max_pages;
  const size_t head_base = (size_t)h * a.num_pages_total;
  using P = PV<T, 16>;
  float* pt = smem + L::P;
  float* sc = smem + L::SC;
  float* alpha_s = smem + L::E;
  float* inv_s = alpha_s + 16;
  float m[4], l[4];
  typename P::Acc acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  P::zero(acc);
  const int nch = (D + DC - 1) / DC;
  const Rows<T, true> qsrc{static_cast<const T*>(a.q) + qrow0 * D, 0, gn,
                           D, a.scale};

  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    if (QUANT) stage_scales<16>(a, table, head_base, t0, t_end, sc);
    const auto ksrc =
        pool_rows<T, MODE, WHOLE>(a, table, head_base, t0, t_end, false);
    const auto vsrc =
        pool_rows<T, MODE, WHOLE>(a, table, head_base, t0, t_end, true);
    if (l0 < v_keep) P::fetch(vsrc, l0, smem + L::H);
    float s[4][4];
    scores<T, 16>(nch, smem + L::A, smem + L::B, smem + L::S, qsrc, ksrc, ty,
                  tx, s);
    paged_softmax<T, QUANT>(
        s, ty, tx, sc, [&](int, int c) { return t0 + c < t_end; }, m, l,
        alpha_s);
    P::store(pt, ty, tx, s);
    if (l0 < v_keep)
      P::slice(pt, vsrc, l0, v_keep, smem + L::H, alpha_s, ty, tx, acc);
    else
      __syncthreads();  // every thread is done with the scales and alpha
  }

  // One split: O = acc / l (lanes from v_keep 0); else the partial O, and
  // from slice 0 m and l, for paged_decode_merge_kernel.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (tx == 0) inv_s[r] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    if (a.splits > 1 && r < gn && l0 == 0 && tx == 0) {
      part[r * part_ld] = m[i];
      part[r * part_ld + 1] = l[i];
    }
  }
  __syncthreads();
  P::each(acc, ty, tx, [&](int r, int d, float v0, float v1) {
    if (r >= gn || l0 + d >= D) return;
    if (a.splits > 1) {
      *reinterpret_cast<float2*>(part + r * part_ld + 2 + l0 + d) =
          make_float2(v0, v1);
      return;
    }
    T* o = static_cast<T*>(a.out) + (qrow0 + r) * D + l0;
    Elem<T>::store(o + d, l0 + d < v_keep ? v0 * inv_s[r] : 0.f);
    Elem<T>::store(o + d + 1, l0 + d + 1 < v_keep ? v1 * inv_s[r] : 0.f);
  });
}

constexpr int MERGE_THREADS = 128;

// The forward's split partials (split_d_frame.cuh::split_d_fwd, ws
// [rows, splits, D + 2]) -> O and L, one CTA a query row of B * Hq * Sq:
// M = max m_s, weights w_s = exp2(m_s - M) (0 for a split that walked no
// key), l = sum w_s l_s, O = (sum w_s O_s) / l (times V_STORE's lane
// multiplier), L = M ln 2 + ln l; a row with l = 0 (an empty range) O = 0,
// L = -inf, as the unsplit store.  Every sum runs in split order, with no
// atomics, so two calls give the same bits.  Bound by ws's bytes.
__global__ void __launch_bounds__(MERGE_THREADS)
split_d_fwd_merge_kernel(const float* __restrict__ ws, float* __restrict__ o,
                         float* __restrict__ lse,
                         const float* __restrict__ vstore, int Hq, int Hkv,
                         int Sq, int D, int interleaved, int splits) {
  __shared__ float w_s[mfa_sd::MAX_FWD_SPLITS];
  const size_t row = blockIdx.x;
  const size_t ld = (size_t)D + 2;
  const float* p = ws + mfa_sd::fwd_partial(row, 0, splits, D);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, p[s * ld]);
  if (threadIdx.x < splits) {
    const float ms = p[threadIdx.x * ld];
    w_s[threadIdx.x] = ms == -INFINITY ? 0.f : exp2f(ms - mx);
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l = fmaf(w_s[s], p[s * ld + 1], l);
  const bool live = l > 0.f;
  if (threadIdx.x == 0) lse[row] = live ? mx * LN2 + logf(l) : -INFINITY;
  const float* vs = nullptr;
  if (vstore) {
    const int bh = (int)(row / Sq), h = bh % Hq, b = bh / Hq;
    const int hk = interleaved ? h % Hkv : h / (Hq / Hkv);
    vs = vstore + ((size_t)b * Hkv + hk) * D;
  }
  for (int d = threadIdx.x; d < D; d += MERGE_THREADS) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s)
      acc = fmaf(w_s[s], p[s * ld + 2 + d], acc);
    float v = live ? acc / l : 0.f;
    if (vs) v *= vs[d];
    o[row * D + d] = v;
  }
}

// The dQ's split partials (split_d_frame.cuh::split_d_dq, ws [splits,
// n] for n = B * Hq * Sq * D, a multiple of 4) -> dQ: dq[i] = (ws[0][i] +
// ws[1][i] + ...) times the lane's dqsc [B, Hkv, D] (the quantized dQ's
// store multipliers) or `scale` (the float dQ's), the runs summed in
// order from run 0 as the unsplit store scales the one walk's sum, with no
// atomics, so two calls give the same bits.  Bound by ws's bytes.
__global__ void __launch_bounds__(256)
split_d_dq_merge_kernel(const float4* __restrict__ ws,
                        float4* __restrict__ dq,
                        const float* __restrict__ dqsc, float scale, int Hq,
                        int Hkv, int Sq, int D, int interleaved, int splits,
                        long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 acc = ws[i];
    for (int sp = 1; sp < splits; ++sp) {
      const float4 x = ws[sp * n4 + i];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    float4 m = make_float4(scale, scale, scale, scale);
    if (dqsc) {
      const long long e = 4 * i;
      const long long bh = e / ((long long)Sq * D);
      const int h = (int)(bh % Hq), b = (int)(bh / Hq);
      const int hk = interleaved ? h % Hkv : h / (Hq / Hkv);
      m = *reinterpret_cast<const float4*>(
          dqsc + ((size_t)b * Hkv + hk) * D + (int)(e % D));
    }
    dq[i] = make_float4(acc.x * m.x, acc.y * m.y, acc.z * m.z, acc.w * m.w);
  }
}

template <typename T>
int fwd_of(const FlashArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Sq + 63) / 64, a.Hq * mfa_sd::slices(a.D),
                  a.B * a.splits);
  if (a.row_max)
    return mfa::launch_with_smem(split_d_fwd_kernel<T, true>, grid, 256,
                                 Smem<64, 1>::BYTES, stream, FlashFwd<T>{a});
  return mfa::launch_with_smem(split_d_fwd_kernel<T, false>, grid, 256,
                               Smem<64, 1>::BYTES, stream, FlashFwd<T>{a});
}

// Whether a pool's rows take the cp.async path (Tokens' WHOLE): a bf16
// float pool of whole 16-byte rows.
template <typename T, int MODE>
constexpr bool async_pool() {
  return MODE == KV_FLOAT && std::is_same<T, __nv_bfloat16>::value;
}

template <typename T, int MODE>
int decode_of(const PagedArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(a.Hkv * a.gslices * mfa_sd::slices(a.D), B, a.splits);
  if constexpr (async_pool<T, MODE>())
    if (a.dp % 8 == 0)
      return mfa::launch_with_smem(split_d_decode_kernel<T, MODE, true>, grid,
                                   64, Smem<16, 1>::BYTES, stream, a);
  return mfa::launch_with_smem(split_d_decode_kernel<T, MODE, false>, grid,
                               64, Smem<16, 1>::BYTES, stream, a);
}

template <typename T, int MODE>
int prefill_of(const PagedArgs& a, cudaStream_t stream) {
  const int rows = (a.Hq / a.Hkv) * a.C;
  const dim3 grid((rows + 63) / 64, a.Hkv * mfa_sd::slices(a.D));
  if constexpr (async_pool<T, MODE>())
    if (a.dp % 8 == 0)
      return mfa::launch_with_smem(split_d_prefill_kernel<T, MODE, true>,
                                   grid, 256, Smem<64, 1>::BYTES, stream, a);
  return mfa::launch_with_smem(split_d_prefill_kernel<T, MODE, false>, grid,
                               256, Smem<64, 1>::BYTES, stream, a);
}

template <int MODE>
int decode_mode(int dtype, const PagedArgs& a, int B, cudaStream_t stream) {
  if (dtype == 0) return decode_of<float, MODE>(a, B, stream);
  if (dtype == 1) return decode_of<__nv_bfloat16, MODE>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int prefill_mode(int dtype, const PagedArgs& a, cudaStream_t stream) {
  if (dtype == 0) return prefill_of<float, MODE>(a, stream);
  if (dtype == 1) return prefill_of<__nv_bfloat16, MODE>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace mfa_sd {

int launch_fwd(int dtype, const FlashArgs& a, cudaStream_t stream) {
  if (!takes(a.D) || a.splits < 1 || a.splits > MAX_FWD_SPLITS ||
      (a.splits > 1 && !a.ws))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return fwd_of<float>(a, stream);
  if (dtype == 1) return fwd_of<__nv_bfloat16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_dq(int dtype, const FlashArgs& a, cudaStream_t stream) {
  if (!takes(a.D) || a.splits < 1 || a.splits > MAX_FWD_SPLITS ||
      (a.splits > 1 && !a.ws))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Sq + 63) / 64, a.Hq * slices(a.D), a.B * a.splits);
  if (dtype == 0)
    return mfa::launch_with_smem(split_d_dq_kernel<float>, grid, 256,
                                 Smem<64, 1>::BYTES, stream, a);
  if (dtype == 1)
    return mfa::launch_with_smem(split_d_dq_kernel<__nv_bfloat16>, grid, 256,
                                 Smem<64, 1>::BYTES, stream, a);
  return (int)cudaErrorInvalidValue;
}

int launch_dkv(int dtype, const FlashArgs& a, int splits, float* ws,
               cudaStream_t stream) {
  if (!takes(a.D) || splits < 1 || splits > a.Hq / a.Hkv ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Skv + 63) / 64, a.Hkv * slices(a.D), a.B * splits);
  if (dtype == 0)
    return mfa::launch_with_smem(split_d_dkv_kernel<float>, grid, 256,
                                 Smem<64, 2>::BYTES, stream, a, splits, ws);
  if (dtype == 1)
    return mfa::launch_with_smem(split_d_dkv_kernel<__nv_bfloat16>, grid,
                                 256, Smem<64, 2>::BYTES, stream, a, splits,
                                 ws);
  return (int)cudaErrorInvalidValue;
}

int launch_paged_decode(int dtype, int mode, const PagedArgs& a, int B,
                        cudaStream_t stream) {
  if (!takes(a.D)) return (int)cudaErrorInvalidValue;
  if (mode == KV_FLOAT) return decode_mode<KV_FLOAT>(dtype, a, B, stream);
  if (mode == KV_INT8) return decode_mode<KV_INT8>(dtype, a, B, stream);
  if (mode == KV_INT4) return decode_mode<KV_INT4>(dtype, a, B, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_paged_prefill(int dtype, int mode, const PagedArgs& a,
                         cudaStream_t stream) {
  if (!takes(a.D)) return (int)cudaErrorInvalidValue;
  if (mode == KV_FLOAT) return prefill_mode<KV_FLOAT>(dtype, a, stream);
  if (mode == KV_INT8) return prefill_mode<KV_INT8>(dtype, a, stream);
  if (mode == KV_INT4) return prefill_mode<KV_INT4>(dtype, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mfa_sd

extern "C" {

// The lanes a split-D CTA owns (ops/flash_attention.py::SPLIT_D_SLICE
// answers the same).
int mfa_split_d_slice() { return SLICE; }

// CTAs an SM the occupancy API gives split_d_fwd_kernel's instance for
// dtype (0 fp32, 1 bf16) and static_max (0 or 1); -1 for none.
int mfa_split_d_fwd_ctas_per_sm(int dtype, int static_max) {
  if (dtype == 0)
    return static_max ? ctas_per_sm<1>(split_d_fwd_kernel<float, true>)
                      : ctas_per_sm<1>(split_d_fwd_kernel<float, false>);
  if (dtype == 1)
    return static_max
               ? ctas_per_sm<1>(split_d_fwd_kernel<__nv_bfloat16, true>)
               : ctas_per_sm<1>(split_d_fwd_kernel<__nv_bfloat16, false>);
  return -1;
}

// CTAs an SM the occupancy API gives split_d_dq_kernel (dkv 0) or
// split_d_dkv_kernel (dkv 1) for dtype (0 fp32, 1 bf16); -1 for none.
int mfa_split_d_bwd_ctas_per_sm(int dkv, int dtype) {
  if (dtype == 0)
    return dkv ? ctas_per_sm<2>(split_d_dkv_kernel<float>)
               : ctas_per_sm<1>(split_d_dq_kernel<float>);
  if (dtype == 1)
    return dkv ? ctas_per_sm<2>(split_d_dkv_kernel<__nv_bfloat16>)
               : ctas_per_sm<1>(split_d_dq_kernel<__nv_bfloat16>);
  return -1;
}

// The split-D dQ's merge (split_d_dq_merge_kernel): ws fp32 [splits, B,
// Hq, Sq, D] from mfa_flash_dq / mfa_qflash_bwd with splits > 1 -> dq fp32
// [B, Hq, Sq, D], times dqsc fp32 [B, Hkv, D] (the quantized dQ's store
// multipliers) where given, else times `scale`.
int mfa_split_d_dq_merge(const void* ws, void* dq, const void* dqsc,
                         float scale, int B, int Hq, int Hkv, int Sq, int D,
                         int interleaved, int splits, void* stream) {
  if (splits < 2 || splits > mfa_sd::MAX_FWD_SPLITS || Hkv <= 0 ||
      Hq % Hkv || B <= 0 || Sq <= 0 || D <= 0 || D % 4)
    return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)B * Hq * Sq * D / 4;
  // Grid-stride: at most 8 blocks for each of an H100's 132 SMs.
  const int blocks = (int)std::min<long long>((n4 + 255) / 256, 132 * 8);
  split_d_dq_merge_kernel<<<blocks, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(dq),
      static_cast<const float*>(dqsc), scale, Hq, Hkv, Sq, D, interleaved,
      splits, n4);
  return (int)cudaGetLastError();
}

// The split-D forward's merge (split_d_fwd_merge_kernel): ws fp32 [B * Hq *
// Sq, splits, D + 2] from mfa_flash_fwd / mfa_qattn_fwd with splits > 1 ->
// o fp32 [B, Hq, Sq, D], lse fp32 [B, Hq, Sq]; vstore: the quantized
// forward's V_STORE multipliers fp32 [B, Hkv, D], or null.
int mfa_split_d_fwd_merge(const void* ws, void* o, void* lse,
                          const void* vstore, int B, int Hq, int Hkv, int Sq,
                          int D, int interleaved, int splits, void* stream) {
  if (splits < 2 || splits > mfa_sd::MAX_FWD_SPLITS || Hkv <= 0 ||
      Hq % Hkv || B <= 0 || Sq <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  split_d_fwd_merge_kernel<<<B * Hq * Sq, MERGE_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const float*>(vstore), Hq, Hkv,
      Sq, D, interleaved, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"

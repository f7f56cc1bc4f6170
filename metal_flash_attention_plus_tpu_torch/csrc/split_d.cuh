// The split-D kernels' host interface: the flash forward, dQ and dK/dV and
// the paged decode and prefill (csrc/split_d_attention.cu), the quantized
// forward (csrc/split_d_quantized.cu), and the exact quantized dQ and
// dK/dV and the full-integer pair (csrc/split_d_quantized_bwd.cu), at every
// head dim above DeepSeek's absorbed width 576, where the fixed-width
// kernels of csrc/flash_attention.cu, csrc/paged_attention.cu,
// csrc/quantized_attention.cu and csrc/quantized_attention_bwd.cu end.
// Those files' routers call these launchers for such a head dim.
//
// The frame (see split_d_attention.cu): each CTA owns one SLICE-lane slice
// of O (or of dQ, or of dK and dV), computes the scores over the whole
// head dim in 32-lane chunks, and applies P to its own slice only; the
// full-integer pair splits the scores' head dim over a cluster of a
// head's slices instead (fullint_cluster below).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mfa_sd {

constexpr int MIN_D = 577;  // the widest fixed-width kernels end at 576
constexpr int SLICE = 256;  // output lanes a CTA

// Whether a head dim runs on the split-D kernels: above 576, in whole
// 16-lane steps (the wrappers zero-pad to them).
__host__ __device__ inline bool takes(int D) {
  return D >= MIN_D && D % 16 == 0;
}

// The lane slices, one CTA each, of a head dim D.
__host__ __device__ inline int slices(int D) {
  return (D + SLICE - 1) / SLICE;
}

// The flash kernels' arguments: q / dO [B, Hq, Sq, D] and k / v [B, Hkv,
// Skv, D] of T; L, D (= rowsum(dO * O)) and row_max fp32 [B, Hq, Sq];
// ranges int32 [Sq, 2]; bias fp32 with batch / head strides; out0 = O,
// dQ or dK, out1 = L, dbias or dV (all fp32).  scale: the forward's
// scale * log2(e), the backward's natural scale.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* di;
  const int32_t* ranges;
  const float* bias;
  long long bias_sb, bias_sh;
  const float* row_max;
  float* out0;
  float* out1;
  int B, Hq, Hkv, Sq, Skv, D, interleaved;
  float scale, mask_value;
  // The forward's and the dQ's split of the KV axis (ops/
  // flash_attention.py::split_d_fwd_splits, ops/flash_attention_bwd.py::
  // split_d_dq_splits; at most MAX_FWD_SPLITS): with splits > 1 each row
  // tile's live span is dealt into `splits` runs of whole 64-key tiles, one
  // CTA each, whose partials go to ws (fwd_partial, dq_partial).
  int splits = 1;
  float* ws = nullptr;
};

constexpr int MAX_FWD_SPLITS = 64;

// The forward's partials with splits > 1: ws fp32 [B * Hq * Sq, splits,
// D + 2], row (b, h, r), split s: m (base 2) and l (0 for a row whose range
// is empty) at [0] and [1], written by slice 0, then the unnormalised O
// over the row's lanes (each slice its own 256).
__host__ __device__ inline size_t fwd_partial(size_t row, int split,
                                              int splits, int D) {
  return (row * splits + split) * (size_t)(D + 2);
}

// The dQ's partials with splits > 1: ws fp32 [splits, B * Hq, Sq, D], the
// unscaled dQ of run `split` over row (b, h) = bh's rows (each slice its
// own 256 lanes).
__host__ __device__ inline size_t dq_partial(size_t bh, int split,
                                             size_t heads, int Sq, int D) {
  return (split * heads + bh) * (size_t)Sq * D;
}

// dtype 0 = float32, 1 = bfloat16.  Each returns the launch's cudaError_t.
// With a.splits > 1 the forward writes only ws; mfa_split_d_fwd_merge
// (csrc/split_d_attention.cu) then makes O and L; the dQ likewise, then
// mfa_split_d_dq_merge makes dQ.
int launch_fwd(int dtype, const FlashArgs& a, cudaStream_t stream);
int launch_dq(int dtype, const FlashArgs& a, cudaStream_t stream);
// splits: the CTAs that share a key tile's GQA group; with splits > 1 the
// partials go to ws, fp32 [splits, 2, B, Hkv, Skv, D].
int launch_dkv(int dtype, const FlashArgs& a, int splits, float* ws,
               cudaStream_t stream);

// The paged kernels' arguments (csrc/paged_attention.cu's pool layouts):
// q and out rows of D = the head dim dp rounded up to 16 lanes; the pool's
// rows of dp elements; `table` the decode's [B, max_pages] page table or
// the prefill's page row.
struct PagedArgs {
  const void* q;
  const void* kv;
  const float* kscale;
  const float* vscale;
  const int32_t* table;
  const int32_t* lengths;
  void* out;
  float* ws;  // the decode's [B, Hq, splits, D + 2] (splits > 1)
  int Hq, Hkv, D, dp, PT, rows, v_row, vtz, num_pages_total, max_pages;
  int G, gc, gslices, splits, per;  // the decode
  int C, offset;                    // the prefill
  float scale;
};

// mode: 0 float pool, 1 int8 halves, 2 int4 shared byte.  The decode
// leaves its partials in ws where splits > 1 (the caller then launches
// paged_decode_merge_kernel).
int launch_paged_decode(int dtype, int mode, const PagedArgs& a, int B,
                        cudaStream_t stream);
int launch_paged_prefill(int dtype, int mode, const PagedArgs& a,
                         cudaStream_t stream);

// The quantized forward's arguments (csrc/quantized_attention.cu's Args in
// the natural layout): q [B, Hq, Sq, D] fp32 / bf16 (pre-scaled) or int8
// with qs fp32 [B, Hq, Sq]; the K / V payloads int8 [B, Hkv, Skv, D] or
// group-planar int4 [.., D/2] with their scales and zero points in the
// modes' shapes; o fp32 [B, Hq, Sq, D], lse fp32 [B, Hq, Sq].  k_scales,
// v_scales, flags: that file's KScales, VScales and Flags; kv_span: the keys
// a span of an int8 P's running max (64 for the other modes).
struct QAttnArgs {
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
  int B, Hq, Hkv, Sq, Skv, D, interleaved;
  int bits_k, bits_v, k_scales, v_scales, flags, br, bs, kv_span;
  float mask_value;
  int splits = 1;  // FlashArgs::splits (1 with an int8 P or kv_span > 64)
  float* ws = nullptr;
};

// qtype 0 = float32, 1 = bfloat16, 2 = int8 (a bf16 Q needs ROUND_BF16).
int launch_qattn(int qtype, const QAttnArgs& a, cudaStream_t stream);

// A quantized K / V pair for the exact dQ and dK/dV (FlashArgs::k and v
// then point at the payloads): each operand's bit width, its
// csrc/quantized_tiles.cuh Dequant mode and its scales and zero points in
// that mode's shapes; the dQ's folds: per-token K / V scales [B, Hkv, Skv]
// on S's and dS's / dP's columns and the store multipliers [B, Hkv, D]
// (null where unused).
struct QuantKV {
  const float* ks;
  const float* kz;
  const float* vs;
  const float* vz;
  const float* ksr;
  const float* vsr;
  const float* dqsc;
  int bits_k, bits_v, k_mode, v_mode, br, bs;
};

// dtype 0 = float32, 1 = bfloat16; q pre-scaled for the dQ (a.scale 1),
// scaled by a.scale for the dK/dV, as the fixed-width launchers take it.
int launch_qdq(int dtype, const FlashArgs& a, const QuantKV& kv,
               cudaStream_t stream);
int launch_qdkv(int dtype, const FlashArgs& a, const QuantKV& kv, int splits,
                float* ws, cudaStream_t stream);

// The full-integer pair's arguments (csrc/quantized_attention_bwd.cu's
// FullintArgs, with B and D): per-token int8 Q, dO (dor) and dO times the
// V scales (dov) with their fp32 scales, int8 K and V, ROW K scales or
// null, L (-inf read as 0) and D; out0 = dQ or dK, out1 = dV; width:
// level 2's row-quantization width, 0 level 1; store: dQ's or dK's
// multiplier.
struct FullintArgs {
  const int8_t* qq;
  const float* qsc;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const int8_t* dor;
  const float* dorsc;
  const int8_t* dov;
  const float* dovsc;
  const float* lse;
  const float* di;
  float* out0;
  float* out1;
  int B, Hq, Hkv, Sq, Skv, D, interleaved, width;
  float store;
};

// dq: the dQ (splits 1) or the dK/dV (with splits > 1 the partials, dK
// times `store`, go to ws, fp32 [splits, 2, B, Hkv, Skv, D]).
int launch_fullint(bool dq, const FullintArgs& a, int splits, float* ws,
                   cudaStream_t stream);

// The full-integer pair's cluster (csrc/split_d_quantized_bwd.cu): the
// CTAs of a head's lane slices that split the scores' contraction, each
// summing S and dP over the lanes of slices(D) / C slices, the largest
// divisor of slices(D) up to `limit` (16: a non-portable cluster above
// 8; ops/flash_attention_bwd.py::split_d_fullint_cluster plans the same).
constexpr int MAX_FULLINT_CLUSTER = 16;
inline int fullint_cluster(int D, int limit = MAX_FULLINT_CLUSTER) {
  const int n = slices(D);
  for (int c = n < limit ? n : limit; c > 1; --c)
    if (n % c == 0) return c;
  return 1;
}

}  // namespace mfa_sd

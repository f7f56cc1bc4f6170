// The split-D kernels' host interface (csrc/split_d_attention.cu): the
// flash forward, dQ and dK/dV and the paged decode and prefill at every
// head dim above DeepSeek's absorbed width 576, where the fixed-width
// kernels of csrc/flash_attention.cu and csrc/paged_attention.cu end.
// Those files' routers call these launchers for such a head dim.
//
// The frame (see split_d_attention.cu): each CTA owns one SLICE-lane slice
// of O (or of dQ, or of dK and dV), computes the scores over the whole
// head dim in 32-lane chunks, and applies P to its own slice only.
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
};

// dtype 0 = float32, 1 = bfloat16.  Each returns the launch's cudaError_t.
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

}  // namespace mfa_sd

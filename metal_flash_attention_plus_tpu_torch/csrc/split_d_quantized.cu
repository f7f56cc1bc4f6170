// The quantized attention forward above head dim 576 for Hopper (sm_90a):
// every mode of csrc/quantized_attention.cu on the split-D frame
// (csrc/split_d_frame.cuh), the head dim a run-time value.  The kernel is
// the frame's forward body (split_d_fwd) over the QuantFwd policy: the
// flash forward (split_d_attention.cu::split_d_fwd_kernel) is the same body
// over float rows.
//
// Replaces (TPU kernel of metal_flash_attention_plus_tpu) above D = 576:
//   - ops/quantized_attention.py::_qfwd_kernel -> split_d_qattn_kernel
// csrc/quantized_attention.cu's fixed-width kernels hold Q and whole K / V
// tiles in shared memory (the 576 latent forward 230,400 bytes of the
// 232,448 a CTA may have); its router (mfa_qattn_fwd) calls the launcher
// here for D > 576 (split_d.cuh).
//
// The frame: a CTA owns 256 lanes of O (slices = ceil(D / 256) CTAs a row
// tile), sums the scores over the whole head dim in 32-lane chunks and
// applies P to its own slice of V.  The payloads are read as they lie
// (Payload: int8, or group-planar int4 whose 256-value groups are the
// slices, the last group split at its own midpoint), a chunk at a time,
// never whole:
//   - Rows of whole 16-byte pieces (RING: every int8 row, an int4 row
//     where D is a multiple of 32) land through cp.async: Q (bf16 rows, or
//     int8 words) and K's raw bytes through the scores' 4-stage ring, K's
//     widened in shared memory into the operand (dequantized per token or
//     BLOCK_2D cell and rounded, or the integers) once a chunk has landed,
//     two chunks in flight under the products; V's slice issued raw at the
//     start of the tile into the P region, idle under the scores, and
//     widened into bf16 rows before P.V.  The widening gives the bits the
//     synchronous staging gives.
//   - An int4 row of D / 2 bytes that is not whole 16-byte pieces (D % 32
//     = 16: 592, 624, 656, ...) keeps the synchronous staging: each chunk
//     loaded, dequantized and stored before it is multiplied, V's slice
//     before the scores.  So do the scalar fp32 steps: an fp32 Q's scores
//     and P.V, and the P.V of an int8 Q whose mode keeps P in fp32 (V
//     staged 128 lanes at a time after the scores).
//   - The KV split (split_d_fwd_splits: where the row tiles leave SMs
//     idle, Perceiver IO's 512 latents) deals each row tile's span into
//     runs, merged by split_d_attention.cu::split_d_fwd_merge_kernel; an
//     int8 P (P_INT8, or kv_span > 64) keeps one walk.
//   - S: a bf16 Q by bf16 mma.sync over K dequantized per token or BLOCK_2D
//     block (a cell is lane / bs of the whole head dim, so a block may
//     straddle two slices) and rounded to bf16, or over K's integers
//     (folded: CHANNEL / TENSOR scales in Q, ROW scales on the score
//     column); an int8 Q by s8 mma.sync m16n8k32 over K's integers, one k
//     step a 32-lane chunk, summed exactly in int32 and times the row's Q
//     scale; an fp32 Q by scalar fp32 FMAs, each chunk summed apart.
//   - P.V: bf16 mma.sync where the mode rounds to bf16 (every bf16 Q and
//     every int8 Q of a bf16 call), else scalar fp32 FMAs, over V
//     dequantized (TOKEN / BLOCK_2D) or its integers (the P and STORE
//     scale modes: ROW V scales on P, CHANNEL / TENSOR V scales at the
//     store of the CTA's own lanes; int8_pv's integer P times integer V,
//     exact in bf16 and summed in fp32).
//   - The element-wise steps are qattn_body's, in its order: the K column
//     scale, bias * log2(e), the mask (to mask_value), the base-2 online
//     softmax over 64-key tiles aligned to multiples of 64 from key 0, V's
//     P scale, the bf16 or int8 rounding of P, l over the rounded or the
//     unrounded P (L_ROUNDED); an int8 Q walks kv_span-key spans, with a
//     first pass over each span wider than a tile for its row max, so an
//     int8 P rounds against the TPU's block_kv max in every slice.
//   - Every slice runs the same score code in the same chunk order, so m,
//     l and P are the same bits in every slice; only slice 0 writes L.
// What bounds it: the tensor-core operations (4 D a live pair, the scores
// recomputed once a slice: (2 s + 2) D executed, s = slices); the int8 /
// int4 payloads halve or quarter the key side's bytes, which is what
// Perceiver IO's cross-attention (50,176 keys) reads most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "split_d_frame.cuh"

namespace {

using mfa_sd::QAttnArgs;

// Replaces ops/quantized_attention.py::_qfwd_kernel above D = 576 (the body:
// split_d_frame.cuh::split_d_fwd over QuantFwd).  QT: Q's type (float,
// bf16, int8); PT: the type P and V round to before P.V (bf16 where the
// mode rounds to bf16, else float).
template <typename QT, typename PT, bool RING>
__global__ void __launch_bounds__(256)
split_d_qattn_kernel(const QuantFwd<QT, RING> src) {
  split_d_fwd<PT, false>(src);
}

// RING where every payload row is whole 16-byte pieces (an fp32 Q stages
// synchronously either way: its scores and P.V are scalar).
template <typename QT, typename PT>
int qattn_of(const QAttnArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Sq + 63) / 64, a.Hq * mfa_sd::slices(a.D),
                  a.B * a.splits);
  const bool whole = a.D % 32 == 0 || (a.bits_k == 8 && a.bits_v == 8);
  if constexpr (!std::is_same<QT, float>::value)
    if (whole)
      return mfa::launch_with_smem(split_d_qattn_kernel<QT, PT, true>, grid,
                                   256, Smem<64, 1>::BYTES, stream,
                                   QuantFwd<QT, true>{a});
  return mfa::launch_with_smem(split_d_qattn_kernel<QT, PT, false>, grid, 256,
                               Smem<64, 1>::BYTES, stream,
                               QuantFwd<QT, false>{a});
}

}  // namespace

namespace mfa_sd {

// A bf16 Q always rounds to bf16 (csrc/quantized_attention.cu's routing);
// an int8 Q rounds P and V to bf16 where the call's mode does.
int launch_qattn(int qtype, const QAttnArgs& a, cudaStream_t stream) {
  if (!takes(a.D) || a.splits < 1 || a.splits > MAX_FWD_SPLITS ||
      (a.splits > 1 &&
       (!a.ws || (a.flags & P_INT8) || a.kv_span != TILE)))
    return (int)cudaErrorInvalidValue;
  const bool rb = a.flags & ROUND_BF16;
  if (qtype == 0) return qattn_of<float, float>(a, stream);
  if (qtype == 1 && rb)
    return qattn_of<__nv_bfloat16, __nv_bfloat16>(a, stream);
  if (qtype == 2)
    return rb ? qattn_of<int8_t, __nv_bfloat16>(a, stream)
              : qattn_of<int8_t, float>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mfa_sd

extern "C" {

// CTAs an SM the occupancy API gives split_d_qattn_kernel's instance for
// qtype (0 fp32 Q, 1 bf16, 2 int8 with a bf16 P, 3 int8 with an fp32 P)
// and ring (1: the raw path of whole rows; an fp32 Q has none); -1 for
// none (utils/profiling.py --fwd-splits prints them).
int mfa_split_d_qattn_ctas_per_sm(int qtype, int ring) {
  if (ring != 0 && ring != 1) return -1;
  if (qtype == 0)
    return ring ? -1
                : ctas_per_sm<1>(split_d_qattn_kernel<float, float, false>);
  if (qtype == 1)
    return ring ? ctas_per_sm<1>(
                      split_d_qattn_kernel<__nv_bfloat16, __nv_bfloat16, true>)
                : ctas_per_sm<1>(split_d_qattn_kernel<__nv_bfloat16,
                                                      __nv_bfloat16, false>);
  if (qtype == 2)
    return ring ? ctas_per_sm<1>(
                      split_d_qattn_kernel<int8_t, __nv_bfloat16, true>)
                : ctas_per_sm<1>(
                      split_d_qattn_kernel<int8_t, __nv_bfloat16, false>);
  if (qtype == 3)
    return ring ? ctas_per_sm<1>(split_d_qattn_kernel<int8_t, float, true>)
                : ctas_per_sm<1>(split_d_qattn_kernel<int8_t, float, false>);
  return -1;
}

}  // extern "C"

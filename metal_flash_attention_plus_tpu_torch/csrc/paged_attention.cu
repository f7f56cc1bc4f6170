// Paged attention kernels for Hopper (sm_90a): single-token decode and
// chunked causal prefill over the merged page pool, float or quantized.
//
// Replaces (TPU kernels of metal_flash_attention_plus_tpu):
//   - serving/paged_attention.py::_decode_kernel_streamed and ::_decode_kernel
//     (one function, two TPU schedules chosen by head_dim) ->
//     paged_decode_tc_kernel (bf16) and paged_decode_kernel (fp32), each
//     followed by paged_decode_merge_kernel where the KV axis is split
//   - serving/paged_attention.py::_prefill_kernel -> paged_prefill_tc_kernel
//     and, above D = 288, paged_prefill_wide_kernel (bf16, where prefill_tc
//     says so) and paged_prefill_kernel (the rest)
// Above D = 576 both go to the split-D kernels of
// csrc/split_d_attention.cu (split_d_decode_kernel, then
// paged_decode_merge_kernel here; split_d_prefill_kernel), which split O's
// lanes over CTAs and take the head dim at run time.
//
// Pool layouts (one layer of serving/kv_cache.py's pool, or of the MLA
// latent pool of models/cached_mla.py), MODE of the kernels' template:
//   - KV_FLOAT: kv [Hkv, NP+1, S_SUB*PT, D] of T (float or bf16, q's dtype).
//     S_SUB = 2: K of a page in token rows [0, PT), V in rows [PT, 2PT);
//     S_SUB = 1: one state per token that serves as K and V (MLA's latent
//     pages, [c | k_rope]);
//   - KV_INT8: the same rows in int8, with per-token symmetric scales
//     ks, vs [Hkv, NP+1, 1, PT] fp32 (row vectors);
//   - KV_INT4: kv [Hkv, NP+1, PT, D] int8, ONE byte per (token, d): K + 8 in
//     the low nibble, V as the signed high nibble (value << 4); K is
//     (byte & 0xF) - 8, V the arithmetic shift byte >> 4; scales as int8.
// V_TAIL_ZERO (vtz): V reads K's rows with its last vtz lanes zeroed (the
// rope tail of an MLA latent state, so one pool serves both sides).  The
// kernels compute O only over the kept lanes [0, D - vtz) and store 0 in
// the last vtz: each O lane depends on its own V lane only.
// Page ids come from int32 tables; an id is clamped into the pool so a bad
// entry cannot read outside it.  Each token's scale is read by its page id,
// which serves both TPU decode schedules (per-page scales in the streamed
// one, scales densified by the wrapper in the wave one).
// Head dims: any from 1 (the kernels of this file up to 576, the split-D
// kernels above).  The kernels compute D = the head dim
// rounded up to 16 lanes: q, O and the decode's workspace are rows of D
// (the wrapper zero-pads q and cuts O back), while the pool keeps its rows
// of the true head dim dp (PoolGeom::dp): the staging reads them as they
// lie, in 16-byte copies where a row is whole 16-byte chunks, else in 8-,
// 4-byte copies or element loads as its bytes allow, and zero-fills the
// bytes of lanes [dp, D) of the staged K and V: q's lanes there are zero
// too, so the last k step of S adds exact zeros (an int4 byte of 0 reads
// K = -8, V = 0), and O's lanes past dp are 0.
// The tensor-core kernels are built for the widths DP = 32, 64, 128, 256,
// 288 (MLAConfig()'s 256 + 32) and 576 (DeepSeek's absorbed 512 + 64) and
// run a D <= DP with their loops cut at D; the scalar kernels take D as a
// template constant for 32, 64, 128 and 288, and as a run-time value in
// their DC = 0 instances (one for D up to 288, one above, with smaller
// tiles).
//
// Numerics, shared with the plain PyTorch versions in
// serving/paged_attention.py so the two can be held to a tight tolerance:
//   - q is pre-scaled and rounded back to T: (float(q) * scale) -> T;
//   - s = sum_d q * k in fp32 (k the integer payload in the quantized
//     modes), THEN s *= ks[token]; then the causal or length mask;
//   - softmax statistics are fp32, natural exp, online (running max m,
//     running sum l, rescale alpha = exp(m_prev - m_next), alpha = 0 while
//     m_prev is -inf, p = 0 where the score is -inf); l sums the p before
//     any V scale;
//   - quantized modes: p *= vs[token]; then P is rounded to T before P.V
//     with the integer V (float mode: P rounded to T, V in T);
//   - the P.V sum is fp32 and the output is acc / l in T.
// The tensor-core kernels round P against the running max of their own
// tiles (and, in the decode, of their own split of the KV axis),
// where the plain versions take the row's global max: the same effect as
// the tensor-core forwards' tile boundaries (csrc/flash_attention.cu),
// covered by the bf16 gate.
//
// Paged decode: what bounds it on the H100, and the design.
//   One query token per sequence against its whole cache: 2 flops per KV
//   element, far below the ~295 flop/byte ridge, so the bound is the live
//   KV bytes over 3.35 TB/s: 4*D bytes per token and KV head in bf16 (2*D
//   with one-state pages); in int8 half of that plus 8 bytes of scales; in
//   int4 a quarter plus the same 8 bytes.  At the engine's batch (8
//   sequences x 4 KV heads, or 8 x 1 for MLA) one CTA per (sequence, KV
//   head) fills a quarter of the 132 SMs and each waits on its own loads,
//   so the KV axis is split across CTAs (flash-decoding): the grid is
//   (KV head x group slice, sequence, split), each split a fixed range of
//   `per` tokens of the table's capacity, planned on the host from shapes
//   alone (serving/paged_attention.py::decode_splits: two 64-token tiles
//   a split, more where the grid would pass eight CTAs an SM; 32 splits,
//   1024 CTAs, at the engine's batch), so no length is read back: each
//   CTA is a short chain of tile loads, and many chains keep the loads in
//   flight that one long chain would wait on.  A split past its
//   sequence's length writes an empty partial (m = -inf, l = 0) and exits.
//   Each split leaves its unnormalised partial (m, l, O) in an fp32
//   workspace [B, Hq, splits, D + 2]; paged_decode_merge_kernel, a second
//   launch, a CTA per query row, sums the splits in split order (weights
//   exp(m_s - max m), no atomics), so a call's result does not depend on
//   the order the CTAs ran in.  One split (a one-page table) writes O
//   directly and skips the merge.
//   The whole GQA group (up to 16 query rows; a larger group is sliced into
//   16-row slices) shares one CTA, so each KV byte is read once per split.
//   - bf16 (paged_decode_tc_kernel, 4 warps): the tile's 64 token rows (32
//     at 576: decode_tile) are gathered through their page ids into a
//     cp.async ring of two to four stages (decode_stages), 16 bytes a
//     thread, one token row at a time (any page size); int8 and
//     int4 payloads land as bytes and are widened into bf16 rows in shared
//     memory (exact: |x| <= 128).  The group's rows, zero-padded to 16,
//     are the A operand of bf16 mma.sync m16n8k16 into fp32: S = Q.K^T with
//     warp w taking tokens [16w, 16w + 16) (at 576 warps 0 and 1; ks
//     applied to S, the mask, the tile's row max and sums exchanged through
//     shared memory), then P (times vs, rounded to bf16) from shared memory
//     against V read by ldmatrix.trans for O += P.V, whose 16-lane column
//     blocks are dealt to the warps (at most 5 a warp at D = 288, 9 at
//     576: 72 fp32 registers).  With one-state pages one staged tile
//     serves as K and V, and P.V runs over the ceil((D - vtz) / 16) blocks
//     of kept lanes only (256 for MLAConfig(), 512 for DeepSeek's 576).
//   - fp32 (paged_decode_kernel, 8 warps): the same grid, split and ring
//     (32-token tiles of fp32 rows, 16 above D = 288: sc_tile), products by
//     scalar fp32 FMAs: TF32 would keep ~3 digits against the 2e-5 gate.
//
// Paged chunked prefill: what bounds it on the H100, and the design.
//   A chunk of C queries of one sequence against its cached prefix plus its
//   own causal triangle: 4*Hq*D flops per visible query-key pair (plus 2 *
//   D more per pair over the cached bytes, ~(offset+C)*Hkv*2*D elements),
//   i.e. compute bound on the tensor cores (989 TFLOP/s bf16) at the
//   engine's C = 256 in every pool mode.  The rows of one KV head are the
//   group-major rows r = g*C + c, contiguous in q [Hq, C, D]; causality is
//   in global positions (column <= offset + (r mod C)).
//   - bf16 up to D = 256, and MLA's D = 288 with one-state pages whose
//     kept lanes D - vtz fit 256 (paged_prefill_tc_kernel; prefill_tc, and
//     serving/paged_attention.py::prefill_body): FlashAttention-2 on
//     mma.sync, flash_fwd_tc_kernel's frame: one CTA per (64 rows, KV head),
//     the row tiles walked last first, 4 warps x 16 rows, S and O in
//     fragments; each 64-token KV tile is gathered through the page row
//     into a cp.async ring of two to four stages (prefill_stages; payload
//     bytes widened into bf16 rows as in the decode; one tile a stage with
//     one-state pages); tiles no
//     row of the CTA sees are not visited, tiles every row of a warp sees
//     skip the mask selects, and P.V runs over the kept lanes only (MLA:
//     256, as flash_fwd_tc_kernel's D = 256).  Known limit: at the
//     engine's chunk (C = 256 over 4 KV heads, or 16 heads over MLA's one)
//     that is 64 CTAs on 132 SMs, each a chain of up to 12 tiles, so the
//     tiles' latency, not the tensor cores, sets its time.
//   - bf16 above D = 288 with one-state pages whose kept lanes fit 512
//     (paged_prefill_wide_kernel): the same frame at 8 warps, O's 512
//     lanes split over two warp groups and the scores over the two warps
//     of a row slab, in 32-token tiles (see the kernel).
//   - fp32, and the other bf16 shapes (paged_prefill_kernel): scalar fp32
//     FMAs on 256 threads, a 4 x 4 score block a thread; Q, K and P staged
//     transposed in shared memory as fp32 so each thread's rows and columns
//     are 16-byte vectors; above D = 128, K^T and V share one buffer (V
//     staged after the scores), which keeps D = 288 at 171 KB; above 288,
//     32 query rows a CTA and 32-token tiles (4 x 1 scores a thread: the
//     same 171 KB at 576: pf_tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "split_d.cuh"

namespace {

using mfa::Elem;

constexpr int KV_FLOAT = 0;
constexpr int KV_INT8 = 1;
constexpr int KV_INT4 = 2;
// The widest head dim of this file's kernels (DeepSeek's absorbed width);
// wider ones go to the split-D kernels.
constexpr int MAX_D = 576;

__device__ __forceinline__ int clamp_page(int page, int num_pages_total) {
  return min(max(page, 0), num_pages_total - 1);
}

// Where a token's rows lie in the pool: page rows (S_SUB * PT, or PT for
// the int4 byte), V's row offset within the page (0 when K is V), V's
// zeroed tail lanes, the page's states (S_SUB; 1 for the int4 byte) and
// the head dim dp, the elements of a pool row (the kernels' D, dp rounded
// up to 16 lanes, is the width they compute).
struct PoolGeom {
  int PT, rows, v_row, vtz, ss, dp;
};

template <int MODE>
PoolGeom pool_geom(int PT, int s_sub, int vtz, int dp) {
  const int ss = MODE == KV_INT4 ? 1 : s_sub;
  return PoolGeom{PT, ss * PT, (ss - 1) * PT, vtz, ss, dp};
}

// The tensor-core kernels' built width for a head dim D.
int tc_width(int D) {
  return D <= 32    ? 32
         : D <= 64  ? 64
         : D <= 128 ? 128
         : D <= 256 ? 256
         : D <= 288 ? 288
                    : 576;
}

// Whether a prefill of dtype (0 = float32, 1 = bfloat16) at head dim D
// over pages of s_sub states with vtz zeroed V lanes runs on the tensor
// cores (paged_prefill_tc_kernel, or paged_prefill_wide_kernel above
// D = 288; else paged_prefill_kernel): bf16 where D <= 256, or where
// one-state pages leave D - vtz lanes for P.V that the width's fp32 O
// holds: 256 at 288 (MLAConfig()'s 288 - 32), 512 at 576 (DeepSeek's 576
// - 64, split over two warp groups).  The bf16 decode always runs
// paged_decode_tc_kernel, fp32 paged_decode_kernel.
// serving/paged_attention.py::prefill_body and ::decode_body answer the
// same.
bool prefill_tc(int dtype, int D, int s_sub, int vtz) {
  const int pv_lanes = D <= 288 ? 256 : 512;
  return dtype == 1 && D <= MAX_D &&
         (D <= 256 || (s_sub == 1 && D - vtz <= pv_lanes));
}

// The split-D kernels' arguments (csrc/split_d.cuh) of a call.
mfa_sd::PagedArgs split_d_paged(const void* q, const void* kv,
                                const float* ks, const float* vs,
                                const int32_t* table, void* out, int Hq,
                                int Hkv, int D, int num_pages_total,
                                int max_pages, const PoolGeom& pg,
                                float scale) {
  mfa_sd::PagedArgs p{};
  p.q = q;
  p.kv = kv;
  p.kscale = ks;
  p.vscale = vs;
  p.table = table;
  p.out = out;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.dp = pg.dp;
  p.PT = pg.PT;
  p.rows = pg.rows;
  p.v_row = pg.v_row;
  p.vtz = pg.vtz;
  p.num_pages_total = num_pages_total;
  p.max_pages = max_pages;
  p.scale = scale;
  return p;
}

using mfa::launch_with_smem;

// ---------------------------------------------------------------------------
// Staging: token rows through their page ids, payloads widened
// ---------------------------------------------------------------------------

// stage_tokens' copies where a pool row is not whole 16-byte chunks (dp <
// D): as stage_tokens' own loop (warp lanes on consecutive copies of its
// tokens' rows, `halves` a token, half_stride bytes apart in dst; a copy's
// token by a multiply-high, its pool row by shuffle from the lane that
// worked it out: my_row, my_ok), each pool row of row_bytes landing in a
// dst row of dst_bytes, zeros past row_bytes and for tokens not ok.  A copy
// is the largest power of two up to 16 that divides row_bytes: cp.async of
// 16, 8 or 4, or a plain load of 2 or 1 (a row of an odd bf16 or byte
// count).
template <int TPW>
__device__ __forceinline__ void copy_padded_rows(
    const uint8_t* __restrict__ kv, int v_row, int halves, int row_bytes,
    int dst_bytes, size_t my_row, bool my_ok, int tw, uint8_t* dst,
    int dst_ld, int half_stride) {
  const int lane = threadIdx.x & 31;
  const int ch = min(row_bytes & -row_bytes, 16);  // bytes a copy
  const int cpr = dst_bytes / ch;  // copies a staged row
  const int per_tok = halves * cpr;
  const int total = TPW * per_tok;
  const uint32_t magic = 0xFFFFFFFFu / (uint32_t)per_tok + 1u;
  const uint32_t row_lo = (uint32_t)my_row;
  const uint32_t row_hi = (uint32_t)(my_row >> 32);
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    const int j = min((int)__umulhi((uint32_t)i, magic), TPW - 1);
    const size_t row =
        (size_t)__shfl_sync(0xffffffffu, row_lo, j) |
        (size_t)__shfl_sync(0xffffffffu, row_hi, j) << 32;
    const bool ok = __shfl_sync(0xffffffffu, my_ok ? 1 : 0, j) != 0;
    if (i < total) {
      const int rem = i - j * per_tok;
      const int hf = rem >= cpr ? 1 : 0;
      const int c = rem - hf * cpr;
      const bool in = ok && c * ch < row_bytes;  // lanes from dp: zeros
      const uint8_t* src =
          kv + (row + hf * v_row) * (size_t)row_bytes + (in ? c * ch : 0);
      uint8_t* to = dst + hf * half_stride + (tw + j) * dst_ld + c * ch;
      if (ch == 16) {
        mfa::cp_async16(to, src, in ? 16 : 0);
      } else if (ch == 8) {
        mfa::cp_async8(to, src, in ? 8 : 0);
      } else if (ch == 4) {
        mfa::cp_async4(to, src, in ? 4 : 0);
      } else if (ch == 2) {
        *reinterpret_cast<uint16_t*>(to) =
            in ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
      } else {
        *to = in ? *src : (uint8_t)0;
      }
    }
  }
}

// cp.async the rows of tokens [t0, t0 + NTOK) of one KV head into dst:
// each token's `halves` rows (1: its K row, which is V too, or its int4
// byte; 2: K's row, then V's half_stride bytes on) of pg.dp elements of
// esz bytes, widened with zero bytes to D elements, dst_ld bytes apart;
// tokens from `lim` are zeros.  NT threads; warp w stages tokens [w * TPW,
// (w + 1) * TPW): lane j < TPW reads token j's page id once (clamped into
// the pool) and works out its pool row, which the warp's 16-byte copies
// take by shuffle, consecutive lanes on consecutive chunks of a row (a
// copy's token by a multiply-high: the index is below 2^16, so the
// rounded-up reciprocal divides exactly), where WHOLE (dp = D); else
// copy_padded_rows.  The tensor-core kernels take WHOLE as a template
// argument, so their tile loops hold one kind of copy: both in one loop
// slowed the int8 prefill at D = 64 by 20-24% on the card.  With kscale,
// the tokens' K and V scales (zeros from `lim`) go to sc[0, NTOK) and
// sc[NTOK, 2 NTOK).
template <int NT, int NTOK, bool WHOLE>
__device__ __forceinline__ void stage_tokens(
    const uint8_t* __restrict__ kv, const int32_t* __restrict__ table_row,
    size_t head_base, int num_pages_total, const PoolGeom& pg, int halves,
    int esz, int D, int t0, int lim, uint8_t* dst, int dst_ld,
    int half_stride, const float* kscale, const float* vscale, float* sc) {
  constexpr int TPW = NTOK / (NT / 32);
  static_assert(TPW >= 1 && TPW <= 32, "a warp stages 1 to 32 tokens");
  const int lane = threadIdx.x & 31;
  const int tw = (threadIdx.x >> 5) * TPW;
  const int my_pos = t0 + tw + lane;
  const bool my_ok = lane < TPW && my_pos < lim;
  size_t my_row = 0;  // the token's K row in the pool
  if (my_ok) {
    const int page = clamp_page(table_row[my_pos / pg.PT], num_pages_total);
    const int off = my_pos % pg.PT;
    my_row = (head_base + page) * pg.rows + off;
    if (kscale != nullptr) {
      const size_t at = (head_base + page) * pg.PT + off;
      mfa::cp_async4(sc + tw + lane, kscale + at, 4);
      mfa::cp_async4(sc + NTOK + tw + lane, vscale + at, 4);
    }
  } else if (kscale != nullptr && lane < TPW) {
    mfa::cp_async4(sc + tw + lane, kscale, 0);
    mfa::cp_async4(sc + NTOK + tw + lane, vscale, 0);
  }
  if constexpr (!WHOLE) {
    copy_padded_rows<TPW>(kv, pg.v_row, halves, pg.dp * esz, D * esz,
                          my_row, my_ok, tw, dst, dst_ld, half_stride);
    return;
  }
  const int row_bytes = D * esz;
  const int cpr = row_bytes >> 4;  // 16-byte chunks a row
  const int per_tok = halves * cpr;
  const int total = TPW * per_tok;
  const uint32_t magic = 0xFFFFFFFFu / (uint32_t)per_tok + 1u;
  const uint32_t row_lo = (uint32_t)my_row;
  const uint32_t row_hi = (uint32_t)(my_row >> 32);
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    const int j = min((int)__umulhi((uint32_t)i, magic), TPW - 1);
    const size_t row =
        (size_t)__shfl_sync(0xffffffffu, row_lo, j) |
        (size_t)__shfl_sync(0xffffffffu, row_hi, j) << 32;
    const bool ok = __shfl_sync(0xffffffffu, my_ok ? 1 : 0, j) != 0;
    if (i < total) {
      const int rem = i - j * per_tok;
      const int hf = rem >= cpr ? 1 : 0;
      const int c = rem - hf * cpr;
      const uint8_t* src =
          kv + (row + hf * pg.v_row) * (size_t)row_bytes + c * 16;
      mfa::cp_async16(dst + hf * half_stride + (tw + j) * dst_ld + c * 16,
                      src, ok ? 16 : 0);
    }
  }
}

// 16 payload bytes (one 16-byte chunk of a row) as floats: k the int8
// values (KV_INT8), or of the int4 bytes the K nibbles (low, minus 8) and
// v the V nibbles (the signed high ones).  On the FP32 pipe (mma.cuh's
// byte tricks): exact, and off the conversion unit.
template <int E>
__device__ __forceinline__ float u8_minus8(uint32_t x) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | E)) -
         8388616.0f;
}

template <int MODE>
__device__ __forceinline__ void widen16(const uint4& u, float (&k)[16],
                                        float (&v)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (MODE == KV_INT4) {
      const uint32_t lo = w[q] & 0x0F0F0F0Fu;
      const uint32_t hi = ((w[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      k[4 * q] = u8_minus8<0>(lo);
      k[4 * q + 1] = u8_minus8<1>(lo);
      k[4 * q + 2] = u8_minus8<2>(lo);
      k[4 * q + 3] = u8_minus8<3>(lo);
      v[4 * q] = u8_minus8<0>(hi);
      v[4 * q + 1] = u8_minus8<1>(hi);
      v[4 * q + 2] = u8_minus8<2>(hi);
      v[4 * q + 3] = u8_minus8<3>(hi);
    } else {
      const uint32_t x = w[q] ^ 0x80808080u;
      k[4 * q] = mfa::s8_f32<0>(x);
      k[4 * q + 1] = mfa::s8_f32<1>(x);
      k[4 * q + 2] = mfa::s8_f32<2>(x);
      k[4 * q + 3] = mfa::s8_f32<3>(x);
    }
  }
}

// Staged payload rows [NTOK][raw_ld] (`halves` of them, raw_half bytes
// apart) -> rows of the operand tiles dst ([NTOK][dst_ld], K then V
// dst_half bytes on): int8 halves as they are, the int4 byte as its K
// nibble into the K tile and its V nibble into the V tile; bf16 rows
// (BF16) or fp32 rows.  D / 16 chunks a row, NT threads.
template <int MODE, bool BF16, int NT, int NTOK>
__device__ __forceinline__ void widen_rows(const uint8_t* raw, int raw_ld,
                                           int raw_half, int halves, int D,
                                           uint8_t* dst, int dst_ld,
                                           int dst_half) {
  const int cpr = D >> 4;
  const int per_half = NTOK * cpr;
  for (int i = threadIdx.x; i < halves * per_half; i += NT) {
    const int hf = i >= per_half ? 1 : 0;
    const int rem = i - hf * per_half;
    const int r = rem / cpr;
    const int c = rem - r * cpr;
    const uint4 u =
        *reinterpret_cast<const uint4*>(raw + hf * raw_half + r * raw_ld +
                                        c * 16);
    float k[16], v[16];
    widen16<MODE>(u, k, v);
    const int nout = MODE == KV_INT4 ? 2 : 1;
#pragma unroll
    for (int o = 0; o < nout; ++o) {
      const float* f = o ? v : k;
      uint8_t* d = dst + (hf + o) * dst_half + r * dst_ld;
      if constexpr (BF16) {
        uint4* p = reinterpret_cast<uint4*>(d + c * 32);
        p[0] = make_uint4(mfa::pack_bf16_exact(f[0], f[1]),
                          mfa::pack_bf16_exact(f[2], f[3]),
                          mfa::pack_bf16_exact(f[4], f[5]),
                          mfa::pack_bf16_exact(f[6], f[7]));
        p[1] = make_uint4(mfa::pack_bf16_exact(f[8], f[9]),
                          mfa::pack_bf16_exact(f[10], f[11]),
                          mfa::pack_bf16_exact(f[12], f[13]),
                          mfa::pack_bf16_exact(f[14], f[15]));
      } else {
        float4* p = reinterpret_cast<float4*>(d + c * 64);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                             f[4 * e + 3]);
      }
    }
  }
}

// bf16 rows in place, 16-byte chunks `cpr` a row: x -> round_bf16(x *
// scale), as (float(q) * scale) -> bf16 (bf16_bits gives cvt.rn's bits on
// the FP32 pipe); NT threads.
template <int NT>
__device__ __forceinline__ void scale_rows(uint8_t* tile, int ld, int rows,
                                           int cpr, float scale) {
  for (int i = threadIdx.x; i < rows * cpr; i += NT) {
    uint4* p = reinterpret_cast<uint4*>(tile + (i / cpr) * ld +
                                        (i % cpr) * 16);
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = __fmul_rn(__uint_as_float(w[e] << 16), scale);
      const float hi = __fmul_rn(__uint_as_float(w[e] & 0xFFFF0000u), scale);
      w[e] = __byte_perm(mfa::bf16_bits(lo), mfa::bf16_bits(hi), 0x7632);
    }
    *p = u;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernels' shared pieces
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps
constexpr int TK = 64;           // KV tokens a tile

// The stages of a tensor-core kernel's cp.async ring at width DP: as many
// as keep a CTA's shared memory within the card's 227 KB at every pool
// layout it takes (the prefill at 288: one-state pages only).  A chain of
// tiles waits on each tile's loads less the deeper the ring: the decode's
// splits and the prefill's 64 CTAs are such chains.
template <int DP>
__host__ __device__ constexpr int decode_stages() {
  return DP <= 64 ? 4 : DP <= 128 ? 3 : 2;
}
// The decode's KV tokens a tile at width DP: 64, or 32 at 576, where two
// 64-token stages of two-state pages (2 x 149,504 B) or the widened K and V
// tiles of a quantized pool would not fit; two 32-token stages of one-state
// pages leave room for two CTAs an SM, as many bytes in flight as one CTA
// of 64-token stages.
template <int DP>
__host__ __device__ constexpr int decode_tile() {
  return DP > 288 ? 32 : TK;
}
template <int DP>
__host__ __device__ constexpr int prefill_stages() {
  return DP <= 64 ? 4 : DP == 256 ? 2 : 3;
}

// Byte offsets of a tensor-core kernel's shared memory: an NS-stage ring
// of staged token rows ([NS][halves][TKT][stage_ld]: the bf16 operand rows
// of a float pool, else payload bytes), the widened bf16 operand tiles of
// a quantized pool ([nkv][TKT][ROW]), Q ([q_rows][ROW]), the decode's P
// ([16][2 TKT + 16]), the scales ([NS][2][TKT] fp32) and the decode's row
// statistics ([2][4][16] fp32); TKT tokens a tile.
struct TcLayout {
  int halves, nkv, stage_ld;
  int conv, q, p, sc, red, bytes;
};

template <int DP, int MODE, int NS, int TKT = TK>
__host__ __device__ __forceinline__ TcLayout tc_layout(int ss, int q_rows,
                                                       bool decode) {
  constexpr int ROW = 2 * DP + 16;
  TcLayout L;
  L.halves = MODE == KV_INT4 ? 1 : ss;
  L.nkv = MODE == KV_INT4 ? 2 : ss;
  L.stage_ld = MODE == KV_FLOAT ? ROW : DP + 16;
  L.conv = NS * L.halves * TKT * L.stage_ld;
  L.q = L.conv + (MODE == KV_FLOAT ? 0 : L.nkv * TKT * ROW);
  L.p = L.q + q_rows * ROW;
  L.sc = L.p + (decode ? 16 * (2 * TKT + 16) : 0);
  L.red = L.sc + NS * 2 * TKT * (int)sizeof(float);
  L.bytes = L.red + (decode ? 2 * 4 * 16 * (int)sizeof(float) : 0);
  return L;
}

// acc[j] += A[ar0, ar0 + 16) . B[br0 + 8j, br0 + 8j + 8)^T over the first
// 16 * kc_n lanes (kc_n <= KCM): bf16 row tiles whose rows hold k (A_LD,
// B_LD bytes a row), both read by ldmatrix; NB even.
template <int KCM, int NB, int A_LD, int B_LD>
__device__ __forceinline__ void mma_qk(const uint8_t* A, int ar0,
                                       const uint8_t* B, int br0, int kc_n,
                                       float (&acc)[NB][4]) {
  const int lane = threadIdx.x & 31;
  const uint8_t* ap =
      A + (ar0 + mfa::ldsm_a_row(lane)) * A_LD + mfa::ldsm_a_byte(lane);
  const uint8_t* bp =
      B + (br0 + mfa::ldsm_b_row(lane)) * B_LD + mfa::ldsm_b_byte(lane);
#pragma unroll
  for (int kc = 0; kc < KCM; ++kc) {
    if (kc < kc_n) {
      uint32_t af[4];
      mfa::ldsm_x4(af, ap + kc * 32);
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2) {
        uint32_t bf[4];
        mfa::ldsm_x4(bf, bp + j2 * 16 * B_LD + kc * 32);
        mfa::mma_bf16(acc[2 * j2], af, bf[0], bf[1], acc[2 * j2]);
        mfa::mma_bf16(acc[2 * j2 + 1], af, bf[2], bf[3], acc[2 * j2 + 1]);
      }
    }
  }
}

// acc[0..1] += A . V[k0, k0 + 16)[16 cb, 16 cb + 16): A one m16n8k16 A
// fragment (16 rows x 16 tokens), V a bf16 row tile [token][lane] (ROW
// bytes a row) read by ldmatrix.trans.
template <int ROW>
__device__ __forceinline__ void mma_pv(const uint32_t (&af)[4],
                                       const uint8_t* V, int k0, int cb,
                                       float (&acc0)[4], float (&acc1)[4]) {
  const int lane = threadIdx.x & 31;
  uint32_t bf[4];
  mfa::ldsm_x4_t(bf, V + (k0 + mfa::ldsm_t_k(lane)) * ROW +
                         (16 * cb + mfa::ldsm_t_n(lane)) * 2);
  mfa::mma_bf16(acc0, af, bf[0], bf[1], acc0);
  mfa::mma_bf16(acc1, af, bf[2], bf[3], acc1);
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;
  const void* kv;
  const float* kscale;
  const float* vscale;
  const int32_t* table;
  const int32_t* lengths;
  void* out;
  float* ws;  // [B, Hq, splits, D + 2]: m, l, O of each split (splits > 1)
  int Hq, G, gc, gslices, D, num_pages_total, max_pages, splits, per;
  PoolGeom pg;
  float scale;
};

// Replaces serving/paged_attention.py::_decode_kernel_streamed and
// ::_decode_kernel for a bf16 q.  Bound: the live KV bytes (see above).
// WHOLE: pool rows of whole 16-byte chunks (stage_tokens).
template <int DP, int MODE, bool WHOLE>
__global__ void __launch_bounds__(TC_THREADS)
paged_decode_tc_kernel(const DecodeArgs a) {
  constexpr bool QUANT = MODE != KV_FLOAT;
  constexpr int ROW = 2 * DP + 16;
  constexpr int KCM = DP / 16;
  constexpr int NCH = (DP / 16 + 3) / 4;  // 16-lane O blocks a warp, at most
  constexpr int NS = decode_stages<DP>();
  constexpr int TKD = decode_tile<DP>();  // tokens a tile
  constexpr int SW = TKD / 16;            // warps with 16 of a tile's tokens
  constexpr int PRW = 2 * TKD + 16;       // a bf16 row of P [16][TKD]
  extern __shared__ __align__(16) uint8_t smem[];
  const PoolGeom pg = a.pg;
  const TcLayout L = tc_layout<DP, MODE, NS, TKD>(pg.ss, 16, true);
  const int D = a.D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int h = blockIdx.x / a.gslices;
  const int g0 = (blockIdx.x % a.gslices) * a.gc;
  const int gn = min(a.gc, a.G - g0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_tok = min(a.lengths[b], a.max_pages * pg.PT);
  const int t_begin = split * a.per;
  const int t_end = min(t_begin + a.per, n_tok);
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * a.G + g0;
  const size_t part_ld = (size_t)a.splits * (D + 2);
  float* part = a.splits > 1
                    ? a.ws + (qrow0 * a.splits + split) * (size_t)(D + 2)
                    : nullptr;
  if (a.splits > 1 && t_begin >= t_end) {  // past the sequence: empty
    if (tid < gn) {
      part[tid * part_ld] = -INFINITY;
      part[tid * part_ld + 1] = 0.f;
    }
    return;
  }
  uint8_t* sq = smem + L.q;
  uint8_t* sp = smem + L.p;
  float* ssc = reinterpret_cast<float*>(smem + L.sc);
  float* red = reinterpret_cast<float*>(smem + L.red);  // [2][4][16]
  const int ring_stage = L.halves * TKD * L.stage_ld;
  const size_t head_base = (size_t)h * a.num_pages_total;
  auto stage = [&](int t0, int buf) {
    stage_tokens<TC_THREADS, TKD, WHOLE>(
        static_cast<const uint8_t*>(a.kv), a.table + (size_t)b * a.max_pages,
        head_base, a.num_pages_total, pg, L.halves, QUANT ? 1 : 2, D, t0,
        t_end, smem + buf * ring_stage, L.stage_ld, TKD * L.stage_ld,
        QUANT ? a.kscale : nullptr, a.vscale, ssc + buf * 2 * TKD);
  };

  // The group's q rows, zero rows up to 16, scaled and rounded in place.
  const int qc = D / 8;  // 16-byte chunks a q row
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + qrow0 * D;
  for (int i = tid; i < 16 * qc; i += TC_THREADS) {
    const int r = i / qc;
    const int c = i - r * qc;
    const bool ok = r < gn;
    mfa::cp_async16(sq + r * ROW + c * 16,
                    qb + (size_t)(ok ? r : 0) * D + c * 8, ok ? 16 : 0);
  }
  mfa::cp_async_commit();
  for (int k = 0; k < NS - 1; ++k) {  // tiles 0 .. NS - 2, a group each
    if (t_begin + k * TKD < t_end) stage(t_begin + k * TKD, k);
    mfa::cp_async_commit();
  }
  mfa::cp_async_wait<NS - 1>();
  __syncthreads();  // q landed
  scale_rows<TC_THREADS>(sq, ROW, 16, qc, a.scale);

  const int v_keep = (WHOLE ? D : pg.dp) - pg.vtz;
  const int nchunks = (v_keep + 15) / 16;  // 16-lane O blocks computed
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NCH][2][4];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][0][e] = acc[k][1][e] = 0.f;

  for (int t0 = t_begin, buf = 0; t0 < t_end;
       t0 += TKD, buf = buf + 1 == NS ? 0 : buf + 1) {
    mfa::cp_async_wait<NS - 2>();
    __syncthreads();  // this tile staged, q scaled; the last tile's
                      // readers done with its stage
    if (t0 + (NS - 1) * TKD < t_end)
      stage(t0 + (NS - 1) * TKD, buf == 0 ? NS - 1 : buf - 1);
    mfa::cp_async_commit();
    const uint8_t* sk = smem + buf * ring_stage;
    if constexpr (QUANT) {
      widen_rows<MODE, true, TC_THREADS, TKD>(sk, L.stage_ld,
                                              TKD * L.stage_ld, L.halves, D,
                                              smem + L.conv, ROW, TKD * ROW);
      __syncthreads();
      sk = smem + L.conv;
    }
    const uint8_t* sv = L.nkv == 2 ? sk + TKD * ROW : sk;
    const float* ksc = ssc + buf * 2 * TKD;
    const float* vsc = ksc + TKD;

    // S for this warp's 16 tokens (warps from SW have none: their scores
    // are -inf): element (row g + 8i, token 16 warp + 8j + 2tq + c) at
    // s[j][2i + c].
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = -INFINITY;
    float mx[2] = {-INFINITY, -INFINITY};
    if (warp < SW) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      mma_qk<KCM, 2, ROW, ROW>(sq, 0, sk, 16 * warp, D / 16, s);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = 16 * warp + 8 * j + 2 * tq + (e & 1);
          float x = s[j][e];
          if (QUANT) x *= ksc[tl];
          x = t0 + tl < t_end ? x : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (tq == 0) red[warp * 16 + g + 8 * i] = mx[i];
    }
    __syncthreads();  // the warps' row maxima
    float alpha[2], mref[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      const float tm = fmaxf(fmaxf(red[r], red[16 + r]),
                             fmaxf(red[32 + r], red[48 + r]));
      const float m_next = fmaxf(m[i], tm);
      alpha[i] = m[i] == -INFINITY ? 0.f : __expf(m[i] - m_next);
      mref[i] = m_next == -INFINITY ? 0.f : m_next;
      m[i] = m_next;
    }
    // P = exp(s - m): l sums it before the V scale; P.V takes it times vs,
    // rounded to bf16, from shared memory.
    if (warp < SW) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tl = 16 * warp + 8 * j + 2 * tq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float p0 = __expf(s[j][2 * i] - mref[i]);
          float p1 = __expf(s[j][2 * i + 1] - mref[i]);
          sum[i] += p0 + p1;
          if (QUANT) {
            p0 *= vsc[tl];
            p1 *= vsc[tl + 1];
          }
          *reinterpret_cast<uint32_t*>(sp + (g + 8 * i) * PRW + 2 * tl) =
              mfa::pack_bf16(p0, p1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      if (tq == 0) red[64 + warp * 16 + g + 8 * i] = sum[i];
    }
    __syncthreads();  // P and the warps' row sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 64 + g + 8 * i;
      l[i] = alpha[i] * l[i] +
             (((red[r] + red[16 + r]) + red[32 + r]) + red[48 + r]);
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[k][n][0] *= alpha[0];
          acc[k][n][1] *= alpha[0];
          acc[k][n][2] *= alpha[1];
          acc[k][n][3] *= alpha[1];
        }
    }
    uint32_t pa[SW][4];
#pragma unroll
    for (int kk = 0; kk < SW; ++kk)
      mfa::ldsm_x4(pa[kk], sp + mfa::ldsm_a_row(lane) * PRW + kk * 32 +
                               mfa::ldsm_a_byte(lane));
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int cb = warp + 4 * k;
      if (cb < nchunks) {
#pragma unroll
        for (int kk = 0; kk < SW; ++kk)
          mma_pv<ROW>(pa[kk], sv, 16 * kk, cb, acc[k][0], acc[k][1]);
      }
    }
  }
  mfa::cp_async_wait<0>();

  if (a.splits == 1) {
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + qrow0 * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      if (r >= gn) continue;
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int cb = warp + 4 * k;
        if (cb >= nchunks) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int d = 16 * cb + 8 * n + 2 * tq;
          *reinterpret_cast<uint32_t*>(ob + (size_t)r * D + d) =
              mfa::pack_bf16(d < v_keep ? acc[k][n][2 * i] / li : 0.f,
                             d + 1 < v_keep ? acc[k][n][2 * i + 1] / li : 0.f);
        }
      }
    }
    const int zl = D - 16 * nchunks;  // lanes past the computed blocks
    for (int i = tid; i < gn * zl; i += TC_THREADS)
      ob[(size_t)(i / zl) * D + 16 * nchunks + i % zl] = __float2bfloat16(0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      if (r >= gn) continue;
      float* pr = part + r * part_ld;
      if (warp == 0 && tq == 0) {
        pr[0] = m[i];
        pr[1] = l[i];
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int cb = warp + 4 * k;
        if (cb >= nchunks) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<float2*>(pr + 2 + 16 * cb + 8 * n + 2 * tq) =
              make_float2(acc[k][n][2 * i], acc[k][n][2 * i + 1]);
      }
    }
  }
}

// q_row . k_row over n4 float4s, the products summed in lane order; fully
// unrolled when the head dim DC is a compile-time constant.
template <int DC>
__device__ __forceinline__ float row_dot(const float4* a, const float4* b,
                                         int n4) {
  float s = 0.f;
  auto step = [&](int c) {
    const float4 x = a[c];
    const float4 y = b[c];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  };
  if constexpr (DC != 0) {
#pragma unroll
    for (int c = 0; c < DC / 4; ++c) step(c);
  } else {
#pragma unroll 8
    for (int c = 0; c < n4; ++c) step(c);
  }
  return s;
}

constexpr int SC_THREADS = 256;  // 8 warps

// paged_decode_kernel's KV tokens a tile for head dims up to DMAX: 32, or
// 16 above 288, where two 32-token stages of two-state fp32 pages at 576
// (2 x 148,480 B) would not fit.
template <int DMAX>
__host__ __device__ constexpr int sc_tile() {
  return DMAX > 288 ? 16 : 32;
}

// The stages of paged_decode_kernel's ring at head dim DC (0: run time),
// as decode_stages: within 227 KB for two-state fp32 pages.
template <int DC>
__host__ __device__ constexpr int sc_stages() {
  return DC != 0 && DC <= 64 ? 4 : DC == 128 ? 3 : 2;
}

// Byte offsets of paged_decode_kernel's shared memory: the ring of staged
// rows ([NS][halves][TKS][stage_ld]: fp32 rows of D + 4 floats for a
// float pool, else payload bytes), the widened fp32 K and V tiles of a
// quantized pool, q [gc][D], P [gc][TKS], m, l, alpha [gc] and the
// scales [NS][2][TKS]; TKS tokens a tile.
struct ScLayout {
  int halves, nkv, stage_ld, conv, q, p, stats, sc, bytes;
};

template <int MODE, int NS, int TKS>
__host__ __device__ __forceinline__ ScLayout sc_layout(int D, int ss,
                                                       int gc) {
  const int row = (D + 4) * (int)sizeof(float);
  ScLayout L;
  L.halves = MODE == KV_INT4 ? 1 : ss;
  L.nkv = MODE == KV_INT4 ? 2 : ss;
  L.stage_ld = MODE == KV_FLOAT ? row : D + 16;
  L.conv = NS * L.halves * TKS * L.stage_ld;
  L.q = L.conv + (MODE == KV_FLOAT ? 0 : L.nkv * TKS * row);
  L.p = L.q + gc * D * (int)sizeof(float);
  L.stats = L.p + gc * TKS * (int)sizeof(float);
  L.sc = L.stats + ((3 * gc + 3) / 4) * 4 * (int)sizeof(float);
  L.bytes = L.sc + NS * 2 * TKS * (int)sizeof(float);
  return L;
}

// Replaces serving/paged_attention.py::_decode_kernel_streamed and
// ::_decode_kernel for an fp32 q: paged_decode_tc_kernel's grid, splits and
// ring over tiles of fp32 rows (sc_tile), the products by scalar fp32 FMAs.
// DC: the head dim, or 0 for a run-time one up to DMAX.
template <int DC, int MODE, int DMAX = (DC != 0 ? DC : 288)>
__global__ void __launch_bounds__(SC_THREADS)
paged_decode_kernel(const DecodeArgs a) {
  constexpr bool QUANT = MODE != KV_FLOAT;
  constexpr int NS = sc_stages<DC>();
  constexpr int TKS = sc_tile<DMAX>();
  constexpr int MAX_OUT = DMAX / 16;  // outputs a thread: 16 rows x DMAX
  extern __shared__ __align__(16) uint8_t smem[];
  const PoolGeom pg = a.pg;
  const int D = DC ? DC : a.D;
  const int KS = D + 4;  // floats a staged row
  const ScLayout L = sc_layout<MODE, NS, TKS>(D, pg.ss, a.gc);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x / a.gslices;
  const int g0 = (blockIdx.x % a.gslices) * a.gc;
  const int gn = min(a.gc, a.G - g0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_tok = min(a.lengths[b], a.max_pages * pg.PT);
  const int t_begin = split * a.per;
  const int t_end = min(t_begin + a.per, n_tok);
  const size_t qrow0 = (size_t)b * a.Hq + (size_t)h * a.G + g0;
  const size_t part_ld = (size_t)a.splits * (D + 2);
  float* part = a.splits > 1
                    ? a.ws + (qrow0 * a.splits + split) * (size_t)(D + 2)
                    : nullptr;
  if (a.splits > 1 && t_begin >= t_end) {  // past the sequence: empty
    if (tid < gn) {
      part[tid * part_ld] = -INFINITY;
      part[tid * part_ld + 1] = 0.f;
    }
    return;
  }
  float* qs = reinterpret_cast<float*>(smem + L.q);   // [gc][D]
  float* ps = reinterpret_cast<float*>(smem + L.p);   // [gc][TKS]
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + a.gc;
  float* a_s = l_s + a.gc;
  float* ssc = reinterpret_cast<float*>(smem + L.sc);
  const int ring_stage = L.halves * TKS * L.stage_ld;
  const size_t head_base = (size_t)h * a.num_pages_total;
  auto stage = [&](int t0, int buf) {
    auto copy = [&](auto whole) {
      stage_tokens<SC_THREADS, TKS, decltype(whole)::value>(
          static_cast<const uint8_t*>(a.kv),
          a.table + (size_t)b * a.max_pages, head_base, a.num_pages_total,
          pg, L.halves, QUANT ? 1 : 4, D, t0, t_end,
          smem + buf * ring_stage, L.stage_ld, TKS * L.stage_ld,
          QUANT ? a.kscale : nullptr, a.vscale, ssc + buf * 2 * TKS);
    };
    if (pg.dp == D)
      copy(std::true_type());
    else
      copy(std::false_type());
  };
  for (int k = 0; k < NS - 1; ++k) {  // tiles 0 .. NS - 2, a group each
    if (t_begin + k * TKS < t_end) stage(t_begin + k * TKS, k);
    mfa::cp_async_commit();
  }

  const float* qb = static_cast<const float*>(a.q) + qrow0 * D;
  for (int i = tid; i < gn * D; i += SC_THREADS) qs[i] = qb[i] * a.scale;
  for (int g = tid; g < gn; g += SC_THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int k = 0; k < MAX_OUT; ++k) acc[k] = 0.f;
  const int n_out = gn * D;

  for (int t0 = t_begin, buf = 0; t0 < t_end;
       t0 += TKS, buf = buf + 1 == NS ? 0 : buf + 1) {
    mfa::cp_async_wait<NS - 2>();
    __syncthreads();  // this tile staged; the last tile's readers done
    if (t0 + (NS - 1) * TKS < t_end)
      stage(t0 + (NS - 1) * TKS, buf == 0 ? NS - 1 : buf - 1);
    mfa::cp_async_commit();
    const uint8_t* st = smem + buf * ring_stage;
    if constexpr (QUANT) {
      widen_rows<MODE, false, SC_THREADS, TKS>(
          st, L.stage_ld, TKS * L.stage_ld, L.halves, D, smem + L.conv,
          KS * 4, TKS * KS * 4);
      __syncthreads();
      st = smem + L.conv;
    }
    const float* kt = reinterpret_cast<const float*>(st);
    const float* vt = L.nkv == 2 ? kt + TKS * KS : kt;
    const float* ksc = ssc + buf * 2 * TKS;
    const float* vsc = ksc + TKS;

    for (int i = tid; i < gn * TKS; i += SC_THREADS) {
      const int g = i / TKS;
      const int t = i % TKS;
      float s = row_dot<DC>(reinterpret_cast<const float4*>(qs + g * D),
                            reinterpret_cast<const float4*>(kt + t * KS),
                            D / 4);
      if (QUANT) s *= ksc[t];
      ps[i] = (t0 + t < t_end) ? s : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < gn; g += SC_THREADS / 32) {
      float* pr = ps + g * TKS;
      const float s0 = lane < TKS ? pr[lane] : -INFINITY;
      float mx = s0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_next);
      const float p0 = (s0 == -INFINITY) ? 0.f : expf(s0 - m_next);
      float sum = p0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < TKS) pr[lane] = QUANT ? p0 * vsc[lane] : p0;
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_next;
        l_s[g] = alpha * l_s[g] + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < MAX_OUT; ++k) {
      const int o = tid + k * SC_THREADS;
      if (o < n_out) {
        const int g = o / D;
        const int d = o % D;
        const float* pr = ps + g * TKS;
        float pv = 0.f;
#pragma unroll 8
        for (int t = 0; t < TKS; ++t) pv = fmaf(pr[t], vt[t * KS + d], pv);
        acc[k] = acc[k] * a_s[g] + pv;
      }
    }
  }
  mfa::cp_async_wait<0>();
  __syncthreads();  // m_s, l_s final

  const int v_keep = pg.dp - pg.vtz;
  float* ob = static_cast<float*>(a.out) + qrow0 * D;
#pragma unroll
  for (int k = 0; k < MAX_OUT; ++k) {
    const int o = tid + k * SC_THREADS;
    if (o >= n_out) continue;
    const int g = o / D;
    const int d = o % D;
    if (a.splits == 1) {
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];
      ob[o] = d < v_keep ? acc[k] / l : 0.f;
    } else {
      part[g * part_ld + 2 + d] = acc[k];
    }
  }
  if (a.splits > 1 && tid < gn) {
    part[tid * part_ld] = m_s[tid];
    part[tid * part_ld + 1] = l_s[tid];
  }
}

constexpr int MERGE_THREADS = 128;

// One CTA per query row: its splits' partials -> O = sum_s w_s O_s /
// sum_s w_s l_s, w_s = exp(m_s - max m).  The splits that hold tokens of
// the row's sequence are a prefix (each split a range of positions from
// 0), found as those whose m is not -inf; the sums run over them in split
// order (l by every thread alike, each O lane by one thread, its loads
// independent of each other), so the result is the same bits on every
// call.  Lanes from v_keep are 0.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
paged_decode_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                          int splits, int D, int v_keep) {
  extern __shared__ float wl[];  // [splits] weights, then [splits] l
  __shared__ float red_m[MERGE_THREADS / 32];
  __shared__ int red_n[MERGE_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t ld = (size_t)D + 2;
  const float* p = ws + (size_t)blockIdx.x * splits * ld;
  float mx = -INFINITY;
  int live = 0;
  for (int s = tid; s < splits; s += MERGE_THREADS) {
    const float ms = p[s * ld];
    if (ms != -INFINITY) {
      mx = fmaxf(mx, ms);
      live = s + 1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    live = max(live, __shfl_xor_sync(0xffffffffu, live, o));
  }
  if (lane == 0) {
    red_m[warp] = mx;
    red_n[warp] = live;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < MERGE_THREADS / 32; ++w) {
    mx = fmaxf(mx, red_m[w]);
    live = max(live, red_n[w]);
  }
  for (int s = tid; s < live; s += MERGE_THREADS) {
    wl[s] = expf(p[s * ld] - mx);
    wl[splits + s] = p[s * ld + 1];
  }
  __syncthreads();
  float lsum = 0.f;
  for (int s = 0; s < live; ++s) lsum = fmaf(wl[s], wl[splits + s], lsum);
  T* o = out + (size_t)blockIdx.x * D;
  for (int d = tid; d < D; d += MERGE_THREADS) {
    float acc = 0.f;
    if (d < v_keep) {
      const float* pd = p + 2 + d;
#pragma unroll 4
      for (int s = 0; s < live; ++s) acc = fmaf(wl[s], pd[s * ld], acc);
    }
    Elem<T>::store(o + d, lsum > 0.f ? acc / lsum : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Chunked prefill on the tensor cores
// ---------------------------------------------------------------------------

struct PrefillArgs {
  const void* q;
  const void* kv;
  const float* kscale;
  const float* vscale;
  const int32_t* page_row;
  void* out;
  int Hq, Hkv, C, D, num_pages_total, max_pages, offset;
  PoolGeom pg;
  float scale;
};

// Replaces serving/paged_attention.py::_prefill_kernel for a bf16 q where
// prefill_tc says so.  Bound: tensor-core operations (4*D per visible
// query-key pair).  WHOLE: pool rows of whole 16-byte chunks.
template <int DP, int MODE, bool WHOLE>
__global__ void __launch_bounds__(TC_THREADS)
paged_prefill_tc_kernel(const PrefillArgs a) {
  constexpr bool QUANT = MODE != KV_FLOAT;
  constexpr int ROW = 2 * DP + 16;
  constexpr int KCM = DP / 16;
  constexpr int DVP = DP > 256 ? 256 : DP;  // P.V lanes, at most
  constexpr int NB = DVP / 8;
  constexpr int NS = prefill_stages<DP>();
  extern __shared__ __align__(16) uint8_t smem[];
  const PoolGeom pg = a.pg;
  const TcLayout L = tc_layout<DP, MODE, NS>(pg.ss, 64, false);
  const int D = a.D;
  const int C = a.C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rows = (a.Hq / a.Hkv) * C;
  // The last row tiles first: they see the most keys.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y;
  const size_t head_row0 = (size_t)h * rows;
  uint8_t* sq = smem + L.q;
  float* ssc = reinterpret_cast<float*>(smem + L.sc);
  const int ring_stage = L.halves * TK * L.stage_ld;
  const size_t head_base = (size_t)h * a.num_pages_total;

  const int r_last = min(r0 + 64, rows) - 1;
  const int c_max = (r0 / C == r_last / C) ? (r_last % C) : (C - 1);
  const int kv_end = min(a.offset + c_max + 1, a.max_pages * pg.PT);
  auto stage = [&](int t0, int buf) {
    stage_tokens<TC_THREADS, TK, WHOLE>(
        static_cast<const uint8_t*>(a.kv), a.page_row, head_base,
        a.num_pages_total, pg, L.halves, QUANT ? 1 : 2, D, t0, kv_end,
        smem + buf * ring_stage, L.stage_ld, TK * L.stage_ld,
        QUANT ? a.kscale : nullptr, a.vscale, ssc + buf * 2 * TK);
  };

  const int qc = D / 8;
  const __nv_bfloat16* qh =
      static_cast<const __nv_bfloat16*>(a.q) + head_row0 * D;
  for (int i = tid; i < 64 * qc; i += TC_THREADS) {
    const int r = i / qc;
    const int c = i - r * qc;
    const bool ok = r0 + r < rows;
    mfa::cp_async16(sq + r * ROW + c * 16,
                    qh + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok ? 16 : 0);
  }
  mfa::cp_async_commit();
  for (int k = 0; k < NS - 1; ++k) {  // tiles 0 .. NS - 2, a group each
    if (k * TK < kv_end) stage(k * TK, k);
    mfa::cp_async_commit();
  }
  mfa::cp_async_wait<NS - 1>();
  __syncthreads();  // Q landed
  scale_rows<TC_THREADS>(sq, ROW, 64, qc, a.scale);

  // Row i of this thread's fragments: r0 + 16 warp + g + 8i; its last
  // visible column (padding rows see every column: their O is not stored).
  int row[2], lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + 16 * warp + g + 8 * i;
    lim[i] = row[i] < rows ? a.offset + row[i] % C : kv_end - 1;
  }
  // Columns [0, w_lo] are visible in every row of this warp, none past
  // w_hi in any.
  int w_lo = min(lim[0], lim[1]), w_hi = max(lim[0], lim[1]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, off));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, off));
  }
  const int v_keep = (WHOLE ? D : pg.dp) - pg.vtz;
  const int npairs = (v_keep + 15) / 16;  // 16-lane O blocks computed
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int t0 = 0, buf = 0; t0 < kv_end;
       t0 += TK, buf = buf + 1 == NS ? 0 : buf + 1) {
    mfa::cp_async_wait<NS - 2>();
    __syncthreads();  // this tile staged, Q scaled; the last tile's
                      // readers done with its stage
    if (t0 + (NS - 1) * TK < kv_end)
      stage(t0 + (NS - 1) * TK, buf == 0 ? NS - 1 : buf - 1);
    mfa::cp_async_commit();
    const uint8_t* sk = smem + buf * ring_stage;
    if constexpr (QUANT) {
      widen_rows<MODE, true, TC_THREADS, TK>(sk, L.stage_ld, TK * L.stage_ld,
                                             L.halves, D, smem + L.conv, ROW,
                                             TK * ROW);
      __syncthreads();
      sk = smem + L.conv;
    }
    if (t0 > w_hi) continue;  // no row of this warp sees the tile
    const uint8_t* sv = L.nkv == 2 ? sk + TK * ROW : sk;
    const float* ksc = ssc + buf * 2 * TK;
    const float* vsc = ksc + TK;

    // S = Q_s.K^T for this warp's 16 rows and the tile's 64 tokens: element
    // (row[i], token t0 + 8j + 2tq + c) at s[j][2i + c].
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_qk<KCM, 8, ROW, ROW>(sq, 16 * warp, sk, 0, D / 16, s);
    if (QUANT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 k2 =
            *reinterpret_cast<const float2*>(ksc + 8 * j + 2 * tq);
        s[j][0] *= k2.x;
        s[j][1] *= k2.y;
        s[j][2] *= k2.x;
        s[j][3] *= k2.y;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
    if (t0 + TK - 1 <= w_lo && t0 + TK <= kv_end) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + 8 * j + 2 * tq + (e & 1);
          float& x = s[j][e];
          x = (col > lim[e >> 1] || col >= kv_end) ? -INFINITY : x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2], mref[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_next = fmaxf(m[i], mx[i]);
      alpha[i] = m[i] == -INFINITY ? 0.f : __expf(m[i] - m_next);
      mref[i] = m_next == -INFINITY ? 0.f : m_next;
      m[i] = m_next;
    }
    // P = exp(s - m): l sums it before the V scale; P.V takes it times vs,
    // rounded to bf16 (cvt.rn.bf16x2 while packing the A fragments).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 v2 = make_float2(1.f, 1.f);
      if (QUANT) v2 = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - mref[e >> 1]);
        sum[e >> 1] += p;
        s[j][e] = QUANT ? p * ((e & 1) ? v2.y : v2.x) : p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = alpha[i] * l[i] + sum[i];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[nb][0] *= alpha[0];
        acc[nb][1] *= alpha[0];
        acc[nb][2] *= alpha[1];
        acc[nb][3] *= alpha[1];
      }
    }
    // O += P.V over the kept lanes' blocks, 16 tokens a step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = 2 * kk;
      const uint32_t pa[4] = {mfa::pack_bf16(s[j][0], s[j][1]),
                              mfa::pack_bf16(s[j][2], s[j][3]),
                              mfa::pack_bf16(s[j + 1][0], s[j + 1][1]),
                              mfa::pack_bf16(s[j + 1][2], s[j + 1][3])};
#pragma unroll
      for (int np = 0; np < NB / 2; ++np)
        if (np < npairs)
          mma_pv<ROW>(pa, sv, 16 * kk, np, acc[2 * np], acc[2 * np + 1]);
    }
  }
  mfa::cp_async_wait<0>();

  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(a.out) + head_row0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* orow = oh + (size_t)row[i] * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int d = 8 * nb + 2 * tq;
      if (nb / 2 < npairs)
        *reinterpret_cast<uint32_t*>(orow + d) = mfa::pack_bf16(
            d < v_keep ? acc[nb][2 * i] / li : 0.f,
            d + 1 < v_keep ? acc[nb][2 * i + 1] / li : 0.f);
    }
  }
  const int zl = D - 16 * npairs;  // lanes past the computed blocks
  const int tile_rows = min(64, rows - r0);
  for (int i = tid; i < tile_rows * zl; i += TC_THREADS)
    oh[(size_t)(r0 + i / zl) * D + 16 * npairs + i % zl] =
        __float2bfloat16(0.f);
}

// ---------------------------------------------------------------------------
// Chunked prefill on the tensor cores at DeepSeek's width 576
// ---------------------------------------------------------------------------

constexpr int PW_DP = 576;        // the built width
constexpr int PW_THREADS = 256;   // 8 warps: two groups of 4
constexpr int PW_TK = 32;         // KV tokens a tile
constexpr int PW_NS = 3;          // stages of the cp.async ring
constexpr int PW_LANES = 256;     // O lanes a warp group holds
constexpr int PW_PROW = 2 * PW_TK + 16;  // a bf16 row of P [16][32]

// Byte offsets of paged_prefill_wide_kernel's shared memory (one-state
// pages): the ring of staged token rows ([PW_NS][PW_TK][stage_ld]), the
// widened bf16 operand tiles of a quantized pool ([nkv][PW_TK][ROW]), Q
// ([64][ROW]), each row slab's P ([4][16][PW_PROW]), the scales
// ([PW_NS][2][PW_TK] fp32) and each row slab's exchanged row statistics
// ([4][2 warps][max, sum][16] fp32).  At most 213,248 B (int4).
struct PwLayout {
  int nkv, stage_ld, conv, q, p, sc, red, bytes;
};

template <int MODE>
__host__ __device__ __forceinline__ PwLayout pw_layout() {
  constexpr int ROW = 2 * PW_DP + 16;
  PwLayout L;
  L.nkv = MODE == KV_INT4 ? 2 : 1;
  L.stage_ld = MODE == KV_FLOAT ? ROW : PW_DP + 16;
  L.conv = PW_NS * PW_TK * L.stage_ld;
  L.q = L.conv + (MODE == KV_FLOAT ? 0 : L.nkv * PW_TK * ROW);
  L.p = L.q + 64 * ROW;
  L.sc = L.p + 4 * 16 * PW_PROW;
  L.red = L.sc + PW_NS * 2 * PW_TK * (int)sizeof(float);
  L.bytes = L.red + 4 * 2 * 2 * 16 * (int)sizeof(float);
  return L;
}

// Replaces serving/paged_attention.py::_prefill_kernel for a bf16 q at
// head dims above 288 over one-state pages whose kept lanes D - vtz fit
// 512 (prefill_tc; DeepSeek's 576 - 64).  Bound: tensor-core operations.
// paged_prefill_tc_kernel's frame (a CTA per 64 rows and KV head, the row
// tiles last first, tiles no row sees skipped) with O's lanes split, as in
// DeepSeek's FlashMLA: 16 rows x 512 fp32 lanes of O are 256 registers a
// thread, past the 255 a thread may have, so 8 warps hold O, warp w rows
// [16 (w % 4), +16) and lanes [256 (w / 4), +256) (128 registers).  The two
// warps of a row slab split the scores instead: each computes S over 16 of
// a 32-token tile's keys and all of D, they exchange row maxima and sums
// through shared memory (a named barrier a slab), and each writes its half
// of the slab's P, which both read as the A operand of O += P.V over their
// own lanes; both keep the same m and l (max, and the two halves' sums in
// one order).  Tiles of 32 keys in a three-stage ring keep Q, the ring and
// P within 227 KB at every pool mode.  WHOLE: pool rows of whole 16-byte
// chunks.
template <int MODE, bool WHOLE>
__global__ void __launch_bounds__(PW_THREADS, 1)
paged_prefill_wide_kernel(const PrefillArgs a) {
  constexpr bool QUANT = MODE != KV_FLOAT;
  constexpr int ROW = 2 * PW_DP + 16;
  constexpr int KCM = PW_DP / 16;
  constexpr int NB = PW_LANES / 8;  // 8-lane O blocks a warp
  extern __shared__ __align__(16) uint8_t smem[];
  const PoolGeom pg = a.pg;
  const PwLayout L = pw_layout<MODE>();
  const int D = a.D;
  const int C = a.C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slab = warp & 3;   // rows [16 slab, 16 slab + 16) of the tile
  const int half = warp >> 2;  // keys [16 half, +16) of a KV tile in S,
                               // lanes [256 half, +256) of O
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rows = (a.Hq / a.Hkv) * C;
  // The last row tiles first: they see the most keys.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int h = blockIdx.y;
  const size_t head_row0 = (size_t)h * rows;
  uint8_t* sq = smem + L.q;
  uint8_t* sp = smem + L.p + slab * 16 * PW_PROW;
  float* ssc = reinterpret_cast<float*>(smem + L.sc);
  // This slab's [warp half][max, sum][16 rows].
  float* red = reinterpret_cast<float*>(smem + L.red) + slab * 64;
  const int ring_stage = PW_TK * L.stage_ld;
  const size_t head_base = (size_t)h * a.num_pages_total;

  const int r_last = min(r0 + 64, rows) - 1;
  const int c_max = (r0 / C == r_last / C) ? (r_last % C) : (C - 1);
  const int kv_end = min(a.offset + c_max + 1, a.max_pages * pg.PT);
  auto stage = [&](int t0, int buf) {
    stage_tokens<PW_THREADS, PW_TK, WHOLE>(
        static_cast<const uint8_t*>(a.kv), a.page_row, head_base,
        a.num_pages_total, pg, 1, QUANT ? 1 : 2, D, t0, kv_end,
        smem + buf * ring_stage, L.stage_ld, PW_TK * L.stage_ld,
        QUANT ? a.kscale : nullptr, a.vscale, ssc + buf * 2 * PW_TK);
  };

  const int qc = D / 8;
  const __nv_bfloat16* qh =
      static_cast<const __nv_bfloat16*>(a.q) + head_row0 * D;
  for (int i = tid; i < 64 * qc; i += PW_THREADS) {
    const int r = i / qc;
    const int c = i - r * qc;
    const bool ok = r0 + r < rows;
    mfa::cp_async16(sq + r * ROW + c * 16,
                    qh + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok ? 16 : 0);
  }
  mfa::cp_async_commit();
  for (int k = 0; k < PW_NS - 1; ++k) {  // tiles 0 .. NS - 2, a group each
    if (k * PW_TK < kv_end) stage(k * PW_TK, k);
    mfa::cp_async_commit();
  }
  mfa::cp_async_wait<PW_NS - 1>();
  __syncthreads();  // Q landed
  scale_rows<PW_THREADS>(sq, ROW, 64, qc, a.scale);

  // Row i of this thread's fragments: r0 + 16 slab + g + 8i; its last
  // visible column (padding rows see every column: their O is not stored).
  int row[2], lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + 16 * slab + g + 8 * i;
    lim[i] = row[i] < rows ? a.offset + row[i] % C : kv_end - 1;
  }
  // Columns [0, w_lo] are visible in every row of this slab, none past
  // w_hi in any (the same in both warps of the slab).
  int w_lo = min(lim[0], lim[1]), w_hi = max(lim[0], lim[1]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, off));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, off));
  }
  const int v_keep = (WHOLE ? D : pg.dp) - pg.vtz;
  const int nblk = (v_keep + 15) / 16;  // 16-lane O blocks computed
  const int npairs = min(max(nblk - 16 * half, 0), PW_LANES / 16);  // mine
  const int k0 = 16 * half;  // this warp's keys of a tile
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int t0 = 0, buf = 0; t0 < kv_end;
       t0 += PW_TK, buf = buf + 1 == PW_NS ? 0 : buf + 1) {
    mfa::cp_async_wait<PW_NS - 2>();
    __syncthreads();  // this tile staged, Q scaled; the last tile's
                      // readers done with its stage
    if (t0 + (PW_NS - 1) * PW_TK < kv_end)
      stage(t0 + (PW_NS - 1) * PW_TK, buf == 0 ? PW_NS - 1 : buf - 1);
    mfa::cp_async_commit();
    const uint8_t* sk = smem + buf * ring_stage;
    if constexpr (QUANT) {
      widen_rows<MODE, true, PW_THREADS, PW_TK>(
          sk, L.stage_ld, PW_TK * L.stage_ld, 1, D, smem + L.conv, ROW,
          PW_TK * ROW);
      __syncthreads();
      sk = smem + L.conv;
    }
    if (t0 > w_hi) continue;  // no row of this slab sees the tile
    const uint8_t* sv = L.nkv == 2 ? sk + PW_TK * ROW : sk;
    const float* ksc = ssc + buf * 2 * PW_TK;
    const float* vsc = ksc + PW_TK;

    // S = Q_s.K^T for this slab's 16 rows and this warp's 16 keys: element
    // (row[i], token t0 + k0 + 8j + 2tq + c) at s[j][2i + c].
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_qk<KCM, 2, ROW, ROW>(sq, 16 * slab, sk, k0, D / 16, s);
    if (QUANT) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 k2 =
            *reinterpret_cast<const float2*>(ksc + k0 + 8 * j + 2 * tq);
        s[j][0] *= k2.x;
        s[j][1] *= k2.y;
        s[j][2] *= k2.x;
        s[j][3] *= k2.y;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
    const int c0 = t0 + k0;  // this warp's first key
    if (c0 + 15 <= w_lo && c0 + 16 <= kv_end) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          float& x = s[j][e];
          x = (col > lim[e >> 1] || col >= kv_end) ? -INFINITY : x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (tq == 0) red[half * 32 + g + 8 * i] = mx[i];
    }
    mfa::named_barrier(1 + slab, 64);  // both warps' row maxima
    float alpha[2], mref[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      const float m_next = fmaxf(m[i], fmaxf(red[r], red[32 + r]));
      alpha[i] = m[i] == -INFINITY ? 0.f : __expf(m[i] - m_next);
      mref[i] = m_next == -INFINITY ? 0.f : m_next;
      m[i] = m_next;
    }
    // P = exp(s - m): l sums it before the V scale; P.V takes it times vs,
    // rounded to bf16, from the slab's P in shared memory.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tl = k0 + 8 * j + 2 * tq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p0 = __expf(s[j][2 * i] - mref[i]);
        float p1 = __expf(s[j][2 * i + 1] - mref[i]);
        sum[i] += p0 + p1;
        if (QUANT) {
          p0 *= vsc[tl];
          p1 *= vsc[tl + 1];
        }
        *reinterpret_cast<uint32_t*>(sp + (g + 8 * i) * PW_PROW + 2 * tl) =
            mfa::pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      if (tq == 0) red[half * 32 + 16 + g + 8 * i] = sum[i];
    }
    mfa::named_barrier(1 + slab, 64);  // the slab's P, both row sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 + g + 8 * i;
      l[i] = alpha[i] * l[i] + (red[r] + red[32 + r]);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[nb][0] *= alpha[0];
        acc[nb][1] *= alpha[0];
        acc[nb][2] *= alpha[1];
        acc[nb][3] *= alpha[1];
      }
    }
    // O += P.V over this warp's blocks of kept lanes, 16 tokens a step.
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mfa::ldsm_x4(pa[kk], sp + mfa::ldsm_a_row(lane) * PW_PROW + kk * 32 +
                               mfa::ldsm_a_byte(lane));
#pragma unroll
    for (int np = 0; np < NB / 2; ++np)
      if (np < npairs) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          mma_pv<ROW>(pa[kk], sv, 16 * kk, 16 * half + np, acc[2 * np],
                      acc[2 * np + 1]);
      }
  }
  mfa::cp_async_wait<0>();

  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(a.out) + head_row0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* orow = oh + (size_t)row[i] * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int d = PW_LANES * half + 8 * nb + 2 * tq;
      if (nb / 2 < npairs)
        *reinterpret_cast<uint32_t*>(orow + d) = mfa::pack_bf16(
            d < v_keep ? acc[nb][2 * i] / li : 0.f,
            d + 1 < v_keep ? acc[nb][2 * i + 1] / li : 0.f);
    }
  }
  const int zl = D - 16 * nblk;  // lanes past the computed blocks
  const int tile_rows = min(64, rows - r0);
  for (int i = tid; i < tile_rows * zl; i += PW_THREADS)
    oh[(size_t)(r0 + i / zl) * D + 16 * nblk + i % zl] =
        __float2bfloat16(0.f);
}

// ---------------------------------------------------------------------------
// Chunked prefill, scalar
// ---------------------------------------------------------------------------

// 16-byte loads of a token's K and V rows widened to fp32: S is the pool's
// element type, VEC the elements per load.  load() reads the K row (is_v
// false) or the V row at p; load2() reads both, the V row v_off elements
// on (0: K is V, one load serves both); an int4 byte holds both, K in its
// low nibble and V in its high one, so it is read once.
template <typename T, int MODE>
struct KVLoad;

template <typename T>
struct KVLoad<T, KV_FLOAT> {
  using S = T;
  static constexpr int VEC = Elem<T>::VEC;
  static __device__ __forceinline__ S zero() { return S(); }
  static __device__ __forceinline__ void load(const S* p, bool, float* f) {
    Elem<T>::unpack(*reinterpret_cast<const uint4*>(p), f);
  }
  static __device__ __forceinline__ void load2(const S* p, size_t v_off,
                                               float* kf, float* vf) {
    load(p, false, kf);
    if (v_off) {
      load(p + v_off, true, vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[e] = kf[e];
    }
  }
};

template <typename T>
struct KVLoad<T, KV_INT8> {
  using S = int8_t;
  static constexpr int VEC = 16;
  static __device__ __forceinline__ S zero() { return 0; }
  static __device__ __forceinline__ void load(const S* p, bool, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = (float)b[e];
  }
  static __device__ __forceinline__ void load2(const S* p, size_t v_off,
                                               float* kf, float* vf) {
    load(p, false, kf);
    if (v_off) {
      load(p + v_off, true, vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[e] = kf[e];
    }
  }
};

template <typename T>
struct KVLoad<T, KV_INT4> {
  using S = int8_t;
  static constexpr int VEC = 16;
  // The byte of K = 0 and V = 0.
  static __device__ __forceinline__ S zero() { return 0x08; }
  static __device__ __forceinline__ void load(const S* p, bool is_v,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int x = b[e];
      f[e] = (float)(is_v ? (x >> 4) : ((x & 0xF) - 8));
    }
  }
  static __device__ __forceinline__ void load2(const S* p, size_t,
                                               float* kf, float* vf) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int x = b[e];
      kf[e] = (float)((x & 0xF) - 8);
      vf[e] = (float)(x >> 4);
    }
  }
};

constexpr int PF_THREADS = 256;  // TY x TX: 4 rows x BT / TX columns each
constexpr int PF_PAD = 4;

// paged_prefill_kernel's query rows a CTA and KV tokens a tile for head
// dims up to DMAX: 64 (16 x 16 threads, a 4 x 4 score block each), or 32
// above 288 (8 x 32 threads, 4 x 1), where Q^T and K^T at 64 x 576 fp32
// (2 x 156,672 B) would not fit.
template <int DMAX>
__host__ __device__ constexpr int pf_tile() {
  return DMAX > 288 ? 32 : 64;
}

// K^T and V share one buffer above D = 128 (see the file comment).
__host__ __device__ constexpr bool prefill_shares_kv(int dmax) {
  return dmax > 128;
}

size_t prefill_smem_bytes(int D, bool share, int bt) {
  const int ldm = bt + PF_PAD, ldn = bt + PF_PAD, ldv = D + PF_PAD;
  const size_t kv = share ? (size_t)max(D * ldn, bt * ldv)
                          : (size_t)D * ldn + (size_t)bt * ldv;
  return sizeof(float) *
         ((size_t)D * ldm + kv + (size_t)bt * ldm + 2 * bt);
}

// Replaces serving/paged_attention.py::_prefill_kernel for an fp32 q, and
// for the bf16 shapes prefill_tc leaves here.  DC: the head dim, or 0 for
// a run-time one up to DMAX.  Thread (ty, tx) holds rows [4 ty, 4 ty + 4)
// of the CTA's BT and O lanes tx + TX e.
template <typename T, int DC, int MODE, int DMAX = (DC != 0 ? DC : 288)>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_kernel(const T* __restrict__ q, const void* __restrict__ kv_,
                     const float* __restrict__ kscale,
                     const float* __restrict__ vscale,
                     const int32_t* __restrict__ page_row,
                     T* __restrict__ out, int Hq, int Hkv, int C, int d_rt,
                     int num_pages_total, PoolGeom pg, int max_pages,
                     int offset, float scale) {
  using E = Elem<T>;
  using L = KVLoad<T, MODE>;
  constexpr bool QUANT = MODE != KV_FLOAT;
  constexpr int BT = pf_tile<DMAX>();  // query rows a CTA, KV tokens a tile
  constexpr int TY = BT / 4;
  constexpr int TX = PF_THREADS / TY;  // threads of a row: 16 or 32
  constexpr int CJ = BT / TX;          // score columns a thread: 4 or 1
  constexpr int DVMAX = (DMAX + TX - 1) / TX;  // output lanes a thread
  constexpr bool SHARE = prefill_shares_kv(DMAX);
  constexpr int LDM = BT + PF_PAD;
  constexpr int LDN = BT + PF_PAD;
  const int D = DC ? DC : d_rt;
  const int LDV = D + PF_PAD;
  const int VPR = D / L::VEC;     // KV loads per token row
  const int QPR = D / E::VEC;     // q loads per row
  const int v_keep = pg.dp - pg.vtz;  // output lanes V does not zero
  const int PT = pg.PT;
  const typename L::S* kv = static_cast<const typename L::S*>(kv_);

  extern __shared__ __align__(16) float smem_pf[];
  float* qt = smem_pf;             // [D][LDM]   Q transposed
  float* kt = qt + D * LDM;        // [D][LDN]   K transposed
  float* vs = SHARE ? kt : kt + D * LDN;  // [BT][LDV]
  float* pt = SHARE ? kt + max(D * LDN, BT * LDV)
                    : vs + BT * LDV;      // [BT][LDM]  P transposed
  float* ksc = pt + BT * LDM;      // [BT] K scales of the tile's tokens
  float* vsc = ksc + BT;           // [BT] V scales

  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows = G * C;
  const int r0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const size_t head_row0 = (size_t)h * rows;
  const T* qh = q + head_row0 * D;

  for (int i = tid; i < BT * QPR; i += PF_THREADS) {
    const int r = i / QPR;
    const int c = i % QPR;
    float f[E::VEC];
    if (r0 + r < rows) {
      E::unpack(*reinterpret_cast<const uint4*>(qh + (size_t)(r0 + r) * D +
                                                c * E::VEC),
                f);
#pragma unroll
      for (int e = 0; e < E::VEC; ++e) f[e] = E::round(f[e] * scale);
    } else {
#pragma unroll
      for (int e = 0; e < E::VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E::VEC; ++e) qt[(c * E::VEC + e) * LDM + r] = f[e];
  }

  int lim[4];  // last visible global column of each of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) lim[i] = offset + (r0 + ty * 4 + i) % C;
  const int r_last = min(r0 + BT, rows) - 1;
  const int c_max = (r0 / C == r_last / C) ? (r_last % C) : (C - 1);
  const int kv_end = min(offset + c_max + 1, max_pages * PT);

  float m[4], l[4], acc[4][DVMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e) acc[i][e] = 0.f;
  }
  const size_t head_base = (size_t)h * num_pages_total;
  const size_t v_off = (size_t)pg.v_row * pg.dp;
  const bool whole = pg.dp == D;  // pool rows of whole 16-byte loads

  // Stage tile t0's K rows (as K^T) and, with KV_ROWS, its V rows in one
  // pass; V_ONLY: its V rows alone.
  constexpr int KV_ROWS = 0, V_ONLY = 1;
  auto stage = [&](int t0, int what) {
    for (int i = tid; i < BT * VPR; i += PF_THREADS) {
      const int t = i / VPR;
      const int c = i % VPR;
      const int pos = t0 + t;
      float kf[L::VEC], vf[L::VEC];
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) kf[e] = vf[e] = 0.f;
      if (pos < kv_end) {
        const int page = clamp_page(page_row[pos / PT], num_pages_total);
        const typename L::S* p = kv +
                                 ((head_base + page) * pg.rows + pos % PT) *
                                     (size_t)pg.dp +
                                 c * L::VEC;
        if (whole) {
          if (what == V_ONLY)
            L::load(p + v_off, true, vf);
          else if (SHARE)
            L::load(p, false, kf);
          else
            L::load2(p, v_off, kf, vf);
        } else {  // rows of dp elements: lanes from dp read as zeros
          __align__(16) typename L::S kb[L::VEC], vb[L::VEC];
#pragma unroll
          for (int e = 0; e < L::VEC; ++e) {
            const bool in = c * L::VEC + e < pg.dp;
            kb[e] = in ? p[e] : L::zero();
            vb[e] = in && v_off ? p[v_off + e] : kb[e];
          }
          if (what != V_ONLY) L::load(kb, false, kf);
          if (what == V_ONLY || !SHARE) L::load(vb, true, vf);
        }
      }
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) {
        const int d = c * L::VEC + e;
        if (what != V_ONLY) kt[d * LDN + t] = kf[e];
        if (what == V_ONLY || !SHARE) vs[t * LDV + d] = vf[e];
      }
    }
  };

  for (int t0 = 0; t0 < kv_end; t0 += BT) {
    __syncthreads();  // Q staged (first tile); last tile's readers done
    stage(t0, KV_ROWS);  // K^T, and V unless it shares K^T's buffer
    if (QUANT) {
      for (int t = tid; t < BT; t += PF_THREADS) {
        const int pos = t0 + t;
        float a = 0.f, v = 0.f;
        if (pos < kv_end) {
          const size_t at =
              (head_base + clamp_page(page_row[pos / PT], num_pages_total)) *
                  PT +
              pos % PT;
          a = kscale[at];
          v = vscale[at];
        }
        ksc[t] = a;
        vsc[t] = v;
      }
    }
    __syncthreads();

    float s[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDM + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float kv4[CJ];
      if constexpr (CJ == 4) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(kt + d * LDN + tx * 4);
        kv4[0] = k4.x;
        kv4[1] = k4.y;
        kv4[2] = k4.z;
        kv4[3] = k4.w;
      } else {
#pragma unroll
        for (int j = 0; j < CJ; ++j) kv4[j] = kt[d * LDN + tx * CJ + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(av[i], kv4[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = t0 + tx * CJ + j;
        if (QUANT) s[i][j] *= ksc[tx * CJ + j];
        if (col > lim[i] || col >= kv_end) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // The TX threads of a row are the TX lanes sharing ty in one warp.
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_next);
        sum += p;
        s[i][j] = E::round(QUANT ? p * vsc[tx * CJ + j] : p);
      }
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = alpha * l[i] + sum;
      m[i] = m_next;
#pragma unroll
      for (int e = 0; e < DVMAX; ++e) acc[i][e] *= alpha;
    }
    if (SHARE) {
      __syncthreads();  // every thread is done with K^T
      stage(t0, V_ONLY);
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      *reinterpret_cast<float4*>(pt + (tx * CJ + j) * LDM + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int c = 0; c < BT; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * LDM + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vr = vs + c * LDV + tx;
#pragma unroll
      for (int e = 0; e < DVMAX; ++e) {
        if (e * TX + tx < D) {
          const float ve = vr[e * TX];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], ve, acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r < rows) {
      const float li = (l[i] == 0.f) ? 1.f : l[i];
      T* orow = out + (head_row0 + r) * D;
#pragma unroll
      for (int e = 0; e < DVMAX; ++e) {
        const int d = e * TX + tx;
        if (d < D) E::store(orow + d, d < v_keep ? acc[i][e] / li : 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DP, int MODE>
int launch_decode_tc(const DecodeArgs& a, dim3 grid, cudaStream_t stream) {
  const TcLayout L =
      tc_layout<DP, MODE, decode_stages<DP>(), decode_tile<DP>()>(a.pg.ss, 16,
                                                                  true);
  if (a.pg.dp == a.D)
    return launch_with_smem(paged_decode_tc_kernel<DP, MODE, true>, grid,
                            TC_THREADS, L.bytes, stream, a);
  return launch_with_smem(paged_decode_tc_kernel<DP, MODE, false>, grid,
                          TC_THREADS, L.bytes, stream, a);
}

template <int DC, int MODE, int DMAX = (DC != 0 ? DC : 288)>
int launch_decode_fma(const DecodeArgs& a, dim3 grid, cudaStream_t stream) {
  const ScLayout L = sc_layout<MODE, sc_stages<DC>(), sc_tile<DMAX>()>(
      a.D, a.pg.ss, a.gc);
  return launch_with_smem(paged_decode_kernel<DC, MODE, DMAX>, grid,
                          SC_THREADS, L.bytes, stream, a);
}

// The decode of a dtype in one pool mode: the split kernel, then (splits
// > 1) the merge.
template <int MODE>
int launch_decode(int dtype, const DecodeArgs& a, int B, int Hkv,
                  cudaStream_t stream) {
  const dim3 grid(Hkv * a.gslices, B, a.splits);
  int rc = (int)cudaErrorInvalidValue;
  if (a.D > MAX_D) {
    mfa_sd::PagedArgs p =
        split_d_paged(a.q, a.kv, a.kscale, a.vscale, a.table, a.out, a.Hq,
                      Hkv, a.D, a.num_pages_total, a.max_pages, a.pg,
                      a.scale);
    p.lengths = a.lengths;
    p.ws = a.ws;
    p.G = a.G;
    p.gc = a.gc;
    p.gslices = a.gslices;
    p.splits = a.splits;
    p.per = a.per;
    rc = mfa_sd::launch_paged_decode(dtype, MODE, p, B, stream);
  } else if (dtype == 1) {
    switch (tc_width(a.D)) {
      case 32: rc = launch_decode_tc<32, MODE>(a, grid, stream); break;
      case 64: rc = launch_decode_tc<64, MODE>(a, grid, stream); break;
      case 128: rc = launch_decode_tc<128, MODE>(a, grid, stream); break;
      case 256: rc = launch_decode_tc<256, MODE>(a, grid, stream); break;
      case 288: rc = launch_decode_tc<288, MODE>(a, grid, stream); break;
      default: rc = launch_decode_tc<576, MODE>(a, grid, stream); break;
    }
  } else if (dtype == 0) {
    switch (a.D) {
      case 32: rc = launch_decode_fma<32, MODE>(a, grid, stream); break;
      case 64: rc = launch_decode_fma<64, MODE>(a, grid, stream); break;
      case 128: rc = launch_decode_fma<128, MODE>(a, grid, stream); break;
      case 288: rc = launch_decode_fma<288, MODE>(a, grid, stream); break;
      default:
        rc = a.D <= 288 ? launch_decode_fma<0, MODE>(a, grid, stream)
                        : launch_decode_fma<0, MODE, 576>(a, grid, stream);
        break;
    }
  }
  if (rc != 0 || a.splits == 1) return rc;
  const dim3 mgrid(B * a.Hq);
  const size_t msmem = 2 * sizeof(float) * a.splits;
  const int v_keep = a.pg.dp - a.pg.vtz;
  if (dtype == 1)
    return launch_with_smem(paged_decode_merge_kernel<__nv_bfloat16>, mgrid,
                            MERGE_THREADS, msmem, stream, a.ws,
                            static_cast<__nv_bfloat16*>(a.out), a.splits,
                            a.D, v_keep);
  return launch_with_smem(paged_decode_merge_kernel<float>, mgrid,
                          MERGE_THREADS, msmem, stream, a.ws,
                          static_cast<float*>(a.out), a.splits, a.D, v_keep);
}

template <int DP, int MODE>
int launch_prefill_tc(const PrefillArgs& a, cudaStream_t stream) {
  const int rows = (a.Hq / a.Hkv) * a.C;
  const TcLayout L =
      tc_layout<DP, MODE, prefill_stages<DP>()>(a.pg.ss, 64, false);
  const dim3 grid((rows + 63) / 64, a.Hkv);
  if (a.pg.dp == a.D)
    return launch_with_smem(paged_prefill_tc_kernel<DP, MODE, true>, grid,
                            TC_THREADS, L.bytes, stream, a);
  return launch_with_smem(paged_prefill_tc_kernel<DP, MODE, false>, grid,
                          TC_THREADS, L.bytes, stream, a);
}

template <int MODE>
int launch_prefill_wide(const PrefillArgs& a, cudaStream_t stream) {
  const int rows = (a.Hq / a.Hkv) * a.C;
  const dim3 grid((rows + 63) / 64, a.Hkv);
  if (a.pg.dp == a.D)
    return launch_with_smem(paged_prefill_wide_kernel<MODE, true>, grid,
                            PW_THREADS, pw_layout<MODE>().bytes, stream, a);
  return launch_with_smem(paged_prefill_wide_kernel<MODE, false>, grid,
                          PW_THREADS, pw_layout<MODE>().bytes, stream, a);
}

template <typename T, int DC, int MODE, int DMAX = (DC != 0 ? DC : 288)>
int launch_prefill_fma(const PrefillArgs& a, cudaStream_t stream) {
  constexpr int BT = pf_tile<DMAX>();
  const int rows = (a.Hq / a.Hkv) * a.C;
  const size_t smem =
      prefill_smem_bytes(a.D, prefill_shares_kv(DMAX), BT);
  return launch_with_smem(
      paged_prefill_kernel<T, DC, MODE, DMAX>,
      dim3((rows + BT - 1) / BT, a.Hkv), PF_THREADS, smem, stream,
      static_cast<const T*>(a.q), a.kv, a.kscale, a.vscale, a.page_row,
      static_cast<T*>(a.out), a.Hq, a.Hkv, a.C, a.D, a.num_pages_total, a.pg,
      a.max_pages, a.offset, a.scale);
}

// The prefill of a dtype in one pool mode: the tensor cores where
// prefill_tc says so (paged_prefill_tc_kernel up to D = 288,
// paged_prefill_wide_kernel above), else paged_prefill_kernel (bf16 there
// only at the widths above 256: D = 272 and 288, and above 288 two-state
// pages or more than 512 kept lanes).
template <int MODE>
int launch_prefill(int dtype, const PrefillArgs& a, cudaStream_t stream) {
  if (a.D > MAX_D) {
    mfa_sd::PagedArgs p =
        split_d_paged(a.q, a.kv, a.kscale, a.vscale, a.page_row, a.out, a.Hq,
                      a.Hkv, a.D, a.num_pages_total, a.max_pages, a.pg,
                      a.scale);
    p.C = a.C;
    p.offset = a.offset;
    return mfa_sd::launch_paged_prefill(dtype, MODE, p, stream);
  }
  if (prefill_tc(dtype, a.pg.dp, a.pg.ss, a.pg.vtz)) {
    switch (tc_width(a.D)) {
      case 32: return launch_prefill_tc<32, MODE>(a, stream);
      case 64: return launch_prefill_tc<64, MODE>(a, stream);
      case 128: return launch_prefill_tc<128, MODE>(a, stream);
      case 256: return launch_prefill_tc<256, MODE>(a, stream);
      case 288: return launch_prefill_tc<288, MODE>(a, stream);
      default: return launch_prefill_wide<MODE>(a, stream);
    }
  }
  if (dtype == 1) {
    if (a.D == 288)
      return launch_prefill_fma<__nv_bfloat16, 288, MODE>(a, stream);
    if (a.D <= 288)
      return launch_prefill_fma<__nv_bfloat16, 0, MODE>(a, stream);
    return launch_prefill_fma<__nv_bfloat16, 0, MODE, 576>(a, stream);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 32: return launch_prefill_fma<float, 32, MODE>(a, stream);
    case 64: return launch_prefill_fma<float, 64, MODE>(a, stream);
    case 128: return launch_prefill_fma<float, 128, MODE>(a, stream);
    case 288: return launch_prefill_fma<float, 288, MODE>(a, stream);
    default:
      return a.D <= 288 ? launch_prefill_fma<float, 0, MODE>(a, stream)
                        : launch_prefill_fma<float, 0, MODE, 576>(a, stream);
  }
}

bool valid_layout(int mode, int D, int s_sub, int vtz) {
  if (D <= 0 || vtz < 0 || vtz >= D) return false;
  if (mode == KV_INT4) return s_sub == 1 && vtz == 0;
  return s_sub == 1 || s_sub == 2;
}

PoolGeom geom_of(int mode, int PT, int s_sub, int vtz, int dp) {
  if (mode == KV_INT8) return pool_geom<KV_INT8>(PT, s_sub, vtz, dp);
  if (mode == KV_INT4) return pool_geom<KV_INT4>(PT, s_sub, vtz, dp);
  return pool_geom<KV_FLOAT>(PT, s_sub, vtz, dp);
}

// The lanes the kernels compute at head dim D: D rounded up to 16.
int lane_width(int D) { return (D + 15) / 16 * 16; }

}  // namespace

// Plain C interface (loaded with ctypes).  dtype (q's and, in mode 0, the
// pool's): 0 = float32, 1 = bfloat16.  mode: 0 float pool, 1 int8 halves,
// 2 int4 shared byte; ks and vs are ignored (may be null) in mode 0.
// s_sub: page rows per token (1 or 2; 1 for the int4 byte); vtz: V's
// zeroed tail lanes.  D: the head dim (any from 1; the split-D kernels
// above 576), the elements of a pool row; q and out are rows of D rounded
// up to 16 lanes (q zero past D).
// Returns the launch's cudaError_t; cudaErrorInvalidValue for an
// unsupported dtype, mode, page layout, head dim or split plan.
extern "C" {

// splits: the KV axis's splits (serving/paged_attention.py::decode_splits),
// each ceil(ceil(max_pages * PT / 64) / splits) * 64 tokens; ws: an fp32
// workspace [B, Hq, splits, Dl + 2] when splits > 1 (else unused), Dl the
// head dim rounded up to 16.
int mfa_paged_decode(const void* q, const void* kv, const void* ks,
                     const void* vs, const void* table, const void* lengths,
                     void* out, int dtype, int mode, int B, int Hq, int Hkv,
                     int D, int num_pages_total, int PT, int s_sub, int vtz,
                     int max_pages, float scale, int splits, void* ws,
                     void* stream) {
  if (!valid_layout(mode, D, s_sub, vtz) || Hkv <= 0 || Hq % Hkv ||
      splits < 1 || (splits > 1 && ws == nullptr) || PT <= 0 ||
      max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int gslices = (G + 15) / 16;
  const int tiles = (max_pages * PT + TK - 1) / TK;
  DecodeArgs a;
  a.q = q;
  a.kv = kv;
  a.kscale = static_cast<const float*>(ks);
  a.vscale = static_cast<const float*>(vs);
  a.table = static_cast<const int32_t*>(table);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.Hq = Hq;
  a.G = G;
  a.gslices = gslices;
  a.gc = (G + gslices - 1) / gslices;
  a.D = lane_width(D);
  a.num_pages_total = num_pages_total;
  a.max_pages = max_pages;
  a.splits = splits;
  a.per = (tiles + splits - 1) / splits * TK;
  a.pg = geom_of(mode, PT, s_sub, vtz, D);
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == KV_FLOAT) return launch_decode<KV_FLOAT>(dtype, a, B, Hkv, s);
  if (mode == KV_INT8) return launch_decode<KV_INT8>(dtype, a, B, Hkv, s);
  if (mode == KV_INT4) return launch_decode<KV_INT4>(dtype, a, B, Hkv, s);
  return (int)cudaErrorInvalidValue;
}

int mfa_paged_prefill(const void* q, const void* kv, const void* ks,
                      const void* vs, const void* page_row, void* out,
                      int dtype, int mode, int Hq, int Hkv, int C, int D,
                      int num_pages_total, int PT, int s_sub, int vtz,
                      int max_pages, int offset, float scale, void* stream) {
  if (!valid_layout(mode, D, s_sub, vtz) || Hkv <= 0 || Hq % Hkv ||
      PT <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  PrefillArgs a;
  a.q = q;
  a.kv = kv;
  a.kscale = static_cast<const float*>(ks);
  a.vscale = static_cast<const float*>(vs);
  a.page_row = static_cast<const int32_t*>(page_row);
  a.out = out;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.C = C;
  a.D = lane_width(D);
  a.num_pages_total = num_pages_total;
  a.max_pages = max_pages;
  a.offset = offset;
  a.pg = geom_of(mode, PT, s_sub, vtz, D);
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == KV_FLOAT) return launch_prefill<KV_FLOAT>(dtype, a, s);
  if (mode == KV_INT8) return launch_prefill<KV_INT8>(dtype, a, s);
  if (mode == KV_INT4) return launch_prefill<KV_INT4>(dtype, a, s);
  return (int)cudaErrorInvalidValue;
}

// Which paged kernels a call of dtype at head dim D over pages of s_sub
// states with vtz zeroed V lanes runs: up to D = 576 bit 0 the decode
// (paged_decode_tc_kernel), bit 1 the prefill (prefill_tc) on the tensor
// cores; above 576 bits 2 and 3 instead, the decode and the prefill on
// the split-D kernels; -1 for a dtype or layout without kernels.
int mfa_paged_bodies(int dtype, int D, int s_sub, int vtz) {
  if ((dtype != 0 && dtype != 1) || !valid_layout(KV_FLOAT, D, s_sub, vtz))
    return -1;
  if (D > MAX_D) return 4 | 8;
  return (dtype == 1 ? 1 : 0) | (prefill_tc(dtype, D, s_sub, vtz) ? 2 : 0);
}

const char* mfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

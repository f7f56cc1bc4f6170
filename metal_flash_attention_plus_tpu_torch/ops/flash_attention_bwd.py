"""Flash attention backward: dQ and dK/dV over float, int8 or int4 K/V.

The port of the JAX package's ``ops/flash_attention_bwd.py``.  Kernels with
disjoint outputs, so no atomics:

- :func:`flash_dq` → ``csrc/flash_attention.cu::flash_dq_kernel`` (TPU
  ``_dq_kernel``): per query tile, recomputes P = exp(S − L) from the
  saved logsumexp, dP = dO·Vᵀ, dS = P ⊙ (dP − D), dQ += dS·K; optionally
  writes dbias = dS.  Its bf16 instances, and those of :func:`qflash_dq`,
  run on the tensor cores (bf16 mma.sync: ``flash_dq_tc_kernel`` and
  ``qflash_dq_tc_kernel`` up to D = 256, ``flash_dq_wide_kernel`` and
  ``qflash_dq_wide_kernel`` at MLA's 288, ``flash_dq_latent_kernel`` and
  ``qflash_dq_latent_kernel`` at DeepSeek's 576); fp32 the scalar body
  (:func:`dq_body`); above 576 both dtypes ``split_d_dq_kernel``
  (``csrc/split_d_attention.cu``: dQ's lanes split over CTAs; where few
  row tiles leave SMs idle, :func:`split_d_dq_splits` runs of the KV axis,
  whose partials :func:`merge_dq_splits` sums).
- :func:`flash_dkv` → ``flash_dkv_kernel`` (TPU ``_dkv_kernel``): per key
  tile, walks the GQA group's q heads × the live query rows, dV += Pᵀ·dO,
  dK += dSᵀ·Q_s; the group reduction happens inside the kernel.  Its bf16
  instances, and those of :func:`qflash_dkv`, run on the tensor cores
  (``flash_dkv_tc_kernel``, ``qflash_dkv_tc_kernel`` up to D = 256;
  ``flash_dkv_wide_kernel``, ``qflash_dkv_wide_kernel`` at 288 and
  ``flash_dkv_latent_kernel``, ``qflash_dkv_latent_kernel`` at 576, which
  deal the GQA group over
  :func:`dkv_splits` CTAs a key tile into an fp32 workspace that
  :func:`merge_dkv_splits` sums in split order); fp32 the scalar body
  (:func:`dkv_body`); above 576 both dtypes ``split_d_dkv_kernel`` (dK's
  and dV's lanes split over CTAs, the group dealt over
  :func:`dkv_splits` CTAs and merged as at 288 and 576).
- Quantized K/V (:class:`QuantizedTensor`), exact: :func:`qflash_dq` and
  :func:`qflash_dkv` → ``csrc/quantized_attention_bwd.cu`` (the TPU
  kernels' quantized modes), the same two bodies with K/V staged from their
  payloads; above 576 ``split_d_qdq_kernel`` and ``split_d_qdkv_kernel``
  (``csrc/split_d_quantized_bwd.cu``: the split-D dQ and dK/dV bodies
  over the payloads, whole payload rows under a bf16 Q through a cp.async
  ring of their raw bytes; the dQ's KV split as the float dQ's).  dK/dV
  are gradients with respect to the DEQUANTIZED
  K/V.  The mode selection is the JAX package's: BLOCK_2D dequantizes in both
  kernels; the folded mode (a non-fp32 Q, SYMMETRIC TENSOR / CHANNEL / ROW
  K and V) runs dQ over the integers with TENSOR / CHANNEL K scales folded
  into Q and the dQ store vector, V's into dO, ROW scales as column
  multiplies on S and dS (K) or dP (V), while dK/dV dequantize (per token,
  or per channel); otherwise both dequantize per token.
- The full-integer backward (``fullint=True`` where
  :func:`fullint_backward_supported`): :func:`fullint_dq` and
  :func:`fullint_dkv` (TPU ``_dq_fullint_kernel`` / ``_dkv_fullint_kernel``)
  over per-token int8 Q and dO; level 1 by default, level 2
  (``MFA_BWD_FULLINT_LEVEL=2``) row-quantizes dS and P per tile of the
  TPU's width, resolved from ``block_sizes`` as the JAX package does.  They
  run on the tensor cores (``fullint_dq_tc_kernel``,
  ``fullint_dkv_tc_kernel``: s8 mma.sync, bf16 or s8 for the output
  products) except at level-2 widths that are not multiples of 32
  (:func:`fullint_body`), at every head dim from 1 to 576, zero-padded to
  :func:`~.quantized_attention.qattn_width` as the exact kernels are; above
  576 at both levels ``split_d_fullint_dq_kernel`` and
  ``split_d_fullint_dkv_kernel`` (``csrc/split_d_quantized_bwd.cu``: the
  lanes split over CTAs, S and dP on s8 ``mma.sync``).

D = rowsum(dO ⊙ O) is computed once in plain torch, in fp32 from the fp32
O residual, and shared by both kernels (callers may pass it as ``di``).
On a CUDA tensor each wrapper launches its kernel or raises; its plain
PyTorch version (``*_plain``) runs only for tensors on the CPU.  Both round
where the kernels do: q pre-scaled by ``scale`` and rounded to its dtype,
dO in q's dtype, dequantized K/V rounded to it, P rounded to dO's dtype
before Pᵀ·dO, dS rounded to K's (= Q's) dtype before dS·K and dSᵀ·Q_s; in
the full-integer kernels dS and P rounded to bf16 (level 1) or
row-quantized (level 2) before their products.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention.masking import (
    FULL,
    MaskKind,
    MaskSpec,
    Ranges,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    DTYPE_CODES,
    BlockSizes,
    _default_scale,
    bias_args,
    build_block_bounds,
    check_kernel_inputs,
    flash_width,
    fwd_body,
    kernel_bias,
    pad_lanes,
    range_mask,
    row_ranges_tensor,
    split_d_fwd_runs,
    split_d_fwd_splits,
    split_d_slices,
    stream_of,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    _FOLDED,
    HEAD_DIMS,
    _channel_scales,
    _check_payload,
    _kv_head_map,
    _kv_values,
    _per_token_params,
    _ptr,
    _scale_shapes,
    check_placement,
    pad_payload,
    pad_scales,
    qattn_width,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    _sm_count,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import QuantizedTensor
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    _expand_kv_heads,
    _reduce_kv_heads,
)

_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
# q, k, v, dO, L, D, ranges, bias | bias strides | two outputs | ints | scale
_BWD_ARGS = ([_PTR] * 8 + [_I64, _I64] + [_PTR, _PTR] + [_I32] * 8
             + [_F32, _PTR])
# The same | splits, workspace | stream (the dQ and the dK/dV)
_DKV_ARGS = _BWD_ARGS[:-1] + [_I32, _PTR, _PTR]
# workspace, dQ, dqsc | scale | B, Hq, Hkv, Sq, D, interleaved, splits |
# stream
_MERGE_DQ_ARGS = [_PTR] * 3 + [_F32] + [_I32] * 7 + [_PTR]
# workspace, dK, dV | splits | elements of dK | stream
_MERGE_ARGS = [_PTR] * 3 + [_I32, _I64, _PTR]
# dq | q, dO, K (payload, scale, zp), V (same), ksr, vsr, dqsc, L, D,
# ranges, bias | bias strides | two outputs | ints | scale
_QFLASH_ARGS = ([_I32] + [_PTR] * 15 + [_I64, _I64] + [_PTR, _PTR]
                + [_I32] * 14 + [_F32, _I32, _PTR, _PTR])
# dq | Q, its scales, K, its ROW scales, V, dO (and scales), dOv (and
# scales), L, D | two outputs | ints | store multiplier
_FULLINT_ARGS = [_I32] + [_PTR] * 13 + [_I32] * 8 + [_F32, _I32, _PTR,
                                                     _PTR]
# How the exact quantized kernels stage a K or V payload
# (csrc/quantized_tiles.cuh::Dequant).
DEQUANT = {"int": 0, "token": 1, "block2d": 2, "channel": 5}


def build_kv_block_bounds(
    row_ranges: np.ndarray,
    block_q: int,
    block_kv: int,
    num_kv_blocks: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-KV-block live q-block bounds (ilo, ihi), int32 ``[nj]`` — the
    transpose of :func:`build_block_bounds`.  A non-contiguous live set is
    covered by its span; masking zeroes the gaps.  The dK/dV kernel applies
    the same rule per key tile, at row rather than block granularity."""
    lo, hi, _ms, _me = build_block_bounds(row_ranges, block_q, block_kv)
    ni = lo.shape[0]
    live = np.zeros((ni, num_kv_blocks), dtype=bool)
    for i in range(ni):
        live[i, lo[i]: hi[i]] = True
    any_live = live.any(axis=0)
    first_i = np.where(any_live, live.argmax(axis=0), 0)
    last_i = np.where(any_live, ni - 1 - live[::-1].argmax(axis=0) + 1, 0)
    return first_i.astype(np.int32), last_i.astype(np.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _probabilities(q, k, v, do, lse, di, row_ranges, bias, scale,
                   interleaved_kv):
    """(q_s, k, dO, P, dS) per q head, fp32, rounded where the kernels
    round."""
    hq, skv = q.shape[1], k.shape[2]
    qs = (q.float() * scale).to(q.dtype).float()
    kx = _expand_kv_heads(k, hq, interleaved_kv).float()
    vx = _expand_kv_heads(v, hq, interleaved_kv).float()
    dof = do.to(q.dtype).float()
    s = qs @ kx.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    l_safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    keep, _ = range_mask(row_ranges, skv)
    p = torch.where(keep, torch.exp(s - l_safe[..., None]),
                    torch.zeros_like(s))
    dp = dof @ vx.transpose(-1, -2)
    ds = p * (dp - di[..., None])
    return qs, kx, dof, p, ds


def _dq_runs(dsk, k, row_ranges, splits, mult):
    """dQ = round_T(dS')·K × ``mult``: in one product, or with ``splits``
    > 1 the split-D dQ's runs of the KV axis (:func:`split_d_fwd_runs`,
    unaligned), each run's product over its own keys, merged by
    :func:`merge_dq_splits_plain`."""
    if splits == 1:
        return (dsk @ k) * mult
    run = split_d_fwd_runs(row_ranges, k.shape[-2], splits, aligned=False)
    ws = torch.stack([torch.where(run == sp, dsk, 0.0) @ k
                      for sp in range(splits)])
    return merge_dq_splits_plain(ws, mult)


def flash_attention_dq_plain(
    q, k, v, do, lse, di, row_ranges, *, bias=None, scale,
    interleaved_kv=False, want_dbias=False, splits=1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`flash_dq`; ``splits`` > 1: the
    split-D kernel's runs of the KV axis, merged."""
    _, kx, _, _, ds = _probabilities(q, k, v, do, lse, di, row_ranges, bias,
                                     scale, interleaved_kv)
    dq = _dq_runs(ds.to(k.dtype).float(), kx, row_ranges, splits, scale)
    return dq, (ds if want_dbias else None)


def flash_attention_dkv_plain(
    q, k, v, do, lse, di, row_ranges, *, bias=None, scale,
    interleaved_kv=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_dkv`."""
    qs, _, dof, p, ds = _probabilities(q, k, v, do, lse, di, row_ranges,
                                       bias, scale, interleaved_kv)
    dv = p.to(q.dtype).float().transpose(-1, -2) @ dof
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ qs
    hkv = k.shape[1]
    return (_reduce_kv_heads(dk, hkv, interleaved_kv),
            _reduce_kv_heads(dv, hkv, interleaved_kv))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def dkv_body(dtype: torch.dtype, d: int) -> str:
    """Which body of ``csrc/attention_bwd.cuh`` the dK/dV kernels
    (:func:`flash_dkv`, :func:`qflash_dkv`) run for a Q of ``dtype`` at head
    dim ``d``: "tensor_core" (bf16 mma.sync) for bf16 at every kernel
    width: ``dkv_tc_body`` up to 256, ``dkv_wide_body`` at MLA's width 288
    (272 runs at 288; the flash and the quantized kernels alike),
    ``dkv_latent_body`` at DeepSeek's absorbed width 576 (304 to 560 run at
    576; the flash and the quantized kernels alike); "fp32_fma"
    (``dkv_body``: scalar fp32 FMAs, ``dkv_body32`` at 576) for fp32, whose
    2e-5 gate TF32 would break; "split_d" above 576 in both dtypes
    (``split_d_dkv_kernel`` over float K/V, ``split_d_qdkv_kernel`` over
    the quantized payloads: one body).
    The C launchers route the same way (``mfa::dkv_tc``,
    ``mfa::bwd_wide``, ``mfa::bwd_latent``, ``mfa_sd::takes``)."""
    return fwd_body(dtype, d)


def dq_body(dtype: torch.dtype, d: int) -> str:
    """Which body of ``csrc/attention_bwd.cuh`` the dQ kernels
    (:func:`flash_dq`, :func:`qflash_dq`) run for a Q of ``dtype`` at head
    dim ``d``: "tensor_core" for bf16 (``dq_tc_body`` up to 256,
    ``dq_wide_body`` at 288, ``dq_latent_body`` at 576), "fp32_fma"
    (``dq_body``, ``dq_body32`` at 576) for fp32, "split_d" above 576
    (``split_d_dq_kernel``, ``split_d_qdq_kernel``); the same answer as
    :func:`dkv_body`.  The C launchers route the same way
    (``mfa::dq_tc``, ``mfa::bwd_wide``, ``mfa::bwd_latent``)."""
    return dkv_body(dtype, d)


# The dK/dV's wide and latent bodies (bf16 at widths 288 and 576) run one
# CTA an SM (205 and 227 KB of shared memory); dkv_splits deals the GQA
# group over CTAs until the grid holds this many CTAs an SM.  At MLA's
# training shape ``utils/profiling.py --dkv-splits`` measured 3.75, 1.90,
# 1.49, 1.28 and 1.20 ms for 1, 2, 4, 8 and 16 splits (64 key tiles; 16 is
# 8 CTAs an SM).
_DKV_CTAS_PER_SM = 8
# Keys a CTA of the split bodies: dkv_wide_body's 64 at 288,
# dkv_latent_body's 32 at 576, split_d_dkv_kernel's 64 above 576.
_DKV_SPLIT_TILE = {288: 64, 576: 32, "split_d": 64}


def dkv_splits(dtype: torch.dtype, d: int, batch: int, q_heads: int,
               kv_heads: int, kv_len: int, sms: int) -> int:
    """How many CTAs share each (key tile, batch row, KV head) of the
    dK/dV, from shapes alone: 1 except on the wide and latent bodies (bf16
    at kernel widths 288 and 576: ``dkv_wide_body``'s 64-key tiles,
    ``dkv_latent_body``'s 32-key ones), whose CTA walks its q heads in
    series.  There the GQA group of ``q_heads / kv_heads`` heads is dealt
    into runs of whole heads, one CTA a run: the split doubles while it
    stays within the group and the grid within ``_DKV_CTAS_PER_SM`` CTAs
    for each of ``sms`` SMs; the runs are then made equal
    (``ceil(group / per)`` of ``per`` heads).  MLA's training shape (batch
    2, 16 q heads over one latent head, 2048 keys: 64 tiles at 288) takes
    16 splits of one head on 132 SMs; DeepSeek-V2-Lite's (the same at
    576: 64 tiles of 32 keys a batch row, 128 CTAs) 8 splits of two
    heads.  Above 576 (``split_d_dkv_kernel``, both dtypes: 64-key tiles)
    the grid's CTAs count its lane slices too (:func:`split_d_slices`), so
    the trio's timing shape (batch 2, 16 q heads over one, 2048 keys) takes
    4 splits of 4 heads at D = 640 and 1024: 768 and 1,024 CTAs."""
    body = dkv_body(dtype, d)
    tile = _DKV_SPLIT_TILE.get(body if body == "split_d" else flash_width(d))
    if body == "fp32_fma" or tile is None:
        return 1
    group = q_heads // kv_heads
    ctas = -(-kv_len // tile) * kv_heads * batch * split_d_slices(d)
    splits = 1
    while (splits * 2 <= group
           and ctas * splits * 2 <= _DKV_CTAS_PER_SM * sms):
        splits *= 2
    per = -(-group // splits)
    return -(-group // per)


def split_d_dq_splits(d: int, batch: int, q_heads: int, seq_q: int,
                      seq_kv: int, sms: int) -> int:
    """How many runs the split-D dQ (``split_d_dq_kernel``,
    ``split_d_qdq_kernel``) deals each row tile's key span into, from
    shapes alone: the forward's plan (:func:`split_d_fwd_splits`: 1 unless
    the grid leaves SMs idle, then runs of at least 16 key tiles for two
    CTAs an SM, at most 64; 1 at or below 576), which the dQ walks as the
    float forward does (:func:`split_d_fwd_runs`, unaligned).  Perceiver
    IO's cross-attention (512 latents of 1024, one head, 50,176 keys: 32
    CTAs, 784 tiles) takes 8 runs of 98 tiles on 132 SMs; the trio (B=2,
    16 heads, S=2048: 4,096 CTAs) 1.  One CTA runs on an SM at a time (its
    registers): at Perceiver IO ``utils/profiling.py --dq-splits`` timed
    4, 8 and 16 runs within 2% of each other, float and quantized, and 1
    and 2 runs 4.0× and 2.0× slower on an H100."""
    return split_d_fwd_splits(d, batch, q_heads, seq_q, seq_kv, sms)


def split_d_dq_workspace(shape, splits: int,
                         device) -> Optional[torch.Tensor]:
    """The split-D dQ's partials fp32 [splits, B, Hq, Sq, D] for a dQ of
    ``shape`` [B, Hq, Sq, D] (at the kernel width), or None at one run."""
    if splits == 1:
        return None
    return torch.empty((splits,) + tuple(shape), dtype=torch.float32,
                       device=device)


def merge_dq_splits_plain(ws: torch.Tensor, mult) -> torch.Tensor:
    """Plain PyTorch version of :func:`merge_dq_splits`: ``ws`` fp32
    [splits, B, Hq, Sq, D] summed in run order from run 0, then times
    ``mult`` (the scale, or the store multipliers broadcast to [B, Hq, 1,
    D]): the kernel's order, so the two agree bit for bit."""
    acc = ws[0].clone()
    for part in ws[1:]:
        acc += part
    return acc * mult


def merge_dq_splits(ws: torch.Tensor, dq: torch.Tensor, *, kv_heads: int,
                    interleaved_kv: bool = False,
                    dqsc: Optional[torch.Tensor] = None,
                    scale: float = 1.0) -> None:
    """dq (fp32 [B, Hq, Sq, D]) = the split-D dQ's partials ``ws`` fp32
    [splits, B, Hq, Sq, D] summed in run order, times ``dqsc`` fp32
    [B, Hkv, D] (the quantized dQ's store multipliers, by the GQA map of
    ``kv_heads`` and ``interleaved_kv``) or ``scale``, in place
    (``csrc/split_d_attention.cu::split_d_dq_merge_kernel``: no atomics, so
    two calls agree bit for bit).  CPU tensors take
    :func:`merge_dq_splits_plain`."""
    b, hq, sq, d = dq.shape
    if ws.device.type == "cpu":
        mult = (scale if dqsc is None else _expand_kv_heads(
            dqsc[:, :, None], hq, interleaved_kv))
        dq.copy_(merge_dq_splits_plain(ws, mult))
        return
    if (ws.dtype != torch.float32 or not ws.is_contiguous()
            or ws.dim() != 5 or ws.shape[1:] != dq.shape or d % 4
            or (dqsc is not None and dqsc.shape != (b, kv_heads, d))
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != ws.device
                   for t in (dq,) + (() if dqsc is None else (dqsc,)))):
        raise ValueError("merge_dq_splits: ws fp32 [splits, *dq.shape], "
                         "contiguous fp32 dq (and dqsc [B, Hkv, D]) on its "
                         "device expected")
    rc = _build.kernel_function("mfa_split_d_dq_merge", _MERGE_DQ_ARGS)(
        ws.data_ptr(), dq.data_ptr(), _ptr(dqsc), scale, b, hq, kv_heads,
        sq, d, int(interleaved_kv), ws.shape[0], stream_of(dq))
    _build.check_launch(rc, "split_d_dq_merge")
    merge_dq_splits.launches += 1


merge_dq_splits.launches = 0


def _launch(name, fn_name, q, k, v, do, lse, di, row_ranges, bias, out0,
            out1, scale, interleaved_kv, split=()):
    """``split``: (splits, workspace) for ``mfa_flash_dq`` and
    ``mfa_flash_dkv``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bptr, bsb, bsh = bias_args(bias)
    rc = _build.kernel_function(fn_name, _DKV_ARGS if split else _BWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), row_ranges.data_ptr(), bptr, bsb, bsh,
        out0.data_ptr(), None if out1 is None else out1.data_ptr(),
        DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, d, int(interleaved_kv),
        scale, *split, stream_of(q),
    )
    _build.check_launch(rc, name)


def flash_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    di: torch.Tensor,
    row_ranges: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: float,
    interleaved_kv: bool = False,
    want_dbias: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The dQ kernel: (dq fp32 [B, Hq, Sq, D], dS as dbias fp32
    [B, Hq, Sq, Skv] or None).  ``do`` in q's dtype; ``lse``/``di`` fp32
    [B, Hq, Sq]; ``bias`` fp32 [1 or B, 1 or Hq, Sq, Skv].  The kernel runs
    at the head dim's ``flash_width``, on the body :func:`dq_body` names.
    Above 576 the KV axis splits where :func:`split_d_dq_splits` says: the
    kernel writes each run's partial to a workspace this call allocates
    and :func:`merge_dq_splits` makes dQ."""
    if q.device.type == "cpu":
        return flash_attention_dq_plain(
            q, k, v, do, lse, di, row_ranges, bias=bias, scale=scale,
            interleaved_kv=interleaved_kv, want_dbias=want_dbias)
    check_kernel_inputs("flash_dq", q, k, v, row_ranges, bias, q_like=(do,),
                        stats=(lse, di))
    b, hq, sq, d = q.shape
    q, k, v, do = pad_lanes(flash_width(d), q, k, v, do)
    hkv, skv = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dbias = (torch.zeros((b, hq, sq, skv), dtype=torch.float32,
                         device=q.device) if want_dbias else None)
    splits = split_d_dq_splits(q.shape[-1], b, hq, sq, skv,
                               _sm_count(q.device))
    ws = split_d_dq_workspace(q.shape, splits, q.device)
    _launch("flash_dq", "mfa_flash_dq", q, k, v, do, lse, di, row_ranges,
            bias, dq, dbias, scale, interleaved_kv,
            split=(splits, _ptr(ws)))
    flash_dq.launches += 1
    if ws is not None:
        merge_dq_splits(ws, dq, kv_heads=hkv, interleaved_kv=interleaved_kv,
                        scale=scale)
    return (dq if dq.shape[-1] == d else dq[..., :d].contiguous()), dbias


flash_dq.launches = 0


def flash_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    di: torch.Tensor,
    row_ranges: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: float,
    interleaved_kv: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: (dk, dv) fp32 [B, Hkv, Skv, D], summed over each
    KV head's group of q heads.  Inputs as for :func:`flash_dq`; the kernel
    runs at the head dim's ``flash_width``.  Where :func:`dkv_splits` deals
    the group over several CTAs a key tile, they write fp32 partials into a
    workspace this call allocates, [splits, 2, B, Hkv, Skv, D], and
    :func:`merge_dkv_splits` sums them in split order."""
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(
            q, k, v, do, lse, di, row_ranges, bias=bias, scale=scale,
            interleaved_kv=interleaved_kv)
    check_kernel_inputs("flash_dkv", q, k, v, row_ranges, bias,
                        q_like=(do,), stats=(lse, di))
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q, k, v, do = pad_lanes(flash_width(d), q, k, v, do)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    splits = dkv_splits(q.dtype, d, b, hq, hkv, skv, _sm_count(q.device))
    ws = (torch.empty((splits, 2) + tuple(k.shape), dtype=torch.float32,
                      device=k.device) if splits > 1 else None)
    _launch("flash_dkv", "mfa_flash_dkv", q, k, v, do, lse, di, row_ranges,
            bias, dk, dv, scale, interleaved_kv,
            split=(splits, None if ws is None else ws.data_ptr()))
    flash_dkv.launches += 1
    if ws is not None:
        merge_dkv_splits(ws, dk, dv)
    if dk.shape[-1] != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


flash_dkv.launches = 0


def merge_dkv_splits_plain(ws: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Plain PyTorch version of :func:`merge_dkv_splits`: (dk, dv) =
    ws[0, i] + ws[1, i] + ... in split order."""
    acc = ws[0].clone()
    for part in ws[1:]:
        acc += part
    return acc[0], acc[1]


def merge_dkv_splits(ws: torch.Tensor, dk: torch.Tensor,
                     dv: torch.Tensor) -> None:
    """dk, dv (fp32, contiguous) = the split dK/dV's partials ``ws`` fp32
    [splits, 2, *dk.shape] summed in split order, in place
    (``csrc/flash_attention.cu::flash_dkv_merge_kernel``; the plain
    version's order, so the two agree bit for bit)."""
    if ws.device.type == "cpu":
        mk, mv = merge_dkv_splits_plain(ws)
        dk.copy_(mk)
        dv.copy_(mv)
        return
    if (ws.dtype != torch.float32 or not ws.is_contiguous()
            or ws.shape[1:] != (2,) + tuple(dk.shape)
            or dv.shape != dk.shape
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != ws.device for t in (dk, dv))):
        raise ValueError("merge_dkv_splits: ws fp32 [splits, 2, *dk.shape] "
                         "and contiguous fp32 dk, dv on its device expected")
    rc = _build.kernel_function("mfa_flash_dkv_merge", _MERGE_ARGS)(
        ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.shape[0],
        dk.numel(), stream_of(dk))
    _build.check_launch(rc, "flash_dkv_merge")
    merge_dkv_splits.launches += 1


merge_dkv_splits.launches = 0


# ---------------------------------------------------------------------------
# Quantized K/V, exact: the dQ and dK/dV kernels over payloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVMode:
    """How the exact quantized kernels stage K and V (``DEQUANT``): "int"
    (the integers; the folded dQ), "token", "block2d" or "channel"
    (dequantized and rounded to Q's dtype); each payload's bit width; the
    BLOCK_2D block (rows, columns)."""

    k: str
    v: str
    bits_k: int = 8
    bits_v: int = 8
    block: Tuple[int, int] = (1, 1)


def _kv_tiles(kq, vq, k_params, v_params, mode, d, dtype):
    """fp32 [B, Hkv, Skv, D] K and V values as the kernels stage them."""
    return (_kv_values(kq, *k_params, mode.k, mode.bits_k, d, mode.block,
                       dtype),
            _kv_values(vq, *v_params, mode.v, mode.bits_v, d, mode.block,
                       dtype))


def qflash_dq_plain(
    q, do, kq, vq, k_params, v_params, lse, di, row_ranges, *, mode, dqsc,
    ksr=None, vsr=None, bias=None, interleaved_kv=False, want_dbias=False,
    splits=1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`qflash_dq`; ``splits`` > 1: the
    split-D kernel's runs of the KV axis, merged."""
    hq, skv, d = q.shape[1], kq.shape[2], q.shape[3]
    kv_of = _kv_head_map(hq, kq.shape[1], interleaved_kv).to(q.device)
    k, v = (t[:, kv_of] for t in _kv_tiles(kq, vq, k_params, v_params, mode,
                                           d, q.dtype))
    ks = None if ksr is None else ksr[:, kv_of, None, :]
    s = q.float() @ k.transpose(-1, -2)
    if ks is not None:
        s = s * ks
    if bias is not None:
        s = s + bias.float()
    l_safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    keep, _ = range_mask(row_ranges, skv)
    p = torch.where(keep, torch.exp(s - l_safe[..., None]),
                    torch.zeros_like(s))
    dp = do.float() @ v.transpose(-1, -2)
    if vsr is not None:
        dp = dp * vsr[:, kv_of, None, :]
    ds = p * (dp - di[..., None])
    dsk = ds if ks is None else ds * ks
    dq = _dq_runs(dsk.to(q.dtype).float(), k, row_ranges, splits,
                  dqsc[:, kv_of, None, :])
    return dq, (ds if want_dbias else None)


def qflash_dkv_plain(
    q, do, kq, vq, k_params, v_params, lse, di, row_ranges, *, mode, scale,
    bias=None, interleaved_kv=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`qflash_dkv`: the float dK/dV over
    the dequantized K/V."""
    k, v = _kv_tiles(kq, vq, k_params, v_params, mode, q.shape[3], q.dtype)
    return flash_attention_dkv_plain(q, k, v, do, lse, di, row_ranges,
                                     bias=bias, scale=scale,
                                     interleaved_kv=interleaved_kv)


def check_qflash_inputs(name, q, do, kq, vq, k_params, v_params, lse, di,
                        row_ranges, bias, mode, ksr=None, vsr=None,
                        dqsc=None):
    """Raise unless the tensors are what ``qflash_*_kernel`` take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if q.dtype not in DTYPE_CODES or do.dtype != q.dtype:
        raise TypeError(f"{name}: q and dO must share a dtype in "
                        f"{tuple(DTYPE_CODES)}")
    if q.dim() != 4 or kq.dim() != 4 or do.shape != q.shape:
        raise ValueError(f"{name}: q = dO [B, Hq, Sq, D], payloads "
                         "[B, Hkv, Skv, D or D/2] expected")
    b, hq, sq, d = q.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    if kq.shape[0] != b or hq % hkv:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} / "
                         f"{tuple(kq.shape)} do not match")
    qattn_width(d)
    if (mode.k not in DEQUANT or mode.v not in DEQUANT
            or mode.bits_k not in (8, 4) or mode.bits_v not in (8, 4)):
        raise ValueError(f"{name}: mode {mode} has no kernel")
    br, bs = mode.block
    if "block2d" in (mode.k, mode.v) and (skv % br or d % bs):
        raise ValueError(f"{name}: block {mode.block} does not tile "
                         f"[{skv}, {d}]")
    _check_payload(name, kq, mode.bits_k, b, hkv, skv, d)
    _check_payload(name, vq, mode.bits_v, b, hkv, skv, d)
    specs = [(lse, (b, hq, sq)), (di, (b, hq, sq))]
    for t, shape in ((ksr, (b, hkv, skv)), (vsr, (b, hkv, skv)),
                     (dqsc, (b, hkv, d))):
        if t is not None:
            specs.append((t, shape))
    for params, m in ((k_params, mode.k), (v_params, mode.v)):
        shapes = _scale_shapes(m, b, hkv, skv, d, mode.block)
        for t, shape in zip(params, shapes):
            if (t is None) != (shape is None):
                raise TypeError(f"{name}: {m} scales take {shapes}")
            if t is not None:
                specs.append((t, shape))
    for t, shape in specs:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: scales and statistics must be fp32 "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
    check_placement(name, dev, [q, do, kq, vq, *(t for t, _ in specs)],
                    (q, do, kq, vq), row_ranges, bias, (b, hq, sq, skv))


def pad_qflash_kv(d: int, kq, vq, k_params, v_params, mode: KVMode):
    """(kq, vq, k_params, v_params) at the kernel width of head dim ``d``
    (:func:`qattn_width`): the payloads widened with zeros (int4
    repacked), per-channel and BLOCK_2D scales padded with cells of scale
    1 and zero point 0.  The padded lanes meet the zero lanes of Q and dO
    and land in gradient lanes that are cut off."""
    w = qattn_width(d)
    return (pad_payload(kq, mode.bits_k, d, w),
            pad_payload(vq, mode.bits_v, d, w),
            pad_scales(k_params, mode.k, d, w, mode.block),
            pad_scales(v_params, mode.v, d, w, mode.block))


def _launch_qflash(name, dq, q, do, kq, vq, k_params, v_params, ksr, vsr,
                   dqsc, lse, di, row_ranges, bias, out0, out1, mode, scale,
                   interleaved_kv, splits=1, ws=None):
    b, hq, sq, d = q.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    bptr, bsb, bsh = bias_args(bias)
    rc = _build.kernel_function("mfa_qflash_bwd", _QFLASH_ARGS)(
        int(dq), q.data_ptr(), do.data_ptr(), kq.data_ptr(),
        _ptr(k_params[0]), _ptr(k_params[1]), vq.data_ptr(),
        _ptr(v_params[0]), _ptr(v_params[1]), _ptr(ksr), _ptr(vsr),
        _ptr(dqsc), lse.data_ptr(), di.data_ptr(), row_ranges.data_ptr(),
        bptr, bsb, bsh, out0.data_ptr(), _ptr(out1), DTYPE_CODES[q.dtype], b,
        hq, hkv, sq, skv, d, int(interleaved_kv), mode.bits_k, mode.bits_v,
        DEQUANT[mode.k], DEQUANT[mode.v], mode.block[0], mode.block[1], scale,
        splits, _ptr(ws), stream_of(q),
    )
    _build.check_launch(rc, name)


def qflash_dq(
    q: torch.Tensor,
    do: torch.Tensor,
    kq: torch.Tensor,
    vq: torch.Tensor,
    k_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    v_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    lse: torch.Tensor,
    di: torch.Tensor,
    row_ranges: torch.Tensor,
    *,
    mode: KVMode,
    dqsc: torch.Tensor,
    ksr: Optional[torch.Tensor] = None,
    vsr: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    interleaved_kv: bool = False,
    want_dbias: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The exact quantized dQ kernel: (dq fp32 [B, Hq, Sq, D], dS as dbias
    fp32 [B, Hq, Sq, Skv] or None).

    ``q`` / ``do``: what the kernel multiplies (fp32 or bf16, Q pre-scaled,
    folded scales applied); ``kq`` / ``vq``: int8 [B, Hkv, Skv, D] or
    packed int4 [.., D/2], staged as ``mode`` says, with (scale, zero
    point) fp32 per token [B, Hkv, Skv] or per block [B, Hkv, Skv/br, D/bs]
    (None for "int"); ``ksr`` / ``vsr``: per-token K / V scales fp32
    [B, Hkv, Skv] on S's and dS's / dP's columns; ``dqsc``: the store
    multipliers fp32 [B, Hkv, D].  CPU tensors take
    :func:`qflash_dq_plain`; CUDA tensors launch ``qflash_dq_tc_kernel``
    (bf16 up to kernel width 256), ``qflash_dq_wide_kernel`` (bf16 at 288),
    ``qflash_dq_latent_kernel`` (bf16 at 576), ``qflash_dq_kernel`` (fp32;
    :func:`dq_body`, 32-row tiles at 576) or above 576 ``split_d_qdq_kernel``
    (both dtypes; the KV axis split as :func:`flash_dq` splits it, then
    :func:`merge_dq_splits` with the store multipliers), or raise."""
    kw = dict(mode=mode, dqsc=dqsc, ksr=ksr, vsr=vsr, bias=bias,
              interleaved_kv=interleaved_kv)
    if q.device.type == "cpu":
        return qflash_dq_plain(q, do, kq, vq, k_params, v_params, lse, di,
                               row_ranges, want_dbias=want_dbias, **kw)
    check_qflash_inputs("qflash_dq", q, do, kq, vq, k_params, v_params, lse,
                        di, row_ranges, bias, mode, ksr, vsr, dqsc)
    b, hq, sq, d = q.shape
    w = qattn_width(d)
    kq, vq, k_params, v_params = pad_qflash_kv(d, kq, vq, k_params,
                                               v_params, mode)
    q, do = pad_lanes(w, q, do)
    if w != d:
        dqsc = torch.nn.functional.pad(dqsc, (0, w - d), value=1.0)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dbias = (torch.zeros((b, hq, sq, kq.shape[2]), dtype=torch.float32,
                         device=q.device) if want_dbias else None)
    splits = split_d_dq_splits(w, b, hq, sq, kq.shape[2],
                               _sm_count(q.device))
    ws = split_d_dq_workspace(q.shape, splits, q.device)
    _launch_qflash("qflash_dq", True, q, do, kq, vq, k_params, v_params, ksr,
                   vsr, dqsc, lse, di, row_ranges, bias, dq, dbias, mode, 1.0,
                   interleaved_kv, splits, ws)
    qflash_dq.launches += 1
    if ws is not None:
        merge_dq_splits(ws, dq, kv_heads=kq.shape[1],
                        interleaved_kv=interleaved_kv, dqsc=dqsc)
    return (dq if w == d else dq[..., :d].contiguous()), dbias


qflash_dq.launches = 0


def qflash_dkv(
    q: torch.Tensor,
    do: torch.Tensor,
    kq: torch.Tensor,
    vq: torch.Tensor,
    k_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    v_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    lse: torch.Tensor,
    di: torch.Tensor,
    row_ranges: torch.Tensor,
    *,
    mode: KVMode,
    scale: float,
    bias: Optional[torch.Tensor] = None,
    interleaved_kv: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact quantized dK/dV kernel: (dk, dv) fp32 [B, Hkv, Skv, D],
    gradients with respect to the dequantized K/V, summed over each KV
    head's group.  ``q`` unscaled (the kernel scales and rounds it);
    payloads and parameters as for :func:`qflash_dq`, with "channel" scales
    fp32 [B, Hkv, D].  CPU tensors take :func:`qflash_dkv_plain`; CUDA
    tensors launch ``qflash_dkv_tc_kernel`` (bf16 up to kernel width 256),
    ``qflash_dkv_wide_kernel`` (bf16 at 288) or ``qflash_dkv_latent_kernel``
    (bf16 at 576: at both, where :func:`dkv_splits` deals the group over
    several CTAs a key tile, into a workspace that :func:`merge_dkv_splits`
    sums in split order), ``qflash_dkv_kernel`` (fp32; :func:`dkv_body`,
    32-key tiles at 576) or above 576 ``split_d_qdkv_kernel`` (both dtypes,
    the group split as at 576), or raise."""
    kw = dict(mode=mode, scale=scale, bias=bias,
              interleaved_kv=interleaved_kv)
    if q.device.type == "cpu":
        return qflash_dkv_plain(q, do, kq, vq, k_params, v_params, lse, di,
                                row_ranges, **kw)
    check_qflash_inputs("qflash_dkv", q, do, kq, vq, k_params, v_params, lse,
                        di, row_ranges, bias, mode)
    b, hq, _, d = q.shape
    w = qattn_width(d)
    kq, vq, k_params, v_params = pad_qflash_kv(d, kq, vq, k_params,
                                               v_params, mode)
    q, do = pad_lanes(w, q, do)
    shape = (*kq.shape[:3], w)
    dk = torch.empty(shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(shape, dtype=torch.float32, device=q.device)
    splits = dkv_splits(q.dtype, d, b, hq, shape[1], shape[2],
                        _sm_count(q.device))
    ws = (torch.empty((splits, 2) + shape, dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    _launch_qflash("qflash_dkv", False, q, do, kq, vq, k_params, v_params,
                   None, None, None, lse, di, row_ranges, bias, dk, dv, mode,
                   scale, interleaved_kv, splits, ws)
    qflash_dkv.launches += 1
    if ws is not None:
        merge_dkv_splits(ws, dk, dv)
    if w != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


qflash_dkv.launches = 0


def qflash_arguments(q, k, v, do, lse, di, rr, bias=None, *, scale,
                     interleaved_kv=False, want_dbias=False):
    """The exact quantized kernels' arguments for this backward: ((args,
    kwargs) of :func:`qflash_dq`, (args, kwargs) of :func:`qflash_dkv`),
    and of their plain versions.  The JAX package's mode selection, Q / dO
    folds and scale layouts; ``do`` in q's dtype, ``lse`` / ``di`` fp32,
    ``rr`` the row-range table, ``bias`` as the kernels read it."""
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kc, vc = k.config, v.config
    kv_of = _kv_head_map(hq, hkv, interleaved_kv).to(q.device)
    qs = (q.float() * scale).to(q.dtype)
    q_dq, do_dq, ksr, vsr = qs, do, None, None
    dqsc = torch.full((b, hkv, d), scale, dtype=torch.float32,
                      device=q.device)
    folded = (q.dtype != torch.float32
              and kc.strategy == QuantStrategy.SYMMETRIC
              and vc.strategy == QuantStrategy.SYMMETRIC
              and kc.granularity in _FOLDED and vc.granularity in _FOLDED)
    if kc.granularity == QuantGranularity.BLOCK_2D:
        block = (kc.block_rows, kc.block_size)
        if vc.granularity != QuantGranularity.BLOCK_2D or block != (
                vc.block_rows, vc.block_size):
            raise ValueError("K/V must share BLOCK_2D block geometry")
        if 128 % block[0]:
            raise ValueError(f"block_rows {block[0]} must divide 128")
        kp, vp = ((t.scale.float().contiguous(),
                   t.zero_point.float().contiguous()) for t in (k, v))
        dq_mode = dkv_mode = KVMode("block2d", "block2d", kc.bits, vc.bits,
                                    block)
        dq_params = (kp, vp)
    elif folded:
        # dQ over the integers (see the module docstring); the channel
        # scales follow the GQA mapping, interleaved or grouped.
        if kc.granularity == QuantGranularity.CHANNEL:
            ksc = _channel_scales(k)
            q_dq = (qs.float() * ksc[:, kv_of, None, :]).to(q.dtype)
            dqsc = (ksc * scale).contiguous()
        elif kc.granularity == QuantGranularity.TENSOR:
            ksc = k.scale.reshape(()).float()
            q_dq = (qs.float() * ksc).to(q.dtype)
            dqsc = (ksc * scale).expand(b, hkv, d).contiguous()
        else:
            ksr = k.scale.reshape(b, hkv, skv).float().contiguous()
        if vc.granularity == QuantGranularity.CHANNEL:
            do_dq = (do.float() * _channel_scales(v)[:, kv_of, None, :]).to(
                q.dtype)
        elif vc.granularity == QuantGranularity.TENSOR:
            do_dq = (do.float() * v.scale.reshape(()).float()).to(q.dtype)
        else:
            vsr = v.scale.reshape(b, hkv, skv).float().contiguous()
        dq_mode = KVMode("int", "int", kc.bits, vc.bits)
        dq_params = ((None, None), (None, None))

        def dequant(t):
            if t.config.granularity == QuantGranularity.CHANNEL:
                return "channel", (_channel_scales(t).contiguous(), None)
            return "token", _per_token_params(t)

        (km, kp), (vm, vp) = dequant(k), dequant(v)
        dkv_mode = KVMode(km, vm, kc.bits, vc.bits)
    else:
        kp, vp = _per_token_params(k), _per_token_params(v)
        dq_mode = dkv_mode = KVMode("token", "token", kc.bits, vc.bits)
        dq_params = (kp, vp)
    kd, vd = k.data.contiguous(), v.data.contiguous()
    return (
        ((q_dq.contiguous(), do_dq.contiguous(), kd, vd, *dq_params, lse, di,
          rr),
         dict(mode=dq_mode, dqsc=dqsc, ksr=ksr, vsr=vsr, bias=bias,
              interleaved_kv=interleaved_kv, want_dbias=want_dbias)),
        ((q, do, kd, vd, kp, vp, lse, di, rr),
         dict(mode=dkv_mode, scale=scale, bias=bias,
              interleaved_kv=interleaved_kv)),
    )


# ---------------------------------------------------------------------------
# The full-integer backward
# ---------------------------------------------------------------------------


def _per_token_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: [..., S, D] → (int8 payload, fp32 scales
    [..., S, 1]); scale = max(absmax, 1e-12)/127, round(x / scale) half to
    even, clipped to ±127."""
    xf = x.float()
    sc = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(xf / sc).clamp(-127, 127).to(torch.int8), sc


def _rowquant_signed(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of an fp32 tile over its last dim: (the
    integers as fp32, scales [..., 1] = absmax/127); ±0.5 then truncation,
    as the TPU kernel rounds."""
    am = x.abs().amax(dim=-1, keepdim=True)
    xs = x * (127.0 / am.clamp_min(1e-30))
    half = torch.where(xs >= 0, 0.5, -0.5)
    return torch.trunc(xs + half), am * (1.0 / 127.0)


def _rowquant_pos(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_rowquant_signed` for a non-negative tile (P): +0.5 then
    truncation, integers in [0, 127]."""
    am = x.amax(dim=-1, keepdim=True)
    return (torch.trunc(x * (127.0 / am.clamp_min(1e-30)) + 0.5),
            am * (1.0 / 127.0))


def _quantized_product(x, m, width, rowquant):
    """Level 2's product x·m: x's rows quantized per ``width``-wide tile
    of its last dim, each tile's integer product times its row scales,
    summed over the tiles, as the TPU kernel accumulates."""
    *lead, r, c = x.shape
    xq, sc = rowquant(x.reshape(*lead, r, c // width, width))
    mb = m.reshape(*m.shape[:-2], c // width, width, m.shape[-1])
    return (torch.einsum("...rnw,...nwd->...rnd", xq, mb) * sc).sum(dim=-2)


def _bf16_product(x, m):
    return x.to(torch.bfloat16).float() @ m


def fullint_dq_plain(qq, qsc, kq, ks, vq, dov, dovsc, lse, di, *, store,
                     width=0, interleaved_kv=False) -> torch.Tensor:
    """Plain PyTorch version of :func:`fullint_dq`."""
    kv_of = _kv_head_map(qq.shape[1], kq.shape[1], interleaved_kv).to(
        qq.device)
    kx, vx = kq[:, kv_of].float(), vq[:, kv_of].float()
    ksx = None if ks is None else ks[:, kv_of, None, :]
    s = (qq.float() @ kx.transpose(-1, -2)) * qsc[..., None]
    if ksx is not None:
        s = s * ksx
    p = torch.exp(s - lse[..., None])
    dp = (dov.float() @ vx.transpose(-1, -2)) * dovsc[..., None]
    ds = p * (dp - di[..., None])
    if ksx is not None:
        ds = ds * ksx
    dq = (_quantized_product(ds, kx, width, _rowquant_signed) if width
          else _bf16_product(ds, kx))
    return dq * store


def fullint_dkv_plain(qq, qsc, kq, ks, vq, dor, dorsc, dov, dovsc, lse, di,
                      *, store, width=0, interleaved_kv=False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fullint_dkv`."""
    hkv = kq.shape[1]
    kv_of = _kv_head_map(qq.shape[1], hkv, interleaved_kv).to(qq.device)
    kx, vx = kq[:, kv_of].float(), vq[:, kv_of].float()
    qf = qq.float()
    cols = qsc[:, :, None, :]  # [B, Hq, 1, Sq]: per-query, on Sᵀ's columns
    st = (kx @ qf.transpose(-1, -2)) * cols
    if ks is not None:
        st = st * ks[:, kv_of, :, None]
    pt = torch.exp(st - lse[:, :, None, :])
    ptd = pt * dorsc[:, :, None, :]
    dpt = (vx @ dov.float().transpose(-1, -2)) * dovsc[:, :, None, :]
    dst = pt * (dpt - di[:, :, None, :]) * cols
    dorf = dor.float()
    if width:
        dv = _quantized_product(ptd, dorf, width, _rowquant_pos)
        dk = _quantized_product(dst, qf, width, _rowquant_signed)
    else:
        dv, dk = _bf16_product(ptd, dorf), _bf16_product(dst, qf)
    return (_reduce_kv_heads(dk, hkv, interleaved_kv) * store,
            _reduce_kv_heads(dv, hkv, interleaved_kv))


FULLINT_K_STEP = 32  # keys or queries of one s8 m16n8k32 k step


def fullint_body(d: int, width: int) -> str:
    """Which kernels :func:`fullint_dq` and :func:`fullint_dkv` launch at
    head dim ``d`` and level-2 width ``width`` (0: level 1): "tensor_core"
    (``fullint_dq_tc_kernel``, ``fullint_dkv_tc_kernel``: s8 mma.sync for
    S and dP, bf16 mma.sync at level 1 and s8 at level 2 for the output
    products) at level 1 and at widths of whole s8 k steps (multiples of
    32 keys or queries), the spans whose integer products they sum under
    one scale; "dp4a" (``fullint_dq_kernel``, ``fullint_dkv_kernel``:
    __dp4a and scalar fp32 FMAs) at the other widths, which
    :func:`fullint_widths` gives sequences that no power of two from 32
    divides (below 32, or 8 or 16 times an odd number: 48 at 336).  Both
    pairs are built at every ``HEAD_DIMS`` width, MLA's 288 and DeepSeek's
    absorbed 576 among them (at 576 in 32-row tiles), and run the other
    head dims up to 576 zero-padded at :func:`qattn_width`; past 576
    "split_d" at both levels and every width (``split_d_fullint_dq_kernel``,
    ``split_d_fullint_dkv_kernel``: a head's lane slices as clusters of
    :func:`split_d_fullint_cluster` CTAs that split S's and dP's
    contraction and add their exact int32 partials through distributed
    shared memory, S and dP on s8 ``mma.sync``, the output products on
    bf16 ``mma.sync`` at level 1 and on s8 ``mma.sync`` over the
    row-quantized codes at level 2, a span's tiles ending at its end).
    The C launcher routes the same way (``mfa_fullint_tc_body``)."""
    w = qattn_width(d)
    if width < 0:
        raise ValueError(f"level-2 width {width} has no kernel")
    if w > HEAD_DIMS[-1]:
        return "split_d"
    return "tensor_core" if width % FULLINT_K_STEP == 0 else "dp4a"


SPLIT_D_FULLINT_MAX_CLUSTER = 16  # C's mfa_sd::MAX_FULLINT_CLUSTER


def split_d_fullint_cluster(d: int) -> Tuple[int, int]:
    """The cluster of the split-D full-integer pair at head dim ``d``:
    (C, slices a CTA).  A head's :func:`split_d_slices` lane slices run as
    clusters of C CTAs (C the largest divisor of the slices up to
    ``SPLIT_D_FULLINT_MAX_CLUSTER``, a non-portable size above 8), rank r
    of a cluster summing S and dP over the lanes of slices ``[r * per,
    (r + 1) * per)``, ``per`` = slices / C, before the cluster adds the
    ranks' int32 partials: 3 clusters of one slice at 640, 4 at 1024, 5 at
    1152, 9 at 2304; (1, 1) at or below 576.  C's
    ``mfa_split_d_fullint_cluster`` answers the size the launch takes,
    this plan where the card holds such a cluster."""
    n = split_d_slices(d)
    c = max(k for k in range(1, min(n, SPLIT_D_FULLINT_MAX_CLUSTER) + 1)
            if n % k == 0)
    return c, n // c


def _check_fullint(name, qq, qsc, kq, ks, vq, dos, lse, di, width):
    """Raise unless the tensors are what ``fullint_*_kernel`` take; ``dos``:
    the (int8 dO, scales) pairs."""
    dev = qq.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if qq.dim() != 4 or kq.dim() != 4:
        raise ValueError(f"{name}: Q [B, Hq, Sq, D], K/V [B, Hkv, Skv, D] "
                         "expected")
    b, hq, sq, d = qq.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    qattn_width(d)
    if kq.shape[0] != b or hq % hkv or width < 0:
        raise ValueError(f"{name}: shapes {tuple(qq.shape)} / "
                         f"{tuple(kq.shape)}, width {width} have no kernel")
    rows = (b, hq, sq)
    specs = [(qq, torch.int8, qq.shape), (kq, torch.int8, (b, hkv, skv, d)),
             (vq, torch.int8, (b, hkv, skv, d)), (qsc, torch.float32, rows),
             (lse, torch.float32, rows), (di, torch.float32, rows)]
    if ks is not None:
        specs.append((ks, torch.float32, (b, hkv, skv)))
    for t, sc in dos:
        specs += [(t, torch.int8, qq.shape), (sc, torch.float32, rows)]
    for t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise TypeError(f"{name}: expected {dtype} {tuple(shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on {dev}")
        if t.dtype == torch.int8 and t.data_ptr() % 16:
            raise ValueError(f"{name}: int8 operands must be 16-byte aligned")


def _launch_fullint(name, dq, qq, qsc, kq, ks, vq, dor, dorsc, dov, dovsc,
                    lse, di, out0, out1, width, store, interleaved_kv,
                    splits=1, ws=None):
    b, hq, sq, d = qq.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    rc = _build.kernel_function("mfa_fullint_bwd", _FULLINT_ARGS)(
        int(dq), qq.data_ptr(), qsc.data_ptr(), kq.data_ptr(), _ptr(ks),
        vq.data_ptr(), _ptr(dor), _ptr(dorsc), dov.data_ptr(),
        dovsc.data_ptr(), lse.data_ptr(), di.data_ptr(), out0.data_ptr(),
        _ptr(out1), b, hq, hkv, sq, skv, d, int(interleaved_kv), width,
        store, splits, _ptr(ws), stream_of(qq),
    )
    _build.check_launch(rc, name)


def fullint_dkv_splits(d: int, batch: int, q_heads: int, kv_heads: int,
                       kv_len: int, sms: int) -> int:
    """How many CTAs share each (key tile, batch row, KV head) of the
    full-integer dK/dV: at kernel width 576, whose 32-key CTAs walk their
    q heads in series, :func:`dkv_splits`' plan for the latent bodies'
    32-key tiles (DeepSeek-V2-Lite's training shape, batch 2, 16 q heads
    over one latent head, 2048 keys: 8 splits of two heads); above 576 its
    plan for the split-D kernels' 64-key tiles, the lane slices counted as
    CTAs (4 splits at 640 and 1024 on that shape); 1 at the other widths."""
    if qattn_width(d) < 576:
        return 1
    return dkv_splits(torch.bfloat16, d, batch, q_heads, kv_heads, kv_len,
                      sms)


def fullint_dq(
    qq: torch.Tensor,
    qsc: torch.Tensor,
    kq: torch.Tensor,
    ks: Optional[torch.Tensor],
    vq: torch.Tensor,
    dov: torch.Tensor,
    dovsc: torch.Tensor,
    lse: torch.Tensor,
    di: torch.Tensor,
    *,
    store: float,
    width: int = 0,
    interleaved_kv: bool = False,
) -> torch.Tensor:
    """The full-integer dQ kernel: dq fp32 [B, Hq, Sq, D].

    ``qq``: int8 Q·scale per token, ``qsc`` its scales fp32 [B, Hq, Sq]
    (times a TENSOR K scale); ``kq`` / ``vq``: int8 [B, Hkv, Skv, D]; ``ks``:
    ROW K scales fp32 [B, Hkv, Skv] or None; ``dov`` / ``dovsc``: dO times
    the V scales, per-token int8 and scales; ``lse`` with -inf read as 0;
    ``width``: level 2's row-quantization width (0: level 1); ``store``:
    dQ's multiplier.  CPU tensors take :func:`fullint_dq_plain`; CUDA
    tensors launch the kernel :func:`fullint_body` names or raise."""
    kw = dict(store=store, width=width, interleaved_kv=interleaved_kv)
    if qq.device.type == "cpu":
        return fullint_dq_plain(qq, qsc, kq, ks, vq, dov, dovsc, lse, di,
                                **kw)
    _check_fullint("fullint_dq", qq, qsc, kq, ks, vq, [(dov, dovsc)], lse,
                   di, width)
    d = qq.shape[3]
    qq, kq, vq, dov = pad_lanes(qattn_width(d), qq, kq, vq, dov)
    dq = torch.empty(qq.shape, dtype=torch.float32, device=qq.device)
    _launch_fullint("fullint_dq", True, qq, qsc, kq, ks, vq, None, None, dov,
                    dovsc, lse, di, dq, None, width, store, interleaved_kv)
    fullint_dq.launches += 1
    return dq if dq.shape[3] == d else dq[..., :d].contiguous()


fullint_dq.launches = 0


def fullint_dkv(
    qq: torch.Tensor,
    qsc: torch.Tensor,
    kq: torch.Tensor,
    ks: Optional[torch.Tensor],
    vq: torch.Tensor,
    dor: torch.Tensor,
    dorsc: torch.Tensor,
    dov: torch.Tensor,
    dovsc: torch.Tensor,
    lse: torch.Tensor,
    di: torch.Tensor,
    *,
    store: float,
    width: int = 0,
    interleaved_kv: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-integer dK/dV kernel: (dk, dv) fp32 [B, Hkv, Skv, D],
    summed over each KV head's group; ``dor`` / ``dorsc``: dO itself,
    per-token int8 and scales; ``store``: dK's multiplier; the rest as for
    :func:`fullint_dq`.  CPU tensors take :func:`fullint_dkv_plain`; CUDA
    tensors launch the kernel :func:`fullint_body` names or raise.  Where
    :func:`fullint_dkv_splits` deals the group over several CTAs a key
    tile (width 576 and above), they write fp32 partials (dK times
    ``store``) into a
    workspace this call allocates, [splits, 2, B, Hkv, Skv, D], and
    :func:`merge_dkv_splits` sums them in split order."""
    kw = dict(store=store, width=width, interleaved_kv=interleaved_kv)
    if qq.device.type == "cpu":
        return fullint_dkv_plain(qq, qsc, kq, ks, vq, dor, dorsc, dov, dovsc,
                                 lse, di, **kw)
    _check_fullint("fullint_dkv", qq, qsc, kq, ks, vq,
                   [(dor, dorsc), (dov, dovsc)], lse, di, width)
    b, hq, _, d = qq.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    qq, kq, vq, dor, dov = pad_lanes(qattn_width(d), qq, kq, vq, dor,
                                     dov)
    dk = torch.empty(kq.shape, dtype=torch.float32, device=kq.device)
    dv = torch.empty(kq.shape, dtype=torch.float32, device=kq.device)
    splits = fullint_dkv_splits(d, b, hq, hkv, skv, _sm_count(qq.device))
    ws = (torch.empty((splits, 2) + tuple(kq.shape), dtype=torch.float32,
                      device=kq.device) if splits > 1 else None)
    _launch_fullint("fullint_dkv", False, qq, qsc, kq, ks, vq, dor, dorsc,
                    dov, dovsc, lse, di, dk, dv, width, store, interleaved_kv,
                    splits, ws)
    fullint_dkv.launches += 1
    if ws is not None:
        merge_dkv_splits(ws, dk, dv)
    if dk.shape[3] != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


fullint_dkv.launches = 0


def fullint_backward_supported(q, k, v, mask: MaskSpec, bias,
                               mask_ranges) -> bool:
    """Whether the full-integer backward takes this call, as in the JAX
    package: int8 SYMMETRIC K (ROW or TENSOR) and V (CHANNEL or TENSOR), a
    non-fp32 Q, no mask, bias or ranges, and ``MFA_NO_BWD_FULLINT`` unset.
    The other calls take the exact kernels (a dispatch by configuration)."""
    if not (isinstance(k, QuantizedTensor) and isinstance(v, QuantizedTensor)):
        return False
    kc, vc = k.config, v.config
    return (
        mask.kind == MaskKind.NONE and bias is None and mask_ranges is None
        and q.dtype != torch.float32 and kc.bits == 8 and vc.bits == 8
        and kc.strategy == QuantStrategy.SYMMETRIC
        and vc.strategy == QuantStrategy.SYMMETRIC
        and kc.granularity in (QuantGranularity.ROW, QuantGranularity.TENSOR)
        and vc.granularity in (QuantGranularity.CHANNEL,
                               QuantGranularity.TENSOR)
        and not os.environ.get("MFA_NO_BWD_FULLINT")
    )


def _tile_width(block: int, n: int) -> int:
    """A TPU kernel's tile along a sequence of n: ``block``, at most n
    rounded up to 128, halved until it divides n."""
    w = min(block, -(-n // 128) * 128)
    while n % w:
        w //= 2
    return w


def fullint_widths(block_sizes: BlockSizes, sq: int,
                   skv: int) -> Tuple[int, int]:
    """Level 2's row-quantization widths, resolved from ``block_sizes`` as
    the JAX package resolves its tiles: dQ's dS rows over block_kv_dq keys,
    dK/dV's Pᵀ and dSᵀ rows over block_q_dkv queries."""
    return (_tile_width(block_sizes.block_kv_dq, skv),
            _tile_width(block_sizes.block_q_dkv, sq))


def _f32(x) -> float:
    """A Python number or 0-d tensor rounded to fp32, as the kernels read
    it."""
    return float(torch.as_tensor(x).float())


def fullint_arguments(q, k, v, o, l, do, *, scale, block_sizes=BlockSizes(),
                      interleaved_kv=False, di=None, int8_grads=False):
    """The full-integer kernels' arguments for this backward (the caller
    checked :func:`fullint_backward_supported`): ((args, kwargs) of
    :func:`fullint_dq`, (args, kwargs) of :func:`fullint_dkv`).  Q·scale
    and dO quantized per token (dO twice: as it is, and times CHANNEL V
    scales; one quantization serves both for a TENSOR V scale), a TENSOR K
    scale folded into Q's scales and the stores.  ``int8_grads``: level 2,
    its widths from ``block_sizes``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qq, q_sc = _per_token_quant(q.float() * scale)
    if k.config.granularity == QuantGranularity.TENSOR:
        ksc = k.scale.reshape(()).float()
        q_sc = q_sc * ksc
        ks, dqsc, dkc = None, _f32(ksc * scale), _f32(1.0 / ksc)
    else:
        ks = k.scale.reshape(b, hkv, skv).float().contiguous()
        dqsc, dkc = _f32(scale), 1.0
    dof = do.float()
    dor, dor_sc = _per_token_quant(dof)
    if v.config.granularity == QuantGranularity.CHANNEL:
        kv_of = _kv_head_map(hq, hkv, interleaved_kv).to(q.device)
        vsc = v.scale.reshape(b, hkv, d).float()[:, kv_of, None, :]
        dov, dov_sc = _per_token_quant(dof * vsc)
    else:
        dov, dov_sc = dor, dor_sc * v.scale.reshape(()).float()
    di = (dof * o.float()).sum(dim=-1) if di is None else di.float()
    l_safe = torch.where(torch.isneginf(l), torch.zeros_like(l), l).float()
    w_dq, w_dkv = (fullint_widths(block_sizes, sq, skv) if int8_grads
                   else (0, 0))

    def rows(t):
        return t[..., 0].contiguous()

    kd, vd = k.data.contiguous(), v.data.contiguous()
    lse, di, qsc = l_safe.contiguous(), di.contiguous(), rows(q_sc)
    return (
        ((qq, qsc, kd, ks, vd, dov, rows(dov_sc), lse, di),
         dict(store=dqsc, width=w_dq, interleaved_kv=interleaved_kv)),
        ((qq, qsc, kd, ks, vd, dor, rows(dor_sc), dov, rows(dov_sc), lse,
          di),
         dict(store=dkc, width=w_dkv, interleaved_kv=interleaved_kv)),
    )


# ---------------------------------------------------------------------------
# Public backward
# ---------------------------------------------------------------------------


def flash_attention_backward(
    q: torch.Tensor,
    k,
    v,
    o: torch.Tensor,
    l: torch.Tensor,
    do: torch.Tensor,
    *,
    mask: MaskSpec = FULL,
    mask_ranges: Optional[Ranges] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    compute_dbias: bool = False,
    di: Optional[torch.Tensor] = None,
    fullint: bool = False,
):
    """Backward from the saved (o, l) residuals.

    ``k`` / ``v``: float tensors, or :class:`QuantizedTensor` s (int8 or
    int4, each its own width); the returned dk/dv are then gradients with
    respect to the DEQUANTIZED K/V.  ``o`` is the forward's fp32 O; ``di``
    an optional precomputed D = rowsum(dO ⊙ O), fp32 [B, Hq, Sq].
    ``fullint``: the full-integer backward where
    :func:`fullint_backward_supported` (approximate: per-token int8 Q and
    dO); other calls take the exact kernels, so float K/V give what
    ``fullint=False`` gives.  ``block_sizes`` is the TPU's tiling: the
    Hopper kernels choose their own tiles, and only the full-integer level
    2 reads it (its row-quantization widths).  Returns (dq, dk, dv, dbias),
    fp32; dk/dv are reduced over the GQA group by the dK/dV kernel; dbias
    is None unless ``compute_dbias`` and a bias is given, and is summed
    over the bias's broadcast dims.
    """
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = _default_scale(d, scale)
    if fullint and fullint_backward_supported(q, k, v, mask, bias,
                                              mask_ranges):
        (dq_a, dq_kw), (dkv_a, dkv_kw) = fullint_arguments(
            q, k, v, o, l, do, scale=scale, block_sizes=block_sizes,
            interleaved_kv=interleaved_kv, di=di,
            int8_grads=os.environ.get("MFA_BWD_FULLINT_LEVEL") == "2")
        return (fullint_dq(*dq_a, **dq_kw), *fullint_dkv(*dkv_a, **dkv_kw),
                None)
    quantized = isinstance(k, QuantizedTensor)
    if quantized != isinstance(v, QuantizedTensor):
        raise TypeError("k and v must both be tensors or both "
                        "QuantizedTensors")
    if di is None:
        di = (do.float() * o.float()).sum(dim=-1)
    q = q.contiguous()
    do = do.to(q.dtype).contiguous()
    lse = l.float().contiguous()
    di = di.float().contiguous()
    rr = row_ranges_tensor(mask, sq, skv, mask_ranges, q.device)
    kb = kernel_bias(bias)
    want_dbias = compute_dbias and bias is not None
    if quantized:
        (dq_a, dq_kw), (dkv_a, dkv_kw) = qflash_arguments(
            q, k, v, do, lse, di, rr, kb, scale=scale,
            interleaved_kv=interleaved_kv, want_dbias=want_dbias)
        dq, dbias = qflash_dq(*dq_a, **dq_kw)
        dk, dv = qflash_dkv(*dkv_a, **dkv_kw)
    else:
        k, v = k.contiguous(), v.contiguous()
        dq, dbias = flash_dq(q, k, v, do, lse, di, rr, bias=kb, scale=scale,
                             interleaved_kv=interleaved_kv,
                             want_dbias=want_dbias)
        dk, dv = flash_dkv(q, k, v, do, lse, di, rr, bias=kb, scale=scale,
                           interleaved_kv=interleaved_kv)
    if want_dbias:
        if bias.shape[0] == 1 and b > 1:
            dbias = dbias.sum(dim=0, keepdim=True)
        if bias.shape[1] == 1 and hq > 1:
            dbias = dbias.sum(dim=1, keepdim=True)
    return dq, dk, dv, dbias

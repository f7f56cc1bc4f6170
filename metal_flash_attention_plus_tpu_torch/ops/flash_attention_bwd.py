"""Flash attention backward: dQ and dK/dV over float, int8 or int4 K/V.

The port of the JAX package's ``ops/flash_attention_bwd.py``.  Kernels with
disjoint outputs, so no atomics:

- :func:`flash_dq` → ``csrc/flash_attention.cu::flash_dq_kernel`` (TPU
  ``_dq_kernel``): per query tile, recomputes P = exp(S − L) from the
  saved logsumexp, dP = dO·Vᵀ, dS = P ⊙ (dP − D), dQ += dS·K; optionally
  writes dbias = dS.
- :func:`flash_dkv` → ``flash_dkv_kernel`` (TPU ``_dkv_kernel``): per key
  tile, walks the GQA group's q heads × the live query rows, dV += Pᵀ·dO,
  dK += dSᵀ·Q_s; the group reduction happens inside the kernel.
- Quantized K/V (:class:`QuantizedTensor`), exact: :func:`qflash_dq` and
  :func:`qflash_dkv` → ``csrc/quantized_attention_bwd.cu`` (the TPU
  kernels' quantized modes), the same two bodies with K/V staged from their
  payloads.  dK/dV are gradients with respect to the DEQUANTIZED K/V.  The
  mode selection is the JAX package's: BLOCK_2D dequantizes in both
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
  TPU's width, resolved from ``block_sizes`` as the JAX package does.

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
    kernel_bias,
    pad_lanes,
    range_mask,
    row_ranges_tensor,
    stream_of,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    _FOLDED,
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
# dq | q, dO, K (payload, scale, zp), V (same), ksr, vsr, dqsc, L, D,
# ranges, bias | bias strides | two outputs | ints | scale
_QFLASH_ARGS = ([_I32] + [_PTR] * 15 + [_I64, _I64] + [_PTR, _PTR]
                + [_I32] * 14 + [_F32, _PTR])
# dq | Q, its scales, K, its ROW scales, V, dO (and scales), dOv (and
# scales), L, D | two outputs | ints | store multiplier
_FULLINT_ARGS = [_I32] + [_PTR] * 13 + [_I32] * 8 + [_F32, _PTR]
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


def flash_attention_dq_plain(
    q, k, v, do, lse, di, row_ranges, *, bias=None, scale,
    interleaved_kv=False, want_dbias=False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`flash_dq`."""
    _, kx, _, _, ds = _probabilities(q, k, v, do, lse, di, row_ranges, bias,
                                     scale, interleaved_kv)
    dq = (ds.to(k.dtype).float() @ kx) * scale
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


def _launch(name, fn_name, q, k, v, do, lse, di, row_ranges, bias, out0,
            out1, scale, interleaved_kv):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bptr, bsb, bsh = bias_args(bias)
    rc = _build.kernel_function(fn_name, _BWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), row_ranges.data_ptr(), bptr, bsb, bsh,
        out0.data_ptr(), None if out1 is None else out1.data_ptr(),
        DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, d, int(interleaved_kv),
        scale, stream_of(q),
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
    at the head dim's ``flash_width``."""
    if q.device.type == "cpu":
        return flash_attention_dq_plain(
            q, k, v, do, lse, di, row_ranges, bias=bias, scale=scale,
            interleaved_kv=interleaved_kv, want_dbias=want_dbias)
    check_kernel_inputs("flash_dq", q, k, v, row_ranges, bias, q_like=(do,),
                        stats=(lse, di))
    b, hq, sq, d = q.shape
    q, k, v, do = pad_lanes(flash_width(d), q, k, v, do)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dbias = (torch.zeros((b, hq, sq, k.shape[2]), dtype=torch.float32,
                         device=q.device) if want_dbias else None)
    _launch("flash_dq", "mfa_flash_dq", q, k, v, do, lse, di, row_ranges,
            bias, dq, dbias, scale, interleaved_kv)
    flash_dq.launches += 1
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
    runs at the head dim's ``flash_width``."""
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(
            q, k, v, do, lse, di, row_ranges, bias=bias, scale=scale,
            interleaved_kv=interleaved_kv)
    check_kernel_inputs("flash_dkv", q, k, v, row_ranges, bias,
                        q_like=(do,), stats=(lse, di))
    d = q.shape[-1]
    q, k, v, do = pad_lanes(flash_width(d), q, k, v, do)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    _launch("flash_dkv", "mfa_flash_dkv", q, k, v, do, lse, di, row_ranges,
            bias, dk, dv, scale, interleaved_kv)
    flash_dkv.launches += 1
    if dk.shape[-1] != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


flash_dkv.launches = 0


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
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`qflash_dq`."""
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
    dq = (dsk.to(q.dtype).float() @ k) * dqsc[:, kv_of, None, :]
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
                   interleaved_kv):
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
        stream_of(q),
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
    :func:`qflash_dq_plain`; CUDA tensors launch ``qflash_dq_kernel`` or
    raise."""
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
    _launch_qflash("qflash_dq", True, q, do, kq, vq, k_params, v_params, ksr,
                   vsr, dqsc, lse, di, row_ranges, bias, dq, dbias, mode, 1.0,
                   interleaved_kv)
    qflash_dq.launches += 1
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
    tensors launch ``qflash_dkv_kernel`` or raise."""
    kw = dict(mode=mode, scale=scale, bias=bias,
              interleaved_kv=interleaved_kv)
    if q.device.type == "cpu":
        return qflash_dkv_plain(q, do, kq, vq, k_params, v_params, lse, di,
                                row_ranges, **kw)
    check_qflash_inputs("qflash_dkv", q, do, kq, vq, k_params, v_params, lse,
                        di, row_ranges, bias, mode)
    d = q.shape[3]
    w = qattn_width(d)
    kq, vq, k_params, v_params = pad_qflash_kv(d, kq, vq, k_params,
                                               v_params, mode)
    q, do = pad_lanes(w, q, do)
    shape = (*kq.shape[:3], w)
    dk = torch.empty(shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(shape, dtype=torch.float32, device=q.device)
    _launch_qflash("qflash_dkv", False, q, do, kq, vq, k_params, v_params,
                   None, None, None, lse, di, row_ranges, bias, dk, dv, mode,
                   scale, interleaved_kv)
    qflash_dkv.launches += 1
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
                    lse, di, out0, out1, width, store, interleaved_kv):
    b, hq, sq, d = qq.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    rc = _build.kernel_function("mfa_fullint_bwd", _FULLINT_ARGS)(
        int(dq), qq.data_ptr(), qsc.data_ptr(), kq.data_ptr(), _ptr(ks),
        vq.data_ptr(), _ptr(dor), _ptr(dorsc), dov.data_ptr(),
        dovsc.data_ptr(), lse.data_ptr(), di.data_ptr(), out0.data_ptr(),
        _ptr(out1), b, hq, hkv, sq, skv, d, int(interleaved_kv), width,
        store, stream_of(qq),
    )
    _build.check_launch(rc, name)


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
    tensors launch ``fullint_dq_kernel`` or raise."""
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
    tensors launch ``fullint_dkv_kernel`` or raise."""
    kw = dict(store=store, width=width, interleaved_kv=interleaved_kv)
    if qq.device.type == "cpu":
        return fullint_dkv_plain(qq, qsc, kq, ks, vq, dor, dorsc, dov, dovsc,
                                 lse, di, **kw)
    _check_fullint("fullint_dkv", qq, qsc, kq, ks, vq,
                   [(dor, dorsc), (dov, dovsc)], lse, di, width)
    d = qq.shape[3]
    qq, kq, vq, dor, dov = pad_lanes(qattn_width(d), qq, kq, vq, dor, dov)
    dk = torch.empty(kq.shape, dtype=torch.float32, device=kq.device)
    dv = torch.empty(kq.shape, dtype=torch.float32, device=kq.device)
    _launch_fullint("fullint_dkv", False, qq, qsc, kq, ks, vq, dor, dorsc,
                    dov, dovsc, lse, di, dk, dv, width, store, interleaved_kv)
    fullint_dkv.launches += 1
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

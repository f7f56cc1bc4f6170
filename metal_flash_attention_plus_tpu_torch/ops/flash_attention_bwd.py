"""Flash attention backward: the dQ kernel and the dK/dV kernel.

The port of the JAX package's ``ops/flash_attention_bwd.py`` (its float
path).  Two kernels with disjoint outputs, so no atomics:

- :func:`flash_dq` → ``csrc/flash_attention.cu::flash_dq_kernel`` (TPU
  ``_dq_kernel``): per query tile, recomputes P = exp(S − L) from the
  saved logsumexp, dP = dO·Vᵀ, dS = P ⊙ (dP − D), dQ += dS·K; optionally
  writes dbias = dS.
- :func:`flash_dkv` → ``flash_dkv_kernel`` (TPU ``_dkv_kernel``): per key
  tile, walks the GQA group's q heads × the live query rows, dV += Pᵀ·dO,
  dK += dSᵀ·Q_s; the group reduction happens inside the kernel.

D = rowsum(dO ⊙ O) is computed once in plain torch, in fp32 from the fp32
O residual, and shared by both kernels (callers may pass it as ``di``).
On a CUDA tensor each wrapper launches its kernel or raises; its plain
PyTorch version (``flash_attention_dq_plain`` / ``flash_attention_dkv_plain``)
runs only for tensors on the CPU.  Both round where the kernels do: q
pre-scaled by ``scale`` and rounded to its dtype, dO in q's dtype, P
rounded to dO's dtype before Pᵀ·dO, dS rounded to K's (= Q's) dtype
before dS·K and dSᵀ·Q_s.

Quantized K/V and the full-integer backward raise ``NotImplementedError``
until the quantized-attention slices.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention.masking import (
    FULL,
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
    kernel_bias,
    range_mask,
    row_ranges_tensor,
    stream_of,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    _expand_kv_heads,
    _reduce_kv_heads,
)

_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
# q, k, v, dO, L, D, ranges, bias | bias strides | two outputs | ints | scale
_BWD_ARGS = ([_PTR] * 8 + [_I64, _I64] + [_PTR, _PTR] + [_I32] * 8
             + [_F32, _PTR])


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
    [B, Hq, Sq]; ``bias`` fp32 [1 or B, 1 or Hq, Sq, Skv]."""
    if q.device.type == "cpu":
        return flash_attention_dq_plain(
            q, k, v, do, lse, di, row_ranges, bias=bias, scale=scale,
            interleaved_kv=interleaved_kv, want_dbias=want_dbias)
    check_kernel_inputs("flash_dq", q, k, v, row_ranges, bias, q_like=(do,),
                        stats=(lse, di))
    b, hq, sq, _ = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dbias = (torch.zeros((b, hq, sq, k.shape[2]), dtype=torch.float32,
                         device=q.device) if want_dbias else None)
    _launch("flash_dq", "mfa_flash_dq", q, k, v, do, lse, di, row_ranges,
            bias, dq, dbias, scale, interleaved_kv)
    flash_dq.launches += 1
    return dq, dbias


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
    KV head's group of q heads.  Inputs as for :func:`flash_dq`."""
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(
            q, k, v, do, lse, di, row_ranges, bias=bias, scale=scale,
            interleaved_kv=interleaved_kv)
    check_kernel_inputs("flash_dkv", q, k, v, row_ranges, bias,
                        q_like=(do,), stats=(lse, di))
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    _launch("flash_dkv", "mfa_flash_dkv", q, k, v, do, lse, di, row_ranges,
            bias, dk, dv, scale, interleaved_kv)
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


# ---------------------------------------------------------------------------
# Public backward
# ---------------------------------------------------------------------------


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
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

    ``o`` is the forward's fp32 O; ``di`` an optional precomputed
    D = rowsum(dO ⊙ O), fp32 [B, Hq, Sq].  Returns (dq, dk, dv, dbias),
    fp32; dk/dv are reduced over the GQA group by the dK/dV kernel;
    dbias is None unless ``compute_dbias`` and a bias is given, and is
    summed over the bias's broadcast dims.  ``block_sizes`` is accepted for
    parity with the JAX package and unused.
    """
    del block_sizes  # the Hopper kernels choose their own tiles
    if fullint:
        raise NotImplementedError(
            "the full-integer backward comes with the quantized-attention "
            "slice")
    if not isinstance(k, torch.Tensor) or not isinstance(v, torch.Tensor):
        raise NotImplementedError(
            "quantized K/V in the backward come with the quantized slices")
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = _default_scale(d, scale)
    if di is None:
        di = (do.float() * o.float()).sum(dim=-1)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    lse = l.float().contiguous()
    di = di.float().contiguous()
    rr = row_ranges_tensor(mask, sq, skv, mask_ranges, q.device)
    kb = kernel_bias(bias)
    want_dbias = compute_dbias and bias is not None
    dq, dbias = flash_dq(q, k, v, do, lse, di, rr, bias=kb, scale=scale,
                         interleaved_kv=interleaved_kv, want_dbias=want_dbias)
    dk, dv = flash_dkv(q, k, v, do, lse, di, rr, bias=kb, scale=scale,
                       interleaved_kv=interleaved_kv)
    if want_dbias:
        if bias.shape[0] == 1 and b > 1:
            dbias = dbias.sum(dim=0, keepdim=True)
        if bias.shape[1] == 1 and hq > 1:
            dbias = dbias.sum(dim=1, keepdim=True)
    return dq, dk, dv, dbias

"""Quantized flash attention: int8 / packed-int4 K/V.

The port of the JAX package's ``ops/quantized_attention.py``: the forward
below, and the differentiable :func:`quantized_flash_attention` (its
backward in ``ops/flash_attention_bwd.py``, chained here into the K/V
scale and zero-point cotangents) and :func:`quantized_flash_attention_qat`
at the end.  K and
V are :class:`QuantizedTensor` s ``[B, Hkv, Skv, D]``; Q stays float unless
``quantize_q``.  The mode selection, its errors, Q's pre-scaling and
quantization are the JAX package's; the mode decides what the kernel does
with the scales:

- dequant-on-load: ROW / TENSOR token scales and zero points, or BLOCK_2D
  blocks, dequantized to the compute dtype (bf16 unless Q is fp32);
- ``quantize_q``: Q int8 per token (absmax/127, softmax scale·log2e folded
  into its scales), scores int8 × int8 → int32 times the per-row and
  per-column (ROW K) scales; with SYMMETRIC CHANNEL / TENSOR V also P × V
  in int8 (``int8_pv``: P in 1/127 units, the V scale at the store);
- folded (bf16 Q, SYMMETRIC TENSOR / CHANNEL / ROW K and V): TENSOR and
  CHANNEL K scales fold into Q, ROW K scales multiply the score column;
  TENSOR / CHANNEL V scales multiply O at the store, ROW V scales P.

The TPU kernel ``_qfwd_kernel`` becomes ``csrc/quantized_attention.cu::
qattn_fwd_kernel`` behind :func:`qattn_fwd`; ``_hpack_kernel`` (the d=64
head-pair layout) becomes ``hpack_fwd_kernel`` behind :func:`hpack_fwd`.
On CUDA tensors each launches its kernel or raises; their plain PyTorch
versions run for CPU tensors.  The TPU's tiles, schedules, ones-lane
rowsum and host padding have no counterpart: one ``[Sq, 2]`` row-range
table covers every mask.  What they did to the numbers is kept:

- Q is pre-scaled by ``scale·log2e`` (× the folded K scales) in fp32 and
  rounded back to Q's dtype (no rows are padded, so none needs the TPU's
  unit scale);
- dequantized K/V are ``(w − zp)·s`` (BLOCK_2D: ``w·s − z·s``) rounded to
  the compute dtype, and P is rounded to it before P·V — the head-pair
  kernel always rounds P to bf16;
- l sums the rounded P where the TPU kernel's ones-lane rowsum did
  (head dim not a multiple of 128, and no per-token V scale), else the
  unrounded p; with ``int8_pv`` the int8 P (``+0.5`` then truncation) or
  the unrounded ``127·2^(s−m)``, and L drops ln 127.

The kernels take the softmax online over key tiles aligned to multiples
of their width from key 0, so P rounds against the running row max, as the
TPU kernel's does over its ``block_kv`` tiles.  For the int8 P of
``int8_pv`` that max decides the integers (at thousands of keys a one-pass
softmax lands ~0.1 of O's max abs away), so the forward resolves
``block_kv`` from ``block_sizes`` as the JAX package does and hands it to
the kernel as ``kv_tile``: a first pass over each such span takes the
span's row max.  The plain versions take the softmax in one pass, or with
``kv_tile`` over the same spans as a kernel; on CPU tensors ``qattn_fwd``
hands them its own spans, so it computes the same on either device.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention.masking import (
    DEFAULT_MASK_VALUE,
    FULL,
    MaskKind,
    MaskSpec,
    Ranges,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    LN2,
    LOG2E,
    BlockSizes,
    bias_args,
    kernel_bias,
    pad_lanes,
    range_mask,
    row_ranges_tensor,
    stream_of,
)
from metal_flash_attention_plus_tpu_torch.ops.hadamard import (
    hadamard_transform,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    block2d_expanders,
    dequant_block2d_vals,
    dequant_kv_vals,
    unpack_int4_tile_int8,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    dequantize,
    pack_int4,
    quantize,
    unpack_int4,
)

LOG2_127 = float(np.log2(127.0))
LN_127 = float(np.log(127.0))
KV_TILE = 64  # the kernels' query rows and keys per tile (BM, BN)
# The head dims the quantized kernels (forward, exact and full-integer
# backward) are built for; other multiples of 16 up to 256 run zero-padded
# to the next (:func:`qattn_width`).
HEAD_DIMS = (32, 64, 128, 256)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def qattn_width(d: int) -> int:
    """The kernel width a head dim ``d`` runs at (see ``HEAD_DIMS``)."""
    if d % 16 == 0:
        for w in HEAD_DIMS:
            if d <= w:
                return w
    raise ValueError(f"head dim {d} has no quantized kernel (multiples of "
                     f"16 up to {HEAD_DIMS[-1]})")


def pad_payload(t: torch.Tensor, bits: int, d: int,
                width: int) -> torch.Tensor:
    """A K/V payload of head dim ``d`` (int8 [..., D], or group-planar int4
    [..., D/2]) widened to ``width`` lanes holding the integer 0.  An int4
    payload narrower than a packing group splits at its own midpoint, so it
    is repacked at the new width, not extended."""
    if width == d:
        return t
    if bits == 4:
        return pack_int4(torch.nn.functional.pad(unpack_int4(t),
                                                 (0, width - d)))
    return torch.nn.functional.pad(t, (0, width - d))


def pad_scales(params, kind: str, d: int, width: int, block):
    """A mode's (scale, zero point) for ``width`` lanes: per-channel
    ("store", "channel") and BLOCK_2D vectors get cells of scale 1 and
    zero point 0 (so padded lanes dequantize to exactly 0); per-token ones
    have no lane dim and stay.  BLOCK_2D gets whole cells, the last one
    cut short where the block size does not tile ``width`` (a block of 48
    at D=96: one cell over lanes 96-127; the kernels index a lane's cell
    as lane // bs)."""
    s, z = params
    if width == d or kind not in ("store", "channel", "block2d"):
        return params
    cells = width - d
    if kind == "block2d":
        cells = -(-cells // block[1])
    pad = torch.nn.functional.pad
    return (pad(s, (0, cells), value=1.0),
            None if z is None else pad(z, (0, cells)))


def int8_p_tile(block_sizes: BlockSizes, skv: int) -> int:
    """The key span the JAX kernel rounds an int8 P over: its resolved
    ``block_kv``, ``min(block_kv, round_up(Skv, 128))``."""
    return min(block_sizes.block_kv, _round_up(skv, 128))

K_SCALES = {"none": 0, "token": 1, "block2d": 2, "column": 3}
V_SCALES = {"token": 1, "block2d": 2, "p": 3, "store": 4}
Q_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FOLDED = (QuantGranularity.TENSOR, QuantGranularity.CHANNEL,
           QuantGranularity.ROW)

_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
_QATTN_ARGS = ([_PTR] * 10 + [_I64, _I64, _PTR, _PTR] + [_I32] * 16
               + [_F32, _PTR])
_HPACK_ARGS = [_PTR] * 7 + [_I32] * 9 + [_F32, _PTR]


@dataclasses.dataclass(frozen=True)
class QAttnMode:
    """What the kernel does with the K and V scales (the TPU kernel's
    flags; see ``csrc/quantized_attention.cu``).

    ``k_scales``: "none" (folded into Q), "token" or "block2d"
    (dequantize), "column" (per-token scale on the score column).
    ``v_scales``: "token", "block2d", "p" (per-token scale on P), "store"
    (per-channel scale on O).  ``round_bf16``: the compute dtype is bf16.
    ``l_rounded``: l sums the rounded P.  ``p_int8``: P in 1/127 units
    times integer V.  ``block``: BLOCK_2D (rows, columns)."""

    k_scales: str
    v_scales: str
    bits_k: int = 8
    bits_v: int = 8
    p_int8: bool = False
    round_bf16: bool = True
    l_rounded: bool = False
    block: Tuple[int, int] = (1, 1)

    @property
    def flags(self) -> int:
        return (int(self.round_bf16) | 2 * int(self.l_rounded)
                | 4 * int(self.p_int8))


# ---------------------------------------------------------------------------
# The forward kernel and its plain version
# ---------------------------------------------------------------------------


def _kv_values(payload, scale, zp, mode_scales, bits, d, block,
               compute_dtype):
    """fp32 [B, Hkv, Skv, D] values the kernels stage: dequantized and
    rounded for "token" / "block2d" / "channel" (``w·s``, scales
    [B, Hkv, D]), the integers otherwise."""
    if mode_scales == "token":
        return dequant_kv_vals(payload, scale[..., None], zp[..., None], d,
                               bits, compute_dtype).float()
    if mode_scales == "block2d":
        er, ec = block2d_expanders(block[0], block[1], payload.shape[2], d,
                                   payload.device)
        return dequant_block2d_vals(payload, scale, zp, er, ec, d, bits,
                                    compute_dtype).float()
    w = (unpack_int4_tile_int8(payload, d) if bits == 4 else payload).float()
    if mode_scales == "channel":
        return (w * scale[:, :, None, :]).to(compute_dtype).float()
    return w


def _running_max(s: torch.Tensor, kv_tile: int) -> torch.Tensor:
    """Each score's row max over the key tiles up to its own, as the kernel
    walks them: tiles of ``kv_tile`` keys aligned to multiples of it from
    key 0, as the TPU kernel's ``block_kv`` tiles are."""
    skv = s.shape[-1]
    tile = (torch.arange(skv, device=s.device) // kv_tile).expand_as(s)
    tile_max = torch.full((*s.shape[:-1], -(-skv // kv_tile)), -float("inf"),
                          device=s.device).scatter_reduce(-1, tile, s, "amax")
    return tile_max.cummax(-1).values.gather(-1, tile)


def qattn_fwd_plain(
    q: torch.Tensor,
    q_scales: Optional[torch.Tensor],
    kq: torch.Tensor,
    vq: torch.Tensor,
    k_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    v_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    row_ranges: torch.Tensor,
    *,
    mode: QAttnMode,
    bias: Optional[torch.Tensor] = None,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    kv_tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`qattn_fwd`: the same values, the
    same roundings, the softmax in one pass.  ``kv_tile``: round P against
    the running row max over tiles of that many keys and rescale, as an
    online softmax does (the kernel's spans: ``kv_tile`` when it is given
    one, else ``KV_TILE``).  That changes what the int8 P of ``p_int8``
    rounds to; over thousands of keys it moves O by ~0.1 of its max abs
    from the one-pass values."""
    hq, d = q.shape[1], q.shape[3]
    hkv, skv = kq.shape[1], kq.shape[2]
    cd = torch.bfloat16 if mode.round_bf16 else torch.float32
    kv_of = _kv_head_map(hq, hkv, interleaved_kv).to(q.device)

    def per_head(t):  # [B, Hkv, ...] → [B, Hq, ...] by the GQA mapping
        return t[:, kv_of]

    k = per_head(_kv_values(kq, *k_params, mode.k_scales, mode.bits_k, d,
                            mode.block, cd))
    v = per_head(_kv_values(vq, *v_params, mode.v_scales, mode.bits_v, d,
                            mode.block, cd))
    s = q.float() @ k.transpose(-1, -2)  # exact integers for an int8 Q
    if q_scales is not None:
        s = s * q_scales[..., None]
    if mode.k_scales == "column":
        s = s * per_head(k_params[0])[:, :, None, :]
    if bias is not None:
        s = s + bias.float() * LOG2E
    keep, live = range_mask(row_ranges, skv)
    s = torch.where(keep, s, torch.full_like(s, mask_value))
    m = s.amax(dim=-1, keepdim=True)
    m_run = m
    if kv_tile is not None:  # a row's -inf prefix adds nothing, as on-chip
        m_run = _running_max(s, kv_tile)
        m_run = torch.where(torch.isinf(m_run), m, m_run)
    if mode.p_int8:
        raw = torch.exp2(s + (LOG2_127 - m_run))
        p = torch.floor(raw + 0.5)
    else:
        raw = p = torch.exp2(s - m_run)
        if mode.v_scales == "p":
            p = p * per_head(v_params[0])[:, :, None, :]
        p = p.to(cd).float()
    if kv_tile is not None:  # earlier tiles rescaled to the final max
        rescale = torch.exp2(m_run - m)
        raw, p = raw * rescale, p * rescale
    lsum = (p if mode.l_rounded else raw).sum(dim=-1, keepdim=True)
    o = (p @ v) / lsum
    if mode.v_scales == "store":
        o = o * per_head(v_params[0])[:, :, None, :]
    lse = (m * LN2 + torch.log(lsum))[..., 0] - (LN_127 if mode.p_int8
                                                  else 0.0)
    live = live & (lsum > 0)
    o = torch.where(live, o, torch.zeros_like(o))
    lse = torch.where(live[..., 0], lse, torch.full_like(lse, -float("inf")))
    return o, lse


def _check_payload(name, t, bits, b, hkv, skv, d):
    want = (torch.int8, (b, hkv, skv, d)) if bits == 8 else (
        torch.uint8, (b, hkv, skv, d // 2))
    if (t.dtype, tuple(t.shape)) != want:
        raise TypeError(f"{name}: a {bits}-bit payload must be {want[0]} "
                        f"{want[1]}, got {t.dtype} {tuple(t.shape)}")


def _scale_shapes(mode_scales, b, hkv, skv, d, block):
    """Expected shapes of a mode's (scale, zero point); None: unused."""
    tok = (b, hkv, skv)
    if mode_scales == "token":
        return tok, tok
    if mode_scales == "block2d":
        cell = (b, hkv, skv // block[0], d // block[1])
        return cell, cell
    if mode_scales in ("column", "p"):
        return tok, None
    if mode_scales in ("store", "channel"):
        return (b, hkv, d), None
    return None, None


def check_qattn_inputs(name, q, q_scales, kq, vq, k_params, v_params,
                       row_ranges, bias, mode):
    """Raise unless the tensors are what ``qattn_fwd_kernel`` takes."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if q.dtype not in Q_TYPES:
        raise TypeError(f"{name}: Q dtype {q.dtype} has no kernel")
    if q.dim() != 4 or kq.dim() != 4:
        raise ValueError(f"{name}: q [B, Hq, Sq, D], payloads [B, Hkv, Skv, "
                         "D or D/2] expected")
    b, hq, sq, d = q.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    if kq.shape[0] != b or hq % hkv:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} / "
                         f"{tuple(kq.shape)} do not match")
    qattn_width(d)
    if (mode.k_scales not in K_SCALES or mode.v_scales not in V_SCALES
            or mode.bits_k not in (8, 4) or mode.bits_v not in (8, 4)):
        raise ValueError(f"{name}: mode {mode} has no kernel")
    br, bs = mode.block
    if "block2d" in (mode.k_scales, mode.v_scales) and (skv % br or d % bs):
        raise ValueError(f"{name}: block {mode.block} does not tile "
                         f"[{skv}, {d}]")
    _check_payload(name, kq, mode.bits_k, b, hkv, skv, d)
    _check_payload(name, vq, mode.bits_v, b, hkv, skv, d)
    if (q.dtype == torch.int8) != (q_scales is not None):
        raise TypeError(f"{name}: an int8 Q needs its scales, a float Q none")
    tensors = [q, kq, vq]
    if q_scales is not None:
        if q_scales.dtype != torch.float32 or q_scales.shape != (b, hq, sq):
            raise TypeError(f"{name}: Q scales must be fp32 [B, Hq, Sq]")
        tensors.append(q_scales)
    for params, scales in ((k_params, mode.k_scales),
                           (v_params, mode.v_scales)):
        shapes = _scale_shapes(scales, b, hkv, skv, d, mode.block)
        for t, shape in zip(params, shapes):
            if (t is None) != (shape is None):
                raise TypeError(f"{name}: {scales} scales take "
                                f"{shapes}, got {params}")
            if t is None:
                continue
            if t.dtype != torch.float32 or tuple(t.shape) != shape:
                raise TypeError(f"{name}: {scales} scales must be fp32 "
                                f"{shape}, got {t.dtype} {tuple(t.shape)}")
            tensors.append(t)
    check_placement(name, dev, tensors, (q, kq, vq), row_ranges, bias,
                    (b, hq, sq, skv))


def check_placement(name, dev, tensors, aligned, row_ranges, bias, dims):
    """Raise unless the row-range table is int32 [Sq, 2], the bias fp32
    [1 or B, 1 or Hq, Sq, Skv] or None, every tensor (and those two)
    contiguous on ``dev``, and each of ``aligned`` 16-byte aligned;
    ``dims`` = (B, Hq, Sq, Skv)."""
    b, hq, sq, skv = dims
    if row_ranges.dtype != torch.int32 or row_ranges.shape != (sq, 2):
        raise ValueError(f"{name}: row ranges must be int32 [Sq, 2]")
    tensors = [*tensors, row_ranges]
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.dim() != 4
                or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, hq)
                or bias.shape[2:] != (sq, skv)):
            raise ValueError(f"{name}: bias must be fp32 "
                             "[1 or B, 1 or Hq, Sq, Skv]")
        tensors.append(bias)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: Q, dO and the payloads must be "
                             "16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def qattn_fwd(
    q: torch.Tensor,
    q_scales: Optional[torch.Tensor],
    kq: torch.Tensor,
    vq: torch.Tensor,
    k_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    v_params: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
    row_ranges: torch.Tensor,
    *,
    mode: QAttnMode,
    bias: Optional[torch.Tensor] = None,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    kv_tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized forward kernel: (o fp32 [B, Hq, Sq, D], l fp32
    [B, Hq, Sq]).

    q: fp32 / bf16 pre-scaled, or int8 with ``q_scales`` fp32 [B, Hq, Sq];
    kq, vq: int8 [B, Hkv, Skv, D] or group-planar uint8 [.., D/2];
    ``k_params`` / ``v_params``: (scale, zero point) fp32 in the shapes of
    ``mode`` — per token [B, Hkv, Skv], per block [B, Hkv, Skv/br, D/bs],
    per channel [B, Hkv, D] (V "store"), None where unused.  ``kv_tile``:
    the key span (a multiple of 64, above 64 for an int8 Q only) whose
    running row max P rounds against, the TPU's ``block_kv``
    (:func:`int8_p_tile`); None: the kernel's ``KV_TILE``-key tiles.  CPU
    tensors take :func:`qattn_fwd_plain` over the same spans; CUDA tensors
    launch ``qattn_fwd_kernel`` or raise.

    A head dim outside ``HEAD_DIMS`` runs at :func:`qattn_width`
    (:func:`pad_qattn_arguments`): the padded lanes meet Q's zero lanes in
    S and land in O's padded lanes, which are cut off, so they change
    nothing; ``mode.l_rounded`` was chosen from the true head dim by
    :func:`qattn_arguments`."""
    kw = dict(mode=mode, bias=bias, interleaved_kv=interleaved_kv,
              mask_value=mask_value)
    span = KV_TILE if kv_tile is None else kv_tile
    if q.device.type == "cpu":
        return qattn_fwd_plain(q, q_scales, kq, vq, k_params, v_params,
                               row_ranges, kv_tile=span, **kw)
    check_qattn_inputs("qattn_fwd", q, q_scales, kq, vq, k_params, v_params,
                       row_ranges, bias, mode)
    if span <= 0 or span % KV_TILE:
        raise ValueError(f"qattn_fwd: kv_tile {kv_tile} is not a positive "
                         f"multiple of {KV_TILE}")
    if span != KV_TILE and q.dtype != torch.int8:
        raise ValueError("qattn_fwd: key spans other than KV_TILE need an "
                         "int8 Q (the int8-P mode)")
    d_in = q.shape[3]
    q, kq, vq, k_params, v_params = pad_qattn_arguments(
        q, kq, vq, k_params, v_params, mode)
    b, hq, sq, d = q.shape
    hkv, skv = kq.shape[1], kq.shape[2]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    bptr, bsb, bsh = bias_args(bias)
    rc = _build.kernel_function("mfa_qattn_fwd", _QATTN_ARGS)(
        q.data_ptr(), _ptr(q_scales), kq.data_ptr(), _ptr(k_params[0]),
        _ptr(k_params[1]), vq.data_ptr(), _ptr(v_params[0]),
        _ptr(v_params[1]), row_ranges.data_ptr(), bptr, bsb, bsh,
        o.data_ptr(), lse.data_ptr(), Q_TYPES[q.dtype], b, hq, hkv, sq, skv,
        d, int(interleaved_kv), mode.bits_k, mode.bits_v,
        K_SCALES[mode.k_scales], V_SCALES[mode.v_scales], mode.flags,
        mode.block[0], mode.block[1], span, mask_value, stream_of(q),
    )
    _build.check_launch(rc, "qattn_fwd")
    qattn_fwd.launches += 1
    return (o if d == d_in else o[..., :d_in].contiguous()), lse


qattn_fwd.launches = 0


def pad_qattn_arguments(q, kq, vq, k_params, v_params, mode: QAttnMode):
    """(q, kq, vq, k_params, v_params) of :func:`qattn_fwd` at the kernel
    width of Q's head dim: Q zero-padded, the payloads by
    :func:`pad_payload`, the scales by :func:`pad_scales`; unchanged at a
    built width."""
    d = q.shape[3]
    w = qattn_width(d)
    if w == d:
        return q, kq, vq, k_params, v_params
    (q,) = pad_lanes(w, q)
    return (q, pad_payload(kq, mode.bits_k, d, w),
            pad_payload(vq, mode.bits_v, d, w),
            pad_scales(k_params, mode.k_scales, d, w, mode.block),
            pad_scales(v_params, mode.v_scales, d, w, mode.block))


# ---------------------------------------------------------------------------
# The d = 64 head-pair kernel over the packed layout
# ---------------------------------------------------------------------------


def pack_heads(x: torch.Tensor) -> torch.Tensor:
    """Lane-pack head pairs: [B, H, S, 64] → [B, H/2, S, 128] (head 2p in
    lanes [0, 64) of pair p, head 2p + 1 in [64, 128))."""
    b, h, s, d = x.shape
    if h % 2:
        raise ValueError("pack_heads needs an even head count")
    return x.reshape(b, h // 2, 2, s, d).transpose(2, 3).reshape(
        b, h // 2, s, 2 * d)


def unpack_heads(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_heads`: [B, H/2, S, 128] → [B, H, S, 64]."""
    b, h2, s, d2 = x.shape
    return x.reshape(b, h2, s, 2, d2 // 2).transpose(2, 3).reshape(
        b, 2 * h2, s, d2 // 2)


_HPACK_MODE = dict(k_scales="none", v_scales="store", round_bf16=True,
                   l_rounded=False)


def hpack_fwd_plain(q_packed, kq, vq, vsc, row_ranges, *, bits_k, bits_v,
                    interleaved_kv=False, mask_value=DEFAULT_MASK_VALUE):
    """Plain PyTorch version of :func:`hpack_fwd`."""
    o, lse = qattn_fwd_plain(
        unpack_heads(q_packed), None, kq, vq, (None, None), (vsc, None),
        row_ranges, mode=QAttnMode(bits_k=bits_k, bits_v=bits_v,
                                   **_HPACK_MODE),
        interleaved_kv=interleaved_kv, mask_value=mask_value)
    return pack_heads(o), lse


def hpack_fwd(
    q_packed: torch.Tensor,
    kq: torch.Tensor,
    vq: torch.Tensor,
    vsc: torch.Tensor,
    row_ranges: torch.Tensor,
    *,
    bits_k: int,
    bits_v: int,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head-pair kernel: q_packed [B, Hq/2, Sq, 128] fp32 / bf16,
    pre-scaled with the K scales folded in; K/V payloads of head dim 64;
    ``vsc`` the V scales per channel, fp32 [B, Hkv, 64].  Returns (o_packed
    fp32 [B, Hq/2, Sq, 128], l fp32 [B, Hq, Sq]); P is rounded to bf16
    whatever Q's dtype.  CPU tensors take :func:`hpack_fwd_plain`; CUDA
    tensors launch ``hpack_fwd_kernel`` or raise."""
    kw = dict(bits_k=bits_k, bits_v=bits_v, interleaved_kv=interleaved_kv,
              mask_value=mask_value)
    if q_packed.device.type == "cpu":
        return hpack_fwd_plain(q_packed, kq, vq, vsc, row_ranges, **kw)
    b, h2, sq, d2 = q_packed.shape
    if (d2 != 128 or q_packed.dtype == torch.int8
            or not q_packed.is_contiguous()):
        raise ValueError("hpack_fwd: q must be float, contiguous "
                         "[B, Hq/2, Sq, 128]")
    mode = QAttnMode(bits_k=bits_k, bits_v=bits_v, **_HPACK_MODE)
    # A view [B, Hq, Sq, 64] of the same bytes takes the natural layout's
    # checks (dtype, device, shapes, alignment); the kernel reads the
    # packed layout through its strides.
    check_qattn_inputs("hpack_fwd", q_packed.view(b, 2 * h2, sq, 64),
                       None, kq, vq, (None, None), (vsc, None), row_ranges,
                       None, mode)
    hkv, skv = kq.shape[1], kq.shape[2]
    o = torch.empty(q_packed.shape, dtype=torch.float32,
                    device=q_packed.device)
    lse = torch.empty((b, 2 * h2, sq), dtype=torch.float32,
                      device=q_packed.device)
    rc = _build.kernel_function("mfa_hpack_fwd", _HPACK_ARGS)(
        q_packed.data_ptr(), kq.data_ptr(), vq.data_ptr(), vsc.data_ptr(),
        row_ranges.data_ptr(), o.data_ptr(), lse.data_ptr(),
        Q_TYPES[q_packed.dtype], b, h2, hkv, sq, skv, int(interleaved_kv),
        bits_k, bits_v, mask_value, stream_of(q_packed),
    )
    _build.check_launch(rc, "hpack_fwd")
    hpack_fwd.launches += 1
    return o, lse


hpack_fwd.launches = 0


def _check_folded(t: QuantizedTensor, name: str):
    if t.config.strategy != QuantStrategy.SYMMETRIC or (
            t.config.granularity not in (QuantGranularity.TENSOR,
                                         QuantGranularity.CHANNEL)):
        raise ValueError(
            f"packed attention needs SYMMETRIC TENSOR/CHANNEL {name} "
            "scales (the folded pipeline's preconditions)")


def _channel_scales(t: QuantizedTensor) -> torch.Tensor:
    """fp32 [B, H, D] per-channel scales of a CHANNEL or TENSOR tensor."""
    b, h, _, d = t.shape
    if t.config.granularity == QuantGranularity.CHANNEL:
        return t.scale.reshape(b, h, d).float()
    return t.scale.reshape(1, 1, 1).float().expand(b, h, d)


def hpack_arguments(q_packed, k, v, *, mask=FULL, scale=None,
                    interleaved_kv=False):
    """The head-pair kernel's arguments for the packed API: ``(args,
    kwargs)`` of :func:`hpack_fwd` (and of :func:`hpack_fwd_plain`).
    Checks the preconditions and folds softmax scale · log2e and the K
    scales into packed Q (CHANNEL: elementwise by the pair-concatenated
    scale vector, exact per term), rounded back to Q's dtype."""
    b, h2, sq, d2 = q_packed.shape
    d = d2 // 2
    _, hkv, skv, dk = k.shape
    if d != 64 or dk != 64:
        raise ValueError("packed layout is the d=64 head-pair format")
    if mask.kind not in (MaskKind.NONE, MaskKind.CAUSAL):
        raise ValueError("packed attention supports NONE/CAUSAL masks")
    for t, name in ((k, "K"), (v, "V")):
        _check_folded(t, name)
    pre = (float(d) ** -0.5 if scale is None else float(scale)) * LOG2E
    kv_of = _kv_head_map(2 * h2, hkv, interleaved_kv)
    if k.config.granularity == QuantGranularity.CHANNEL:
        ksf = _channel_scales(k)
        ksc_cat = torch.cat([ksf[:, kv_of[0::2]], ksf[:, kv_of[1::2]]],
                            dim=-1)[:, :, None, :]
        q_packed = (q_packed.float() * (ksc_cat * pre)).to(q_packed.dtype)
    else:
        pre_t = k.scale.reshape(()).float() * pre
        q_packed = (q_packed.float() * pre_t).to(q_packed.dtype)
    rr = row_ranges_tensor(mask, sq, skv, None, q_packed.device)
    args = (q_packed.contiguous(), k.data, v.data,
            _channel_scales(v).contiguous(), rr)
    return args, dict(bits_k=k.config.bits, bits_v=v.config.bits,
                      interleaved_kv=interleaved_kv)


def quantized_flash_attention_forward_packed(
    q_packed: torch.Tensor,
    k: QuantizedTensor,
    v: QuantizedTensor,
    *,
    mask: MaskSpec = FULL,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-pair d=64 quantized forward over the PACKED layout.

    ``q_packed``: [B, Hq/2, Sq, 128] (:func:`pack_heads`); K/V natural
    [B, Hkv, Skv, 64] int8 or packed int4, SYMMETRIC with TENSOR/CHANNEL
    scales.  Mask NONE or CAUSAL (bottom-right aligned).  Returns (o_packed
    [B, Hq/2, Sq, 128] ``out_dtype``, l [B, Hq, Sq] natural-log LSE): the
    kernel reads Q and writes O in this layout, so a caller that keeps it
    pays no pack/unpack transposes.  ``block_sizes`` is the TPU's tiling,
    accepted and unused."""
    del block_sizes
    args, kw = hpack_arguments(q_packed, k, v, mask=mask, scale=scale,
                               interleaved_kv=interleaved_kv)
    o, lse = hpack_fwd(*args, **kw)
    return o.to(out_dtype), lse


def _kv_head_map(hq: int, hkv: int, interleaved: bool) -> torch.Tensor:
    """The kv head of each q head."""
    h = torch.arange(hq)
    return h % hkv if interleaved else h // (hq // hkv)


def _hpack_forward(q, k, v, *, mask, scale, interleaved_kv, out_dtype):
    """Natural-layout boundary of the head-pair forward: packs Q, runs the
    packed API, unpacks O → (o [B, Hq, Sq, 64], l [B, Hq, Sq])."""
    o_p, lse = quantized_flash_attention_forward_packed(
        pack_heads(q), k, v, mask=mask, scale=scale,
        interleaved_kv=interleaved_kv, out_dtype=out_dtype)
    return unpack_heads(o_p), lse


# ---------------------------------------------------------------------------
# Public forward contract
# ---------------------------------------------------------------------------


def _per_token_params(t: QuantizedTensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Scale and zero point of a [B, H, S, D] quantized tensor as per-token
    fp32 [B, H, S] (TENSOR broadcast; ROW as it is)."""
    b, h, s, _ = t.shape
    g = t.config.granularity
    if g == QuantGranularity.ROW:
        return (t.scale.reshape(b, h, s).float().contiguous(),
                t.zero_point.reshape(b, h, s).float().contiguous())
    if g == QuantGranularity.TENSOR:
        return (t.scale.reshape(1, 1, 1).float().expand(b, h, s).contiguous(),
                t.zero_point.reshape(1, 1, 1).float().expand(
                    b, h, s).contiguous())
    raise NotImplementedError(
        f"quantized attention K/V granularity {g}; use ROW or TENSOR")


@dataclasses.dataclass(frozen=True)
class _Pipeline:
    """The JAX package's mode selection for one call."""

    ks_folded: bool  # quantize_q with a TENSOR K scale folded into Q's
    int8_pv: bool  # quantize_q with CHANNEL / TENSOR V: int8 P × int8 V
    kv_folded: bool  # bf16 Q, SYMMETRIC TENSOR / CHANNEL / ROW K and V
    k_rowscale: bool
    v_rowscale: bool


def _pipeline(q: torch.Tensor, k: QuantizedTensor, v: QuantizedTensor,
              quantize_q: bool) -> _Pipeline:
    """Select the pipeline, raising on what it does not take, as the JAX
    package does."""
    kc, vc = k.config, v.config
    ks_folded = int8_pv = False
    if quantize_q:
        if (kc.strategy != QuantStrategy.SYMMETRIC
                or kc.granularity not in (QuantGranularity.ROW,
                                          QuantGranularity.TENSOR)):
            raise ValueError(
                "quantize_q needs SYMMETRIC K with ROW or TENSOR scales "
                "(the zero-point-free int8 MXU score path)")
        ks_folded = kc.granularity == QuantGranularity.TENSOR
        int8_pv = (vc.strategy == QuantStrategy.SYMMETRIC
                   and vc.granularity in (QuantGranularity.CHANNEL,
                                          QuantGranularity.TENSOR))
    kv_folded = (
        not quantize_q and q.dtype != torch.float32
        and kc.strategy == QuantStrategy.SYMMETRIC
        and kc.granularity in _FOLDED
        and vc.strategy == QuantStrategy.SYMMETRIC
        and vc.granularity in _FOLDED
    )
    if (not quantize_q and not kv_folded
            and vc.granularity == QuantGranularity.CHANNEL):
        raise ValueError(
            "CHANNEL-granularity V requires the full-integer pipeline "
            "(quantize_q=True) or the folded int8 fast path (symmetric "
            "TENSOR K, non-fp32 Q)")
    return _Pipeline(
        ks_folded, int8_pv, kv_folded,
        kv_folded and kc.granularity == QuantGranularity.ROW,
        kv_folded and vc.granularity == QuantGranularity.ROW)


def qattn_arguments(
    q: torch.Tensor,
    k: QuantizedTensor,
    v: QuantizedTensor,
    *,
    mask: MaskSpec = FULL,
    mask_ranges: Optional[Ranges] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    quantize_q: bool = False,
):
    """The quantized forward kernel's arguments: ``(args, kwargs)`` of
    :func:`qattn_fwd` (and of :func:`qattn_fwd_plain`) for these inputs,
    Q pre-scaled or quantized and the scales laid out for the selected
    mode."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    kc, vc = k.config, v.config
    pipe = _pipeline(q, k, v, quantize_q)
    pre = (float(d) ** -0.5 if scale is None else float(scale)) * LOG2E
    q_scales = None
    k_params = v_params = (None, None)
    block = (1, 1)
    if quantize_q:
        qf = q.float()
        q_scale = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
        q_in = torch.round(qf / q_scale).clamp(-128, 127).to(torch.int8)
        q_scales = q_scale * pre
        if pipe.ks_folded:
            q_scales = q_scales * k.scale.reshape(()).float()
        q_scales = q_scales[..., 0].contiguous()
        k_mode = "none" if pipe.ks_folded else "column"
        if not pipe.ks_folded:
            k_params = (_per_token_params(k)[0], None)
    elif pipe.k_rowscale:
        q_in = (q.float() * pre).to(q.dtype)
        k_mode = "column"
        k_params = (k.scale.reshape(b, hkv, skv).float().contiguous(), None)
    elif pipe.kv_folded and kc.granularity == QuantGranularity.CHANNEL:
        kv_of = _kv_head_map(hq, hkv, interleaved_kv)
        ksc = _channel_scales(k)[:, kv_of, None, :]  # [B, Hq, 1, D]
        q_in = (q.float() * (ksc * pre)).to(q.dtype)
        k_mode = "none"
    elif pipe.kv_folded:
        q_in = (q.float() * (k.scale.reshape(()).float() * pre)).to(q.dtype)
        k_mode = "none"
    else:
        q_in = (q.float() * pre).to(q.dtype)
        if kc.granularity == QuantGranularity.BLOCK_2D:
            if vc.granularity != QuantGranularity.BLOCK_2D or (
                    (kc.block_rows, kc.block_size)
                    != (vc.block_rows, vc.block_size)):
                raise ValueError("K/V must share BLOCK_2D block geometry")
            block = (kc.block_rows, kc.block_size)
            k_mode = "block2d"
            k_params = (k.scale.float().contiguous(),
                        k.zero_point.float().contiguous())
        else:
            k_mode = "token"
            k_params = _per_token_params(k)
    if pipe.int8_pv or (pipe.kv_folded and not pipe.v_rowscale):
        v_mode = "store"
        v_params = (_channel_scales(v).contiguous(), None)
    elif pipe.v_rowscale:
        v_mode = "p"
        v_params = (v.scale.reshape(b, hkv, skv).float().contiguous(), None)
    elif k_mode == "block2d":
        v_mode = "block2d"
        v_params = (v.scale.float().contiguous(),
                    v.zero_point.float().contiguous())
    else:
        v_mode = "token"
        v_params = _per_token_params(v)
    mode = QAttnMode(
        k_scales=k_mode, v_scales=v_mode, bits_k=kc.bits, bits_v=vc.bits,
        p_int8=pipe.int8_pv, round_bf16=q.dtype != torch.float32,
        l_rounded=d % 128 != 0 and not pipe.v_rowscale, block=block,
    )
    rr = row_ranges_tensor(mask, sq, skv, mask_ranges, q.device)
    args = (q_in.contiguous(), q_scales, k.data, v.data, k_params, v_params,
            rr)
    return args, dict(mode=mode, bias=kernel_bias(bias),
                      interleaved_kv=interleaved_kv, mask_value=mask_value)


def quantized_flash_attention_forward(
    q: torch.Tensor,
    k: QuantizedTensor,
    v: QuantizedTensor,
    *,
    mask: MaskSpec = FULL,
    mask_ranges: Optional[Ranges] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    out_dtype: torch.dtype = torch.float32,
    quantize_q: bool = False,
    hadamard_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward with quantized K/V: the contract of
    ``flash_attention_forward`` with k, v :class:`QuantizedTensor` s of
    logical shape [B, Hkv, Skv, D] (int8, or int4 with even D).

    ``quantize_q``: quantize Q per token (int8 symmetric) so scores run
    int8 × int8; needs SYMMETRIC ROW or TENSOR K.  ``hadamard_block``: K/V
    were quantized in the Hadamard-rotated basis; Q is rotated on the fly
    and O un-rotated after the kernel (both exact).  Unmasked d=64 calls
    with folded TENSOR / CHANNEL scales take the head-pair kernel, as in
    the JAX package.  ``block_sizes`` is the TPU's tiling: its ``block_kv``
    gives the spans the int8 P of ``int8_pv`` rounds over
    (:func:`int8_p_tile`), and the other modes read none of it.  Returns
    (o [B, Hq, Sq, D] ``out_dtype``, l [B, Hq, Sq] fp32 natural LSE).
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if d != dk or tuple(v.shape) != tuple(k.shape) or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and K/V {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match")
    pipe = _pipeline(q, k, v, quantize_q)
    if (pipe.kv_folded and not (pipe.k_rowscale or pipe.v_rowscale)
            and d == 64 and hq % 2 == 0 and bias is None
            and mask_ranges is None and hadamard_block is None
            and mask.kind == MaskKind.NONE and sq % 128 == 0
            and skv % 128 == 0 and mask_value == DEFAULT_MASK_VALUE):
        return _hpack_forward(q, k, v, mask=mask, scale=scale,
                              interleaved_kv=interleaved_kv,
                              out_dtype=out_dtype)
    if hadamard_block:
        q = hadamard_transform(q, hadamard_block)
    args, kw = qattn_arguments(
        q, k, v, mask=mask, mask_ranges=mask_ranges, bias=bias, scale=scale,
        interleaved_kv=interleaved_kv, mask_value=mask_value,
        quantize_q=quantize_q)
    o, lse = qattn_fwd(*args, **kw, kv_tile=(
        int8_p_tile(block_sizes, skv) if pipe.int8_pv else None))
    o = o.to(out_dtype)
    if hadamard_block:
        # V was stored rotated, so O came out rotated: H once more.
        o = hadamard_transform(o.float(), hadamard_block).to(out_dtype)
    return o, lse


# ---------------------------------------------------------------------------
# Differentiable wrapper: gradients to q, bias and the K/V scales and zero
# points; the integer payloads are data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _KVMeta:
    config_k: QuantConfig
    config_v: QuantConfig
    shape: Tuple[int, ...]


def _flatten_kv(k: QuantizedTensor, v: QuantizedTensor):
    """The six tensors autograd sees, and what rebuilds K/V from them."""
    flat = (k.data, k.scale, k.zero_point, v.data, v.scale, v.zero_point)
    return flat, _KVMeta(k.config, v.config, tuple(k.shape))


def _rebuild_kv(flat, meta: _KVMeta):
    kd, ks, kz, vd, vs, vz = flat
    return (QuantizedTensor(data=kd, scale=ks, zero_point=kz, sums=None,
                            config=meta.config_k, shape=meta.shape),
            QuantizedTensor(data=vd, scale=vs, zero_point=vz, sums=None,
                            config=meta.config_v, shape=meta.shape))


def _scale_zp_cotangents(dxdeq: torch.Tensor, qt: QuantizedTensor):
    """Exact cotangents of X = (w − zp)·scale with respect to (scale, zp),
    from the gradient with respect to the dequantized X: dscale =
    Σ_cell dX ⊙ (w − zp), dzp = −Σ_cell dX ⊙ scale; (w − zp) is recovered
    as X / scale, so an int4 payload needs no unpacking.  An integer zero
    point gets None."""
    dx = dxdeq.float()
    deq = dequantize(qt)
    g = qt.config.granularity
    b, h, s, d = qt.shape
    if g == QuantGranularity.BLOCK_2D:
        br, bs = qt.config.block_rows, qt.config.block_size
        scale_el = qt.scale.float().repeat_interleave(br, dim=2)
        scale_el = scale_el.repeat_interleave(bs, dim=3)
    elif g == QuantGranularity.CHANNEL:
        scale_el = qt.scale.float()  # [B, H, 1, D]
    else:
        scale_el = _per_token_params(qt)[0][..., None]  # [B, H, S, 1]
    ds_cells = dx * (deq / scale_el)
    dz_cells = -dx * scale_el
    if g == QuantGranularity.ROW:
        red = dict(dim=-1)
    elif g == QuantGranularity.CHANNEL:
        red = dict(dim=-2, keepdim=True)
    elif g == QuantGranularity.BLOCK_2D:
        ds_cells = ds_cells.reshape(b, h, s // br, br, d // bs, bs)
        dz_cells = dz_cells.reshape(b, h, s // br, br, d // bs, bs)
        red = dict(dim=(3, 5))
    else:  # TENSOR
        red = dict(dim=tuple(range(4)))
    dscale = ds_cells.sum(**red).reshape(qt.scale.shape)
    dzp = dz_cells.sum(**red).reshape(qt.zero_point.shape)
    return (dscale.to(qt.scale.dtype),
            None if not qt.zero_point.is_floating_point()
            else dzp.to(qt.zero_point.dtype))


class _QuantizedFlashAttention(torch.autograd.Function):
    """``custom_vjp`` analog.  Autograd sees the K/V payloads, scales and
    zero points as six tensors, so ``torch.autograd.grad`` reaches a scale
    tensor put into a :class:`QuantizedTensor` (``dataclasses.replace(kq,
    scale=s)``).  Backward: the quantized dQ and dK/dV kernels (exact, or
    the full-integer pair with ``bwd_fullint``), dK/dV with respect to the
    dequantized K/V chained into the scale and zero-point cotangents."""

    @staticmethod
    def forward(ctx, q, bias, kd, ks, kz, vd, vs, vz, meta, kw):
        k, v = _rebuild_kv((kd, ks, kz, vd, vs, vz), meta)
        fwd = {n: kw[n] for n in ("mask", "scale", "block_sizes",
                                  "interleaved_kv", "mask_value",
                                  "hadamard_block", "quantize_q")}
        o, lse = quantized_flash_attention_forward(q, k, v, bias=bias, **fwd)
        ctx.save_for_backward(q, bias, kd, ks, kz, vd, vs, vz, o, lse)
        ctx.meta, ctx.kw = meta, kw
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (  # noqa: E501
            flash_attention_backward,
        )

        q, bias, *flat, o, lse = ctx.saved_tensors
        k, v = _rebuild_kv(flat, ctx.meta)
        kw, hb = ctx.kw, ctx.kw["hadamard_block"]
        q_in = q
        if hb:
            # The payloads are rotated: the backward runs in that basis.
            q_in, o, do = (hadamard_transform(t, hb) for t in (q, o, do))
        dq, dk, dv, dbias = flash_attention_backward(
            q_in, k, v, o, lse, do, mask=kw["mask"], bias=bias,
            scale=kw["scale"], block_sizes=kw["block_sizes"],
            interleaved_kv=kw["interleaved_kv"],
            compute_dbias=bias is not None, fullint=kw["bwd_fullint"])
        if hb:
            dq = hadamard_transform(dq, hb)
        dks, dkz = _scale_zp_cotangents(dk, k)
        dvs, dvz = _scale_zp_cotangents(dv, v)
        return (dq.to(q.dtype),
                None if dbias is None else dbias.to(bias.dtype),
                None, dks, dkz, None, dvs, dvz, None, None)


def quantized_flash_attention(
    q: torch.Tensor,
    k: QuantizedTensor,
    v: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    *,
    mask: MaskSpec = FULL,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    hadamard_block: Optional[int] = None,
    quantize_q: bool = False,
    bwd_fullint: bool = False,
) -> torch.Tensor:
    """Differentiable quantized-KV flash attention; returns O in q's dtype.

    Gradients: dq, dbias, and exact cotangents for the K/V ``scale`` and
    float ``zero_point`` tensors (through the dequantizing dK/dV kernel);
    the integer payloads get none.  ``quantize_q``: the forward's int8-Q
    pipeline.  ``bwd_fullint``: the full-integer backward kernels where
    ``fullint_backward_supported`` (approximate: per-token int8 Q and dO;
    its level 2 reads ``block_sizes``); other configurations take the
    exact kernels."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    flat, meta = _flatten_kv(k, v)
    kw = dict(mask=mask, scale=float(scale), block_sizes=block_sizes,
              interleaved_kv=interleaved_kv, mask_value=mask_value,
              hadamard_block=hadamard_block, quantize_q=quantize_q,
              bwd_fullint=bwd_fullint)
    return _QuantizedFlashAttention.apply(q, bias, *flat, meta, kw)


# ---------------------------------------------------------------------------
# QAT: float K/V masters, quantized compute, straight-through dK/dV
# ---------------------------------------------------------------------------


class _QuantizedAttentionQAT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, config, kw):
        kq, vq = quantize(k, config), quantize(v, config)
        o, lse = quantized_flash_attention_forward(q, kq, vq, **kw)
        ctx.save_for_backward(q, o, lse)
        ctx.kv, ctx.kw, ctx.dtypes = (kq, vq), kw, (k.dtype, v.dtype)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (  # noqa: E501
            flash_attention_backward,
        )

        q, o, lse = ctx.saved_tensors
        kw = ctx.kw
        dq, dk, dv, _ = flash_attention_backward(
            q, *ctx.kv, o, lse, do, mask=kw["mask"], scale=kw["scale"],
            block_sizes=kw["block_sizes"],
            interleaved_kv=kw["interleaved_kv"])
        # STE: the gradients with respect to the dequantized K/V pass
        # through the quantization to the float masters unchanged.
        return (dq.to(q.dtype), dk.to(ctx.dtypes[0]), dv.to(ctx.dtypes[1]),
                None, None)


def quantized_flash_attention_qat(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    config: QuantConfig = QuantConfig(),
    mask: MaskSpec = FULL,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> torch.Tensor:
    """Train-time quantized attention over FLOAT K/V masters: the forward
    quantizes K/V with ``config`` and runs the quantized forward kernel
    (the serving numerics); the backward runs the dequantizing dQ and
    dK/dV kernels and passes dK/dV straight through to the masters."""
    kw = dict(mask=mask, scale=scale, block_sizes=block_sizes,
              interleaved_kv=interleaved_kv, mask_value=mask_value)
    return _QuantizedAttentionQAT.apply(q, k, v, config, kw)

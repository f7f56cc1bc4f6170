"""Quantized GEMMs, and the K/V tile helpers of the quantized attention.

The entry points of the JAX package's ``ops/quantized_gemm.py``, each with
the JAX dispatch over its CUDA kernels (``csrc/quantized_gemm.cu``); every
kernel wrapper launches its kernel on CUDA tensors (or raises), runs its
plain PyTorch version (``*_plain``) on CPU tensors, and counts its launches
in ``<wrapper>.launches``:

- :func:`quantized_matmul`, the weight-only GEMM: float A [M, K] ×
  quantized Bᵀ [N, K].  SYMMETRIC TENSOR / ROW weights and a non-fp32 A
  take :func:`wo_folded_gemm` (``wo_tc_kernel``'s folded tile, the TPU's
  ``_wo_folded_kernel``): A in bf16 times the integer weights, the scale
  on the fp32 accumulator once, then C; every other weight (or an fp32 A)
  takes :func:`wo_gemm` (``wo_tc_kernel`` for a bf16 A, ``wo_kernel`` for
  an fp32 one; the TPU's ``_wo_kernel``): each weight ``(q − zp)·s`` with
  TENSOR, ROW or BLOCK (per K-block) scales, rounded to the compute dtype
  (fp32 for an fp32 A, else bf16), fp32 accumulation, C added at the
  store.  Both store the caller's dtype (:data:`WO_OUT_TYPES`) rounded
  once from the fp32 result, as the TPU kernels' store does.
- :func:`quantized_matmul_qa`, the transpose: quantized A [M, K] × float B
  [K, N].  SYMMETRIC TENSOR / ROW A and a non-fp32 B (rounded to bf16,
  whatever its dtype) take :func:`qa_folded_gemm` (``qa_tc_kernel``'s
  folded tile, the TPU's ``_qa_folded_kernel``), the scale per row of A on
  the accumulator; every other A (or an fp32 B) takes :func:`qa_gemm`
  (``qa_tc_kernel`` for a bf16 B, ``qa_kernel`` for an fp32 one; the
  TPU's ``_qa_kernel``), dequantizing A to B's precision.  Neither takes
  C: ``ops.gemm.matmul`` adds it after them.
- :func:`compensated_matmul`: int8 A [M, K] × int8 Bᵀ [N, K], both BLOCK
  along K with one block size.  A block size that is a multiple of 128
  takes :func:`comp_gemm` (``comp_tc_kernel``, the TPU's
  ``_comp_kernel``): integer block products on the s8 tensor cores and the
  per-block zero-point compensation from :func:`per_row_block_sums`;
  other blocks take :func:`comp_small_gemm` (the TPU's
  ``_comp_small_kernel``, whose plain version dequantizes both operands
  per element and sums exact fp32 products): ``comp_tc_kernel`` too for a
  block of a multiple of 16, or ``comp_small_kernel``'s per-element
  dequantization for the others (:func:`comp_small_body`).
- :func:`dynamic_quantized_matmul`, W8A8 / W4A8, below.

The dynamic GEMM.  A is quantized per row in the wrapper (int8
symmetric, absmax/127, clipped to [-127, 127], and Σq per row), as the JAX
wrapper does outside its kernel; :func:`dyn_gemm` then runs the
integer product (``dyn_tc_kernel``: s8 tensor cores, tiles and K splits of
:func:`dyn_tile`) and the one-pass epilogue

    out = (float(Σ_k qa·qb) − Σqa·z_b) · (s_a·s_b)  [+ C]

in fp32, in that order, with the roundings of the JAX kernel as XLA runs
it: the subtraction of Σqa·z_b and the addition of C are each one fused
multiply-add.  B is a :class:`QuantizedTensor` over ``[N, K]`` with ROW or
TENSOR scales, int8 or group-planar int4 (K % 256 == 0); any strategy, the
zero point is compensated exactly through Σqa.

The JAX package's ``block_m/n/k`` are TPU tiles: the entry points accept
them and the CUDA kernels choose their own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    exact_fp32,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    INT4_GROUP,
    QuantizedTensor,
    unpack_int4,
)

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_DYN_ARGS = [_PTR] * 8 + [_I32] * 6 + [_PTR]
_WO_FOLDED_ARGS = [_PTR] * 5 + [_I32] * 7 + [_PTR] * 2
_WO_ARGS = [_PTR] * 6 + [_I32] * 9 + [_PTR] * 2
# The weight-only kernel's scale cells (csrc/quantized_gemm.cu::WoScales).
WO_SCALES = {QuantGranularity.TENSOR: 0, QuantGranularity.ROW: 1,
             QuantGranularity.BLOCK: 2}
# The dtypes the weight-only kernels store (csrc/quantized_gemm.cu::OutType).
WO_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize_rows(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Runtime per-row symmetric int8 activations: (qa int8 [M, K], s_a fp32
    [M], Σqa fp32 [M]).  Clipped to [-127, 127] (the KV pool clips to
    -128; this does not)."""
    af = a.float()
    sa = af.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    qa = torch.round(af / sa).clamp(-127, 127).to(torch.int8)
    rs = qa.to(torch.int32).sum(dim=1).float()
    return qa, sa[:, 0].contiguous(), rs


def weight_scales(b_t: QuantizedTensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s_b, z_b) fp32 [N] of a ROW or TENSOR weight."""
    n = b_t.shape[0]
    sb = b_t.scale.reshape(-1).float()
    zb = b_t.zero_point.reshape(-1).float()
    if b_t.config.granularity == QuantGranularity.TENSOR:
        sb, zb = sb.expand(n), zb.expand(n)
    return sb.contiguous(), zb.contiguous()


def _check_weight(b_t: QuantizedTensor, kdim: int):
    cfg = b_t.config
    if cfg.bits not in (8, 4):
        raise ValueError("dynamic_quantized_matmul requires int8/int4 weights")
    if cfg.granularity not in (QuantGranularity.ROW, QuantGranularity.TENSOR):
        raise ValueError(
            "dynamic_quantized_matmul needs ROW or TENSOR weight scales "
            "(per-K-block scales need the compensated/blockwise path)")
    if len(b_t.shape) != 2 or b_t.shape[1] != kdim:
        raise ValueError(f"weight shape {b_t.shape} does not match K={kdim}")
    if cfg.bits == 4 and kdim % INT4_GROUP:
        raise ValueError(
            f"int4 dynamic GEMM requires K % 256 == 0 (got K={kdim})")


def _check_gemm(name: str, specs, aligned=()):
    """Raise unless each (tensor, dtypes, shape) of ``specs`` (None tensors
    skipped) has one of ``dtypes`` and that shape, all contiguous on the
    first tensor's CUDA device, and each of ``aligned`` 16-byte aligned."""
    dev = specs[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t, dtypes, shape in specs:
        if t is None:
            continue
        if t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
            raise TypeError(f"{name}: expected {dtypes} {tuple(shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on {dev}")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: int8 operands must be 16-byte aligned")


def _payload_spec(t: torch.Tensor, bits: int, rows: int, kdim: int):
    """The (tensor, dtypes, shape) a ``bits``-bit [rows, K] payload has."""
    if bits not in (8, 4):
        raise ValueError(f"payload bits {bits} are not 8 or 4")
    if bits == 4 and kdim % INT4_GROUP:
        raise ValueError(f"int4 needs K % 256 == 0 (got {kdim})")
    return ((t, (torch.int8,), (rows, kdim)) if bits == 8
            else (t, (torch.uint8,), (rows, kdim // 2)))


# ---------------------------------------------------------------------------
# K/V tile helpers of the quantized attention: the dequantized values its
# plain versions use (the kernels dequantize while staging, the same way)
# ---------------------------------------------------------------------------


def unpack_int4_tile_int8(qtile: torch.Tensor, bk: int) -> torch.Tensor:
    """Group-planar int4 → int8: packed [..., bk/2] → int8 [..., bk] (the
    layout of :func:`quant.tensor.pack_int4`)."""
    if qtile.shape[-1] * 2 != bk:
        raise ValueError(f"packed width {qtile.shape[-1]} is not {bk}/2")
    return unpack_int4(qtile)


def dequant_kv_vals(payload, scale, zp, d, bits, compute_dtype):
    """Per-token dequantization of a K/V payload [..., S, D] (int8, or
    packed int4 [..., S, D/2]) with per-token scale and zero point
    [..., S, 1]: ``((w − zp)·scale)`` in fp32, rounded to
    ``compute_dtype``."""
    w = (unpack_int4_tile_int8(payload, d) if bits == 4 else payload).float()
    return ((w - zp) * scale).to(compute_dtype)


def dequant_block2d_vals(payload, s, z, er, ec, d, bits, compute_dtype):
    """BLOCK_2D dequantization: payload [..., S, D] with per-block scale and
    zero point [..., S/br, D/bs] → ``w·s − z·s`` with the block values
    expanded by the 0/1 products ``E_r · s · E_c`` (``er`` None when
    br == 1), rounded to ``compute_dtype``."""
    w = (unpack_int4_tile_int8(payload, d) if bits == 4 else payload).float()
    s = s.float()
    zs = z.float() * s
    if er is not None:
        s, zs = er @ s, er @ zs
    return (w * (s @ ec) - zs @ ec).to(compute_dtype)


def block2d_expanders(block_rows: int, block_size: int, bkv: int, d: int,
                      device=None):
    """(E_r [bkv, bkv/br] or None, E_c [ceil(d/bs), d]): the 0/1 fp32
    matrices that expand per-block values to per-element ones."""
    ec = (torch.arange(d, device=device)[None, :] // block_size
          == torch.arange(-(-d // block_size),
                          device=device)[:, None]).float()
    if block_rows == 1:
        return None, ec
    er = (torch.arange(bkv, device=device)[:, None] // block_rows
          == torch.arange(bkv // block_rows, device=device)[None, :]).float()
    return er, ec


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------


def fma32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """fp32 ``x·y + z`` rounded once, as a fused multiply-add: the product
    of two fp32 values is exact in float64; the float64 sum is turned into
    its round-to-odd value (TwoSum gives the sum's error), which rounds to
    fp32 exactly as the one-step rounding would."""
    p = x.double() * y.double()
    zz = z.double()
    s = p + zz
    bb = s - p
    err = (p - (s - bb)) + (zz - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def _epilogue(acc: torch.Tensor, sa, rs, sb, zb, c):
    """fp32, in the kernel's order and roundings: d = acc − Σqa·z_b and, with
    C, out = d·(s_a·s_b) + C, each one fused multiply-add (as XLA runs the
    JAX kernel); without C, out = d·(s_a·s_b)."""
    d = fma32(-rs[:, None].expand_as(acc), zb[None, :].expand_as(acc), acc)
    s = sa[:, None] * sb[None, :]
    return d * s if c is None else fma32(d, s, c.float())


def dyn_gemm_plain(qa, qb, sa, rs, sb, zb, *, bits: int,
                   c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`dyn_gemm`: the same integer sum,
    exactly, then the same epilogue.  The CPU multiplies in int64; torch
    has no integer matmul on CUDA, so the card multiplies in float64,
    which is exact here: |Σ qa·qb| ≤ 127·128·K < 2⁵³."""
    w = unpack_int4(qb) if bits == 4 else qb
    if qa.device.type == "cpu":
        acc = (qa.long() @ w.long().t()).float()
    else:
        acc = (qa.double() @ w.double().t()).float()
    return _epilogue(acc, sa, rs, sb, zb, c)


def _s8_tile(m: int, n: int, units: int, slots: int,
             sms: int) -> Tuple[int, int]:
    """(rows of the s8 tile's BM × 128 tile, K splits) for [M, N] over
    ``units`` indivisible K ranges on ``sms`` SMs: 16-row tiles for M ≤ 16
    (decode); else 128-row tiles where they give every SM a CTA, 64-row
    ones where they do not; K split into as many ranges (≤ 8: one cluster;
    each ≥ 2 units) as keep to ``slots`` CTAs for each SM."""
    cols = -(-n // 128)
    bm = 16 if m <= 16 else (128 if -(-m // 128) * cols >= sms else 64)
    tiles = -(-m // bm) * cols
    return bm, max(1, min(slots * sms // tiles, 8, units // 2))


def dyn_tile(m: int, n: int, kdim: int, sms: int,
             bits: int = 8) -> Tuple[int, int]:
    """(tile rows, K splits) of ``dyn_tc_kernel`` for [M, N] over K of a
    ``bits`` weight: the plan ``AttentionTuner.calibrate_gemm`` stored for
    this GEMM (``attention.tuning.stored_gemm_plan``, one in-memory
    lookup), else :func:`dyn_shape_tile`'s."""
    from metal_flash_attention_plus_tpu_torch.attention.tuning import (
        stored_gemm_plan,
    )

    stored = stored_gemm_plan(m, n, kdim, bits, "dynamic")
    return stored if stored is not None else dyn_shape_tile(m, n, kdim, sms)


def dyn_shape_tile(m: int, n: int, kdim: int, sms: int) -> Tuple[int, int]:
    """(tile rows, K splits) of ``dyn_tc_kernel`` for [M, N] over K on a
    card of ``sms`` SMs (:func:`_s8_tile` over K's steps of 128, splits up
    to one CTA for each SM, which ``utils/profiling.py --dyn-tiles`` found
    as fast as two or faster at every shape of the model): the fully
    quantized forward's M = 4096 takes 128-row tiles over most
    projections, decode (M ≤ 16) 16-row tiles with K split but over the
    unembedding, a prefill chunk (M = 256) 64-row tiles with K split four
    ways where N ≤ 1024.  The splits' int32 partials add exactly, so the
    result is the same bits whatever the plan."""
    return _s8_tile(m, n, -(-kdim // 128), 1, sms)


def dyn_gemm(qa, qb, sa, rs, sb, zb, *, bits: int,
             c: Optional[torch.Tensor] = None,
             tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The integer GEMM with its epilogue → fp32 [M, N].

    qa int8 [M, K]; qb int8 [N, K] (bits 8) or group-planar uint8
    [N, K/2] (bits 4, K % 256 == 0); s_a, Σqa fp32 [M]; s_b, z_b fp32 [N];
    c fp32 [M, N] or None.  CPU tensors take :func:`dyn_gemm_plain`; CUDA
    tensors launch ``dyn_tc_kernel`` (s8 mma.sync; the tile and K splits of
    ``tile`` or else :func:`dyn_tile`, the splits summed inside the launch)
    or raise.  Every plan gives the same bits: the splits' int32 partials
    add exactly.
    """
    if qa.device.type == "cpu":
        return dyn_gemm_plain(qa, qb, sa, rs, sb, zb, bits=bits, c=c)
    m, kdim = qa.shape
    n = qb.shape[0]
    f32 = (torch.float32,)
    _check_gemm("dyn_gemm", [
        (qa, (torch.int8,), (m, kdim)), _payload_spec(qb, bits, n, kdim),
        (sa, f32, (m,)), (rs, f32, (m,)), (sb, f32, (n,)), (zb, f32, (n,)),
        (c, f32, (m, n))], aligned=(qa, qb))
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    bm, splits = tile or dyn_tile(m, n, kdim, _sm_count(qa.device), bits)
    rc = _build.kernel_function("mfa_dyn_gemm", _DYN_ARGS)(
        qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), rs.data_ptr(),
        sb.data_ptr(), zb.data_ptr(), None if c is None else c.data_ptr(),
        out.data_ptr(), m, n, kdim, bits, bm, splits,
        torch.cuda.current_stream(qa.device).cuda_stream,
    )
    _build.check_launch(rc, "dyn_gemm")
    dyn_gemm.launches += 1
    return out


dyn_gemm.launches = 0


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def _operands(a: torch.Tensor, b_t: QuantizedTensor,
              c: Optional[torch.Tensor]):
    if a.dim() != 2:
        raise ValueError(f"A must be [M, K], got {tuple(a.shape)}")
    _check_weight(b_t, a.shape[1])
    if c is not None:
        if tuple(c.shape) != (a.shape[0], b_t.shape[0]):
            raise ValueError(f"c must be [M, N], got {tuple(c.shape)}")
        c = c.float().contiguous()
    qa, sa, rs = quantize_rows(a)
    sb, zb = weight_scales(b_t)
    return (qa, b_t.data, sa, rs, sb, zb), dict(bits=b_t.config.bits, c=c)


def dynamic_quantized_matmul_plain(
    a: torch.Tensor,
    b_t: QuantizedTensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`dynamic_quantized_matmul`."""
    args, kw = _operands(a, b_t, c)
    return dyn_gemm_plain(*args, **kw).to(out_dtype or torch.float32)


def dynamic_quantized_matmul(
    a: torch.Tensor,
    b_t: QuantizedTensor,
    *,
    block_m: int = 512,
    block_n: int = 512,
    block_k: int = 1024,
    out_dtype: Optional[torch.dtype] = None,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dynamic W8A8 / W4A8 GEMM: float A [M, K] × quantized Bᵀ [N, K] →
    [M, N] in ``out_dtype`` (default fp32).

    ``c``: optional [M, N] added in fp32 in the epilogue.  The JAX
    package's ``block_m/n/k`` are TPU tiles, accepted and unused: the CUDA
    kernel chooses its own.
    """
    del block_m, block_n, block_k
    args, kw = _operands(a, b_t, c)
    return dyn_gemm(*args, **kw).to(out_dtype or torch.float32)


# ---------------------------------------------------------------------------
# Weight-only GEMMs: the kernels, their plain versions, quantized_matmul
# ---------------------------------------------------------------------------


def _payload_ints(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The payload [N, K] int8 or group-planar [N, K/2] uint8 as fp32
    integers [N, K]."""
    return (unpack_int4(w) if bits == 4 else w).float()


def _wo_out_type(name: str, out_dtype: torch.dtype) -> int:
    if out_dtype not in WO_OUT_TYPES:
        raise TypeError(f"{name}: the kernel stores {list(WO_OUT_TYPES)}, "
                        f"not {out_dtype}")
    return WO_OUT_TYPES[out_dtype]


def wo_tile(m: int, n: int, kdim: int, sms: int,
            bits: int = 8) -> Tuple[int, int]:
    """(rows of ``wo_tc_kernel``'s BM × 128 tile, K splits) for [M, N] over
    K of a ``bits`` weight: the plan ``AttentionTuner.calibrate_gemm``
    stored for this GEMM (``attention.tuning.stored_gemm_plan``, one
    in-memory lookup), else :func:`wo_shape_tile`'s."""
    from metal_flash_attention_plus_tpu_torch.attention.tuning import (
        stored_gemm_plan,
    )

    stored = stored_gemm_plan(m, n, kdim, bits, "weight_only")
    return stored if stored is not None else wo_shape_tile(m, n, kdim, sms)


def wo_shape_tile(m: int, n: int, kdim: int, sms: int) -> Tuple[int, int]:
    """(rows of ``wo_tc_kernel``'s BM × 128 tile, K splits) for [M, N]
    over K on a card of ``sms`` SMs: 128-row tiles where they give every SM
    a CTA (MLA's decompression: 256 tiles in one wave of two CTAs an SM
    beat 512 of 64 rows in two); else (a small M: the GEMM bench's M = 128)
    128-row tiles where M > 64, so the weight is read and dequantized once,
    and K split into as many contiguous step ranges (≤ 16, each ≥ 8 steps
    of 32) as keep to two CTAs for each SM, their fp32 sums added in order
    by ``wo_reduce_kernel`` (``utils/profiling.py --wo-tiles`` times the
    alternatives)."""
    cols = -(-n // 128)
    if -(-m // 128) * cols >= sms:
        return 128, 1
    bm = 128 if m > 64 else 64
    tiles = -(-m // bm) * cols
    return bm, max(1, min(2 * sms // tiles, 16, -(-kdim // 32) // 8))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _wo_launch(name, a, m, n, kdim, bits, otype, tile, fn_args, argtypes):
    """Launch ``mfa_<name>`` on ``fn_args`` (its arguments before the out
    type), with the out type, the tile, K splits and workspace of ``tile``
    or else :func:`wo_tile` (64 and 1 for an fp32 A), on the current
    stream."""
    if a.dtype != torch.bfloat16:
        bm, splits = 64, 1
    else:
        bm, splits = tile or wo_tile(m, n, kdim, _sm_count(a.device), bits)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    rc = _build.kernel_function(f"mfa_{name}", argtypes)(
        *fn_args, otype, bm, splits, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(rc, name)


def wo_folded_gemm_plain(a, w, scale, *, bits: int,
                         c: Optional[torch.Tensor] = None,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`wo_folded_gemm`: exact bf16 × int
    products summed in fp32, then × the scale, then + C, rounded once to
    ``out_dtype``."""
    r = (a.to(torch.bfloat16).float() @ _payload_ints(w, bits).t()) * scale
    return (r if c is None else r + c.float()).to(out_dtype)


def wo_gemm_body(a_dtype: torch.dtype) -> str:
    """Which tile of ``csrc/quantized_gemm.cu`` a weight-only kernel runs
    for an A of ``a_dtype`` (the A :func:`wo_arguments` hands it):
    "tensor_core" (``wo_tc_kernel``: bf16 mma.sync) for bf16, which is
    every :func:`wo_folded_gemm` call (its A is always bf16) and a
    :func:`wo_gemm` call in bf16; "fp32_fma" (``wo_kernel``'s scalar tile)
    for an fp32 A, whose gate TF32 would break.  The C interface routes
    the same way (``mfa_wo_tc_body``)."""
    return "tensor_core" if a_dtype == torch.bfloat16 else "fp32_fma"


def wo_folded_gemm(a, w, scale, *, bits: int,
                   c: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32,
                   tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The folded weight-only kernel → [M, N] in ``out_dtype``:
    ``(A·Wᵀ)·s[n] (+ C)``, rounded once.

    a bf16 [M, K]; w int8 [N, K] (bits 8) or group-planar uint8 [N, K/2]
    (bits 4, K % 256 == 0); scale fp32 [N] (a TENSOR scale repeated);
    c fp32 [M, N] or None; ``out_dtype`` one of :data:`WO_OUT_TYPES`.  CPU
    tensors take :func:`wo_folded_gemm_plain`; CUDA tensors launch the
    folded instances of ``wo_tc_kernel`` (bf16 mma.sync over the integer
    weights as bf16, each 32-product tensor-core sum added in fp32, the
    column's scale at the store; tile and K splits of ``tile`` or else
    :func:`wo_tile`; :func:`wo_gemm_body`) or raise.
    """
    if a.device.type == "cpu":
        return wo_folded_gemm_plain(a, w, scale, bits=bits, c=c,
                                    out_dtype=out_dtype)
    m, kdim = a.shape
    n = w.shape[0]
    otype = _wo_out_type("wo_folded_gemm", out_dtype)
    f32 = (torch.float32,)
    _check_gemm("wo_folded_gemm", [
        (a, (torch.bfloat16,), (m, kdim)), _payload_spec(w, bits, n, kdim),
        (scale, f32, (n,)), (c, f32, (m, n))])
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _wo_launch("wo_folded_gemm", a, m, n, kdim, bits, otype, tile, (
        a.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if c is None else c.data_ptr(), out.data_ptr(), m, n, kdim,
        bits), _WO_FOLDED_ARGS)
    wo_folded_gemm.launches += 1
    return out


wo_folded_gemm.launches = 0


def _cells(scales: int, n: int, kdim: int):
    """(view of the dequantized weight's scale cells, their count) for
    TENSOR (one), ROW (per n) or BLOCK (per k) scales."""
    return ((1, 1), 1) if scales == 0 else (
        ((n, 1), n) if scales == 1 else ((1, kdim), kdim))


def wo_gemm_plain(a, w, scale, zp, *, bits: int, scales: int,
                  c: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`wo_gemm`: ``(q − zp)·s`` in fp32
    rounded to the compute dtype, A in it, the product summed in fp32,
    then + C, rounded once to ``out_dtype``."""
    cd = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
    n, kdim = w.shape[0], a.shape[1]
    view, _ = _cells(scales, n, kdim)
    deq = ((_payload_ints(w, bits) - zp.reshape(view)) * scale.reshape(view))
    acc = a.to(cd).float() @ deq.to(cd).float().t()
    return (acc if c is None else acc + c.float()).to(out_dtype)


def wo_gemm(a, w, scale, zp, *, bits: int, scales: int,
            c: Optional[torch.Tensor] = None,
            out_dtype: torch.dtype = torch.float32,
            tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The dequant-on-load weight-only kernel → [M, N] in ``out_dtype``:
    ``A·round_cd((q − zp)·s)ᵀ (+ C)``, rounded once.

    a fp32 or bf16 [M, K] (its dtype is the compute dtype); w as for
    :func:`wo_folded_gemm`; ``scales`` 0 (TENSOR: scale, zp fp32 [1]),
    1 (ROW: [N]) or 2 (BLOCK, per element: [K]); c fp32 [M, N] or None;
    ``out_dtype`` one of :data:`WO_OUT_TYPES`.  CPU tensors take
    :func:`wo_gemm_plain`; CUDA tensors launch ``wo_tc_kernel`` (bf16 A; the
    tile and K splits of ``tile`` or else :func:`wo_tile`) or
    ``wo_kernel`` (fp32 A; :func:`wo_gemm_body`) or raise.
    """
    if a.device.type == "cpu":
        return wo_gemm_plain(a, w, scale, zp, bits=bits, scales=scales, c=c,
                             out_dtype=out_dtype)
    m, kdim = a.shape
    n = w.shape[0]
    if scales not in (0, 1, 2):
        raise ValueError(f"wo_gemm: scales {scales} is not 0, 1 or 2")
    otype = _wo_out_type("wo_gemm", out_dtype)
    _, cells = _cells(scales, n, kdim)
    f32 = (torch.float32,)
    _check_gemm("wo_gemm", [
        (a, (torch.float32, torch.bfloat16), (m, kdim)),
        _payload_spec(w, bits, n, kdim), (scale, f32, (cells,)),
        (zp, f32, (cells,)), (c, f32, (m, n))])
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _wo_launch("wo_gemm", a, m, n, kdim, bits, otype, tile, (
        a.data_ptr(), w.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        None if c is None else c.data_ptr(), out.data_ptr(), m, n, kdim,
        bits, scales, int(a.dtype == torch.bfloat16)), _WO_ARGS)
    wo_gemm.launches += 1
    return out


wo_gemm.launches = 0


def wo_arguments(a: torch.Tensor, b_t: QuantizedTensor,
                 c: Optional[torch.Tensor] = None):
    """The JAX dispatch of :func:`quantized_matmul` → (folded, args, kw):
    ``wo_folded_gemm(*args, **kw)`` when ``folded``, else
    ``wo_gemm(*args, **kw)`` (and their plain versions on the same
    arguments), fp32 out unless :func:`wo_call` says otherwise."""
    if a.dim() != 2 or len(b_t.shape) != 2 or a.shape[1] != b_t.shape[1]:
        raise ValueError(f"A {tuple(a.shape)} and Bᵀ {tuple(b_t.shape)} do "
                         "not match")
    m, kdim = a.shape
    n = b_t.shape[0]
    cfg = b_t.config
    g = cfg.granularity
    if g == QuantGranularity.BLOCK and kdim % cfg.block_size:
        raise ValueError(f"K={kdim} is not a multiple of the block size "
                         f"{cfg.block_size}")
    if cfg.bits == 4 and kdim % INT4_GROUP:
        raise ValueError(
            f"int4 kernel path requires K % 256 == 0 (got K={kdim}); "
            "dequantize explicitly for ragged K")
    if c is not None:
        if tuple(c.shape) != (m, n):
            raise ValueError(f"c must be [M, N], got {tuple(c.shape)}")
        c = c.float().contiguous()
    if (cfg.strategy == QuantStrategy.SYMMETRIC
            and g in (QuantGranularity.TENSOR, QuantGranularity.ROW)
            and a.dtype != torch.float32):
        scale = b_t.scale.reshape(-1).float().expand(n).contiguous()
        args = (a.to(torch.bfloat16).contiguous(), b_t.data, scale)
        return True, args, dict(bits=cfg.bits, c=c)
    if g not in WO_SCALES:
        raise NotImplementedError(g)
    scale = b_t.scale.reshape(-1).float()
    zp = b_t.zero_point.reshape(-1).float()
    if g == QuantGranularity.BLOCK:  # per K-block → per element [K]
        scale = scale.repeat_interleave(cfg.block_size)
        zp = zp.repeat_interleave(cfg.block_size)
    a_c = a if a.dtype == torch.float32 else a.to(torch.bfloat16)
    args = (a_c.contiguous(), b_t.data, scale.contiguous(), zp.contiguous())
    return False, args, dict(bits=cfg.bits, scales=WO_SCALES[g], c=c)


def wo_call(folded: bool, args, kw, out_dtype: torch.dtype) -> torch.Tensor:
    """The weight-only kernel of :func:`wo_arguments`' dispatch, storing
    ``out_dtype`` itself where it is one of :data:`WO_OUT_TYPES` (else fp32,
    then cast): :func:`quantized_matmul`'s one launch."""
    store = out_dtype if out_dtype in WO_OUT_TYPES else torch.float32
    out = (wo_folded_gemm if folded else wo_gemm)(*args, **kw,
                                                  out_dtype=store)
    return out.to(out_dtype)


def quantized_matmul(
    a: torch.Tensor,
    b_t: QuantizedTensor,
    *,
    block_m: int = 512,
    block_n: int = 512,
    block_k: int = 512,
    out_dtype: Optional[torch.dtype] = None,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A [M, K] (bf16/fp32) × dequant(Bᵀ [N, K]) → [M, N] in ``out_dtype``
    (default A's dtype).

    With SYMMETRIC TENSOR / ROW weight scales and a non-fp32 A the folded
    kernel runs (A in bf16 times the integer weights, the scales once on
    the accumulator); otherwise the weights are dequantized per tile, with
    TENSOR, ROW or BLOCK scales.  ``c``: an optional [M, N] added in fp32
    at the store (unscaled).  The kernel stores ``out_dtype`` itself,
    rounded once from the fp32 result (:func:`wo_call`).  int4 weights need
    K % 256 == 0.  The JAX package's ``block_m/n/k`` are TPU tiles,
    accepted and unused: the CUDA kernels choose their own.
    """
    del block_m, block_n, block_k
    folded, args, kw = wo_arguments(a, b_t, c)
    return wo_call(folded, args, kw, out_dtype or a.dtype)


# ---------------------------------------------------------------------------
# Quantized A × float B: the kernels, their plain versions,
# quantized_matmul_qa
# ---------------------------------------------------------------------------


_QA_FOLDED_ARGS = [_PTR] * 4 + [_I32] * 4 + [_PTR]
_QA_ARGS = [_PTR] * 5 + [_I32] * 6 + [_PTR]


def qa_folded_gemm_plain(a, b, scale, *, bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`qa_folded_gemm`: exact int × bf16
    products summed in fp32, then × the row scale."""
    with exact_fp32():
        return (_payload_ints(a, bits) @ b.float()) * scale[:, None]


def qa_folded_gemm(a, b, scale, *, bits: int) -> torch.Tensor:
    """The folded quantized-A kernel → fp32 [M, N]: ``(A·B)·s[m]``.

    a int8 [M, K] (bits 8) or group-planar uint8 [M, K/2] (bits 4, K % 256
    == 0); b bf16 [K, N]; scale fp32 [M] (a TENSOR scale repeated).  CPU
    tensors take :func:`qa_folded_gemm_plain`; CUDA tensors launch the
    folded instances of ``qa_tc_kernel`` (bf16 mma.sync over A's integers
    as bf16, each 32-product tensor-core sum added in fp32, the row's scale
    at the store; :func:`qa_gemm_body`) or raise."""
    if a.device.type == "cpu":
        return qa_folded_gemm_plain(a, b, scale, bits=bits)
    m, kdim, n = a.shape[0], b.shape[0], b.shape[1]
    _check_gemm("qa_folded_gemm", [
        _payload_spec(a, bits, m, kdim), (b, (torch.bfloat16,), (kdim, n)),
        (scale, (torch.float32,), (m,))])
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = _build.kernel_function("mfa_qa_folded_gemm", _QA_FOLDED_ARGS)(
        a.data_ptr(), b.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n,
        kdim, bits, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(rc, "qa_folded_gemm")
    qa_folded_gemm.launches += 1
    return out


qa_folded_gemm.launches = 0


def qa_gemm_plain(a, b, scale, zp, *, bits: int,
                  scales: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`qa_gemm`: ``(q − zp)·s`` in fp32
    rounded to B's dtype (the compute dtype), the product summed in fp32."""
    m, kdim = a.shape[0], b.shape[0]
    view, _ = _cells(scales, m, kdim)
    deq = (_payload_ints(a, bits) - zp.reshape(view)) * scale.reshape(view)
    with exact_fp32():
        return deq.to(b.dtype).float() @ b.float()


def qa_gemm_body(b_dtype: torch.dtype) -> str:
    """Which tile of ``csrc/quantized_gemm.cu`` a quantized-A kernel runs
    for a B of ``b_dtype`` (the B :func:`qa_arguments` hands it):
    "tensor_core" (``qa_tc_kernel``: bf16 mma.sync) for bf16, which is
    every :func:`qa_folded_gemm` call (its B is always bf16) and a
    :func:`qa_gemm` call in bf16; "fp32_fma" (``qa_kernel``'s scalar tile)
    for an fp32 B, whose gate TF32 would break.  The C interface routes
    the same way."""
    return "tensor_core" if b_dtype == torch.bfloat16 else "fp32_fma"


def qa_gemm(a, b, scale, zp, *, bits: int, scales: int) -> torch.Tensor:
    """The dequant-on-load quantized-A kernel → fp32 [M, N]:
    ``round_cd((q − zp)·s)·B``.

    a as for :func:`qa_folded_gemm`; b fp32 or bf16 [K, N] (its dtype is
    the compute dtype); ``scales`` 0 (TENSOR: scale, zp fp32 [1]), 1 (ROW,
    per row of A: [M]) or 2 (BLOCK, per element of K: [K]).  CPU tensors
    take :func:`qa_gemm_plain`; CUDA tensors launch ``qa_tc_kernel`` (bf16
    B) or ``qa_kernel`` (fp32 B; :func:`qa_gemm_body`) or raise."""
    if a.device.type == "cpu":
        return qa_gemm_plain(a, b, scale, zp, bits=bits, scales=scales)
    m, kdim, n = a.shape[0], b.shape[0], b.shape[1]
    if scales not in (0, 1, 2):
        raise ValueError(f"qa_gemm: scales {scales} is not 0, 1 or 2")
    _, cells = _cells(scales, m, kdim)
    _check_gemm("qa_gemm", [
        _payload_spec(a, bits, m, kdim),
        (b, (torch.float32, torch.bfloat16), (kdim, n)),
        (scale, (torch.float32,), (cells,)), (zp, (torch.float32,), (cells,))])
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = _build.kernel_function("mfa_qa_gemm", _QA_ARGS)(
        a.data_ptr(), b.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        out.data_ptr(), m, n, kdim, bits, scales,
        int(b.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(rc, "qa_gemm")
    qa_gemm.launches += 1
    return out


qa_gemm.launches = 0


def qa_arguments(a_q: QuantizedTensor, b: torch.Tensor):
    """The JAX dispatch of :func:`quantized_matmul_qa` → (folded, args, kw):
    ``qa_folded_gemm(*args, **kw)`` when ``folded``, else
    ``qa_gemm(*args, **kw)`` (and their plain versions on the same
    arguments)."""
    if len(a_q.shape) != 2 or b.dim() != 2 or a_q.shape[1] != b.shape[0]:
        raise ValueError(f"A {tuple(a_q.shape)} and B {tuple(b.shape)} do "
                         "not match")
    m, kdim = a_q.shape
    cfg = a_q.config
    g = cfg.granularity
    if g == QuantGranularity.BLOCK and kdim % cfg.block_size:
        raise ValueError(f"K={kdim} is not a multiple of the block size "
                         f"{cfg.block_size}")
    if cfg.bits == 4 and kdim % INT4_GROUP:
        raise ValueError(
            f"int4 kernel path requires K % 256 == 0 (got K={kdim}); "
            "dequantize explicitly for ragged K")
    if (cfg.strategy == QuantStrategy.SYMMETRIC
            and g in (QuantGranularity.TENSOR, QuantGranularity.ROW)
            and b.dtype != torch.float32):
        # B is rounded to bf16 whatever its float dtype, as in the JAX
        # kernel's call.
        scale = a_q.scale.reshape(-1).float().expand(m).contiguous()
        args = (a_q.data, b.to(torch.bfloat16).contiguous(), scale)
        return True, args, dict(bits=cfg.bits)
    if g not in WO_SCALES:
        raise NotImplementedError(g)
    scale = a_q.scale.reshape(-1).float()
    zp = a_q.zero_point.reshape(-1).float()
    if g == QuantGranularity.BLOCK:  # per K-block → per element [K]
        scale = scale.repeat_interleave(cfg.block_size)
        zp = zp.repeat_interleave(cfg.block_size)
    cd = torch.float32 if b.dtype == torch.float32 else torch.bfloat16
    args = (a_q.data, b.to(cd).contiguous(), scale.contiguous(),
            zp.contiguous())
    return False, args, dict(bits=cfg.bits, scales=WO_SCALES[g])


def quantized_matmul_qa(
    a_q: QuantizedTensor,
    b: torch.Tensor,
    *,
    block_m: int = 512,
    block_n: int = 512,
    block_k: int = 512,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """dequant(A [M, K]) × B [K, N] (bf16/fp16/fp32) → [M, N] in
    ``out_dtype`` (default B's dtype).

    The quantized-activation orientation of :func:`quantized_matmul`.  With
    SYMMETRIC TENSOR / ROW scales (ROW: per row of A) and a non-fp32 B the
    folded kernel runs (the integers times B in bf16, the scales once on
    the accumulator's rows); otherwise A is dequantized per tile with
    TENSOR, ROW or BLOCK scales in B's precision (bf16 unless B is fp32).
    int4 A needs K % 256 == 0.  ``block_m/n/k`` are the TPU's tiles,
    accepted and unused."""
    del block_m, block_n, block_k
    folded, args, kw = qa_arguments(a_q, b)
    out = (qa_folded_gemm if folded else qa_gemm)(*args, **kw)
    return out.to(out_dtype or b.dtype)


# ---------------------------------------------------------------------------
# Both operands int8, BLOCK along K: the compensated GEMMs
# ---------------------------------------------------------------------------

_COMP_ARGS = [_PTR] * 10 + [_I32] * 4 + [_PTR]
_COMP_SMALL_TC_ARGS = [_PTR] * 10 + [_I32] * 6 + [_PTR]
_COMP_SMALL_ARGS = [_PTR] * 8 + [_I32] * 3 + [_PTR]


def per_row_block_sums(qt: QuantizedTensor) -> torch.Tensor:
    """Per-row per-K-block Σq, the compensation's SqA / SqB: payload
    [..., K] → int32 [..., K/bs]."""
    q = unpack_int4(qt.data) if qt.bits == 4 else qt.data
    k, bs = qt.shape[-1], qt.config.block_size
    q = q.reshape(*qt.shape[:-1], k // bs, bs)
    return q.sum(dim=-1, dtype=torch.int32)


def _int_product(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int64 a·b_tᵀ of two int8 matrices: int64 on the CPU; on a card
    (no integer matmul) in float64, exact below 2⁵³."""
    if a.device.type == "cpu":
        return a.long() @ b_t.long().t()
    return (a.double() @ b_t.double().t()).long()


def comp_gemm_plain(qa, qb, sa, za, sb, zb, sqa, sqb, *, bs: int,
                    c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`comp_gemm`, bit for bit: per block
    the exact integer compensation, rounded to fp32, then
    ``acc = fma(s_a·s_b, comp, acc)`` (the fused multiply-add XLA gives the
    JAX kernel), then + C."""
    m, n = qa.shape[0], qb.shape[0]
    acc = torch.zeros((m, n), dtype=torch.float32, device=qa.device)
    za, zb = za.long(), zb.long()
    for i in range(qa.shape[1] // bs):
        blk = slice(i * bs, (i + 1) * bs)
        comp = (_int_product(qa[:, blk], qb[:, blk])
                - zb[i] * sqa[:, i:i + 1].long()
                - za[i] * sqb[:, i].long()[None, :]
                + bs * za[i] * zb[i]).float()
        acc = fma32((sa[i] * sb[i]).expand_as(comp), comp, acc)
    return acc if c is None else acc + c.float()


def comp_gemm(qa, qb, sa, za, sb, zb, sqa, sqb, *, bs: int,
              c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The compensated int8 × int8 kernel → fp32 [M, N]:
    ``Σ_b s_a·s_b·(Sqq − z_b·SqA − z_a·SqB + bs·z_a·z_b) (+ C)``.

    qa int8 [M, K]; qb int8 [N, K] (Bᵀ); ``bs`` the K-block, a multiple of
    128 dividing K; sa, sb fp32 [K/bs]; za, zb int32 [K/bs]; sqa, sqb the
    int32 block sums [M, K/bs], [N, K/bs]; c fp32 [M, N] or None.  CPU
    tensors take :func:`comp_gemm_plain`; CUDA tensors launch
    ``comp_tc_kernel`` (the int8 products on the s8 tensor cores, K
    unsplit, bit for bit with the plain version) or raise."""
    if qa.device.type == "cpu":
        return comp_gemm_plain(qa, qb, sa, za, sb, zb, sqa, sqb, bs=bs, c=c)
    m, kdim = qa.shape
    n = qb.shape[0]
    if bs <= 0 or bs % 128 or kdim % bs:
        raise ValueError(f"comp_gemm: block {bs} is not a multiple of 128 "
                         f"dividing K={kdim}")
    nb = kdim // bs
    i32, f32 = (torch.int32,), (torch.float32,)
    _check_gemm("comp_gemm", [
        (qa, (torch.int8,), (m, kdim)), (qb, (torch.int8,), (n, kdim)),
        (sa, f32, (nb,)), (za, i32, (nb,)), (sb, f32, (nb,)),
        (zb, i32, (nb,)), (sqa, i32, (m, nb)), (sqb, i32, (n, nb)),
        (c, f32, (m, n))], aligned=(qa, qb))
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    rc = _build.kernel_function("mfa_comp_gemm", _COMP_ARGS)(
        qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), za.data_ptr(),
        sb.data_ptr(), zb.data_ptr(), sqa.data_ptr(), sqb.data_ptr(),
        None if c is None else c.data_ptr(), out.data_ptr(), m, n, kdim, bs,
        torch.cuda.current_stream(qa.device).cuda_stream)
    _build.check_launch(rc, "comp_gemm")
    comp_gemm.launches += 1
    return out


comp_gemm.launches = 0


def small_block_tile(bs: int, kdim: int) -> int:
    """The JAX small-block arm's K tile: a multiple of 128 and of ``bs``
    (the smallest), times as many as fit in min(512, K)."""
    base = 128
    while base % bs:
        base += 128
    return base * max(1, min(512, kdim) // base)


def _block_vectors(s, z, bs: int):
    """Per-block scales s fp32 and zero points z int32 [K/bs] → the
    per-element fp32 (s, z·s) [K] of the small-block dequantization."""
    return (s.repeat_interleave(bs).contiguous(),
            (z.float() * s).repeat_interleave(bs).contiguous())


def comp_small_gemm_plain(qa, qb, sa, za, sb, zb, sqa, sqb, *, bs: int,
                          c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`comp_small_gemm`, the JAX kernel's
    numerics (``sqa``, ``sqb`` unread): each operand ``fma(q, s, −z·s)``
    in fp32 (the fused multiply-add XLA gives the JAX kernel), exact fp32
    products summed per K tile of :func:`small_block_tile` in the JAX
    kernel's order, then + C."""
    del sqa, sqb
    (sa, zsa), (sb, zsb) = _block_vectors(sa, za, bs), _block_vectors(
        sb, zb, bs)
    a = fma32(qa.float(), sa.expand(qa.shape), -zsa.expand(qa.shape))
    b = fma32(qb.float(), sb.expand(qb.shape), -zsb.expand(qb.shape))
    kdim = qa.shape[1]
    bk = small_block_tile(bs, kdim)
    acc = torch.zeros((qa.shape[0], qb.shape[0]), dtype=torch.float32,
                      device=qa.device)
    with exact_fp32():
        for k0 in range(0, kdim, bk):
            acc = acc + a[:, k0:k0 + bk] @ b[:, k0:k0 + bk].t()
    return acc if c is None else acc + c.float()


def comp_small_body(bs: int) -> str:
    """Which kernel :func:`comp_small_gemm` launches for a block of ``bs``:
    "tensor_core" (``comp_tc_kernel``: s8 m16n8k32 products for a
    multiple of 32, m16n8k16 for 16, 48, 80, ..., the compensation per
    block) for a multiple of 16; "scalar" (``comp_small_kernel``: per-
    element dequantization, exact fp32 products) for the other multiples
    of 8 that ``QuantConfig`` takes.  By configuration only: no failure
    moves a call from one to the other.  The C interface routes the same
    way (``mfa_comp_small_body``)."""
    return "tensor_core" if bs % 16 == 0 else "scalar"


def comp_small_tile(m: int, n: int, kdim: int, bs: int,
                    sms: int) -> Tuple[int, int]:
    """(tile rows, K splits) of ``comp_tc_kernel`` (:func:`_s8_tile`
    over K's units of lcm(bs, 128), which no block straddles; splits up to
    two CTAs for each SM): gemm_bench's M = 4096 takes 128-row tiles, its
    M = 128 64-row tiles with K split in two."""
    step = bs // math.gcd(bs, 128)
    return _s8_tile(m, n, -(-(-(-kdim // 128)) // step), 2, sms)


def comp_small_gemm(qa, qb, sa, za, sb, zb, sqa, sqb, *, bs: int,
                    c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The small-block compensated kernel (blocks not a multiple of 128) →
    fp32 [M, N], with :func:`comp_gemm`'s arguments.

    qa int8 [M, K]; qb int8 [N, K] (Bᵀ); ``bs`` the K-block, dividing K;
    sa, sb fp32 [K/bs]; za, zb int32 [K/bs]; sqa, sqb the int32 block sums
    [M, K/bs], [N, K/bs] (None for the scalar route, which reads none); c
    fp32 [M, N] or None.  CPU tensors take :func:`comp_small_gemm_plain`;
    CUDA tensors launch the kernel of :func:`comp_small_body`
    (``comp_tc_kernel``: integer block
    products and the compensation per block, tile and K splits of
    :func:`comp_small_tile`; ``comp_small_kernel``: both operands
    dequantized per element, exact fp32 products) or raise."""
    if qa.device.type == "cpu":
        return comp_small_gemm_plain(qa, qb, sa, za, sb, zb, sqa, sqb, bs=bs,
                                     c=c)
    m, kdim = qa.shape
    n = qb.shape[0]
    if bs <= 0 or kdim % bs:
        raise ValueError(f"comp_small_gemm: block {bs} does not divide "
                         f"K={kdim}")
    nb = kdim // bs
    i32, f32 = (torch.int32,), (torch.float32,)
    _check_gemm("comp_small_gemm", [
        (qa, (torch.int8,), (m, kdim)), (qb, (torch.int8,), (n, kdim)),
        (sa, f32, (nb,)), (za, i32, (nb,)), (sb, f32, (nb,)),
        (zb, i32, (nb,)), (sqa, i32, (m, nb)), (sqb, i32, (n, nb)),
        (c, f32, (m, n))])
    tc = comp_small_body(bs) == "tensor_core"
    if tc and (sqa is None or sqb is None):
        raise ValueError("comp_small_gemm: the tensor-core route needs the "
                         "block sums sqa, sqb")
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    stream = torch.cuda.current_stream(qa.device).cuda_stream
    cp = None if c is None else c.data_ptr()
    if tc:
        bm, splits = comp_small_tile(m, n, kdim, bs, _sm_count(qa.device))
        rc = _build.kernel_function("mfa_comp_small_tc_gemm",
                                    _COMP_SMALL_TC_ARGS)(
            qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), za.data_ptr(),
            sb.data_ptr(), zb.data_ptr(), sqa.data_ptr(), sqb.data_ptr(), cp,
            out.data_ptr(), m, n, kdim, bs, bm, splits, stream)
    else:
        (s_a, zs_a), (s_b, zs_b) = (_block_vectors(sa, za, bs),
                                    _block_vectors(sb, zb, bs))
        rc = _build.kernel_function("mfa_comp_small_gemm", _COMP_SMALL_ARGS)(
            qa.data_ptr(), qb.data_ptr(), s_a.data_ptr(), zs_a.data_ptr(),
            s_b.data_ptr(), zs_b.data_ptr(), cp, out.data_ptr(), m, n, kdim,
            stream)
    _build.check_launch(rc, "comp_small_gemm")
    comp_small_gemm.launches += 1
    return out


comp_small_gemm.launches = 0


def comp_arguments(a: QuantizedTensor, b_t: QuantizedTensor,
                   c: Optional[torch.Tensor] = None):
    """The JAX dispatch of :func:`compensated_matmul` → (small, args, kw):
    ``comp_small_gemm(*args, **kw)`` when ``small`` (a block size not a
    multiple of 128), else ``comp_gemm(*args, **kw)`` (and their plain
    versions on the same arguments), both with the per-block scales, int32
    zero points and :func:`per_row_block_sums` (a read of both payloads:
    None in their place where :func:`comp_small_body` sends the block to
    the scalar tile, which reads no sums).  Raises where the JAX package
    asserts: int8 × int8, BLOCK granularity, one block size, one K."""
    ca, cb = a.config, b_t.config
    if a.bits != 8 or b_t.bits != 8:
        raise ValueError("compensated path is int8×int8")
    if (ca.granularity != QuantGranularity.BLOCK
            or cb.granularity != QuantGranularity.BLOCK):
        raise ValueError("compensated path needs BLOCK granularity")
    bs = ca.block_size
    if bs != cb.block_size:
        raise ValueError("operand block sizes must match")
    if (len(a.shape) != 2 or len(b_t.shape) != 2 or a.shape[1] != b_t.shape[1]
            or a.shape[1] % bs):
        raise ValueError(f"A {tuple(a.shape)} and Bᵀ {tuple(b_t.shape)} do "
                         f"not share a K of whole {bs}-blocks")
    if c is not None:
        if tuple(c.shape) != (a.shape[0], b_t.shape[0]):
            raise ValueError(f"c must be [M, N], got {tuple(c.shape)}")
        c = c.float().contiguous()
    nb = a.shape[1] // bs

    def params(t):
        return (t.scale.reshape(nb).float().contiguous(),
                t.zero_point.reshape(nb).to(torch.int32).contiguous())

    (sa, za), (sb, zb) = params(a), params(b_t)
    small = bool(bs % 128)
    sums = ((None, None) if small and comp_small_body(bs) == "scalar"
            else (per_row_block_sums(a), per_row_block_sums(b_t)))
    return small, (a.data, b_t.data, sa, za, sb, zb, *sums), dict(bs=bs, c=c)


def compensated_matmul(
    a: QuantizedTensor,
    b_t: QuantizedTensor,
    *,
    block_m: int = 512,
    block_n: int = 512,
    out_dtype: torch.dtype = torch.float32,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int8 A [M, K] × int8 Bᵀ [N, K], both BLOCK along K with one block
    size, with per-block zero-point compensation → [M, N] in ``out_dtype``.

    ``c``: an optional [M, N] added in fp32 at the store.  A block size
    that is a multiple of 128 takes :func:`comp_gemm` (integer block
    products, the compensation per block); others (the reference's 16–64)
    take :func:`comp_small_gemm` (the same for a multiple of 16, exact fp32
    per-element dequantization for the rest).
    ``block_m/n`` are the TPU's tiles, accepted and unused."""
    del block_m, block_n
    small, args, kw = comp_arguments(a, b_t, c)
    out = (comp_small_gemm if small else comp_gemm)(*args, **kw)
    return out.to(out_dtype)

"""Quantized GEMMs: float A [M, K] × quantized Bᵀ [N, K] → [M, N], and the
K/V tile helpers of the quantized attention.

Two entry points of the JAX package's ``ops/quantized_gemm.py``:

- :func:`quantized_matmul`, the weight-only GEMM (A stays float), with the
  JAX dispatch: SYMMETRIC TENSOR / ROW weights and a non-fp32 A take
  :func:`wo_folded_gemm` (``csrc/quantized_gemm.cu::wo_folded_kernel``, the
  TPU's ``_wo_folded_kernel``): A in bf16 times the integer weights, the
  scale on the fp32 accumulator once, then C; every other weight (or an
  fp32 A) takes :func:`wo_gemm` (``wo_kernel``, the TPU's ``_wo_kernel``):
  each weight ``(q − zp)·s`` with TENSOR, ROW or BLOCK (per K-block)
  scales, rounded to the compute dtype (fp32 for an fp32 A, else bf16),
  fp32 accumulation, C added at the store.  Launches are counted in
  ``wo_folded_gemm.launches`` and ``wo_gemm.launches``.
- :func:`dynamic_quantized_matmul`, W8A8 / W4A8, below.

The dynamic GEMM.  A is quantized per row in the wrapper (int8
symmetric, absmax/127, clipped to [-127, 127], and Σq per row), as the JAX
wrapper does outside its kernel; :func:`dyn_gemm` then runs the
integer product and the one-pass epilogue

    out = (float(Σ_k qa·qb) − Σqa·z_b) · (s_a·s_b)  [+ C]

in fp32, in that order, with the roundings of the JAX kernel as XLA runs
it: the subtraction of Σqa·z_b and the addition of C are each one fused
multiply-add.  On a CUDA tensor it launches ``dyn_gemm_kernel``
(``csrc/quantized_gemm.cu``) or raises; on the CPU it runs
:func:`dyn_gemm_plain`.  Its launches are counted in ``dyn_gemm.launches``.

B is a :class:`QuantizedTensor` over ``[N, K]`` with ROW or TENSOR scales,
int8 or group-planar int4 (K % 256 == 0); any strategy, the zero point is
compensated exactly through Σqa.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch import _build
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
_DYN_ARGS = [_PTR] * 8 + [_I32] * 4 + [_PTR]
_WO_FOLDED_ARGS = [_PTR] * 5 + [_I32] * 4 + [_PTR]
_WO_ARGS = [_PTR] * 6 + [_I32] * 6 + [_PTR]
# The weight-only kernel's scale cells (csrc/quantized_gemm.cu::WoScales).
WO_SCALES = {QuantGranularity.TENSOR: 0, QuantGranularity.ROW: 1,
             QuantGranularity.BLOCK: 2}


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
    """(E_r [bkv, bkv/br] or None, E_c [d/bs, d]): the 0/1 fp32 matrices
    that expand per-block values to per-element ones."""
    ec = (torch.arange(d, device=device)[None, :] // block_size
          == torch.arange(d // block_size, device=device)[:, None]).float()
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


def dyn_gemm(qa, qb, sa, rs, sb, zb, *, bits: int,
             c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The integer GEMM with its epilogue → fp32 [M, N].

    qa int8 [M, K]; qb int8 [N, K] (bits 8) or group-planar uint8
    [N, K/2] (bits 4, K % 256 == 0); s_a, Σqa fp32 [M]; s_b, z_b fp32 [N];
    c fp32 [M, N] or None.  CPU tensors take :func:`dyn_gemm_plain`; CUDA
    tensors launch ``dyn_gemm_kernel`` or raise.
    """
    if qa.device.type == "cpu":
        return dyn_gemm_plain(qa, qb, sa, rs, sb, zb, bits=bits, c=c)
    m, kdim = qa.shape
    n = qb.shape[0]
    dev = qa.device
    if dev.type != "cuda":
        raise ValueError(f"dyn_gemm: no kernel for device {dev}")
    if qa.dtype != torch.int8:
        raise TypeError("dyn_gemm: activations must be int8")
    want = (torch.int8, (n, kdim)) if bits == 8 else (
        torch.uint8, (n, kdim // 2))
    if bits not in (8, 4) or (qb.dtype, tuple(qb.shape)) != want:
        raise TypeError(f"dyn_gemm: {bits}-bit weights must be "
                        f"{want[0]} {want[1]}, got {qb.dtype} "
                        f"{tuple(qb.shape)}")
    if bits == 4 and kdim % INT4_GROUP:
        raise ValueError(f"dyn_gemm: int4 needs K % 256 == 0 (got {kdim})")
    for t, size in ((sa, m), (rs, m), (sb, n), (zb, n)):
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise TypeError("dyn_gemm: scales and sums must be fp32 [M] / [N]")
    if c is not None and (c.dtype != torch.float32
                          or tuple(c.shape) != (m, n)):
        raise TypeError("dyn_gemm: c must be fp32 [M, N]")
    tensors = (qa, qb, sa, rs, sb, zb) + (() if c is None else (c,))
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"dyn_gemm: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError("dyn_gemm: tensors must be contiguous")
    if qa.data_ptr() % 16 or qb.data_ptr() % 16:
        raise ValueError("dyn_gemm: int8 operands must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = _build.kernel_function("mfa_dyn_gemm", _DYN_ARGS)(
        qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), rs.data_ptr(),
        sb.data_ptr(), zb.data_ptr(), None if c is None else c.data_ptr(),
        out.data_ptr(), m, n, kdim, bits,
        torch.cuda.current_stream(dev).cuda_stream,
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
    out_dtype: Optional[torch.dtype] = None,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dynamic W8A8 / W4A8 GEMM: float A [M, K] × quantized Bᵀ [N, K] →
    [M, N] in ``out_dtype`` (default fp32).

    ``c``: optional [M, N] added in fp32 in the epilogue.  The JAX
    package's ``block_m/n/k`` are TPU tiles and are not taken: the CUDA
    kernel chooses its own.
    """
    args, kw = _operands(a, b_t, c)
    return dyn_gemm(*args, **kw).to(out_dtype or torch.float32)


# ---------------------------------------------------------------------------
# Weight-only GEMMs: the kernels, their plain versions, quantized_matmul
# ---------------------------------------------------------------------------


def _weight_ints(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The payload [N, K] int8 or group-planar [N, K/2] uint8 as fp32
    integers [N, K]."""
    return (unpack_int4(w) if bits == 4 else w).float()


def _check_wo(name, a, a_dtypes, w, bits, vectors, c):
    """Raise unless the tensors are what the weight-only kernels take: A
    [M, K] in ``a_dtypes``, the payload of ``bits`` for [N, K], each of
    ``vectors`` (tensor, length) fp32 of that length, C fp32 [M, N] or
    None, all contiguous on one CUDA device."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if a.dim() != 2 or a.dtype not in a_dtypes:
        raise TypeError(f"{name}: A must be [M, K] in {a_dtypes}, got "
                        f"{a.dtype} {tuple(a.shape)}")
    m, kdim = a.shape
    n = w.shape[0]
    want = (torch.int8, (n, kdim)) if bits == 8 else (
        torch.uint8, (n, kdim // 2))
    if bits not in (8, 4) or (w.dtype, tuple(w.shape)) != want:
        raise TypeError(f"{name}: {bits}-bit weights must be {want[0]} "
                        f"{want[1]}, got {w.dtype} {tuple(w.shape)}")
    if bits == 4 and kdim % INT4_GROUP:
        raise ValueError(f"{name}: int4 needs K % 256 == 0 (got {kdim})")
    for t, size in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (size,):
            raise TypeError(f"{name}: scales and zero points must be fp32 "
                            f"[{size}]")
    if c is not None and (c.dtype != torch.float32
                          or tuple(c.shape) != (m, n)):
        raise TypeError(f"{name}: c must be fp32 [M, N]")
    for t in (a, w, *(t for t, _ in vectors),
              *(() if c is None else (c,))):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def wo_folded_gemm_plain(a, w, scale, *, bits: int,
                         c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`wo_folded_gemm`: exact bf16 × int
    products summed in fp32, then × the scale, then + C."""
    r = (a.to(torch.bfloat16).float() @ _weight_ints(w, bits).t()) * scale
    return r if c is None else r + c.float()


def wo_folded_gemm(a, w, scale, *, bits: int,
                   c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The folded weight-only kernel → fp32 [M, N]: ``(A·Wᵀ)·s[n] (+ C)``.

    a bf16 [M, K]; w int8 [N, K] (bits 8) or group-planar uint8 [N, K/2]
    (bits 4, K % 256 == 0); scale fp32 [N] (a TENSOR scale repeated);
    c fp32 [M, N] or None.  CPU tensors take :func:`wo_folded_gemm_plain`;
    CUDA tensors launch ``wo_folded_kernel`` or raise.
    """
    if a.device.type == "cpu":
        return wo_folded_gemm_plain(a, w, scale, bits=bits, c=c)
    n = w.shape[0]
    _check_wo("wo_folded_gemm", a, (torch.bfloat16,), w, bits,
              ((scale, n),), c)
    m, kdim = a.shape
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = _build.kernel_function("mfa_wo_folded_gemm", _WO_FOLDED_ARGS)(
        a.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if c is None else c.data_ptr(), out.data_ptr(), m, n, kdim,
        bits, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check_launch(rc, "wo_folded_gemm")
    wo_folded_gemm.launches += 1
    return out


wo_folded_gemm.launches = 0


def _cells(scales: int, n: int, kdim: int):
    """(view of the dequantized weight's scale cells, their count) for
    TENSOR (one), ROW (per n) or BLOCK (per k) scales."""
    return ((1, 1), 1) if scales == 0 else (
        ((n, 1), n) if scales == 1 else ((1, kdim), kdim))


def wo_gemm_plain(a, w, scale, zp, *, bits: int, scales: int,
                  c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`wo_gemm`: ``(q − zp)·s`` in fp32
    rounded to the compute dtype, A in it, the product summed in fp32,
    then + C."""
    cd = torch.float32 if a.dtype == torch.float32 else torch.bfloat16
    n, kdim = w.shape[0], a.shape[1]
    view, _ = _cells(scales, n, kdim)
    deq = ((_weight_ints(w, bits) - zp.reshape(view)) * scale.reshape(view))
    acc = a.to(cd).float() @ deq.to(cd).float().t()
    return acc if c is None else acc + c.float()


def wo_gemm(a, w, scale, zp, *, bits: int, scales: int,
            c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dequant-on-load weight-only kernel → fp32 [M, N]:
    ``A·round_cd((q − zp)·s)ᵀ (+ C)``.

    a fp32 or bf16 [M, K] (its dtype is the compute dtype); w as for
    :func:`wo_folded_gemm`; ``scales`` 0 (TENSOR: scale, zp fp32 [1]),
    1 (ROW: [N]) or 2 (BLOCK, per element: [K]); c fp32 [M, N] or None.
    CPU tensors take :func:`wo_gemm_plain`; CUDA tensors launch
    ``wo_kernel`` or raise.
    """
    if a.device.type == "cpu":
        return wo_gemm_plain(a, w, scale, zp, bits=bits, scales=scales, c=c)
    m, kdim = a.shape
    n = w.shape[0]
    if scales not in (0, 1, 2):
        raise ValueError(f"wo_gemm: scales {scales} is not 0, 1 or 2")
    _, cells = _cells(scales, n, kdim)
    _check_wo("wo_gemm", a, (torch.float32, torch.bfloat16), w, bits,
              ((scale, cells), (zp, cells)), c)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = _build.kernel_function("mfa_wo_gemm", _WO_ARGS)(
        a.data_ptr(), w.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        None if c is None else c.data_ptr(), out.data_ptr(), m, n, kdim,
        bits, scales, int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check_launch(rc, "wo_gemm")
    wo_gemm.launches += 1
    return out


wo_gemm.launches = 0


def wo_arguments(a: torch.Tensor, b_t: QuantizedTensor,
                 c: Optional[torch.Tensor] = None):
    """The JAX dispatch of :func:`quantized_matmul` → (folded, args, kw):
    ``wo_folded_gemm(*args, **kw)`` when ``folded``, else
    ``wo_gemm(*args, **kw)`` (and their plain versions on the same
    arguments)."""
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
    at the store (unscaled).  int4 weights need K % 256 == 0.  The JAX
    package's ``block_m/n/k`` are TPU tiles, accepted and unused: the CUDA
    kernels choose their own.
    """
    del block_m, block_n, block_k
    folded, args, kw = wo_arguments(a, b_t, c)
    out = (wo_folded_gemm if folded else wo_gemm)(*args, **kw)
    return out.to(out_dtype or a.dtype)

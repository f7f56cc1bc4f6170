"""Runtime quantization of a 2-D array in one kernel pass.

The port of the JAX package's ``ops/runtime_quantization.py``: for ROW
granularity (a scale and zero point per row) and BLOCK granularity (per
K-block, statistics shared by every row), one kernel computes the
statistics (absmax, mean, min/max), derives the scale and zero point,
writes the int8 codes and, where asked, Σq per cell.  TENSOR granularity
and inputs that are not 2-D go to :func:`quant.tensor.quantize`, as in
JAX.  int4 codes are packed group-planar by :func:`quant.tensor.pack_int4`
after the kernel.

The two TPU kernels ``_row_kernel`` and ``_block_kernel`` become
``csrc/runtime_quantization.cu``'s ``rtq_row_kernel`` and
``rtq_block_kernel`` behind :func:`rtq_rows` and
:func:`rtq_blocks`; their plain PyTorch versions run for CPU tensors.
Kernel, plain version and the JAX package (as XLA compiles its kernels)
are bit-identical: the constant divisors (qmax, qmax − qmin, a cell's
element count) become multiplies by their fp32 reciprocals, as XLA folds
them; the divisions by a scale (``x / scale``, ``−mean / scale``,
``min / scale``) are IEEE divisions; rounding is half to even (``rintf`` /
``torch.round``); and CENTERED's sum takes one fixed order.  A chunk is
8 consecutive columns of one row (columns past the row's or the block's
end are absent); a lane or thread sums its chunks' columns in order from
0.0, chunk after chunk:

- a row of K columns: n = ceil(K / 8) chunks held by a group of G lanes
  (:func:`row_group`: the power of two >= n, at most 32); lane ``j`` sums
  chunks j, j + G, j + 2G, ...; then the G lanes combine by xor butterfly
  over offsets G/2, ..., 1;
- a block: its [R, block_size] slab split over a cluster of C CTAs
  (:func:`block_cluster`), rank ``r`` taking rows [r·B, min(R, (r+1)·B)),
  B = ceil(R / C); a band's chunks are numbered row-major, ceil(bs / 8)
  to a row, and thread ``t`` of 512 sums chunks t, t + 512, ...; the 512
  sums combine by xor butterfly over offsets 16, ..., 1 in each warp of
  32, the 16 warp sums over offsets 8, ..., 1, and the C band sums add in
  rank order, ((b0 + b1) + b2) + ....

Both orders depend on the shape alone, not on the dtype, so a bf16 input
quantizes as its fp32 values do.  The JAX package sums in XLA's order,
so on data whose sums are not exact the mean, and through it a scale or a
code, may differ in the last bit; on data whose every partial sum is
exact the three agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import stream_of
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    pack_int4,
    quantize,
)

EPS = 1e-12
WARP = 32
CHUNK = 8  # columns a chunk: one 16-byte load in bf16, two in fp32
BLOCK_THREADS = 512  # a block kernel CTA
BLOCK_WARPS = BLOCK_THREADS // WARP
MAX_CLUSTER = 16  # CTAs sharing a block's slab (a non-portable size past 8)
CLUSTER_GRID = 256  # the block kernel's grid: two CTAs on each of 132 SMs
STRATEGY_CODES = {QuantStrategy.SYMMETRIC: 0, QuantStrategy.CENTERED: 1,
                  QuantStrategy.ASYMMETRIC: 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ROW_ARGS = [_PTR] * 5 + [_I32] * 4 + [_F32, _F32, _PTR]
_BLOCK_ARGS = [_PTR] * 5 + [_I32] * 5 + [_F32, _F32, _I32, _PTR]

Codes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


# ---------------------------------------------------------------------------
# The fixed summation orders and the statistics
# ---------------------------------------------------------------------------


def row_group(k: int) -> int:
    """The lanes of a warp that hold one row of ``k`` columns in the row
    kernel: the power of two that covers its ceil(k / 8) chunks, at most
    32 (``csrc/runtime_quantization.cu::row_group``)."""
    n, g = -(-k // CHUNK), 1
    while g < n and g < WARP:
        g *= 2
    return g


def block_cluster(k: int, block_size: int) -> int:
    """The CTAs that share one block's slab in the block kernel: the power
    of two, at most 16, that brings the grid of k / block_size clusters to
    256 CTAs, two on each SM (16 blocks x 16 at bs 64 on K = 1024; 8 x 16
    at bs 128)."""
    nb, c = k // block_size, 1
    while nb * c < CLUSTER_GRID and c < MAX_CLUSTER:
        c *= 2
    return c


def _chunk_sums(chunks: torch.Tensor) -> torch.Tensor:
    """[..., passes, lanes, 8] → [..., lanes]: each lane's chunks summed
    in order from 0.0, pass after pass, column after column."""
    acc = torch.zeros(chunks.shape[:-3] + chunks.shape[-2:-1],
                      dtype=torch.float32, device=chunks.device)
    for p in range(chunks.shape[-3]):
        for e in range(CHUNK):
            acc = acc + chunks[..., p, :, e]
    return acc


def _butterfly(acc: torch.Tensor, width: int) -> torch.Tensor:
    """[..., width] → [...]: the xor butterfly over offsets width/2, ...,
    1 (lane 0's result; every lane ends with the same bits)."""
    lane = torch.arange(width, device=acc.device)
    off = width // 2
    while off:
        acc = acc + acc[..., lane ^ off]
        off //= 2
    return acc[..., 0]


def _row_sum(cells: torch.Tensor) -> torch.Tensor:
    """Σ of each row of fp32 ``cells`` [G, n] in the row kernel's order."""
    rows, n = cells.shape
    g = row_group(n)
    nch = -(-n // CHUNK)
    passes = -(-nch // g)
    chunks = F.pad(cells, (0, passes * g * CHUNK - n)).reshape(
        rows, passes, g, CHUNK)
    return _butterfly(_chunk_sums(chunks), g)


def _block_sum(cells: torch.Tensor, rows: int, block_size: int,
               cluster: int) -> torch.Tensor:
    """Σ of each row of fp32 ``cells`` [nb, rows · block_size] (a block's
    slab, row-major) in the block kernel's order over ``cluster`` CTAs."""
    nb = cells.shape[0]
    cpr = -(-block_size // CHUNK)
    band = -(-rows // cluster)
    slab = F.pad(cells.reshape(nb, rows, block_size),
                 (0, cpr * CHUNK - block_size, 0, cluster * band - rows))
    chunks = slab.reshape(nb, cluster, band * cpr, CHUNK)
    passes = -(-(band * cpr) // BLOCK_THREADS)
    chunks = F.pad(chunks, (0, 0, 0, passes * BLOCK_THREADS - band * cpr))
    acc = _chunk_sums(chunks.reshape(nb, cluster, passes, BLOCK_THREADS,
                                     CHUNK))
    warps = _butterfly(acc.reshape(nb, cluster, BLOCK_WARPS, WARP), WARP)
    bands = _butterfly(warps, BLOCK_WARPS)
    total = bands[:, 0]
    for r in range(1, cluster):
        total = total + bands[:, r]
    return total


def _recip(n: float, device) -> torch.Tensor:
    """fp32 1/n, rounded once (as XLA folds a constant divisor)."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return one / torch.full((), float(n), dtype=torch.float32, device=device)


def _stats(cells: torch.Tensor, strategy: QuantStrategy, qmax: float,
           qmin: float, ordered_sum) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero point), fp32 [G], of each row of fp32 ``cells`` [G, n];
    ``ordered_sum`` is the kernel's summation order (CENTERED's mean).
    The constant divisors (the count, qmax, qmax − qmin) are applied as
    multiplies by their fp32 reciprocals, as XLA compiles the JAX kernels;
    the divisions by a scale are IEEE divisions."""
    dev = cells.device
    if strategy == QuantStrategy.SYMMETRIC:
        scale = cells.abs().amax(dim=1).clamp_min(EPS) * _recip(qmax, dev)
        zp = torch.zeros_like(scale)
    elif strategy == QuantStrategy.CENTERED:
        mean = ordered_sum(cells) * _recip(cells.shape[1], dev)
        absmax = (cells - mean[:, None]).abs().amax(dim=1)
        scale = absmax.clamp_min(EPS) * _recip(qmax, dev)
        zp = torch.round(-mean / scale)
    elif strategy == QuantStrategy.ASYMMETRIC:
        hi, lo = cells.amax(dim=1), cells.amin(dim=1)
        scale = (hi - lo).clamp_min(EPS) * _recip(qmax - qmin, dev)
        zp = qmin - torch.round(lo / scale)
    else:
        raise NotImplementedError(strategy)
    return scale, zp


def _codes(cells, scale, zp, qmax, qmin, want_sums) -> Codes:
    """int8 codes of ``cells`` [G, n] with their cells' (scale, zp), the
    zero points as int32 and Σq per cell."""
    q = torch.round(cells / scale[:, None] + zp[:, None]).clamp(qmin, qmax)
    qi = q.to(torch.int32)
    sums = qi.sum(dim=1, dtype=torch.int32) if want_sums else None
    return qi.to(torch.int8), scale, zp.to(torch.int32), sums


# ---------------------------------------------------------------------------
# The kernels and their plain versions
# ---------------------------------------------------------------------------


def rtq_rows_plain(x: torch.Tensor, strategy: QuantStrategy, bits: int,
                        want_sums: bool) -> Codes:
    """Plain PyTorch version of :func:`rtq_rows`."""
    cfg = QuantConfig(bits=bits)
    cells = x.float()
    scale, zp = _stats(cells, strategy, float(cfg.qmax), float(cfg.qmin),
                       _row_sum)
    return _codes(cells, scale, zp, float(cfg.qmax), float(cfg.qmin),
                  want_sums)


def rtq_blocks_plain(x: torch.Tensor, block_size: int,
                          strategy: QuantStrategy, bits: int,
                          want_sums: bool) -> Codes:
    """Plain PyTorch version of :func:`rtq_blocks`."""
    cfg = QuantConfig(bits=bits)
    r, k = x.shape
    nb = k // block_size
    cells = x.float().reshape(r, nb, block_size).transpose(0, 1).reshape(
        nb, r * block_size)
    cluster = block_cluster(k, block_size)
    scale, zp = _stats(
        cells, strategy, float(cfg.qmax), float(cfg.qmin),
        lambda c: _block_sum(c, r, block_size, cluster))
    q, scale, zp, sums = _codes(cells, scale, zp, float(cfg.qmax),
                                float(cfg.qmin), want_sums)
    q = q.reshape(nb, r, block_size).transpose(0, 1).reshape(r, k)
    return q, scale, zp, sums


def _check(name, x, strategy, bits):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} has no kernel "
                        "(float32 or bfloat16)")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [R, K] tensor")
    if bits not in (8, 4) or strategy not in STRATEGY_CODES:
        raise ValueError(f"{name}: bits {bits} / {strategy} has no kernel")


def _outputs(x, cells, want_sums):
    dev = x.device
    codes = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scale = torch.empty(cells, dtype=torch.float32, device=dev)
    zp = torch.empty(cells, dtype=torch.int32, device=dev)
    sums = (torch.empty(cells, dtype=torch.int32, device=dev) if want_sums
            else None)
    return codes, scale, zp, sums


def rtq_rows(x: torch.Tensor, strategy: QuantStrategy, bits: int,
                  want_sums: bool = False) -> Codes:
    """Per-row runtime quantization of x [R, K] (fp32 or bf16) → (int8
    codes [R, K], scale fp32 [R], zero point int32 [R], Σq int32 [R] or
    None).  CPU tensors take :func:`rtq_rows_plain`; CUDA tensors
    launch ``rtq_row_kernel`` or raise."""
    if x.device.type == "cpu":
        return rtq_rows_plain(x, strategy, bits, want_sums)
    _check("rtq_rows", x, strategy, bits)
    cfg = QuantConfig(bits=bits)
    r, k = x.shape
    codes, scale, zp, sums = _outputs(x, r, want_sums)
    rc = _build.kernel_function("mfa_rtq_rows", _ROW_ARGS)(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        None if sums is None else sums.data_ptr(), DTYPE_CODES[x.dtype], r, k,
        STRATEGY_CODES[strategy], float(cfg.qmax), float(cfg.qmin),
        stream_of(x))
    _build.check_launch(rc, "rtq_rows")
    rtq_rows.launches += 1
    return codes, scale, zp, sums


rtq_rows.launches = 0


def rtq_blocks(x: torch.Tensor, block_size: int,
                    strategy: QuantStrategy, bits: int,
                    want_sums: bool = False) -> Codes:
    """Per-K-block runtime quantization of x [R, K] (statistics over each
    [R, block_size] slab) → (int8 codes [R, K], scale fp32 [K/bs], zero
    point int32 [K/bs], Σq int32 [K/bs] or None).  CPU tensors take
    :func:`rtq_blocks_plain`; CUDA tensors launch ``rtq_block_kernel``,
    a cluster of :func:`block_cluster` CTAs a block, or raise."""
    if x.shape[1] % block_size:
        raise ValueError(f"K={x.shape[1]} not divisible by "
                         f"block_size={block_size}")
    if x.device.type == "cpu":
        return rtq_blocks_plain(x, block_size, strategy, bits, want_sums)
    _check("rtq_blocks", x, strategy, bits)
    cfg = QuantConfig(bits=bits)
    r, k = x.shape
    codes, scale, zp, sums = _outputs(x, k // block_size, want_sums)
    rc = _build.kernel_function("mfa_rtq_blocks", _BLOCK_ARGS)(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        None if sums is None else sums.data_ptr(), DTYPE_CODES[x.dtype], r, k,
        block_size, STRATEGY_CODES[strategy], float(cfg.qmax),
        float(cfg.qmin), block_cluster(k, block_size), stream_of(x))
    _build.check_launch(rc, "rtq_blocks")
    rtq_blocks.launches += 1
    return codes, scale, zp, sums


rtq_blocks.launches = 0


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def runtime_quantize(x: torch.Tensor, config: QuantConfig) -> QuantizedTensor:
    """Fused one-pass quantization of a 2-D array: BLOCK and ROW
    granularities run their kernel (their plain version on the CPU);
    TENSOR granularity and inputs that are not 2-D take
    :func:`quant.tensor.quantize`."""
    if x.dim() != 2 or config.granularity not in (QuantGranularity.BLOCK,
                                                  QuantGranularity.ROW):
        return quantize(x, config)
    r, k = x.shape
    x = x.contiguous()
    if config.granularity == QuantGranularity.BLOCK:
        q, scale, zp, sums = rtq_blocks(
            x, config.block_size, config.strategy, config.bits,
            config.compute_sums)
        cell_shape = (1, k // config.block_size)
    else:
        q, scale, zp, sums = rtq_rows(x, config.strategy, config.bits,
                                           config.compute_sums)
        cell_shape = (r, 1)
    return QuantizedTensor(
        data=pack_int4(q) if config.bits == 4 else q,
        scale=scale.reshape(cell_shape),
        zero_point=zp.reshape(cell_shape),
        sums=None if sums is None else sums.reshape(cell_shape),
        config=config,
        shape=(r, k),
        orig_dtype=x.dtype,
    )

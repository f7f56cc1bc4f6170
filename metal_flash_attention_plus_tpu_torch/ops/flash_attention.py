"""Flash attention forward and its differentiable entry points.

The port of the JAX package's ``ops/flash_attention.py``.  Same public
contract: BHSD tensors, O in fp32 by default, L the natural-log row
logsumexp, the whole mask zoo through per-row ``[start, end)`` ranges, an
additive bias, grouped or interleaved GQA, and the static-max softmax
(``row_max``: a per-row subtrahend in place of the running max, from
:func:`estimate_row_max_scaled` or the caller).  The TPU kernel
``_fwd_kernel`` becomes ``csrc/flash_attention.cu::flash_fwd_tc_kernel``,
``::flash_fwd_wide_kernel`` and ``::flash_fwd_kernel``, each in both
modes, and above D = 576 ``csrc/split_d_attention.cu::split_d_fwd_kernel``
(O's lanes split over CTAs), behind :func:`flash_fwd`;
the TPU-only schedules (packed, flat, wavefront,
lean, two-level, the ones-fused rowsum, lane-replicated statistics, the
Mosaic guard) have no counterpart: on Hopper one ``[Sq, 2]`` int32 table
of row ranges, from which each CTA derives its live key span, covers
every mask kind.

:func:`flash_attention` is a ``torch.autograd.Function`` (the JAX
``custom_vjp``); its backward runs the dQ and dK/dV kernels of
:mod:`ops.flash_attention_bwd`.  On a CUDA tensor :func:`flash_fwd`
launches its kernel or raises; its plain PyTorch version
(:func:`flash_attention_forward_plain`) runs only for tensors on the CPU.

Masked scores are set to ``mask_value`` after the bias is added (the
dense reference masks first, then adds the bias); with the default
sentinel the two orders agree on every row with a live key.  A row with
no live key gives O = 0 and L = -inf here, as the JAX flash kernels do
(the dense reference gives the mean of V there).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
    expand_block_ranges_to_rows,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    _expand_kv_heads,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import _sm_count

LOG2E = float(np.log2(np.e))
LN2 = float(np.log(2.0))
# row_max="estimate": the subtrahend is at least the Cauchy-Schwarz bound C
# less this many base-2 units, which keeps exp2 inside fp32's range both
# ways (overflow needs a score 64 above a true upper bound).
ROW_MAX_SLACK = 64.0
# The widths the flash kernels are built for: MLAConfig()'s latent 256 + 32
# and DeepSeek-V2's absorbed 512 + 64 among them.  Any other head dim from
# 1 to 576 runs at the next one up (40 at 64, 72 at 128, 304 to 560 at
# 576) with its Q/K/V/dO lanes zero-padded: zero lanes add nothing to S or
# O and take no gradient; the softmax scale stays the true head dim's.
# Above 576 the split-D kernels (csrc/split_d_attention.cu) take the head
# dim at run time, zero-padded to the next multiple of 16, each CTA owning
# SPLIT_D_SLICE lanes of the output (mfa_split_d_slice answers the same).
FLASH_WIDTHS = (32, 64, 128, 256, 288, 576)
SPLIT_D_SLICE = 256
# The split-D forward's split of the KV axis (split_d_fwd_splits): keys a
# tile, the fewest tiles a run, the CTAs an SM the plan fills, and the
# most runs (C's mfa_sd::MAX_FWD_SPLITS).  One CTA runs on an SM at a time
# (its registers); two a plan keeps runs short where spans differ, and
# at Perceiver IO 4, 8 and 16 runs timed within 1% (PERF.md §6 PR 29).
SPLIT_D_KEY_TILE = 64
SPLIT_D_FWD_MIN_TILES = 16
SPLIT_D_FWD_CTAS_PER_SM = 2
SPLIT_D_FWD_MAX_SPLITS = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Sequence-tile sizes, kept so that a ``TransformerConfig`` carries
    across from the JAX package with the same fields and checks.

    The Hopper kernels pick their own tiles (64 query rows × 64 keys;
    fewer keys at D = 288 and 576) and read none of these; they tune the TPU's
    Pallas grids in the JAX package.  ``block_*_major`` is a multiple of
    its inner tile (0 → equal to it); every other field is a multiple of
    128.
    """

    block_q: int = 512
    block_kv: int = 512
    block_kv_major: int = 0
    block_q_dkv: int = 512
    block_kv_dkv: int = 512
    block_q_dq: int = 512
    block_kv_dq: int = 512
    block_kv_dq_major: int = 0
    block_q_dkv_major: int = 0

    def __post_init__(self):
        majors = {
            "block_kv_major": self.block_kv,
            "block_kv_dq_major": self.block_kv_dq,
            "block_q_dkv_major": self.block_q_dkv,
        }
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in majors:
                if v and v % majors[f.name] != 0:
                    raise ValueError(
                        f"{f.name}={v} must be a multiple of its inner tile"
                    )
                continue
            if v % 128 != 0:
                raise ValueError(f"{f.name}={v} must be a multiple of 128")

    @property
    def kv_major(self) -> int:
        return self.block_kv_major or self.block_kv

    @property
    def kv_dq_major(self) -> int:
        return self.block_kv_dq_major or self.block_kv_dq

    @property
    def q_dkv_major(self) -> int:
        return self.block_q_dkv_major or self.block_q_dkv


# ---------------------------------------------------------------------------
# Masks → per-row ranges → tile bounds
# ---------------------------------------------------------------------------


def compute_row_ranges(
    mask: MaskSpec,
    seq_q: int,
    seq_kv: int,
    *,
    mask_ranges: Optional[np.ndarray] = None,
    seq_q_padded: Optional[int] = None,
    seq_kv_cap: Optional[int] = None,
) -> np.ndarray:
    """Lower any :class:`MaskSpec` to per-row ``[start, end)`` KV ranges.

    Rows past ``seq_q`` (padding) get ``[0, 0)``; every ``end`` is clamped
    to ``seq_kv_cap`` (default ``seq_kv``) and to at least ``start``.
    Returns int32 ``[seq_q_padded or seq_q, 2]``.
    """
    sq_pad = seq_q_padded or seq_q
    cap = seq_kv_cap if seq_kv_cap is not None else seq_kv
    rows = np.arange(sq_pad)
    off = seq_kv - seq_q  # rectangular causal: ends aligned

    if mask.kind == MaskKind.NONE:
        start = np.zeros(sq_pad, np.int64)
        end = np.full(sq_pad, cap, np.int64)
    elif mask.kind == MaskKind.CAUSAL:
        start = np.zeros(sq_pad, np.int64)
        end = np.minimum(rows + off + 1, cap)
    elif mask.kind == MaskKind.SLIDING_WINDOW:
        half = max(1, mask.window_size) // 2
        start = np.maximum(0, rows - half)
        end = np.minimum(rows + half, cap)
        if mask.causal:
            end = np.minimum(end, rows + off + 1)
    elif mask.kind in (MaskKind.SPARSE_RANGES, MaskKind.BLOCK_SPARSE):
        if mask_ranges is None:
            raise ValueError(f"{mask.kind} requires mask_ranges")
        r = np.asarray(mask_ranges)
        if mask.kind == MaskKind.BLOCK_SPARSE:
            r = expand_block_ranges_to_rows(r, mask.block_size, seq_q)
        start = np.zeros(sq_pad, np.int64)
        end = np.zeros(sq_pad, np.int64)
        start[:seq_q] = r[:seq_q, 0]
        end[:seq_q] = np.minimum(r[:seq_q, 1], cap)
    else:
        raise NotImplementedError(mask.kind)

    if sq_pad > seq_q:
        start[seq_q:] = 0
        end[seq_q:] = 0
    end = np.maximum(end, start)
    return np.stack([start, end], axis=-1).astype(np.int32)


def build_block_bounds(
    row_ranges: np.ndarray, block_q: int, block_kv: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-q-block kv-block bounds, int32 ``[ni]`` each: (lo, hi,
    max_start, min_end).  ``[lo, hi)`` is the live kv-block window of
    q-block i (the rule each CUDA CTA applies to its own rows);
    max_start/min_end are the all-rows-live bounds.  Empty q-blocks get
    ``lo == hi``."""
    sq_pad = row_ranges.shape[0]
    ni = sq_pad // block_q
    start = row_ranges[:, 0].reshape(ni, block_q).astype(np.int64)
    end = row_ranges[:, 1].reshape(ni, block_q).astype(np.int64)
    live = end > start
    any_live = live.any(axis=1)
    all_live = live.all(axis=1)
    big = np.int64(np.iinfo(np.int32).max)
    start_masked = np.where(live, start, big)
    lo = np.where(any_live, start_masked.min(axis=1) // block_kv, 0)
    hi = np.where(any_live, -(-end.max(axis=1) // block_kv), 0)
    max_start = np.where(all_live, start.max(axis=1), big)
    min_end = np.where(all_live, end.min(axis=1), -1)
    return (
        lo.astype(np.int32),
        hi.astype(np.int32),
        max_start.astype(np.int32),
        min_end.astype(np.int32),
    )


def compute_row_ranges_dynamic(
    mask_ranges: torch.Tensor,
    seq_q: int,
    seq_kv: int,
    seq_q_padded: int,
    seq_kv_cap: int,
) -> torch.Tensor:
    """:func:`compute_row_ranges` for SPARSE_RANGES given as a torch tensor
    (built on the device, the analog of JAX's traced ranges): clipped to
    ``[0, seq_kv_cap]``, ``end >= start``, padded rows empty.  Stays on the
    tensor's device, so no host round trip.  Returns int32
    ``[seq_q_padded, 2]``."""
    r = mask_ranges.to(torch.int32)
    start = r[:seq_q, 0].clamp(0, seq_kv_cap)
    end = torch.maximum(r[:seq_q, 1].clamp(0, seq_kv_cap), start)
    out = torch.stack([start, end], dim=-1)
    if seq_q_padded > seq_q:
        out = torch.cat([out, out.new_zeros(seq_q_padded - seq_q, 2)])
    return out


@functools.lru_cache(maxsize=64)
def _static_row_ranges(mask: MaskSpec, seq_q: int, seq_kv: int,
                       device: torch.device) -> torch.Tensor:
    """Row ranges of a mask without data, built once per shape and device
    (callers only read them)."""
    return torch.from_numpy(compute_row_ranges(mask, seq_q, seq_kv)).to(
        device)


def row_ranges_tensor(
    mask: MaskSpec,
    seq_q: int,
    seq_kv: int,
    mask_ranges: Optional[Ranges],
    device: torch.device,
) -> torch.Tensor:
    """The int32 ``[seq_q, 2]`` row-range table the kernels read, on
    ``device``: numpy ranges are lowered on the host, tensor ranges on
    their device, and data-free masks come from a small cache."""
    if isinstance(mask_ranges, torch.Tensor):
        if mask.kind != MaskKind.SPARSE_RANGES:
            raise ValueError("tensor mask_ranges require MaskKind.SPARSE_RANGES")
        return compute_row_ranges_dynamic(
            mask_ranges.to(device), seq_q, seq_kv, seq_q, seq_kv
        ).contiguous()
    if mask.kind in (MaskKind.SPARSE_RANGES, MaskKind.BLOCK_SPARSE):
        return torch.from_numpy(compute_row_ranges(
            mask, seq_q, seq_kv, mask_ranges=mask_ranges)).to(device)
    return _static_row_ranges(mask, seq_q, seq_kv, torch.device(device))


def range_mask(row_ranges: torch.Tensor, seq_kv: int):
    """(keep [Sq, Skv] bool, live [Sq, 1] bool) of a row-range table."""
    col = torch.arange(seq_kv, device=row_ranges.device)
    start = row_ranges[:, :1].long()
    end = row_ranges[:, 1:].long()
    return (col >= start) & (col < end), end > start


# ---------------------------------------------------------------------------
# Input checks shared by the three kernel wrappers
# ---------------------------------------------------------------------------


def flash_width(d: int) -> int:
    """The kernel width a head dim ``d`` runs at: the next of
    ``FLASH_WIDTHS`` up to 576, above it the next multiple of 16 (the
    split-D kernels).  Raises below 1."""
    if d < 1:
        raise ValueError(f"head dim {d} has no flash kernel (1 or more)")
    for w in FLASH_WIDTHS:
        if d <= w:
            return w
    return -(-d // 16) * 16


def split_d_slices(d: int) -> int:
    """The CTAs that share each row tile's output lanes at head dim ``d``:
    ``ceil(width / SPLIT_D_SLICE)`` on the split-D kernels (above 576), 1
    on every other.  Each of them recomputes the tile's scores."""
    w = flash_width(d)
    return -(-w // SPLIT_D_SLICE) if w > FLASH_WIDTHS[-1] else 1


def split_d_fwd_splits(d: int, batch: int, q_heads: int, seq_q: int,
                       seq_kv: int, sms: int, *,
                       one_walk: bool = False) -> int:
    """How many runs the split-D forward deals each row tile's key span
    into, from shapes alone: 1 unless the grid (row tiles × q heads × batch
    × :func:`split_d_slices`) leaves some of ``sms`` SMs idle; then as many
    as fill ``SPLIT_D_FWD_CTAS_PER_SM`` CTAs an SM, each run at least
    ``SPLIT_D_FWD_MIN_TILES`` tiles of 64 keys (so the merge, which reads
    every run's partial once, stays small beside the runs), at most
    ``SPLIT_D_FWD_MAX_SPLITS``.  ``one_walk``: an int8 P, whose integers
    round against the running max of the whole span history, never splits.
    1 at or below 576.  Perceiver IO's cross-attention (512 latents of
    1024, one head, 50,176 keys: 32 CTAs, 784 tiles) takes 8 runs of 98
    tiles on 132 SMs; the trio (B=2, 16 heads, S=2048: 4,096 CTAs) 1."""
    if one_walk or split_d_slices(d) == 1:
        return 1
    ctas = -(-seq_q // SPLIT_D_KEY_TILE) * q_heads * batch * split_d_slices(d)
    if ctas >= sms:
        return 1
    tiles = -(-seq_kv // SPLIT_D_KEY_TILE)
    return max(1, min(SPLIT_D_FWD_CTAS_PER_SM * sms // ctas,
                      tiles // SPLIT_D_FWD_MIN_TILES,
                      SPLIT_D_FWD_MAX_SPLITS))


def split_d_fwd_runs(row_ranges: torch.Tensor, seq_kv: int, splits: int, *,
                     aligned: bool) -> torch.Tensor:
    """int64 [Sq, Skv]: the run (0 to splits − 1) of the split-D forward
    that walks each (row, key), −1 where none does.  Each 64-row tile's
    live span (the least start and the greatest end of its rows with a
    live key; the kernels' ``key_span``) is walked in 64-key tiles from its
    first key (``aligned``: from the multiple of 64 below it, as the
    quantized forward walks) and dealt into ``splits`` runs of
    ``ceil(tiles / splits)`` whole tiles."""
    sq = row_ranges.shape[0]
    rr = row_ranges.long()
    start, end = rr[:, 0], rr[:, 1]
    live = end > start
    big = torch.iinfo(torch.int64).max
    tile_of_row = torch.arange(sq, device=rr.device) // SPLIT_D_KEY_TILE
    n_tiles = -(-sq // SPLIT_D_KEY_TILE)
    lo = torch.full((n_tiles,), big, device=rr.device).scatter_reduce(
        0, tile_of_row, torch.where(live, start, big), "amin")
    hi = torch.zeros(n_tiles, dtype=torch.int64, device=rr.device
                     ).scatter_reduce(0, tile_of_row,
                                      torch.where(live, end, 0), "amax")
    first = lo // SPLIT_D_KEY_TILE * SPLIT_D_KEY_TILE if aligned else lo
    tiles = torch.where(hi > lo, -(-(hi - first) // SPLIT_D_KEY_TILE), 0)
    per = -(-tiles // splits)
    col = torch.arange(seq_kv, device=rr.device)
    f, h, p = first[tile_of_row, None], hi[tile_of_row, None], per[
        tile_of_row, None]
    walked = (col >= f) & (col < h)
    run = (col - f) // SPLIT_D_KEY_TILE // torch.clamp(p, min=1)
    return torch.where(walked, run, -1)


def fwd_body(dtype: torch.dtype, d: int) -> str:
    """Which forward kernel :func:`flash_fwd` launches for a Q of ``dtype``
    at head dim ``d``: "tensor_core" (bf16 mma.sync) for bf16 at every
    kernel width, ``flash_fwd_tc_kernel`` up to 256,
    ``flash_fwd_wide_kernel`` (32-key tiles, two CTAs an SM) at MLA's
    width 288 and ``flash_fwd_latent_kernel`` (O's lanes over two warp
    groups, 32-key tiles) at DeepSeek's absorbed width 576; "fp32_fma"
    (``flash_fwd_kernel``: scalar fp32 FMAs, 32-row tiles at 576) for fp32,
    whose 2e-5 gate TF32 would break; "split_d" above 576 in both dtypes
    (``split_d_fwd_kernel``: O's lanes over :func:`split_d_slices` CTAs,
    scalar fp32 FMAs).  The same answer as
    :func:`~.flash_attention_bwd.dq_body` and ``dkv_body``; the C launcher
    routes the same way (``fwd_tc``, ``fwd_wide``, ``fwd_latent`` in
    ``csrc/flash_attention.cu``, ``mfa_sd::takes``)."""
    if flash_width(d) > FLASH_WIDTHS[-1]:  # raises below 1
        return "split_d"
    return "tensor_core" if dtype == torch.bfloat16 else "fp32_fma"


def pad_lanes(width: int, *tensors: torch.Tensor):
    """The tensors with their last dim zero-padded to ``width``."""
    return [t if t.shape[-1] == width else
            torch.nn.functional.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


def check_kernel_inputs(name, q, k, v, row_ranges, bias, *, q_like=(),
                        stats=()):
    """Raise unless the tensors are what the CUDA kernels take: q/k/v (and
    ``q_like``: dO) of one dtype in DTYPE_CODES, BHSD with a head dim that
    :func:`flash_width` takes, contiguous and 16-byte aligned on one CUDA
    device; the row-range table int32 [Sq, 2]; ``stats`` (L, D) fp32
    [B, Hq, Sq]; the bias fp32 [1 or B, 1 or Hq, Sq, Skv]."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} has no kernel "
                        "(float32 or bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q [B, Hq, Sq, D] and k = v [B, Hkv, Skv, D]"
                         " expected")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} / "
                         f"{tuple(k.shape)} do not match")
    flash_width(d)
    for t in (q, k, v, *q_like):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v and dO must share a dtype")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    for t in q_like:
        if t.shape != q.shape:
            raise ValueError(f"{name}: dO must have q's shape")
    if row_ranges.dtype != torch.int32 or row_ranges.shape != (sq, 2):
        raise ValueError(f"{name}: row ranges must be int32 [Sq, 2]")
    for t in stats:
        if t.dtype != torch.float32 or t.shape != (b, hq, sq):
            raise ValueError(f"{name}: L and D must be fp32 [B, Hq, Sq]")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.dim() != 4
                or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, hq)
                or bias.shape[2:] != (sq, skv)):
            raise ValueError(f"{name}: bias must be fp32 "
                             "[1 or B, 1 or Hq, Sq, Skv]")
    for t in (q, k, v, *q_like, row_ranges, *stats,
              *(() if bias is None else (bias,))):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def bias_args(bias: Optional[torch.Tensor]):
    """(pointer, batch stride, head stride) of a contiguous fp32 bias; the
    strides are 0 along broadcast dims."""
    if bias is None:
        return None, 0, 0
    _, hb, sq, skv = bias.shape
    return (bias.data_ptr(),
            0 if bias.shape[0] == 1 else hb * sq * skv,
            0 if hb == 1 else sq * skv)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# The forward kernel and its plain version
# ---------------------------------------------------------------------------

_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
_FWD_ARGS = ([_PTR] * 5 + [_I64, _I64] + [_PTR, _PTR] + [_I32] * 8
             + [_F32, _F32, _PTR, _I32, _PTR, _PTR])


def estimate_row_max_scaled(
    q_scaled: torch.Tensor,
    k: torch.Tensor,
    mask: MaskSpec,
    *,
    row_ranges: Optional[torch.Tensor] = None,
    kv_head_of,
    seq_q: int,
    seq_kv: int,
    num_samples: int = 128,
) -> torch.Tensor:
    """Each row's softmax subtrahend M for the static-max mode (base 2).

    Softmax is invariant to a per-row shift, and fp32 carries relative
    precision at every exponent, so the running max only keeps exp2 in
    range.  M = max(m_est, C − ROW_MAX_SLACK): m_est is the row's max over
    ``num_samples`` strided sample columns (column 0 among them), where the
    mask keeps them; C is the Cauchy–Schwarz bound |q_r|·max_c |k_c|, a
    true upper bound, so exp2 never overflows.  The masks read as the JAX
    package reads them: ``row_ranges`` (int32 [Sq, 2]) where given (the
    sparse kinds), else the causal or window rule, else every column.

    ``q_scaled``: Q already scaled by ``scale·log2e`` and rounded back to
    its dtype, as the kernel reads it; ``k`` float.  Returns fp32
    [B, Hq, Sq].
    """
    b, hq, sq, d = q_scaled.shape
    skv = k.shape[2]
    qf = q_scaled.float()
    kf = k.float()
    head_map = torch.tensor([kv_head_of(h) for h in range(hq)],
                            device=k.device)
    knorm_max = torch.sqrt((kf * kf).sum(-1)).amax(-1)  # [B, Hkv]
    qnorm = torch.sqrt((qf * qf).sum(-1))  # [B, Hq, Sq]
    cbound = qnorm * knorm_max[:, head_map][:, :, None]
    cols = np.unique(np.linspace(0, max(skv - 1, 0), num_samples).astype(
        np.int64))
    colv = torch.from_numpy(cols).to(k.device)
    ks = kf[:, :, colv][:, head_map]  # [B, Hq, nc, D]: sampled, then heads
    s_smp = qf @ ks.transpose(-1, -2)
    rows = torch.arange(sq, device=k.device)[:, None]
    keep = None
    if row_ranges is not None:
        keep = ((colv[None, :] >= row_ranges[:sq, :1].long())
                & (colv[None, :] < row_ranges[:sq, 1:].long()))
    elif mask.kind == MaskKind.CAUSAL:
        keep = colv[None, :] <= rows + (seq_kv - seq_q)
    elif mask.kind == MaskKind.SLIDING_WINDOW:
        half = max(1, mask.window_size) // 2
        hi = rows + half
        if mask.causal:
            hi = torch.minimum(hi, rows + (seq_kv - seq_q))
        keep = (colv[None, :] >= rows - half) & (colv[None, :] < hi)
    if keep is not None:
        s_smp.masked_fill_(~keep, -float("inf"))
    return torch.maximum(s_smp.amax(-1), cbound - ROW_MAX_SLACK)


def flash_attention_forward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    row_ranges: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: float,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    row_max: Optional[torch.Tensor] = None,
    splits: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_fwd`, rounding where the
    kernel does: q·(scale·log2e) rounded to q's dtype, base-2 softmax in
    fp32, P rounded to V's dtype before P·V.  With ``row_max`` (fp32
    [B, Hq, Sq], base 2) the static-max mode: p = 2^(s − M) without a
    running max, L = M·ln2 + ln(l) where l > 0, else -inf with O = 0.
    ``splits`` > 1: the split-D kernel's split of the KV axis, each run's
    partial in one pass over its keys (:func:`split_d_fwd_runs`), merged
    by :func:`merge_fwd_splits_plain`."""
    hq, skv = q.shape[1], k.shape[2]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    kx = _expand_kv_heads(k, hq, interleaved_kv).float()
    vx = _expand_kv_heads(v, hq, interleaved_kv)
    s = qs @ kx.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float() * LOG2E
    keep, live = range_mask(row_ranges, skv)
    s = torch.where(keep, s, torch.full_like(s, mask_value))
    if splits > 1:
        run = split_d_fwd_runs(row_ranges, skv, splits, aligned=False)
        parts = []
        for sp in range(splits):
            walked = run == sp
            s_sp = torch.where(walked, s, -float("inf"))
            m = (s_sp.amax(dim=-1, keepdim=True) if row_max is None
                 else row_max.float()[..., None])
            p = torch.where(walked, torch.exp2(s_sp - m), 0.0)
            lsum = torch.where(live, p.sum(dim=-1, keepdim=True), 0.0)
            parts.append(torch.cat([m, lsum, p.to(vx.dtype).float()
                                    @ vx.float()], dim=-1))
        ws = torch.stack(parts, dim=-2)  # [B, Hq, Sq, splits, D + 2]
        return merge_fwd_splits_plain(ws.flatten(0, 2), q.shape)
    m = (s.amax(dim=-1, keepdim=True) if row_max is None
         else row_max.float()[..., None])
    p = torch.exp2(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    live = live & (lsum > 0)  # a static M above every score empties a row
    safe = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    o = (p.to(vx.dtype).float() @ vx.float()) / safe
    lse = (m * LN2 + torch.log(safe))[..., 0]
    o = torch.where(live, o, torch.zeros_like(o))
    lse = torch.where(live[..., 0], lse, torch.full_like(lse, -float("inf")))
    return o, lse


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    row_ranges: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: float,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    row_max: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward kernel: (o fp32 [B, Hq, Sq, D], l fp32 [B, Hq, Sq]).

    ``row_ranges`` is the int32 [Sq, 2] table of :func:`row_ranges_tensor`;
    ``bias`` is fp32 [1 or B, 1 or Hq, Sq, Skv]; ``row_max``, for the
    static-max mode, fp32 [B, Hq, Sq] subtrahends in base 2 (no bias).  CPU
    tensors take :func:`flash_attention_forward_plain`; CUDA tensors launch
    the kernel :func:`fwd_body` names (``flash_fwd_tc_kernel``,
    ``flash_fwd_wide_kernel``, ``flash_fwd_kernel`` or, above 576,
    ``split_d_fwd_kernel``, in the static-max mode where ``row_max`` is
    given) at the head dim's :func:`flash_width`, or raise.  Above 576 the
    KV axis splits where :func:`split_d_fwd_splits` says: the kernel writes
    each run's partial to a workspace this call allocates and
    :func:`merge_fwd_splits` makes O and L.
    """
    if row_max is not None and bias is not None:
        raise ValueError("row_max is incompatible with bias")
    if q.device.type == "cpu":
        return flash_attention_forward_plain(
            q, k, v, row_ranges, bias=bias, scale=scale,
            interleaved_kv=interleaved_kv, mask_value=mask_value,
            row_max=row_max)
    check_kernel_inputs("flash_fwd", q, k, v, row_ranges, bias,
                        stats=() if row_max is None else (row_max,))
    b, hq, sq, d_in = q.shape
    d = flash_width(d_in)
    q, k, v = pad_lanes(d, q, k, v)
    hkv, skv = k.shape[1], k.shape[2]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    splits = split_d_fwd_splits(d, b, hq, sq, skv, _sm_count(q.device))
    ws = split_d_fwd_workspace(q.shape, splits, q.device)
    bptr, bsb, bsh = bias_args(bias)
    rc = _build.kernel_function("mfa_flash_fwd", _FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), row_ranges.data_ptr(),
        bptr, bsb, bsh, o.data_ptr(), lse.data_ptr(), DTYPE_CODES[q.dtype],
        b, hq, hkv, sq, skv, d, int(interleaved_kv), scale * LOG2E,
        mask_value, None if row_max is None else row_max.data_ptr(),
        splits, None if ws is None else ws.data_ptr(), stream_of(q),
    )
    _build.check_launch(rc, "flash_fwd")
    flash_fwd.launches += 1
    if ws is not None:
        merge_fwd_splits(ws, o, lse, kv_heads=hkv,
                         interleaved_kv=interleaved_kv)
    return (o if d == d_in else o[..., :d_in].contiguous()), lse


flash_fwd.launches = 0


_MERGE_FWD_ARGS = [_PTR] * 4 + [_I32] * 7 + [_PTR]


def merge_fwd_splits_plain(ws: torch.Tensor, shape, *,
                           vstore: Optional[torch.Tensor] = None,
                           interleaved_kv: bool = False):
    """Plain PyTorch version of :func:`merge_fwd_splits`: ``ws`` fp32
    [B·Hq·Sq, splits, D + 2] (m in base 2, l, the unnormalised O of each
    run) → (o fp32 ``shape`` [B, Hq, Sq, D], L fp32 [B, Hq, Sq]), in the
    kernel's order: M = max m_s, w_s = 2^(m_s − M) (0 for a run of no key),
    l = Σ w_s·l_s, O = (Σ w_s·O_s) / l (× ``vstore`` fp32 [B, Hkv, D], the
    quantized forward's V_STORE multipliers), L = M·ln2 + ln l; O = 0,
    L = −inf where l = 0."""
    b, hq, sq, d = shape
    m, lsum, part = ws[..., 0], ws[..., 1], ws[..., 2:]
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.where(torch.isinf(m) & (m < 0), 0.0, torch.exp2(m - mx))
    lt = (w * lsum).sum(dim=-1)
    live = lt > 0
    safe = torch.where(live, lt, torch.ones_like(lt))
    o = (w[..., None] * part).sum(dim=-2) / safe[:, None]
    o = torch.where(live[:, None], o, torch.zeros_like(o)).view(b, hq, sq, d)
    if vstore is not None:
        o = o * _expand_kv_heads(vstore[:, :, None], hq, interleaved_kv)
    lse = torch.where(live, mx[:, 0] * LN2 + torch.log(safe),
                      torch.full_like(lt, -float("inf")))
    return o, lse.view(b, hq, sq)


def merge_fwd_splits(ws: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                     *, kv_heads: int, interleaved_kv: bool = False,
                     vstore: Optional[torch.Tensor] = None) -> None:
    """o (fp32 [B, Hq, Sq, D]) and lse (fp32 [B, Hq, Sq]) from the split-D
    forward's partials ``ws`` fp32 [B·Hq·Sq, splits, D + 2], in place
    (``csrc/split_d_attention.cu::split_d_fwd_merge_kernel``: the runs in
    split order, no atomics, so two calls agree bit for bit; ``vstore``:
    the quantized forward's V_STORE multipliers fp32 [B, Hkv, D]).  CPU
    tensors take :func:`merge_fwd_splits_plain`."""
    if ws.device.type == "cpu":
        mo, ml = merge_fwd_splits_plain(ws, tuple(o.shape), vstore=vstore,
                                        interleaved_kv=interleaved_kv)
        o.copy_(mo)
        lse.copy_(ml)
        return
    b, hq, sq, d = o.shape
    splits = ws.shape[1]
    if (ws.dtype != torch.float32 or not ws.is_contiguous()
            or ws.shape != (b * hq * sq, splits, d + 2)
            or lse.shape != (b, hq, sq)
            or (vstore is not None and vstore.shape != (b, kv_heads, d))
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != ws.device
                   for t in (o, lse) + (() if vstore is None
                                        else (vstore,)))):
        raise ValueError("merge_fwd_splits: ws fp32 [B*Hq*Sq, splits, D + "
                         "2], contiguous fp32 o, lse (and vstore [B, Hkv, "
                         "D]) on its device expected")
    rc = _build.kernel_function("mfa_split_d_fwd_merge", _MERGE_FWD_ARGS)(
        ws.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if vstore is None else vstore.data_ptr(), b, hq, kv_heads, sq,
        d, int(interleaved_kv), splits, stream_of(o))
    _build.check_launch(rc, "split_d_fwd_merge")
    merge_fwd_splits.launches += 1


merge_fwd_splits.launches = 0


def split_d_fwd_workspace(shape, splits: int,
                          device) -> Optional[torch.Tensor]:
    """The split-D forward's partials fp32 [B·Hq·Sq, splits, D + 2] for an
    O of ``shape`` [B, Hq, Sq, D] (at the kernel width), or None at one
    split."""
    if splits == 1:
        return None
    b, hq, sq, d = shape
    return torch.empty((b * hq * sq, splits, d + 2), dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# Public forward contract
# ---------------------------------------------------------------------------


def _default_scale(d: int, scale: Optional[float]) -> float:
    return float(d) ** -0.5 if scale is None else float(scale)


def kernel_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The bias as the kernels read it: fp32, contiguous, 4-D."""
    if bias is None:
        return None
    if bias.dim() != 4:
        raise ValueError("bias must be 4-D, broadcastable to [B, Hq, Sq, Skv]")
    return bias.float().contiguous()


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: MaskSpec = FULL,
    mask_ranges: Optional[Ranges] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    out_dtype: torch.dtype = torch.float32,
    row_max=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward.

    Args:
      q: [B, Hq, Sq, D] (bf16 or fp32); k, v: [B, Hkv, Skv, D], same dtype.
      mask, mask_ranges, bias: the semantics of ``reference_attention``
        (``mask_ranges`` numpy, or a torch tensor for SPARSE_RANGES).
      block_sizes: accepted for parity with the JAX package; unused.
      out_dtype: O's dtype (fp32 by default).
      row_max: the static-max softmax.  ``"estimate"``: each row's
        subtrahend from :func:`estimate_row_max_scaled` (one thin sampled
        product); or an fp32 [B, Hq, Sq] tensor of per-row score bounds in
        natural logit units (scale·q·k).  The result matches the
        running-max forward to roundoff while the true row max stays
        within ~±60 base-2 units of the subtrahend (which "estimate"'s
        Cauchy–Schwarz floor guarantees).  Not with ``bias``.

    Returns (o [B, Hq, Sq, D] out_dtype, l [B, Hq, Sq] fp32 natural LSE).
    """
    del block_sizes  # the Hopper kernels choose their own tiles
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = _default_scale(d, scale)
    rr = row_ranges_tensor(mask, sq, skv, mask_ranges, q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mx = None
    if row_max is not None:
        if bias is not None:
            raise ValueError("row_max is incompatible with bias")
        if isinstance(row_max, str):
            if row_max != "estimate":
                raise ValueError(f"row_max: {row_max!r}")
            group = hq // hkv
            mx = estimate_row_max_scaled(
                (q.float() * (scale * LOG2E)).to(q.dtype), k, mask,
                row_ranges=(rr if mask.kind in (MaskKind.SPARSE_RANGES,
                                                MaskKind.BLOCK_SPARSE)
                            else None),
                kv_head_of=((lambda h: h % hkv) if interleaved_kv
                            else (lambda h: h // group)),
                seq_q=sq, seq_kv=skv)
        else:
            mx = row_max.to(device=q.device, dtype=torch.float32) * LOG2E
        mx = mx.contiguous()
    o, lse = flash_fwd(
        q, k, v, rr, bias=kernel_bias(bias), scale=scale,
        interleaved_kv=interleaved_kv, mask_value=mask_value, row_max=mx,
    )
    return o.to(out_dtype), lse


# ---------------------------------------------------------------------------
# Differentiable public API
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """``custom_vjp`` analog: the forward kernel, then the dQ and dK/dV
    kernels.  Gradients flow to q, k, v and bias; ``mask_ranges`` is
    integer data and gets none; ``l`` is returned without a gradient.

    The fp32 O is what the backward's D = rowsum(dO ⊙ O) is built from,
    not the O cast to ``out_dtype`` that the caller sees."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask_ranges, mask, scale,
                interleaved_kv, mask_value, out_dtype):
        scale_f = _default_scale(q.shape[-1], scale)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        rr = row_ranges_tensor(mask, q.shape[2], k.shape[2], mask_ranges,
                               q.device)
        o, lse = flash_fwd(q, k, v, rr, bias=kernel_bias(bias), scale=scale_f,
                           interleaved_kv=interleaved_kv,
                           mask_value=mask_value)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.mask_ranges = mask_ranges
        ctx.mask = mask
        ctx.scale = scale_f
        ctx.interleaved_kv = interleaved_kv
        odt = q.dtype if out_dtype is None else out_dtype
        ctx.mark_non_differentiable(lse)
        return o.to(odt), lse

    @staticmethod
    def backward(ctx, do, _dl):
        from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (  # noqa: E501
            flash_attention_backward,
        )

        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_backward(
            q, k, v, o, lse, do, mask=ctx.mask, mask_ranges=ctx.mask_ranges,
            bias=bias, scale=ctx.scale, interleaved_kv=ctx.interleaved_kv,
            compute_dbias=bias is not None and ctx.needs_input_grad[3],
        )
        return (
            dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            None if dbias is None else dbias.to(bias.dtype),
            None, None, None, None, None, None,
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask_ranges: Optional[Ranges] = None,
    *,
    mask: MaskSpec = FULL,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Differentiable flash attention; returns O in ``out_dtype`` (default
    q's dtype).  Gradients: dq, dk, dv, and dbias if a bias is given."""
    return flash_attention_with_lse(
        q, k, v, bias, mask_ranges, mask=mask, scale=scale,
        block_sizes=block_sizes, interleaved_kv=interleaved_kv,
        mask_value=mask_value, out_dtype=out_dtype,
    )[0]


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask_ranges: Optional[Ranges] = None,
    *,
    mask: MaskSpec = FULL,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward returning (o, l) from one kernel launch; ``l`` carries no
    gradient (JAX: ``stop_gradient``)."""
    del block_sizes  # the Hopper kernels choose their own tiles
    return _FlashAttention.apply(
        q, k, v, bias, mask_ranges, mask, scale, interleaved_kv, mask_value,
        out_dtype,
    )


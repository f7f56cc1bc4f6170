"""Paged attention over the merged page pool: decode and chunked prefill.

Each public function keeps the JAX package's signature and layouts
(``metal_flash_attention_plus_tpu/serving/paged_attention.py``) and has a
plain PyTorch version beside it (``*_plain``).  On a CUDA tensor the
wrapper launches its hand-written Hopper kernel
(``csrc/paged_attention.cu``) or raises; the plain version runs only for
tensors on the CPU.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.

Pools (one layer of :class:`PagedKVCache`, or of the MLA latent cache):

- float: ``kv_pages [Hkv, NP+1, S_sub·PT, D]`` in q's dtype.  S_sub = 2:
  K of a page in token rows ``[0, PT)``, V in ``[PT, 2PT)``; S_sub = 1:
  one state per token that is both K and V (MLA's latent pages);
- int8 (``k_scales`` given): the same rows in int8, with per-token
  symmetric scales ``k_scales, v_scales [Hkv, NP+1, 1, PT]`` fp32;
- int4 (``k_scales`` given and ``kv_bits=4``): ``[Hkv, NP+1, PT, D]`` int8,
  one byte per (token, d) — K + 8 in the low nibble, V as the signed high
  nibble (``value << 4``).

As in the JAX package, the pool is quantized when ``k_scales`` is given;
``kv_bits=4`` then selects the int4 byte and any other value means int8.
S_sub is ``page rows // page_tokens`` (``page_tokens`` defaults to the page
rows: S_sub = 1).  ``v_tail_zero``: V reads K's rows with its last
``v_tail_zero`` lanes set to 0 (the rope tail of an MLA latent state).
The int4 pool takes neither S_sub = 2 nor ``v_tail_zero``, as in JAX.  The
kernels take any head dim from 1: up to 576 (DeepSeek's absorbed MLA
width, 512 + 64) the fixed-width kernels, above it the split-D kernels
(``csrc/split_d_attention.cu``), whose CTAs each own 256 lanes of O
(``ops.flash_attention.SPLIT_D_SLICE``) and recompute the scores over the
whole head dim.  The pool keeps its
layout and bytes at every head dim: the kernels read its rows as they lie
(whose bytes need not be whole 16-byte chunks) and zero the staged lanes
up to the next multiple of 16; the wrappers zero-pad q to that width and
cut O back (the scale stays the true head dim's).

Numerics shared by kernels and plain versions: q is pre-scaled and rounded
back to its dtype, ``(q.f32 · scale).to(q.dtype)``; scores, softmax
statistics and the P·V sum are fp32.  Float pool: K and V are read in q's
dtype and P is cast to it before P·V.  Quantized pools: the score is
Σ q·k over the integer K, THEN multiplied by the token's K scale; the
softmax sum takes P before any V scale; then P is multiplied by the
token's V scale and cast to q's dtype before P·V over the integer V.  The
output is in q's dtype.  The bf16 kernels round P against the running max
of their tiles (the decode: of its split of the KV axis too), the plain
versions against the row's max; the bf16 gate covers it.

Kernels (:func:`decode_body`, :func:`prefill_body` say which a call takes):
the bf16 decode runs ``paged_decode_tc_kernel`` (mma.sync) and the fp32
one ``paged_decode_kernel`` (fp32 FMAs), both with the KV axis split
across CTAs as :func:`decode_splits` plans and, for more than one split,
``paged_decode_merge_kernel`` after them over a workspace the wrapper
allocates; the bf16 prefill runs ``paged_prefill_tc_kernel`` (above
D = 288 ``paged_prefill_wide_kernel``) where :func:`prefill_body` says
so, the rest ``paged_prefill_kernel``.  Above D = 576 both dtypes run
``split_d_decode_kernel`` (the KV axis split as :func:`decode_splits`
plans and the lanes split too; the same merge) and
``split_d_prefill_kernel``: the "split_d" route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.serving.kv_cache import unpack_kv4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_FIXED_DIM = 576  # the fixed-width kernels' widest; split-D above
# Pool modes of the kernels: float, int8 halves, int4 shared byte.
_MODE_FLOAT, _MODE_INT8, _MODE_INT4 = 0, 1, 2
_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DECODE_ARGS = [_PTR] * 7 + [_I32] * 11 + [_F32, _I32, _PTR, _PTR]
_PREFILL_ARGS = [_PTR] * 6 + [_I32] * 12 + [_F32, _PTR]
_DECODE_TILE = 64  # KV tokens a tile of the decode kernels' splits


def _pool_mode(k_scales, v_scales, kv_bits: int) -> int:
    """The JAX semantics: quantized iff ``k_scales`` is given; then
    ``kv_bits=4`` is the int4 byte and any other value int8."""
    if k_scales is None:
        if v_scales is not None:
            raise ValueError("v_scales given without k_scales")
        if kv_bits == 4:
            raise ValueError("int4 pools need k_scales and v_scales")
        return _MODE_FLOAT
    if v_scales is None:
        raise ValueError("k_scales given without v_scales")
    return _MODE_INT4 if kv_bits == 4 else _MODE_INT8


def _geometry(q_heads, head_dim, kv_pages, page_tokens, mode,
              v_tail_zero):
    """(Hkv, NP+1, PT, S_sub) of a pool, as the JAX package reads it:
    S_sub = page rows // PT, 1 or 2 (1 for the int4 byte)."""
    if kv_pages.dim() != 4:
        raise ValueError(f"kv_pages must be [Hkv, NP+1, rows, D], got "
                         f"{tuple(kv_pages.shape)}")
    hkv, num_pages_total, page_rows, dk = kv_pages.shape
    pt = page_rows if page_tokens is None else page_tokens
    s_sub = page_rows // pt if pt > 0 else 0
    if s_sub not in (1, 2) or page_rows != s_sub * pt:
        raise ValueError(f"page rows {page_rows} are neither 1 nor 2 · "
                         f"page_tokens {pt}")
    if mode == _MODE_INT4 and (s_sub != 1 or v_tail_zero):
        raise ValueError("int4 pools need [.., page_tokens, D] shared-byte "
                         "pages and no v_tail_zero")
    if dk != head_dim:
        raise ValueError(f"head dim mismatch: q {head_dim}, pool {dk}")
    if not 0 <= v_tail_zero < head_dim:
        raise ValueError(f"v_tail_zero {v_tail_zero} outside [0, "
                         f"{head_dim})")
    if q_heads % hkv:
        raise ValueError(f"Hq={q_heads} is not a multiple of Hkv={hkv}")
    return hkv, num_pages_total, pt, s_sub


def _scale_rows(scales, pages, mp, pt):
    """Per-token scales of the gathered pages [Hkv, ..., MP·PT]."""
    g = scales[:, pages.long()]  # [Hkv, ..., MP, 1, PT]
    return g.reshape(*g.shape[:-3], mp * pt)


def _read_kv(pages, pt, mode, dtype, v_tail_zero):
    """K and V (fp32) of gathered pages [..., rows, D] → [..., PT, D] each:
    float pools in ``dtype``, quantized pools as their integers; V's rows
    are the page's last PT (K's own when S_sub = 1), its last
    ``v_tail_zero`` lanes zeroed."""
    if mode == _MODE_INT4:
        k, v = unpack_kv4(pages)
    else:
        k, v = pages[..., :pt, :], pages[..., -pt:, :]
        if mode == _MODE_FLOAT:
            k, v = k.to(dtype), v.to(dtype)
    k, v = k.float(), v.float()
    if v_tail_zero:
        v = v.clone()
        v[..., v.shape[-1] - v_tail_zero:] = 0.0
    return k, v


def _check_cuda_inputs(name, q, kv_pages, ints, mode, scales, pt):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} has no kernel "
                        f"(float32 or bfloat16)")
    if mode == _MODE_FLOAT:
        if kv_pages.dtype != dtype:
            raise TypeError(f"{name}: q and a float kv_pages must share a "
                            "dtype")
    else:
        if kv_pages.dtype != torch.int8:
            raise TypeError(f"{name}: a quantized pool must be int8")
        want = (kv_pages.shape[0], kv_pages.shape[1], 1, pt)
        for t in scales:
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise TypeError(f"{name}: scales must be fp32 {want}")
    for t in (q, kv_pages, *ints, *scales):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in (q, kv_pages):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: page tables and lengths must be int32")
    check_head_dim(name, q.shape[-1])


def check_head_dim(name: str, d: int):
    """Raise ``ValueError`` unless the kernels take head dim ``d``: any
    from 1 (the split-D kernels above 576)."""
    if d < 1:
        raise ValueError(f"{name}: head dim {d} has no kernel (1 or more)")



def _lane_width(d: int) -> int:
    """The lanes a kernel computes for head dim ``d``: the next multiple
    of 16 (q's and O's rows on the card)."""
    return -(-d // 16) * 16


def _default_scale(d: int, scale: Optional[float]) -> float:
    return float(d) ** -0.5 if scale is None else float(scale)


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """(q.f32 · scale) rounded to q's dtype, returned in fp32."""
    return (q.float() * scale).to(q.dtype).float()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_body(dtype: torch.dtype, head_dim: int) -> str:
    """Which decode kernel a q of ``dtype`` at ``head_dim`` launches:
    "tensor_core" (``paged_decode_tc_kernel``: bf16 mma.sync) for bf16,
    "fp32_fma" (``paged_decode_kernel``: scalar fp32 FMAs, which the 2e-5
    gate needs; TF32 would break it) for fp32, both up to 576; "split_d"
    (``split_d_decode_kernel``: the lanes split over CTAs, as
    ``ops.flash_attention.split_d_slices`` counts them) above 576 in both
    dtypes.  A head dim without a kernel raises ``ValueError``.  The C
    library answers the same (``mfa_paged_bodies``, bits 0 and 2)."""
    check_head_dim("decode_body", head_dim)
    if head_dim > _MAX_FIXED_DIM:
        return "split_d"
    return "tensor_core" if dtype == torch.bfloat16 else "fp32_fma"


def prefill_body(dtype: torch.dtype, head_dim: int, page_states: int,
                 v_tail_zero: int) -> str:
    """Which prefill kernel a q of ``dtype`` at ``head_dim`` over pages of
    ``page_states`` states (S_sub) with ``v_tail_zero`` zeroed V lanes
    launches: "tensor_core" for bf16 where ``head_dim`` ≤ 256, or where
    one-state pages leave ``head_dim − v_tail_zero`` lanes for P·V that
    the width's fp32 O accumulator holds: 256 up to ``head_dim`` 288
    (``paged_prefill_tc_kernel``; MLAConfig()'s 288 − 32), 512 above
    (``paged_prefill_wide_kernel``, O split over two warp groups;
    DeepSeek's 576 − 64); "fp32_fma" (``paged_prefill_kernel``) for fp32
    and every other shape up to 576; "split_d" (``split_d_prefill_kernel``)
    above 576 in both dtypes.  A head dim without a kernel (see
    :func:`check_head_dim`) raises ``ValueError``.  The C launcher routes
    the same way (``prefill_tc``; ``mfa_paged_bodies``, bits 1 and 3)."""
    check_head_dim("prefill_body", head_dim)
    if head_dim > _MAX_FIXED_DIM:
        return "split_d"
    pv_lanes = 256 if head_dim <= 288 else 512
    if dtype == torch.bfloat16 and (
            head_dim <= 256
            or (page_states == 1 and head_dim - v_tail_zero <= pv_lanes)):
        return "tensor_core"
    return "fp32_fma"


def decode_splits(batch: int, kv_heads: int, group: int, capacity: int,
                  sms: int) -> int:
    """The number of splits of the decode's KV axis, from shapes alone
    (no length is read back): the table's ``capacity`` (max_pages · PT)
    in 64-token tiles, dealt into equal ranges of whole tiles, two tiles
    each, or more where the grid (KV heads × 16-row group slices × batch ×
    splits) would exceed eight CTAs for each of ``sms`` SMs.  Each CTA is
    a chain of tile loads, so short ranges keep many loads in flight; a
    split past its sequence's length costs one early exit.  At
    ``chip_smoke.py``'s decode lengths ``utils/profiling.py
    --decode-splits`` found 32 splits (two tiles each) the fastest of
    4–64 for the flagship's decode (batch 8, 4 KV heads, capacity 4096),
    D = 64 and 128, bf16 and int8, and within 7% of the fastest (64) for
    MLA's (batch 8, one KV head): both take 32; a one-page table takes
    one."""
    tiles = -(-capacity // _DECODE_TILE)
    ctas = batch * kv_heads * -(-group // 16)
    per = max(2, -(-tiles * ctas // (8 * sms)))
    return -(-tiles // per)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def paged_decode_attention_plain(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    page_tokens: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    v_tail_zero: int = 0,
    kv_bits: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_decode_attention`."""
    mode = _pool_mode(k_scales, v_scales, kv_bits)
    b, hq, d = q.shape
    hkv, _, pt, _ = _geometry(hq, d, kv_pages, page_tokens, mode,
                              v_tail_zero)
    group = hq // hkv
    mp = page_table.shape[1]
    qs = _prescale(q, _default_scale(d, scale)).view(b, hkv, group, d)
    pages = kv_pages[:, page_table.long()]  # [Hkv, B, MP, rows, D]
    k, v = _read_kv(pages, pt, mode, q.dtype, v_tail_zero)
    k = k.reshape(hkv, b, mp * pt, d)
    v = v.reshape(hkv, b, mp * pt, d)
    s = torch.einsum("bhgd,hbtd->bhgt", qs, k)
    if mode != _MODE_FLOAT:  # [Hkv, B, T] → [B, Hkv, 1, T]
        s = s * _scale_rows(k_scales, page_table, mp, pt).transpose(
            0, 1)[:, :, None]
    col = torch.arange(mp * pt, device=q.device)
    s = s.masked_fill(col >= lengths.long().view(b, 1, 1, 1), float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = p.sum(dim=-1, keepdim=True)
    if mode != _MODE_FLOAT:
        p = p * _scale_rows(v_scales, page_table, mp, pt).transpose(
            0, 1)[:, :, None]
    o = torch.einsum("bhgt,hbtd->bhgd", p.to(q.dtype).float(), v)
    return (o / lsum).to(q.dtype).reshape(b, hq, d)


def paged_decode_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    page_tokens: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    v_tail_zero: int = 0,
    kv_bits: int = 8,
) -> torch.Tensor:
    """Single-token decode attention over a paged KV cache.

    Args:
      q: [B, Hq, D] current-step queries.
      kv_pages: [Hkv, NP+1, S_sub·PT, D] merged page pool (float or int8;
        S_sub = 1 → one state per token is K and V), or the int4 pool
        [Hkv, NP+1, PT, D].
      page_table: [B, max_pages] int32 physical page ids (entries past a
        sequence's last page are ignored; padded slots point at the trash
        page).
      lengths: [B] int32 tokens in each sequence's cache, INCLUDING the
        token being decoded (already appended); every length is ≥ 1.
      page_tokens: PT (default: the pool's rows, S_sub = 1).
      k_scales, v_scales: [Hkv, NP+1, 1, PT] fp32 per-token scales of a
        quantized pool; None for a float pool.
      scale: softmax scale (default D^-0.5).
      v_tail_zero: V's last lanes read as 0 (MLA's rope tail).
      kv_bits: 4 → the int4 pool (needs scales); anything else → int8.

    Returns [B, Hq, D] in q.dtype.  GQA: q head h reads kv head h // group.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, kv_pages, page_table, lengths, page_tokens=page_tokens,
            k_scales=k_scales, v_scales=v_scales, scale=scale,
            v_tail_zero=v_tail_zero, kv_bits=kv_bits,
        )
    mode = _pool_mode(k_scales, v_scales, kv_bits)
    scales = () if mode == _MODE_FLOAT else (k_scales, v_scales)
    b, hq, d = q.shape
    hkv, num_pages_total, pt, s_sub = _geometry(hq, d, kv_pages, page_tokens,
                                                mode, v_tail_zero)
    _check_cuda_inputs("paged_decode", q, kv_pages, (page_table, lengths),
                       mode, scales, pt)
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_decode: page_table [B, MP] / lengths [B] "
                         "do not match q's batch")
    dl = _lane_width(d)
    qk = torch.nn.functional.pad(q, (0, dl - d)) if dl != d else q
    out = torch.empty_like(qk)
    scale_ptrs = [t.data_ptr() for t in scales] or [None, None]
    max_pages = page_table.shape[1]
    splits = decode_splits(b, hkv, hq // hkv, max_pages * pt,
                           _sm_count(q.device.index or 0))
    ws = (torch.empty((b, hq, splits, dl + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    rc = _build.kernel_function("mfa_paged_decode", _DECODE_ARGS)(
        qk.data_ptr(), kv_pages.data_ptr(), *scale_ptrs,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], mode, b, hq, hkv, d, num_pages_total, pt,
        s_sub, v_tail_zero, max_pages, _default_scale(d, scale), splits,
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch(rc, "paged_decode")
    paged_decode_attention.launches += 1
    return out if dl == d else out[..., :d].contiguous()


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


def paged_prefill_attention_plain(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_row: torch.Tensor,
    offset: Union[int, torch.Tensor],
    *,
    page_tokens: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    v_tail_zero: int = 0,
    kv_bits: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_prefill_attention`."""
    mode = _pool_mode(k_scales, v_scales, kv_bits)
    hq, chunk, d = q.shape
    hkv, _, pt, _ = _geometry(hq, d, kv_pages, page_tokens, mode,
                              v_tail_zero)
    rows = (hq // hkv) * chunk
    mp = page_row.shape[0]
    qs = _prescale(q, _default_scale(d, scale)).view(hkv, rows, d)
    pages = kv_pages[:, page_row.long()]  # [Hkv, MP, rows, D]
    k, v = _read_kv(pages, pt, mode, q.dtype, v_tail_zero)
    k = k.reshape(hkv, mp * pt, d)
    v = v.reshape(hkv, mp * pt, d)
    s = torch.einsum("hrd,htd->hrt", qs, k)
    if mode != _MODE_FLOAT:
        s = s * _scale_rows(k_scales, page_row, mp, pt)[:, None]
    # Causal in GLOBAL positions: group-major row r is chunk position
    # r mod chunk and sees columns ≤ offset + (r mod chunk).
    row = torch.arange(rows, device=q.device) % chunk
    col = torch.arange(mp * pt, device=q.device)
    visible = col[None, :] <= int(offset) + row[:, None]
    s = s.masked_fill(~visible, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = p.sum(dim=-1, keepdim=True)
    if mode != _MODE_FLOAT:
        p = p * _scale_rows(v_scales, page_row, mp, pt)[:, None]
    o = torch.einsum("hrt,htd->hrd", p.to(q.dtype).float(), v)
    return (o / lsum).to(q.dtype).reshape(hq, chunk, d)


def paged_prefill_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_row: torch.Tensor,
    offset: Union[int, torch.Tensor],
    *,
    page_tokens: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    v_tail_zero: int = 0,
    kv_bits: int = 8,
) -> torch.Tensor:
    """Chunked-prefill attention for ONE sequence over its paged cache.

    The chunk's K/V must already be written to the pages.  Causal masking
    runs in global coordinates, so the chunk attends to the whole cached
    prefix plus its own triangle.

    Args:
      q: [Hq, chunk, D] chunk queries.
      kv_pages, k_scales, v_scales, v_tail_zero, kv_bits: the pool, as
        for :func:`paged_decode_attention`.
      page_row: [max_pages] int32 physical page ids for this sequence.
      offset: the chunk's first global position (an int; a tensor is read
        back to the host).
      page_tokens: PT (default: the pool's rows, S_sub = 1).
      scale: softmax scale (default D^-0.5).

    Returns [Hq, chunk, D] in q.dtype.
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, kv_pages, page_row, offset, page_tokens=page_tokens,
            k_scales=k_scales, v_scales=v_scales, scale=scale,
            v_tail_zero=v_tail_zero, kv_bits=kv_bits,
        )
    mode = _pool_mode(k_scales, v_scales, kv_bits)
    scales = () if mode == _MODE_FLOAT else (k_scales, v_scales)
    hq, chunk, d = q.shape
    hkv, num_pages_total, pt, s_sub = _geometry(hq, d, kv_pages, page_tokens,
                                                mode, v_tail_zero)
    _check_cuda_inputs("paged_prefill", q, kv_pages, (page_row,), mode,
                       scales, pt)
    if page_row.dim() != 1:
        raise ValueError("paged_prefill: page_row must be [max_pages]")
    offset = int(offset)
    if offset < 0:
        raise ValueError(f"paged_prefill: offset {offset} < 0")
    dl = _lane_width(d)
    qk = torch.nn.functional.pad(q, (0, dl - d)) if dl != d else q
    out = torch.empty_like(qk)
    scale_ptrs = [t.data_ptr() for t in scales] or [None, None]
    rc = _build.kernel_function("mfa_paged_prefill", _PREFILL_ARGS)(
        qk.data_ptr(), kv_pages.data_ptr(), *scale_ptrs,
        page_row.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], mode, hq,
        hkv, chunk, d, num_pages_total, pt, s_sub, v_tail_zero,
        page_row.shape[0], offset, _default_scale(d, scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch(rc, "paged_prefill")
    paged_prefill_attention.launches += 1
    return out if dl == d else out[..., :d].contiguous()


paged_prefill_attention.launches = 0

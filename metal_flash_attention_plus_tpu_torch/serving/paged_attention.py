"""Paged attention over the merged float page pool: decode and chunked prefill.

Each public function keeps the JAX package's signature and layouts
(``metal_flash_attention_plus_tpu/serving/paged_attention.py``) and has a
plain PyTorch version beside it (``*_plain``).  On a CUDA tensor the
wrapper launches its hand-written Hopper kernel
(``csrc/paged_attention.cu``) or raises; the plain version runs only for
tensors on the CPU.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.

Pool: ``kv_pages [Hkv, NP+1, 2·PT, D]`` — K of a page in token rows
``[0, PT)``, V in ``[PT, 2PT)`` (one layer of :class:`PagedKVCache`).
Quantized pools (int8 halves, the int4 shared byte) come with a later slice.

Numerics shared by kernels and plain versions: q is pre-scaled and rounded
back to its dtype, ``(q.f32 · scale).to(q.dtype)``; K and V are read in
q's dtype; scores, softmax statistics and the P·V sum are fp32; P is cast
to V's dtype before P·V; the output is in q's dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from metal_flash_attention_plus_tpu_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_DECODE_MAX_GROUP_ELEMS = 2048  # Hq/Hkv · D held by one decode CTA
_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DECODE_ARGS = [_PTR] * 5 + [_I32] * 8 + [_F32, _PTR]
_PREFILL_ARGS = [_PTR] * 4 + [_I32] * 9 + [_F32, _PTR]


def _geometry(q_heads, head_dim, kv_pages, page_tokens):
    if kv_pages.dim() != 4:
        raise ValueError(f"kv_pages must be [Hkv, NP+1, 2·PT, D], got "
                         f"{tuple(kv_pages.shape)}")
    hkv, num_pages_total, page_rows, dk = kv_pages.shape
    pt = page_rows // 2 if page_tokens is None else page_tokens
    if page_rows != 2 * pt:
        raise ValueError(f"page rows {page_rows} != 2 · page_tokens {pt}")
    if dk != head_dim:
        raise ValueError(f"head dim mismatch: q {head_dim}, pool {dk}")
    if q_heads % hkv:
        raise ValueError(f"Hq={q_heads} is not a multiple of Hkv={hkv}")
    return hkv, num_pages_total, pt


def _check_cuda_inputs(name, floats, ints):
    dev = floats[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    dtype = floats[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} has no kernel "
                        f"(float32 or bfloat16)")
    for t in floats:
        if t.dtype != dtype:
            raise TypeError(f"{name}: q and kv_pages must share a dtype")
    for t in (*floats, *ints):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in floats:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: page tables and lengths must be int32")


def _default_scale(d: int, scale: Optional[float]) -> float:
    return float(d) ** -0.5 if scale is None else float(scale)


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """(q.f32 · scale) rounded to q's dtype, returned in fp32."""
    return (q.float() * scale).to(q.dtype).float()


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
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_decode_attention`."""
    b, hq, d = q.shape
    hkv, _, pt = _geometry(hq, d, kv_pages, page_tokens)
    group = hq // hkv
    mp = page_table.shape[1]
    qs = _prescale(q, _default_scale(d, scale)).view(b, hkv, group, d)
    pages = kv_pages[:, page_table.long()]  # [Hkv, B, MP, 2PT, D]
    k = pages[:, :, :, :pt].reshape(hkv, b, mp * pt, d).to(q.dtype).float()
    v = pages[:, :, :, pt:].reshape(hkv, b, mp * pt, d).to(q.dtype)
    s = torch.einsum("bhgd,hbtd->bhgt", qs, k)
    col = torch.arange(mp * pt, device=q.device)
    s = s.masked_fill(col >= lengths.long().view(b, 1, 1, 1), float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgt,hbtd->bhgd", p.to(v.dtype).float(), v.float())
    return (o / lsum).to(q.dtype).reshape(b, hq, d)


def paged_decode_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    page_tokens: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a paged KV cache.

    Args:
      q: [B, Hq, D] current-step queries.
      kv_pages: [Hkv, NP+1, 2·PT, D] merged page pool.
      page_table: [B, max_pages] int32 physical page ids (entries past a
        sequence's last page are ignored; padded slots point at the trash
        page).
      lengths: [B] int32 tokens in each sequence's cache, INCLUDING the
        token being decoded (already appended); every length is ≥ 1.
      page_tokens: PT (default: pool rows / 2).
      scale: softmax scale (default D^-0.5).

    Returns [B, Hq, D] in q.dtype.  GQA: q head h reads kv head h // group.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, kv_pages, page_table, lengths, page_tokens=page_tokens,
            scale=scale,
        )
    b, hq, d = q.shape
    hkv, num_pages_total, pt = _geometry(hq, d, kv_pages, page_tokens)
    _check_cuda_inputs("paged_decode", (q, kv_pages), (page_table, lengths))
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_decode: head dim {d} not in {_HEAD_DIMS}")
    if (hq // hkv) * d > _DECODE_MAX_GROUP_ELEMS:
        raise ValueError("paged_decode: Hq/Hkv · D exceeds "
                         f"{_DECODE_MAX_GROUP_ELEMS}")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_decode: page_table [B, MP] / lengths [B] "
                         "do not match q's batch")
    out = torch.empty_like(q)
    rc = _build.kernel_function("mfa_paged_decode", _DECODE_ARGS)(
        q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], b, hq,
        hkv, d, num_pages_total, pt, page_table.shape[1],
        _default_scale(d, scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch(rc, "paged_decode")
    paged_decode_attention.launches += 1
    return out


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
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_prefill_attention`."""
    hq, chunk, d = q.shape
    hkv, _, pt = _geometry(hq, d, kv_pages, page_tokens)
    rows = (hq // hkv) * chunk
    mp = page_row.shape[0]
    qs = _prescale(q, _default_scale(d, scale)).view(hkv, rows, d)
    pages = kv_pages[:, page_row.long()]  # [Hkv, MP, 2PT, D]
    k = pages[:, :, :pt].reshape(hkv, mp * pt, d).to(q.dtype).float()
    v = pages[:, :, pt:].reshape(hkv, mp * pt, d).to(q.dtype)
    s = torch.einsum("hrd,htd->hrt", qs, k)
    # Causal in GLOBAL positions: group-major row r is chunk position
    # r mod chunk and sees columns ≤ offset + (r mod chunk).
    row = torch.arange(rows, device=q.device) % chunk
    col = torch.arange(mp * pt, device=q.device)
    visible = col[None, :] <= int(offset) + row[:, None]
    s = s.masked_fill(~visible, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("hrt,htd->hrd", p.to(v.dtype).float(), v.float())
    return (o / lsum).to(q.dtype).reshape(hq, chunk, d)


def paged_prefill_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_row: torch.Tensor,
    offset: Union[int, torch.Tensor],
    *,
    page_tokens: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention for ONE sequence over its paged cache.

    The chunk's K/V must already be written to the pages.  Causal masking
    runs in global coordinates, so the chunk attends to the whole cached
    prefix plus its own triangle.

    Args:
      q: [Hq, chunk, D] chunk queries.
      kv_pages: [Hkv, NP+1, 2·PT, D] merged page pool.
      page_row: [max_pages] int32 physical page ids for this sequence.
      offset: the chunk's first global position (an int; a tensor is read
        back to the host).
      page_tokens: PT (default: pool rows / 2).
      scale: softmax scale (default D^-0.5).

    Returns [Hq, chunk, D] in q.dtype.
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, kv_pages, page_row, offset, page_tokens=page_tokens,
            scale=scale,
        )
    hq, chunk, d = q.shape
    hkv, num_pages_total, pt = _geometry(hq, d, kv_pages, page_tokens)
    _check_cuda_inputs("paged_prefill", (q, kv_pages), (page_row,))
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_prefill: head dim {d} not in {_HEAD_DIMS}")
    if page_row.dim() != 1:
        raise ValueError("paged_prefill: page_row must be [max_pages]")
    offset = int(offset)
    if offset < 0:
        raise ValueError(f"paged_prefill: offset {offset} < 0")
    out = torch.empty_like(q)
    rc = _build.kernel_function("mfa_paged_prefill", _PREFILL_ARGS)(
        q.data_ptr(), kv_pages.data_ptr(), page_row.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], hq, hkv, chunk, d,
        num_pages_total, pt, page_row.shape[0], offset,
        _default_scale(d, scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch(rc, "paged_prefill")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0

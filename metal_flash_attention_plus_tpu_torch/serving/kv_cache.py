"""Paged KV cache — device-side page storage behind the native allocator.

The C++ ``PagePool`` (``cpp/mfa_runtime.cc``) owns page accounting (which
physical page belongs to which sequence); this module owns page storage:
one MERGED pool ``[L, Hkv, NP+1, 2·PT, D]`` per model — K tokens of a page
in rows ``[0, PT)``, V tokens in rows ``[PT, 2PT)`` — plus the scatters
that write prompt and decode-token KV into pages.  The extra last page is
the TRASH page: padded batch slots and padded prefill rows point at it so
their writes never corrupt live data.

The pool is updated IN PLACE.  The JAX package returns a new cache from
every write and donates the old buffer to the jitted program so XLA can
reuse it (``serving/engine.py`` there); in PyTorch the scatter writes the
one pool directly, which is what donation achieves.  Functions still
return the cache so call sites read like their JAX twins.

Quantized pools (``bits=8`` or ``bits=4``) quantize at WRITE time with
SYMMETRIC per-token scales, kept in scale pools laid out as row vectors
``[L, Hkv, NP+1, 1, PT]`` fp32 that the paged kernels read by page id:

- ``bits=8``: int8 K and V halves in the merged pool's rows, scale
  absmax/127, values clipped to [-128, 127];
- ``bits=4``: ONE int8 byte per (token, d) in a pool ``[L, Hkv, NP+1, PT,
  D]`` — K + 8 in the low nibble, V as the signed high nibble (``value <<
  4``, so an arithmetic ``>> 4`` recovers it); scale absmax/7, values
  clipped to [-8, 7].  Half the int8 pool's bytes, a quarter of bf16's.

Payloads and scales are byte-identical with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)


@dataclasses.dataclass
class PagedKVCache:
    kv_pages: torch.Tensor  # [L, Hkv, NP+1, 2·PT (PT for int4), D]
    page_tokens: int
    num_pages: int
    # Per-token scales [L, Hkv, NP+1, 1, PT] of a quantized pool, else None.
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    # Payload width: 16 (float pool), 8 (int8 K/V halves), 4 (the K-low /
    # V-high shared byte).
    bits: int = 16

    @property
    def quantized(self) -> bool:
        return self.bits != 16

    @property
    def trash_page(self) -> int:
        return self.num_pages  # the extra page

    @staticmethod
    def create(
        num_layers: int,
        num_kv_heads: int,
        num_pages: int,
        page_tokens: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        quantized: bool = False,
        bits: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "PagedKVCache":
        """``bits`` 16, 8 or 4 (default: 8 if ``quantized`` else 16);
        ``dtype`` is the float pool's."""
        if bits is None:
            bits = 8 if quantized else 16
        if bits not in (4, 8, 16):
            raise ValueError(f"bits must be 4, 8 or 16, got {bits}")
        dev = resolve_device(device)
        rows = page_tokens if bits == 4 else 2 * page_tokens
        shape = (num_layers, num_kv_heads, num_pages + 1, rows, head_dim)
        if bits == 16:
            return PagedKVCache(
                kv_pages=torch.zeros(shape, dtype=dtype, device=dev),
                page_tokens=page_tokens,
                num_pages=num_pages,
            )
        sshape = (num_layers, num_kv_heads, num_pages + 1, 1, page_tokens)
        return PagedKVCache(
            kv_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            page_tokens=page_tokens,
            num_pages=num_pages,
            k_scales=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scales=torch.zeros(sshape, dtype=torch.float32, device=dev),
            bits=bits,
        )


def _quantize_tokens_sym(x: torch.Tensor, qmax: int = 127):
    """Symmetric per-token: x [..., D] → (q int32 in [−qmax−1, qmax],
    scale [..., 1]); scale absmax/qmax."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / qmax
    q = torch.round(xf / scale).clamp(-qmax - 1, qmax)
    return q.to(torch.int32), scale


def _pack_tokens_kv4(k: torch.Tensor, v: torch.Tensor):
    """Symmetric per-token int4 K and V in ONE byte plane: k, v [..., D] →
    (byte [..., D] int8 with K + 8 in the low nibble and V as the signed
    high nibble, k_scale [..., 1], v_scale [..., 1]).  Scale absmax/7."""
    kq, ks = _quantize_tokens_sym(k, 7)
    vq, vs = _quantize_tokens_sym(v, 7)
    return ((kq + 8) | (vq << 4)).to(torch.int8), ks, vs


def unpack_kv4(byte: torch.Tensor):
    """Inverse of :func:`_pack_tokens_kv4`'s byte plane → (k4, v4) int32 in
    [-8, 7]: K masked out of the low nibble, V by an arithmetic shift."""
    wide = byte.to(torch.int32)
    return (wide & 0xF) - 8, wide >> 4


def _page_slots(cache: PagedKVCache, page_row: torch.Tensor,
                positions: torch.Tensor):
    """(physical page, row within page) of each position.  Logical pages
    past the row clamp to its last entry, as JAX's gather does."""
    logical = torch.clamp(positions // cache.page_tokens,
                          max=page_row.shape[-1] - 1)
    return page_row[..., logical], positions % cache.page_tokens


def _scatter(cache: PagedKVCache, layer: int, pidx, off, k, v):
    """Write token-major K and V [Hkv, T, D] (floats) to (page, row)
    slots, quantizing them as the pool is."""
    pool = cache.kv_pages[layer]  # [Hkv, NP+1, rows, D] view
    pt = cache.page_tokens
    if cache.bits == 16:
        pool[:, pidx, off] = k.to(pool.dtype)
        pool[:, pidx, pt + off] = v.to(pool.dtype)
        return cache
    if cache.bits == 4:
        byte, ks, vs = _pack_tokens_kv4(k, v)
        pool[:, pidx, off] = byte
    else:
        kq, ks = _quantize_tokens_sym(k)
        vq, vs = _quantize_tokens_sym(v)
        pool[:, pidx, off] = kq.to(torch.int8)
        pool[:, pidx, pt + off] = vq.to(torch.int8)
    cache.k_scales[layer][:, :, 0][:, pidx, off] = ks[..., 0]
    cache.v_scales[layer][:, :, 0][:, pidx, off] = vs[..., 0]
    return cache


def write_prompt(
    cache: PagedKVCache,
    layer: int,
    k: torch.Tensor,  # [Hkv, L, D]
    v: torch.Tensor,
    page_row: torch.Tensor,  # [max_pages] physical ids for this sequence
    offset: int = 0,
) -> PagedKVCache:
    """Scatter a prompt's (or a prompt chunk's, from global position
    ``offset``) KV into the sequence's pages, in place."""
    t = offset + torch.arange(k.shape[1], device=k.device)
    pidx, off = _page_slots(cache, page_row.long(), t)
    return _scatter(cache, layer, pidx, off, k, v)


def append_tokens(
    cache: PagedKVCache,
    layer: int,
    k: torch.Tensor,  # [B, Hkv, D] — the new token per sequence
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] token index being written (0-based)
    page_tables: torch.Tensor,  # [B, max_pages]
) -> PagedKVCache:
    """Batched single-token append (decode step), in place."""
    rows = torch.arange(k.shape[0], device=k.device)
    logical = torch.clamp(positions.long() // cache.page_tokens,
                          max=page_tables.shape[1] - 1)
    pidx = page_tables.long()[rows, logical]
    off = positions.long() % cache.page_tokens
    return _scatter(cache, layer, pidx, off, k.transpose(0, 1),
                    v.transpose(0, 1))


def gather_kv(
    cache: PagedKVCache, layer: int, page_row: torch.Tensor, seq_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densify one sequence's KV ([Hkv, seq_len, D]) — test/debug helper;
    quantized pools come back dequantized in fp32."""
    t = torch.arange(seq_len, device=cache.kv_pages.device)
    pidx, off = _page_slots(cache, page_row.long(), t)
    pool = cache.kv_pages[layer]
    pt = cache.page_tokens
    if cache.bits == 4:
        k, v = unpack_kv4(pool[:, pidx, off])
    else:
        k, v = pool[:, pidx, off], pool[:, pidx, pt + off]
    if not cache.quantized:
        return k, v
    ks = cache.k_scales[layer][:, :, 0][:, pidx, off]  # [Hkv, L]
    vs = cache.v_scales[layer][:, :, 0][:, pidx, off]
    return k.float() * ks[..., None], v.float() * vs[..., None]

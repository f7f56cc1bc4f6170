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

Only the float pool exists in this slice; ``bits=8`` (int8 halves with
row-vector scales) and ``bits=4`` (the K-low/V-high shared byte) raise
``NotImplementedError`` until the quantized-pool slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)


@dataclasses.dataclass
class PagedKVCache:
    kv_pages: torch.Tensor  # [L, Hkv, NP+1, 2·PT, D]
    page_tokens: int
    num_pages: int

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
        bits: int = 16,
        device: DeviceLike = None,
    ) -> "PagedKVCache":
        if bits in (4, 8):
            raise NotImplementedError(
                f"{bits}-bit KV pools come with the quantized serving slice"
            )
        if bits != 16:
            raise ValueError(f"bits must be 4, 8 or 16, got {bits}")
        shape = (num_layers, num_kv_heads, num_pages + 1, 2 * page_tokens,
                 head_dim)
        return PagedKVCache(
            kv_pages=torch.zeros(shape, dtype=dtype,
                                 device=resolve_device(device)),
            page_tokens=page_tokens,
            num_pages=num_pages,
        )


def _page_slots(cache: PagedKVCache, page_row: torch.Tensor,
                positions: torch.Tensor):
    """(physical page, row within page) of each position.  Logical pages
    past the row clamp to its last entry, as JAX's gather does."""
    logical = torch.clamp(positions // cache.page_tokens,
                          max=page_row.shape[-1] - 1)
    return page_row[..., logical], positions % cache.page_tokens


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
    pool = cache.kv_pages[layer]  # [Hkv, NP+1, 2PT, D] view
    pool[:, pidx, off] = k.to(pool.dtype)
    pool[:, pidx, cache.page_tokens + off] = v.to(pool.dtype)
    return cache


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
    pool = cache.kv_pages[layer]
    pool[:, pidx, off] = k.transpose(0, 1).to(pool.dtype)
    pool[:, pidx, cache.page_tokens + off] = v.transpose(0, 1).to(pool.dtype)
    return cache


def gather_kv(
    cache: PagedKVCache, layer: int, page_row: torch.Tensor, seq_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densify one sequence's KV ([Hkv, seq_len, D]) — test/debug helper."""
    t = torch.arange(seq_len, device=cache.kv_pages.device)
    pidx, off = _page_slots(cache, page_row.long(), t)
    pool = cache.kv_pages[layer]
    return pool[:, pidx, off], pool[:, pidx, cache.page_tokens + off]

"""Ulysses sequence parallelism: an all-to-all from sequence to heads.

The port of the JAX package's ``parallel/ulysses.py``.  Instead of passing
KV chunks around a ring, re-shard once: the sequence-sharded
[B, H, S/N, D] becomes head-sharded [B, H/N, S, D] through one all-to-all
per operand, :func:`ops.flash_attention.flash_attention` runs on the local
heads over the whole sequence (so every mask it takes works unchanged),
and one more all-to-all brings O back to sequence shards.

The all-to-all is the JAX ``all_to_all(split_axis, concat_axis,
tiled=True)``: head chunk j goes to rank j, and the sequence chunks that
arrive are concatenated in rank order.  Its gradient is the inverse
all-to-all: :func:`parallel.comm.all_to_all` is differentiable, and the
reshapes around it carry their own gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import (
    CAUSAL,
    MaskSpec,
    Ranges,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention,
)
from metal_flash_attention_plus_tpu_torch.parallel.comm import (
    all_to_all,
    rank_and_size,
)


def _to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, H, S/N, D] → [B, H/N, S, D]."""
    n = rank_and_size(group)[1]
    b, h, s_loc, d = x.shape
    parts = x.reshape(b, n, h // n, s_loc, d).transpose(0, 1)
    out = all_to_all(parts, group)  # [N (sequence chunk), B, H/N, S/N, D]
    return out.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s_loc, d)


def _to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, H/N, S, D] → [B, H, S/N, D], the inverse of :func:`_to_heads`."""
    n = rank_and_size(group)[1]
    b, h_loc, s, d = x.shape
    parts = x.reshape(b, h_loc, n, s // n, d).permute(2, 0, 1, 3, 4)
    out = all_to_all(parts, group)  # [N (head chunk), B, H/N, S/N, D]
    return out.transpose(0, 1).reshape(b, n * h_loc, s // n, d)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    *,
    mask: MaskSpec = CAUSAL,
    mask_ranges: Optional[Ranges] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
) -> torch.Tensor:
    """Sequence-parallel attention through a head ↔ sequence all-to-all.

    Args:
      q: the local [B, Hq, S_local, D]; Hq must be divisible by the group's
        size N.
      k, v: the local [B, Hkv, S_local, D]; KV heads are repeated up to N
        first where Hkv < N (the grouped GQA mapping absorbs it).
      group: the process group of the context axis (``None``: the default
        group).
      mask, mask_ranges, bias: as :func:`ops.flash_attention.flash_attention`
        takes them over the full sequence; a bias covers the local heads.

    Returns the local O chunk [B, Hq, S_local, D] in q's dtype;
    differentiable in q, k, v (and the bias).
    """
    n = rank_and_size(group)[1]
    hq, hkv = q.shape[1], k.shape[1]
    if hq % n != 0:
        raise ValueError(f"Hq={hq} not divisible by axis size {n}")
    if interleaved_kv and hkv != hq and n > 1:
        # The interleaved (h % Hkv) mapping is global over heads; the
        # all-to-all's contiguous head split cannot keep it.
        raise ValueError(
            "ulysses_attention: interleaved_kv GQA is unsupported "
            "(contiguous head chunks cross interleaved kv groups)")
    if hkv % n != 0:
        if n % hkv != 0:
            raise ValueError(f"Hkv={hkv} vs axis size {n}: need "
                             "divisibility")
        # Each shard gets at least one KV head; the grouped mapping keeps
        # each q-head chunk aligned with its kv head after the all-to-all.
        k = k.repeat_interleave(n // hkv, dim=1)
        v = v.repeat_interleave(n // hkv, dim=1)
    o_h = flash_attention(
        _to_heads(q, group), _to_heads(k, group), _to_heads(v, group), bias,
        mask_ranges, mask=mask, scale=scale, block_sizes=block_sizes,
        interleaved_kv=interleaved_kv)
    return _to_seq(o_h, group)

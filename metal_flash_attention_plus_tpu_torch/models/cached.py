"""KV-cached transformer execution: prefill into pages + paged decode.

The serving-side twin of ``models/transformer.py`` (same parameters, same
math).  ``prefill`` runs a whole prompt through the causal flash forward
kernel and scatters its K/V into the pages; ``prefill_chunk`` scatters a
chunk's K/V and runs the paged-prefill kernel over prefix + chunk;
``decode_step`` appends one token per sequence and runs the paged-decode
kernel.  The cache is updated in place (see :mod:`serving.kv_cache`); a
quantized pool (int8 or int4) is quantized as it is written and read by
the paged kernels' quantized modes.  Quantized weights
(``models.quantized_inference.quantize_weights``) run through ``linear``'s
W8A8 / W4A8 GEMM.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch._device import DeviceLike
from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    _merge_heads,
    _split_heads,
    linear,
    rms_norm,
    rope,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from metal_flash_attention_plus_tpu_torch.serving.kv_cache import (
    PagedKVCache,
    append_tokens,
    write_prompt,
)
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)


def init_cache(
    cfg: TransformerConfig,
    num_pages: int,
    page_tokens: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: Union[bool, int] = False,
    device: DeviceLike = None,
) -> PagedKVCache:
    """Page pool for ``cfg``.  ``quantized``: False → float pool in
    ``dtype``; True or 8 → int8 halves; 4 → the int4 shared byte (K low
    nibble, V high nibble)."""
    bits = {False: 16, True: 8, 8: 8, 4: 4}[quantized]
    return PagedKVCache.create(
        cfg.num_layers, cfg.num_kv_heads, num_pages, page_tokens,
        cfg.head_dim, dtype, bits=bits, device=device,
    )


def _pool(cache: PagedKVCache, li: int):
    """Layer ``li``'s pool arguments of the paged kernels."""
    if not cache.quantized:
        return dict(page_tokens=cache.page_tokens)
    return dict(page_tokens=cache.page_tokens,
                k_scales=cache.k_scales[li], v_scales=cache.v_scales[li],
                kv_bits=cache.bits)


def _mlp(layer, x):
    h2 = rms_norm(x, layer["ln2"])
    y = F.silu(linear(h2, layer["wg"], torch.float32)) * linear(
        h2, layer["wu"], torch.float32
    )
    return x + linear(y.to(x.dtype), layer["wd"], x.dtype)


def prefill(
    params,
    tokens: torch.Tensor,  # [L] one sequence's prompt
    cache: PagedKVCache,
    page_row: torch.Tensor,  # [max_pages] int32, trash-padded
    cfg: TransformerConfig,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Run a whole prompt and fill the cache → (last-position logits [V]
    fp32, cache).  Attention is the causal flash forward kernel."""
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens][None]  # [1, L, D]
    hd = cfg.head_dim
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln1"])
        q = _split_heads(linear(h, layer["wq"]), cfg.num_heads, hd)
        k = _split_heads(linear(h, layer["wk"]), cfg.num_kv_heads, hd)
        v = _split_heads(linear(h, layer["wv"]), cfg.num_kv_heads, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        write_prompt(cache, li, k[0], v[0], page_row)
        o = flash_attention(q, k, v, mask=CAUSAL, block_sizes=cfg.block_sizes)
        x = x + linear(_merge_heads(o.to(x.dtype)), layer["wo"], x.dtype)
        x = _mlp(layer, x)
    hf = rms_norm(x[:, -1:], params["ln_f"])
    logits = linear(hf, params["unembed"], torch.float32)
    return logits[0, 0], cache


def prefill_chunk(
    params,
    tokens: torch.Tensor,  # [C] one chunk of one sequence's prompt
    offset: Union[int, torch.Tensor],  # chunk's first global position
    last_index: Union[int, torch.Tensor],  # row whose logits to return
    cache: PagedKVCache,
    page_row: torch.Tensor,  # [max_pages] int32, trash-padded
    cfg: TransformerConfig,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Chunked prefill: attend to the cached prefix + this chunk's causal
    triangle → (logits[last_index] [V] fp32, cache).

    The engine pads chunks to its fixed size: pad rows write KV into
    positions past the sequence end (unreserved page slots map to the
    trash page) and their outputs are ignored via ``last_index``.
    """
    offset = int(offset)
    c = tokens.shape[0]
    positions = (offset + torch.arange(c, device=tokens.device))[None]
    x = params["embed"][tokens][None]  # [1, C, D]
    hd = cfg.head_dim
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln1"])
        q = _split_heads(linear(h, layer["wq"]), cfg.num_heads, hd)
        k = _split_heads(linear(h, layer["wk"]), cfg.num_kv_heads, hd)
        v = _split_heads(linear(h, layer["wv"]), cfg.num_kv_heads, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        # Scatter this chunk's KV, then attend over prefix + chunk.
        write_prompt(cache, li, k[0], v[0], page_row, offset=offset)
        o = paged_prefill_attention(
            q[0].contiguous(), cache.kv_pages[li], page_row, offset,
            **_pool(cache, li),
        )  # [Hq, C, D]
        attn = o.transpose(0, 1).reshape(1, c, -1).to(x.dtype)
        x = _mlp(layer, x + linear(attn, layer["wo"], x.dtype))
    h_last = rms_norm(x[0, int(last_index)][None, None], params["ln_f"])
    logits = linear(h_last, params["unembed"], torch.float32)
    return logits[0, 0], cache


def decode_step(
    params,
    tokens: torch.Tensor,  # [B] the just-sampled token per sequence
    lengths: torch.Tensor,  # [B] int32 length INCLUDING this token
    page_tables: torch.Tensor,  # [B, max_pages] int32
    cache: PagedKVCache,
    cfg: TransformerConfig,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode step for a batch of sequences → (logits [B, V], cache)."""
    positions = lengths - 1  # this token's index
    x = params["embed"][tokens][:, None]  # [B, 1, D]
    hd = cfg.head_dim
    pos2d = positions[:, None]  # [B, 1] per-sequence RoPE position
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln1"])
        q = _split_heads(linear(h, layer["wq"]), cfg.num_heads, hd)
        k = _split_heads(linear(h, layer["wk"]), cfg.num_kv_heads, hd)
        v = _split_heads(linear(h, layer["wv"]), cfg.num_kv_heads, hd)
        q = rope(q, pos2d, cfg.rope_theta)
        k = rope(k, pos2d, cfg.rope_theta)
        append_tokens(cache, li, k[:, :, 0], v[:, :, 0], positions,
                      page_tables)
        o = paged_decode_attention(
            q[:, :, 0].contiguous(), cache.kv_pages[li], page_tables,
            lengths, **_pool(cache, li),
        )  # [B, Hq, D]
        x = x + linear(o.reshape(x.shape[0], 1, -1), layer["wo"], x.dtype)
        x = _mlp(layer, x)
    hf = rms_norm(x, params["ln_f"])
    logits = linear(hf, params["unembed"], torch.float32)
    return logits[:, 0], cache

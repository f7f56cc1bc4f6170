"""MLA serving: latent-cache prefill and decode over the paged pools.

The twin of the JAX package's ``models/cached_mla.py``.  The per-token
cache state is ONE vector ``[c_kv | k_rope]`` of width d_c + d_r shared
by every head (vs 2·H·d_h for GQA).  One page pool serves both K and V:
pages hold one state per token (S_sub = 1), and the paged kernels read K
as the whole vector and V with the rope tail zeroed (``v_tail_zero``), at
the latent width as head dim with one KV head (an MQA problem).  W_uk is
absorbed into the query and W_uv applied to the latent output, in fp32.

The pool is updated in place (see :mod:`serving.kv_cache`); a quantized
pool holds int8 states with one symmetric scale per token, which serves
as both the K and the V scale.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.models.mla_transformer import (
    MLAConfig,
    mla_layer_kv,
    mla_layer_q,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    linear,
    rms_norm,
)
from metal_flash_attention_plus_tpu_torch.serving.kv_cache import (
    PagedKVCache,
    _page_slots,
    _quantize_tokens_sym,
)
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)


def init_mla_cache(
    cfg: MLAConfig,
    num_pages: int,
    page_tokens: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: Union[bool, int] = False,
    device: DeviceLike = None,
) -> PagedKVCache:
    """One pool of [c | k_rope] states, ``[L, 1, NP+1, PT, d_c + d_r]``
    (S_sub = 1: K is V, the kernels zero V's rope tail).  ``quantized``
    (True or 8): int8 states and per-token symmetric scales
    ``[L, 1, NP+1, 1, PT]`` — d_c + d_r bytes per token; the scale pool is
    both ``k_scales`` and ``v_scales``.  int4 pools take no rope tail, so
    ``quantized=4`` raises."""
    if quantized not in (False, True, 8):
        raise ValueError(f"MLA latent pools are float or int8, got "
                         f"quantized={quantized!r}")
    dev = resolve_device(device)
    shape = (cfg.num_layers, 1, num_pages + 1, page_tokens, cfg.cache_width)
    if not quantized:
        return PagedKVCache(
            kv_pages=torch.zeros(shape, dtype=dtype, device=dev),
            page_tokens=page_tokens, num_pages=num_pages)
    scales = torch.zeros((cfg.num_layers, 1, num_pages + 1, 1, page_tokens),
                         dtype=torch.float32, device=dev)
    return PagedKVCache(
        kv_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
        page_tokens=page_tokens, num_pages=num_pages, k_scales=scales,
        v_scales=scales, bits=8)


def _write_state(cache: PagedKVCache, li: int, pidx, off, state):
    """Scatter per-token states [T, d_c + d_r] to (page, row) slots,
    quantizing them if the pool is, in place."""
    if cache.quantized:
        q, scale = _quantize_tokens_sym(state)
        cache.kv_pages[li, 0, pidx, off] = q.to(torch.int8)
        cache.k_scales[li, 0, pidx, 0, off] = scale[..., 0]
    else:
        cache.kv_pages[li, 0, pidx, off] = state.to(cache.kv_pages.dtype)
    return cache


def _kv_scale_args(cache: PagedKVCache, li: int):
    if cache.quantized:
        return dict(k_scales=cache.k_scales[li], v_scales=cache.k_scales[li])
    return {}


def _attn_scale(cfg: MLAConfig) -> float:
    return float(cfg.head_dim + cfg.rope_dim) ** -0.5


def _q_latent(layer, q, qr, cfg: MLAConfig) -> torch.Tensor:
    """Absorb W_uk and append the rope part → fp32 [B, H, S, d_c + d_r]."""
    q_lat = torch.einsum("bhsd,hdc->bhsc", q.float(), layer["w_uk"].float())
    return torch.cat([q_lat, qr.float()], dim=-1)


def _mlp(layer, x):
    h2 = rms_norm(x, layer["ln2"])
    y = F.silu(linear(h2, layer["wg"], torch.float32)) * linear(
        h2, layer["wu"], torch.float32)
    return x + linear(y.to(x.dtype), layer["wd"], x.dtype)


def mla_prefill_chunk(
    params,
    tokens: torch.Tensor,  # [C] one chunk of one sequence's prompt
    offset: Union[int, torch.Tensor],  # chunk's first global position
    last_index: Union[int, torch.Tensor],  # row whose logits to return
    cache: PagedKVCache,
    page_row: torch.Tensor,  # [max_pages] int32, trash-padded
    cfg: MLAConfig,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Chunked prefill: write the chunk's latent states, then attend over
    prefix + chunk → (logits[last_index] [V] fp32, cache)."""
    offset = int(offset)
    c = tokens.shape[0]
    positions = offset + torch.arange(c, device=tokens.device)
    x = params["embed"][tokens][None]  # [1, C, D]
    pos2d = positions[None]
    for li, layer in enumerate(params["layers"]):
        hn = rms_norm(x, layer["ln1"])
        q, qr = mla_layer_q(layer, hn, pos2d, cfg)
        c_kv, k_rope = mla_layer_kv(layer, hn, pos2d, cfg)
        state = torch.cat([c_kv, k_rope], dim=-1)[0]  # [C, d_c + d_r]
        pidx, off = _page_slots(cache, page_row.long(), positions)
        _write_state(cache, li, pidx, off, state)
        q_lat = _q_latent(layer, q, qr, cfg)[0].to(x.dtype)
        o_lat = paged_prefill_attention(
            q_lat.contiguous(), cache.kv_pages[li], page_row, offset,
            page_tokens=cache.page_tokens, scale=_attn_scale(cfg),
            v_tail_zero=cfg.rope_dim, **_kv_scale_args(cache, li),
        )  # [H, C, d_c + d_r]
        o = torch.einsum("hsc,hcd->hsd", o_lat[..., :cfg.latent_dim].float(),
                         layer["w_uv"].float())  # [H, C, dh]
        attn = o.transpose(0, 1).reshape(1, c, -1).to(x.dtype)
        x = _mlp(layer, x + linear(attn, layer["wo"], x.dtype))
    h_last = rms_norm(x[0, int(last_index)][None, None], params["ln_f"])
    return linear(h_last, params["unembed"], torch.float32)[0, 0], cache


def mla_decode_step(
    params,
    tokens: torch.Tensor,  # [B] the just-sampled token per sequence
    lengths: torch.Tensor,  # [B] int32 length INCLUDING this token
    page_tables: torch.Tensor,  # [B, max_pages] int32
    cache: PagedKVCache,
    cfg: MLAConfig,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode step for a batch of sequences → (logits [B, V], cache)."""
    b = tokens.shape[0]
    positions = lengths.long() - 1  # this token's index
    x = params["embed"][tokens][:, None]  # [B, 1, D]
    pos2d = positions[:, None]
    rows = torch.arange(b, device=tokens.device)
    logical = torch.clamp(positions // cache.page_tokens,
                          max=page_tables.shape[1] - 1)
    pidx = page_tables.long()[rows, logical]
    off = positions % cache.page_tokens
    for li, layer in enumerate(params["layers"]):
        hn = rms_norm(x, layer["ln1"])
        q, qr = mla_layer_q(layer, hn, pos2d, cfg)  # [B, H, 1, ·]
        c_kv, k_rope = mla_layer_kv(layer, hn, pos2d, cfg)  # [B, 1, ·]
        state = torch.cat([c_kv, k_rope], dim=-1)[:, 0]  # [B, d_c + d_r]
        _write_state(cache, li, pidx, off, state)
        q_lat = _q_latent(layer, q, qr, cfg)[:, :, 0].to(x.dtype)
        o_lat = paged_decode_attention(
            q_lat.contiguous(), cache.kv_pages[li], page_tables, lengths,
            page_tokens=cache.page_tokens, scale=_attn_scale(cfg),
            v_tail_zero=cfg.rope_dim, **_kv_scale_args(cache, li),
        )  # [B, H, d_c + d_r]
        o = torch.einsum("bhc,hcd->bhd", o_lat[..., :cfg.latent_dim].float(),
                         layer["w_uv"].float())
        x = _mlp(layer, x + linear(o.reshape(b, 1, -1).to(x.dtype),
                                   layer["wo"], x.dtype))
    hf = rms_norm(x, params["ln_f"])
    return linear(hf, params["unembed"], torch.float32)[:, 0], cache

"""Weight-quantized (W8A8 / W4A8) transformer inference.

The twin of the JAX package's ``models/quantized_inference.py``: every
projection weight is stored as a :class:`QuantizedTensor` (int8 per output
channel, ROW symmetric, by default; ``bits=4`` for W4A8) over the
transposed ``[out, in]`` layout, and every matmul runs the dynamic GEMM
(:func:`ops.quantized_gemm.dynamic_quantized_matmul`): activations are
quantized per row at run time and the product is integer.
:func:`quantized_forward` is the uncached forward that the cached serving
path (``models/cached.py`` through ``linear``) is held to.

Inference only: no gradient flows through the integer weights.
``quantize_kv=True`` also runs attention over K/V quantized at run time
(the fully quantized pipeline): through the head-pair kernel in the packed
d=64 layout (``packed_d64``), or through the quantized forward kernel with
int8 Q scores.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    _merge_heads,
    _merge_heads_packed,
    _split_heads,
    _split_heads_packed,
    linear,
    rms_norm,
    rope,
    rope_packed,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    flash_attention_forward,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    quantized_flash_attention_forward,
    quantized_flash_attention_forward_packed,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    quantize,
)

Params = Dict[str, Any]

WEIGHT_CFG = QuantConfig(
    bits=8,
    granularity=QuantGranularity.ROW,
    strategy=QuantStrategy.SYMMETRIC,
)

_PROJ_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
_MLA_PROJ_KEYS = ("wq", "wqr", "wdkv", "wkr", "wo", "wg", "wu", "wd")


def quantize_weights(params: Params, cfg: QuantConfig = WEIGHT_CFG) -> Params:
    """Float params → quantized params: each projection ``[in, out]`` becomes
    a :class:`QuantizedTensor` over the TRANSPOSED ``[out, in]`` layout (per
    output channel scales; the GEMM's Bᵀ operand).  The embedding (a
    gather) and the norm gains stay float; the unembedding is quantized
    too.  The payloads lie on the weights' device."""

    def qt(w):
        return quantize(w.t().float(), cfg)

    out = dict(params)
    out["layers"] = [
        {k: (qt(v) if k in _PROJ_KEYS else v) for k, v in layer.items()}
        for layer in params["layers"]
    ]
    out["unembed"] = qt(params["unembed"])
    return out


def quantize_mla_weights(params: Params,
                         cfg: QuantConfig = WEIGHT_CFG) -> Params:
    """The MLA family's :func:`quantize_weights`: every 2-D projection
    (NoPE and RoPE queries, latent down-projection, shared RoPE key,
    output, MLP, unembedding) becomes a transposed :class:`QuantizedTensor`;
    the absorbed 3-D up-projections ``w_uk`` / ``w_uv`` stay float (they
    ride inside the latent attention, not through a GEMM)."""

    def qt(w):
        return quantize(w.t().float(), cfg)

    out = dict(params)
    out["layers"] = [
        {k: (qt(v) if k in _MLA_PROJ_KEYS else v) for k, v in layer.items()}
        for layer in params["layers"]
    ]
    out["unembed"] = qt(params["unembed"])
    return out


def quantized_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    *,
    quantize_kv: bool = False,
    positions=None,
    packed_d64=None,
) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] fp32, every projection through the
    dynamic GEMM.

    Attention is the causal flash forward kernel, or with ``quantize_kv``
    the fully quantized pipeline: K/V quantized at run time to int8,
    SYMMETRIC, and attention over them.  ``packed_d64`` (None: on when
    ``quantize_kv``, head_dim 64, an even head count and S % 128 == 0) runs
    it in the packed head-pair layout: Q comes packed out of its
    projection, RoPE rotates each 64-lane half, O goes packed into ``wo``,
    K/V take per-CHANNEL scales and the head-pair kernel runs; otherwise
    K/V take per-token (ROW) scales and the quantized forward kernel runs
    with int8 Q (``quantize_q``).
    """
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    if packed_d64 is None:
        packed_d64 = (quantize_kv and cfg.head_dim == 64
                      and cfg.num_heads % 2 == 0 and s % 128 == 0)
    kv_cfg = QuantConfig(
        bits=8,
        granularity=(QuantGranularity.CHANNEL if packed_d64
                     else QuantGranularity.ROW),
        strategy=QuantStrategy.SYMMETRIC,
    )
    x = params["embed"][tokens]
    dt = x.dtype
    for layer in params["layers"]:
        h = rms_norm(x, layer["ln1"])
        qh = linear(h, layer["wq"], dt)
        k = _split_heads(linear(h, layer["wk"], dt), cfg.num_kv_heads,
                         cfg.head_dim)
        v = _split_heads(linear(h, layer["wv"], dt), cfg.num_kv_heads,
                         cfg.head_dim)
        k = rope(k, positions, cfg.rope_theta)
        if packed_d64 or quantize_kv:
            kq, vq = quantize(k.float(), kv_cfg), quantize(v.float(), kv_cfg)
        if packed_d64:
            q = rope_packed(_split_heads_packed(qh, cfg.num_heads), positions,
                            cfg.rope_theta)
            o, _ = quantized_flash_attention_forward_packed(
                q, kq, vq, mask=CAUSAL, block_sizes=cfg.block_sizes)
            merged = _merge_heads_packed(o.to(dt))
        else:
            q = rope(_split_heads(qh, cfg.num_heads, cfg.head_dim), positions,
                     cfg.rope_theta)
            if quantize_kv:
                o, _ = quantized_flash_attention_forward(
                    q, kq, vq, mask=CAUSAL, block_sizes=cfg.block_sizes,
                    quantize_q=True)
            else:
                o, _ = flash_attention_forward(q, k, v, mask=CAUSAL,
                                               block_sizes=cfg.block_sizes)
            merged = _merge_heads(o.to(dt))
        x = x + linear(merged, layer["wo"], dt)
        h2 = rms_norm(x, layer["ln2"])
        y = F.silu(linear(h2, layer["wg"], torch.float32)) * linear(
            h2, layer["wu"], torch.float32)
        x = x + linear(y.to(dt), layer["wd"], dt)
    hf = rms_norm(x, params["ln_f"])
    return linear(hf, params["unembed"], torch.float32)


def memory_footprint(params: Params) -> Dict[str, int]:
    """Bytes of the parameters: payload, scales and zero points of each
    quantized weight, the whole of each float one."""

    def nbytes(t):
        if isinstance(t, QuantizedTensor):
            return sum(x.numel() * x.element_size()
                       for x in (t.data, t.scale, t.zero_point))
        return t.numel() * t.element_size()

    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(walk(v) for v in node)
        return nbytes(node)

    return {"total_bytes": walk(params)}

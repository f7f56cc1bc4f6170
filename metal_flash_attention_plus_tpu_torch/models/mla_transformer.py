"""MLA (multi-latent attention) transformer, in PyTorch.

The twin of the JAX package's ``models/mla_transformer.py``: per layer the
KV path is compressed to a shared latent ``c_kv = x·W_dkv`` ([d_model →
d_c]) plus a small decoupled-RoPE key ``k_rope = rope(x·W_kr)`` shared by
every head; queries carry a NoPE part (absorbed against W_uk) and a RoPE
part.  The per-token cache state is ``d_c + d_r`` values instead of
``2·H·d_h``.  Parameters are a plain dict mirroring the JAX pytree, weights
in ``[in, out]`` layout (``w_uk [H, dh, d_c]``, ``w_uv [H, d_c, dh]``).

Projections go through the polymorphic :func:`models.transformer.linear`,
so quantized weights (:func:`models.quantized_inference.
quantize_mla_weights`) run the dynamic W8A8 GEMM.  ``mla_forward`` runs
:func:`ops.mla.mla_absorbed_attention` (the flash kernels at head dim
d_c + d_r) unless ``attn_fn`` names another attention;
``attn_fn=plain_mla_attention`` gives the decompress-then-attend dense
fp32 reference, an oracle that runs no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    linear,
    rms_norm,
    rope,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
)
from metal_flash_attention_plus_tpu_torch.ops.mla import (
    mla_absorbed_attention,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    vocab_size: int = 32768
    d_model: int = 1024
    num_layers: int = 8
    num_heads: int = 16
    head_dim: int = 64  # per-head NoPE dim (absorbed against the latent)
    latent_dim: int = 256  # d_c, the shared compressed KV width
    rope_dim: int = 32  # d_r, the decoupled positional key width
    d_ff: int = 4096
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Tiles of the JAX package's Pallas grids; the Hopper kernels choose
    # their own (the quantized latent's int8 P reads block_kv).
    block_sizes: BlockSizes = BlockSizes()

    @property
    def cache_width(self) -> int:
        """Per-token serving-cache state: latent + rope key."""
        return self.latent_dim + self.rope_dim


def init_mla_params(
    cfg: MLAConfig,
    generator: torch.Generator,
    device: DeviceLike = None,
) -> Params:
    """Scaled-normal init (fp32 normals · fan_in^-0.5, stored in
    ``cfg.dtype``); norm weights are fp32 ones.  The numbers come from
    ``generator``, drawn on its device (a CUDA generator draws a
    full-width model on the card, in a fraction of the host's time, and
    other numbers than a CPU one), and differ from ``jax.random``'s; to
    compare with the JAX package, convert its parameters with
    :func:`models.convert.params_from_jax`."""
    dev = resolve_device(device)
    d, h, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    dc, dr, f, v = cfg.latent_dim, cfg.rope_dim, cfg.d_ff, cfg.vocab_size

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * fan_in ** -0.5).to(device=dev, dtype=cfg.dtype)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=dev)

    embed = dense((v, d), d)
    unembed = dense((d, v), d)
    layers = [
        dict(
            ln1=ones(),
            wq=dense((d, h * dh), d),  # NoPE queries
            wqr=dense((d, h * dr), d),  # RoPE queries
            wdkv=dense((d, dc), d),  # latent down-projection
            wkr=dense((d, dr), d),  # shared RoPE key
            w_uk=dense((h, dh, dc), dc),  # key up (absorbed)
            w_uv=dense((h, dc, dh), dc),  # value up
            wo=dense((h * dh, d), h * dh),
            ln2=ones(),
            wg=dense((d, f), d),
            wu=dense((d, f), d),
            wd=dense((f, d), f),
        )
        for _ in range(cfg.num_layers)
    ]
    return dict(embed=embed, layers=layers, ln_f=ones(), unembed=unembed)


def mla_layer_kv(layer, h_norm, positions, cfg: MLAConfig):
    """The per-token cache state: (c_kv [B, S, d_c], k_rope [B, S, d_r])."""
    c_kv = linear(h_norm, layer["wdkv"])
    k_rope = rope(linear(h_norm, layer["wkr"])[:, None],  # head-shared
                  positions, cfg.rope_theta)[:, 0]
    return c_kv, k_rope


def mla_layer_q(layer, h_norm, positions, cfg: MLAConfig):
    """Per-head queries: (q_nope [B, H, S, dh], q_rope [B, H, S, d_r])."""
    b, s, _ = h_norm.shape
    h, dh, dr = cfg.num_heads, cfg.head_dim, cfg.rope_dim
    q = linear(h_norm, layer["wq"]).reshape(b, s, h, dh).transpose(1, 2)
    qr = linear(h_norm, layer["wqr"]).reshape(b, s, h, dr).transpose(1, 2)
    return q, rope(qr, positions, cfg.rope_theta)


def plain_mla_attention(q, c_kv, w_uk, w_uv, *, q_rope=None, k_rope=None,
                        mask=CAUSAL, **_):
    """Decompress-then-attend in dense fp32 (K_h = [C·W_uk[h]ᵀ | k_rope],
    V_h = C·W_uv[h]): the absorbed attention's identity, an ``attn_fn``
    that runs no kernel."""
    k = torch.einsum("bsc,hdc->bhsd", c_kv.float(), w_uk.float())
    v = torch.einsum("bsc,hcd->bhsd", c_kv.float(), w_uv.float())
    qf = q.float()
    if q_rope is not None:
        qf = torch.cat([qf, q_rope.float()], dim=-1)
        k = torch.cat([k, k_rope.float()[:, None].expand(
            -1, k.shape[1], -1, -1)], dim=-1)
    o, _ = reference_attention(qf, k, v, mask=mask,
                               scale=float(qf.shape[-1]) ** -0.5)
    return o.to(q.dtype)


def mla_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: MLAConfig,
    positions: Optional[torch.Tensor] = None,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] fp32 (training / prefill path).
    ``attn_fn`` takes :func:`ops.mla.mla_absorbed_attention`'s arguments
    (default: that function)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    attn_fn = attn_fn or mla_absorbed_attention
    x = F.embedding(tokens, params["embed"])
    for layer in params["layers"]:
        hn = rms_norm(x, layer["ln1"])
        q, qr = mla_layer_q(layer, hn, positions, cfg)
        c_kv, k_rope = mla_layer_kv(layer, hn, positions, cfg)
        o = attn_fn(
            q, c_kv.float(), layer["w_uk"].float(), layer["w_uv"].float(),
            q_rope=qr, k_rope=k_rope.float(), mask=CAUSAL,
            block_sizes=cfg.block_sizes,
        )
        attn = o.transpose(1, 2).reshape(b, s, -1).to(x.dtype)
        x = x + linear(attn, layer["wo"], x.dtype)
        h2 = rms_norm(x, layer["ln2"])
        y = F.silu(linear(h2, layer["wg"], torch.float32)) * linear(
            h2, layer["wu"], torch.float32)
        x = x + linear(y.to(x.dtype), layer["wd"], x.dtype)
    hf = rms_norm(x, params["ln_f"])
    return linear(hf, params["unembed"], torch.float32)


def mla_loss_fn(params: Params, tokens: torch.Tensor, cfg: MLAConfig,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross entropy, mean over all predicted positions:
    mean(logsumexp(logits) − logits[target]), the JAX package's loss.

    As in ``transformer.loss_fn``: ``F.cross_entropy`` writes each target's
    gradient once and ``mla_forward`` looks the tokens up with
    ``F.embedding``, so the gradient has no scatter-add backward that is
    nondeterministic on CUDA."""
    logits = mla_forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn)
    targets = tokens[:, 1:].long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))

"""Flagship decoder-only GQA transformer, in PyTorch.

The twin of the JAX package's ``models/transformer.py``: pre-RMSNorm,
rotary embeddings, GQA attention, SwiGLU MLP, untied LM head.  Parameters
are a plain dict mirroring the JAX pytree (``embed``, ``layers[i]`` with
``ln1 wq wk wv wo ln2 wg wu wd``, ``ln_f``, ``unembed``), weights in JAX's
``[in, out]`` layout so that ``x @ w`` computes the same product.

``forward`` runs causal :func:`ops.flash_attention.flash_attention` (the
flash forward kernel, and the dQ and dK/dV kernels in the backward)
unless ``attn_fn`` names another attention; ``attn_fn=plain_attention``
gives the dense fp32 reference, the independent oracle that the tests and
``chip_smoke.py`` hold the kernels and the serving path to.
:func:`loss_fn` and :func:`make_train_step` are the training path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    dynamic_quantized_matmul,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import QuantizedTensor
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 1024
    num_layers: int = 8
    num_heads: int = 16
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 4096
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Tiles of the JAX package's Pallas grids; the Hopper kernels choose
    # their own and ignore them (kept so configurations carry across).
    block_sizes: BlockSizes = BlockSizes()
    # Recompute each layer's activations in the backward
    # (torch.utils.checkpoint, as jax.checkpoint in the JAX package).
    remat: bool = False

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def init_params(
    cfg: TransformerConfig,
    generator: torch.Generator,
    device: DeviceLike = None,
) -> Params:
    """Scaled-normal init (fp32 normals · fan_in^-0.5, stored in
    ``cfg.dtype``); norm weights are fp32 ones.  The numbers come from
    ``generator`` (a CPU generator) and differ from ``jax.random``'s; to
    compare with the JAX package, convert its parameters with
    :func:`models.convert.params_from_jax`."""
    dev = resolve_device(device)
    d, q, kv, f, v = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                      cfg.vocab_size)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(device=dev, dtype=cfg.dtype)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=dev)

    embed = dense((v, d), d)
    unembed = dense((d, v), d)
    layers = [
        dict(
            ln1=ones(),
            wq=dense((d, q), d),
            wk=dense((d, kv), d),
            wv=dense((d, kv), d),
            wo=dense((q, d), q),
            ln2=ones(),
            wg=dense((d, f), d),
            wu=dense((d, f), d),
            wd=dense((f, d), f),
        )
        for _ in range(cfg.num_layers)
    ]
    return dict(embed=embed, layers=layers, ln_f=ones(), unembed=unembed)


def linear(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None):
    """Projection by a dense ``[K, N]`` weight, or by a
    :class:`QuantizedTensor` stored transposed ``[N, K]`` (the layout of
    ``models.quantized_inference.quantize_weights``), which runs the
    dynamic W8A8 / W4A8 GEMM with an fp32 result.  The result is cast to
    ``out_dtype`` (default: x's dtype)."""
    odt = out_dtype or x.dtype
    if isinstance(w, QuantizedTensor):
        x2 = x.reshape(-1, x.shape[-1])
        y = dynamic_quantized_matmul(x2, w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(odt)
    return (x @ w).to(odt)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding.  x: [B, H, S, D] (D even); positions [S] or [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions.float()[..., None] * freqs  # [S, d/2] or [B, S, d/2]
    ang = ang[None, None] if positions.dim() == 1 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _split_heads(x: torch.Tensor, num_heads: int, head_dim: int):
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _split_heads_packed(x: torch.Tensor, num_heads: int):
    """Projection output [B, S, H·64] → the packed d=64 layout [B, H/2, S,
    128]: head pairs are adjacent in the channel axis, so this is the same
    transpose as :func:`_split_heads`."""
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads // 2, 128).transpose(1, 2)


def _merge_heads_packed(x: torch.Tensor):
    """Packed [B, H/2, S, 128] → [B, S, H·64], heads in natural order."""
    b, h2, s, d2 = x.shape
    return x.transpose(1, 2).reshape(b, s, h2 * d2)


def rope_packed(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding over the packed d=64 layout [B, H/2, S, 128]: each
    64-lane half is a head, rotated as :func:`rope` rotates it."""
    half = 32  # head_dim 64 → 32-lane rotation halves
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions.float()[..., None] * freqs
    ang = ang[None, None] if positions.dim() == 1 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a1, a2, b1, b2 = x.float().split(half, dim=-1)
    out = torch.cat([a1 * cos - a2 * sin, a2 * cos + a1 * sin,
                     b1 * cos - b2 * sin, b2 * cos + b1 * sin], dim=-1)
    return out.to(x.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal dense fp32 reference attention, an ``attn_fn`` that runs no
    kernel: the oracle the kernel path is held to."""
    return reference_attention(q, k, v, mask=CAUSAL)[0]


def attention_block(
    layer: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Pre-norm attention sublayer.  ``attn_fn(q, k, v)`` defaults to
    causal flash attention."""
    h = rms_norm(x, layer["ln1"])
    q = _split_heads(h @ layer["wq"], cfg.num_heads, cfg.head_dim)
    k = _split_heads(h @ layer["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(h @ layer["wv"], cfg.num_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if attn_fn is None:
        attn_fn = functools.partial(
            flash_attention, mask=CAUSAL, block_sizes=cfg.block_sizes
        )
    o = attn_fn(q, k, v)
    return x + (_merge_heads(o.to(x.dtype)) @ layer["wo"]).to(x.dtype)


def mlp_block(layer: Params, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, layer["ln2"])
    y = F.silu((h @ layer["wg"]).float()) * (h @ layer["wu"]).float()
    return x + (y.to(x.dtype) @ layer["wd"]).to(x.dtype)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    attn_fn: Optional[Callable] = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [B, S] int → logits [B, S, V] fp32."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = F.embedding(tokens, params["embed"])

    def layer_fn(layer, x):
        x = attention_block(layer, x, positions, cfg, attn_fn=attn_fn)
        return mlp_block(layer, x)

    for layer in params["layers"]:
        if cfg.remat:
            x = checkpoint(functools.partial(layer_fn, layer), x,
                           use_reentrant=False)
        else:
            x = layer_fn(layer, x)
    h = rms_norm(x, params["ln_f"])
    return (h @ params["unembed"]).float()


def loss_fn(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Next-token cross entropy, mean over all predicted positions:
    mean(logsumexp(logits) − logits[target]), the JAX package's loss.

    ``F.cross_entropy`` computes it with a backward that writes each
    target's gradient once (``torch.gather``'s scatter-add backward is
    nondeterministic on CUDA), and ``forward`` looks the tokens up with
    ``F.embedding``, whose CUDA backward sums each row's gradients in a
    fixed order: a train step gives the same bits every run."""
    logits = forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn)
    targets = tokens[:, 1:].long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def trainable_parameters(params: Params) -> List[torch.Tensor]:
    """Mark every leaf of ``params`` as requiring grad and return them in
    a fixed order: what a ``torch.optim`` optimizer is built over."""
    leaves = [params["embed"]]
    for layer in params["layers"]:
        leaves.extend(layer[name] for name in sorted(layer))
    leaves += [params["ln_f"], params["unembed"]]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def make_train_step(cfg: TransformerConfig, optimizer: torch.optim.Optimizer,
                    loss: Callable = loss_fn):
    """Single-device train step: ``step(params, opt_state, tokens) →
    (params, opt_state, loss)``, the counterpart of the JAX package's
    jitted step over an optax optimizer.

    ``optimizer`` is a ``torch.optim`` optimizer built over
    :func:`trainable_parameters` of ``params``; ``opt_state`` is its
    ``state``.  Both are updated IN PLACE (the JAX step returns new
    pytrees) and returned so call sites read alike.  ``loss`` is the
    detached loss before the update.  The step differentiates
    ``loss(params, tokens, cfg)``: :func:`loss_fn` by default, or another
    loss of the same form (``mla_loss_fn`` with an ``MLAConfig``, which
    neither package gives a step of its own).
    """

    def step(params: Params, opt_state, tokens: torch.Tensor):
        if opt_state is not optimizer.state:
            raise ValueError("opt_state must be optimizer.state")
        optimizer.zero_grad(set_to_none=True)
        value = loss(params, tokens, cfg)
        value.backward()
        optimizer.step()
        return params, optimizer.state, value.detach()

    return step

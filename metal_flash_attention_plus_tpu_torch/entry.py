"""The port's twin of the repository's ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, (params, tokens))``: one forward step of the
flagship-style GQA transformer at ``entry()``'s shapes there (vocab 8192,
d_model 512, 4 layers, 8 query / 4 KV heads, head_dim 64, d_ff 1536, bf16,
batch 2 × 512 tokens), its attention the causal flash forward kernel.
Weights come from ``torch.Generator().manual_seed(0)`` and tokens from
``numpy.random.default_rng(1)``; neither matches ``jax.random``.
"""

from __future__ import annotations

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
)

ENTRY_CONFIG = TransformerConfig(
    vocab_size=8192,
    d_model=512,
    num_layers=4,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1536,
    max_seq=1024,
    dtype=torch.bfloat16,
)


def entry(device: DeviceLike = None):
    """Return (fn, example_args): ``fn(params, tokens)`` → logits
    [2, 512, 8192] fp32, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cfg = ENTRY_CONFIG
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 512))
    ).to(dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)

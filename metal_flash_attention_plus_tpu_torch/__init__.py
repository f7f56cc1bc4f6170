"""PyTorch/CUDA port of metal_flash_attention_plus_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference the port is held
against; this package imports nothing of it (nor of JAX).  This slice
ports the paged serving path: the engine, the cached model, the paged KV
cache and the two paged attention kernels (``csrc/paged_attention.cu``).
Entry points take ``device=None``, meaning the CUDA card, and raise
without one unless given ``device="cpu"``.
"""

from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.models.cached import (
    decode_step,
    init_cache,
    prefill_chunk,
)
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
)
from metal_flash_attention_plus_tpu_torch.serving.engine import (
    GenerationRequest,
    ServingEngine,
)
from metal_flash_attention_plus_tpu_torch.serving.kv_cache import (
    PagedKVCache,
)
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)

__all__ = [
    "TOLERANCES",
    "GenerationRequest",
    "PagedKVCache",
    "ServingEngine",
    "TransformerConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "paged_decode_attention",
    "paged_prefill_attention",
    "params_from_jax",
    "prefill_chunk",
    "reference_attention",
]

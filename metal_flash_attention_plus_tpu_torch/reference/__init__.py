from metal_flash_attention_plus_tpu_torch.reference.attention import (
    CAUSAL,
    FULL,
    reference_attention,
    reference_attention_bwd,
    reference_attention_vjp,
    reference_mha,
)

__all__ = [
    "CAUSAL",
    "FULL",
    "reference_attention",
    "reference_attention_bwd",
    "reference_attention_vjp",
    "reference_mha",
]

from metal_flash_attention_plus_tpu_torch.reference.attention import (
    CAUSAL,
    FULL,
    reference_attention,
)

__all__ = ["CAUSAL", "FULL", "reference_attention"]

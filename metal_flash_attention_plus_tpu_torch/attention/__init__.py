from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)

__all__ = ["TOLERANCES"]

from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.attention.quantized import (
    QuantizedAttention,
    QuantizedAttentionConfig,
)

__all__ = ["TOLERANCES", "QuantizedAttention", "QuantizedAttentionConfig"]

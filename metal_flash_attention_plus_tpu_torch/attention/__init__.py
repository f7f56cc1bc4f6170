from metal_flash_attention_plus_tpu_torch.attention.descriptor import (
    AttentionDescriptor,
    BroadcastMode,
    MultiHeadShape,
)
from metal_flash_attention_plus_tpu_torch.attention.masking import (
    CAUSAL,
    FULL,
    MaskKind,
    MaskSpec,
    sliding_window,
)
from metal_flash_attention_plus_tpu_torch.attention.multi_head import (
    MultiHeadAttention,
)
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.attention.quantized import (
    QuantizedAttention,
    QuantizedAttentionConfig,
)
from metal_flash_attention_plus_tpu_torch.attention.tuning import (
    AttentionTuner,
    CalibrationStore,
    default_block_sizes,
)

__all__ = ["AttentionDescriptor", "AttentionTuner", "BroadcastMode", "CAUSAL",
           "CalibrationStore", "FULL", "MaskKind", "MaskSpec",
           "MultiHeadAttention", "MultiHeadShape", "QuantizedAttention",
           "QuantizedAttentionConfig", "TOLERANCES", "default_block_sizes",
           "sliding_window"]

"""Attention operators: the flash forward and backward, the quantized
forward and backward, the dynamic GEMM and runtime quantization, each a
CUDA kernel behind a wrapper with a plain PyTorch version beside it; the
Hadamard rotation in plain PyTorch."""

from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (  # noqa: F401,E501
    flash_attention_backward,
)
from metal_flash_attention_plus_tpu_torch.ops.hadamard import (  # noqa: F401
    dequantize_unrotate,
    hadamard_transform,
    rotate_quantize,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (  # noqa: F401,E501
    quantized_flash_attention,
    quantized_flash_attention_forward,
    quantized_flash_attention_forward_packed,
    quantized_flash_attention_qat,
)
from metal_flash_attention_plus_tpu_torch.ops.runtime_quantization import (  # noqa: F401,E501
    runtime_quantize,
)

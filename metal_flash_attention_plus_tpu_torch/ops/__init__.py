"""Operators: the flash forward and backward, the quantized forward and
backward, the quantized GEMMs and runtime quantization, each a CUDA kernel
behind a wrapper with a plain PyTorch version beside it; MLA's absorbed
attention and decompression; the GEMM engine's dispatch (``matmul``); the
Hadamard rotation in plain PyTorch."""

from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (  # noqa: F401,E501
    BlockSizes,
    flash_attention,
    flash_attention_forward,
    flash_attention_with_lse,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (  # noqa: F401,E501
    flash_attention_backward,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (  # noqa: F401,E501
    quantized_flash_attention,
    quantized_flash_attention_forward,
    quantized_flash_attention_forward_packed,
    quantized_flash_attention_qat,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (  # noqa: F401,E501
    compensated_matmul,
    per_row_block_sums,
    quantized_matmul,
    quantized_matmul_qa,
)
from metal_flash_attention_plus_tpu_torch.ops.runtime_quantization import (  # noqa: F401,E501
    runtime_quantize,
)
from metal_flash_attention_plus_tpu_torch.ops.mla import (  # noqa: F401
    mla_absorbed_attention,
    mla_decompress,
)
from metal_flash_attention_plus_tpu_torch.ops.hadamard import (  # noqa: F401
    dequantize_unrotate,
    hadamard_transform,
    rotate_quantize,
)
from metal_flash_attention_plus_tpu_torch.ops.gemm import (  # noqa: F401
    GEMMDescriptor,
    matmul,
)

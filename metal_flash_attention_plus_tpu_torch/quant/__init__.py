"""Quantization: the static ``QuantConfig`` and the ``QuantizedTensor``
with its golden quantize/dequantize, byte-identical with the JAX
package's, and the straight-through ``fake_quantize`` for QAT."""

from metal_flash_attention_plus_tpu_torch.quant.ste import (  # noqa: F401
    fake_quantize,
)

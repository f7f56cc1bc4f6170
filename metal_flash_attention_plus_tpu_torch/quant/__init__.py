"""Quantization: the static ``QuantConfig`` and the ``QuantizedTensor``
with its golden quantize/dequantize, byte-identical with the JAX
package's; the straight-through ``fake_quantize`` for QAT; the device
capabilities and the strategy degradation of the GEMM engine; the
versioned ``.npz`` serialization the JAX package writes and reads."""

from metal_flash_attention_plus_tpu_torch.quant.params import (  # noqa: F401
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (  # noqa: F401
    QuantizedTensor,
    dequantize,
    pack_int4,
    quantize,
    unpack_int4,
)
from metal_flash_attention_plus_tpu_torch.quant.capabilities import (  # noqa: F401,E501
    DeviceCapabilities,
    capability_report,
    probe_capabilities,
    resolve_strategy,
)
from metal_flash_attention_plus_tpu_torch.quant.serialization import (  # noqa: F401,E501
    load_quantized,
    save_quantized,
)
from metal_flash_attention_plus_tpu_torch.quant.ste import (  # noqa: F401
    fake_quantize,
)

"""PyTorch/CUDA port of metal_flash_attention_plus_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference the port is held
against; this package imports nothing of it (nor of JAX).  Ported so far:

- the paged serving path: the engine, the cached model, the paged KV
  cache and the two paged attention kernels (``csrc/paged_attention.cu``);
- the training path: the mask zoo, the flash forward, dQ and dK/dV
  kernels (``csrc/flash_attention.cu``) behind the differentiable
  ``flash_attention``, ``loss_fn`` and ``make_train_step``;
- the quantized serving path: ``QuantizedTensor`` and ``quantize``
  (``quant/``), W8A8 / W4A8 weights (``quantize_weights``) through the
  dynamic int8 GEMM kernel (``csrc/quantized_gemm.cu``), and int8 / int4
  paged KV pools in both paged kernels;
- the quantized-attention forward: ``quantized_forward(...,
  quantize_kv=True)`` (packed d=64 head pairs or int8-Q scores) and the
  ``QuantizedAttention`` facade, over the quantized forward and head-pair
  kernels (``csrc/quantized_attention.cu``) and the runtime quantization
  kernels (``csrc/runtime_quantization.cu``);
- the quantized backward: the gradient of ``quantized_flash_attention``
  (exact, and full-integer with ``bwd_fullint``; dq, dbias and the K/V
  scale and zero-point cotangents), of ``QuantizedAttention`` and of
  ``quantized_flash_attention_qat`` / ``fake_quantize``, over the
  quantized dQ / dK/dV and full-integer kernels
  (``csrc/quantized_attention_bwd.cu``).

Entry points take ``device=None``, meaning the CUDA card, and raise
without one unless given ``device="cpu"``.
"""

from metal_flash_attention_plus_tpu_torch.attention.masking import (
    CAUSAL,
    FULL,
    MaskKind,
    MaskSpec,
    sliding_window,
)
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.attention.quantized import (
    QuantizedAttention,
    QuantizedAttentionConfig,
)
from metal_flash_attention_plus_tpu_torch.models.cached import (
    decode_step,
    init_cache,
    prefill,
    prefill_chunk,
)
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from metal_flash_attention_plus_tpu_torch.models.quantized_inference import (
    quantize_weights,
    quantized_forward,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    trainable_parameters,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention,
    flash_attention_forward,
    flash_attention_with_lse,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_backward,
)
from metal_flash_attention_plus_tpu_torch.ops.hadamard import (
    hadamard_transform,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    quantized_flash_attention,
    quantized_flash_attention_forward,
    quantized_flash_attention_forward_packed,
    quantized_flash_attention_qat,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    dynamic_quantized_matmul,
)
from metal_flash_attention_plus_tpu_torch.ops.runtime_quantization import (
    runtime_quantize,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.ste import fake_quantize
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    dequantize,
    quantize,
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
    "CAUSAL",
    "FULL",
    "TOLERANCES",
    "BlockSizes",
    "GenerationRequest",
    "MaskKind",
    "MaskSpec",
    "PagedKVCache",
    "QuantConfig",
    "QuantGranularity",
    "QuantStrategy",
    "QuantizedAttention",
    "QuantizedAttentionConfig",
    "QuantizedTensor",
    "ServingEngine",
    "TransformerConfig",
    "decode_step",
    "dequantize",
    "dynamic_quantized_matmul",
    "fake_quantize",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "flash_attention_with_lse",
    "forward",
    "hadamard_transform",
    "init_cache",
    "init_params",
    "loss_fn",
    "make_train_step",
    "paged_decode_attention",
    "paged_prefill_attention",
    "params_from_jax",
    "params_to_numpy",
    "prefill",
    "prefill_chunk",
    "quantize",
    "quantize_weights",
    "quantized_flash_attention",
    "quantized_flash_attention_forward",
    "quantized_flash_attention_forward_packed",
    "quantized_flash_attention_qat",
    "quantized_forward",
    "reference_attention",
    "runtime_quantize",
    "sliding_window",
    "trainable_parameters",
]

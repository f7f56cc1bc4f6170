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
  (``csrc/quantized_attention_bwd.cu``);
- MLA serving: ``MLAConfig`` models through ``ServingEngine(...,
  executor=mla_executor())`` over one-state latent pages (the paged
  kernels' ``v_tail_zero`` mode, head dim d_c + d_r), float or W8A8
  (``quantize_mla_weights``), and ``mla_decompress`` over quantized
  weights through the weight-only GEMM kernels (``quantized_matmul``,
  ``csrc/quantized_gemm.cu``);
- the GEMM engine: ``matmul`` (with ``GEMMDescriptor``) over float and
  quantized operands: float × float through ``torch.matmul``, float ×
  quantized through ``quantized_matmul``, quantized × float through
  ``quantized_matmul_qa`` and quantized × quantized through
  ``compensated_matmul``, over the quantized-A and compensated GEMM
  kernels (``csrc/quantized_gemm.cu``); ``resolve_strategy`` and
  ``capability_report`` (``quant/capabilities.py``).

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
from metal_flash_attention_plus_tpu_torch.models.cached_mla import (
    init_mla_cache,
    mla_decode_step,
    mla_prefill_chunk,
)
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from metal_flash_attention_plus_tpu_torch.models.mla_transformer import (
    MLAConfig,
    init_mla_params,
    mla_forward,
    mla_loss_fn,
)
from metal_flash_attention_plus_tpu_torch.models.quantized_inference import (
    quantize_mla_weights,
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
from metal_flash_attention_plus_tpu_torch.ops.gemm import (
    GEMMDescriptor,
    matmul,
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
    compensated_matmul,
    dynamic_quantized_matmul,
    per_row_block_sums,
    quantized_matmul,
    quantized_matmul_qa,
)
from metal_flash_attention_plus_tpu_torch.ops.runtime_quantization import (
    runtime_quantize,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.capabilities import (
    capability_report,
    resolve_strategy,
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
from metal_flash_attention_plus_tpu_torch.ops.mla import (
    mla_absorbed_attention,
    mla_decompress,
)
from metal_flash_attention_plus_tpu_torch.serving.engine import (
    GenerationRequest,
    ServingEngine,
    mla_executor,
)
from metal_flash_attention_plus_tpu_torch.serving.kv_cache import (
    PagedKVCache,
)
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)

__all__ = [
    "BlockSizes",
    "CAUSAL",
    "FULL",
    "GEMMDescriptor",
    "GenerationRequest",
    "MLAConfig",
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
    "TOLERANCES",
    "TransformerConfig",
    "capability_report",
    "compensated_matmul",
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
    "init_mla_cache",
    "init_mla_params",
    "init_params",
    "loss_fn",
    "make_train_step",
    "matmul",
    "mla_absorbed_attention",
    "mla_decode_step",
    "mla_decompress",
    "mla_executor",
    "mla_forward",
    "mla_loss_fn",
    "mla_prefill_chunk",
    "paged_decode_attention",
    "paged_prefill_attention",
    "params_from_jax",
    "params_to_numpy",
    "per_row_block_sums",
    "prefill",
    "prefill_chunk",
    "quantize",
    "quantize_mla_weights",
    "quantize_weights",
    "quantized_flash_attention",
    "quantized_flash_attention_forward",
    "quantized_flash_attention_forward_packed",
    "quantized_flash_attention_qat",
    "quantized_forward",
    "quantized_matmul",
    "quantized_matmul_qa",
    "reference_attention",
    "resolve_strategy",
    "runtime_quantize",
    "sliding_window",
    "trainable_parameters",
]

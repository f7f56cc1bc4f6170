"""GEMM dispatch: the descriptor-level entry of the reference's GEMM engine
(``GEMMDescriptor`` → kernel cache → dispatch,
``GEMM/GEMMDescriptor.swift:110-338``).

The twin of the JAX package's ``ops/gemm.py``: :func:`matmul` picks a path
by operand kinds.  A float × float product goes to ``torch.matmul`` under
the precision policy, as the JAX package leaves it to XLA; the kernels of
``ops/quantized_gemm.py`` exist where a quantized operand needs one:

- float × QuantizedTensor → :func:`quantized_matmul` (``wo_folded_gemm``
  or ``wo_gemm``), B stored [N, K];
- QuantizedTensor × float → :func:`quantized_matmul_qa` (``qa_folded_gemm``
  or ``qa_gemm``), with ``c`` added after it, outside the kernel, in fp32;
- QuantizedTensor × QuantizedTensor → :func:`compensated_matmul`
  (``comp_gemm`` or ``comp_small_gemm``) when ``resolve_strategy`` grants
  the compensated path for A's config, B is BLOCK too and the block sizes
  match; otherwise the degraded path: A dequantized to bf16 once, then
  :func:`quantized_matmul`.

As in the JAX package, ``resolve_strategy``'s rounded block size is not
used: the original operands go on, so a 64-block pair runs the
small-block kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    exact_fp32,
    matmul_precision,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    compensated_matmul,
    quantized_matmul,
    quantized_matmul_qa,
)
from metal_flash_attention_plus_tpu_torch.quant import capabilities
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantGranularity,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    dequantize,
)

Operand = Union[torch.Tensor, QuantizedTensor]


@dataclasses.dataclass(frozen=True)
class GEMMDescriptor:
    """Static GEMM problem spec (``GEMMDescriptor.swift:11-94``).  A
    quantized B is stored transposed, [N, K]."""

    m: int
    n: int
    k: int
    transpose_a: bool = False
    out_dtype: Optional[torch.dtype] = None


def _float_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b in the promoted dtype; an fp32 product in exact fp32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if matmul_precision(dt) == "highest":
        with exact_fp32():
            return (a.float() @ b.float()).to(dt)
    return a @ b


def matmul(
    a: Operand,
    b: Operand,
    *,
    descriptor: Optional[GEMMDescriptor] = None,
    out_dtype: Optional[torch.dtype] = None,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A × B by operand kinds (see the module docstring).

    ``c``: an optional [M, N] accumulate-into-C operand (the reference's
    ``loadPreviousC``): result = c + A·B.  ``descriptor.transpose_a``
    transposes a float A (a quantized A is taken as it is, as in the JAX
    package).  Out dtype: ``out_dtype``, else A's for float × float and
    float × quantized, B's for quantized × float, fp32 for two quantized
    operands."""
    a_q = isinstance(a, QuantizedTensor)
    b_q = isinstance(b, QuantizedTensor)
    if descriptor is not None and descriptor.transpose_a and not a_q:
        a = a.t()

    if not a_q and not b_q:
        out = _float_matmul(a, b)
        if c is not None:
            out = out + c.to(out.dtype)
        return out.to(out_dtype or a.dtype)

    if not a_q:
        return quantized_matmul(a, b, out_dtype=out_dtype, c=c)

    if not b_q:
        out = quantized_matmul_qa(a, b, out_dtype=out_dtype)
        if c is not None:  # the qa path adds C outside its kernel
            out = (out.float() + c.float()).to(out.dtype)
        return out

    res = capabilities.resolve_strategy(a.config, both_operands=True)
    if (res.use_compensated_path
            and b.config.granularity == QuantGranularity.BLOCK
            and a.config.block_size == b.config.block_size):
        out = compensated_matmul(a, b, c=c)
        return out.to(out_dtype or torch.float32)
    # Degraded path: widen A once, stream B through dequant-on-load.
    a_f = dequantize(a).to(torch.bfloat16)
    return quantized_matmul(a_f, b, out_dtype=out_dtype or torch.float32,
                            c=c)

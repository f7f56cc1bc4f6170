"""Straight-through estimator (STE) for QAT through quantized paths.

The twin of the JAX package's ``quant/ste.py``: :func:`fake_quantize` is
the quantize → dequantize round trip whose backward is the clipped
pass-through (gradient 1 where the round trip's error is within half a
scale, 0 where the value was clipped).  Its output and cotangent have x's
shape for every rank; a rank-1 x is quantized as one [1, N] row, as
``quantize`` does, and reshaped back.
"""

from __future__ import annotations

import torch

from metal_flash_attention_plus_tpu_torch.quant.params import QuantConfig
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    _broadcast_cells,
    dequantize,
    quantize,
)


class _FakeQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, config):
        qt = quantize(x, config)
        y = dequantize(qt).reshape(x.shape).to(x.dtype)
        # Inside the representable range the rounding error is at most
        # scale/2 and the gradient passes; a clipped value's is larger.
        max_err = 0.5 * _broadcast_cells(qt.scale, qt.config, qt.shape) + 1e-8
        err = (y.float() - x.float()).reshape(qt.shape).abs()
        ctx.save_for_backward((err <= max_err).reshape(x.shape).to(x.dtype))
        return y

    @staticmethod
    def backward(ctx, g):
        (passthrough,) = ctx.saved_tensors
        return g * passthrough, None


def fake_quantize(x: torch.Tensor, config: QuantConfig) -> torch.Tensor:
    """Quantize → dequantize in x's dtype and shape, with clipped STE
    gradients."""
    return _FakeQuantize.apply(x, config)

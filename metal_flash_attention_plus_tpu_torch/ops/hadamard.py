"""Hadamard rotation (blocked FWHT): outlier smoothing before quantization.

The twin of the JAX package's ``ops/hadamard.py``.  The transform is a
log2(n)-stage butterfly of elementwise adds over the tensor, which that
package left to XLA; here it is plain PyTorch for the same reason (a few
bandwidth-bound elementwise passes, no kernel of its own).  The stages and
the final ``1/sqrt(n)`` scale are the JAX package's, in fp32, so the two
agree to the last bit on the same inputs.

Orthonormal convention: each application scales by ``1/sqrt(n)``, so the
transform is an involution: rotate → quantize → dequantize → rotate
restores the original basis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch.quant.params import QuantConfig
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    dequantize,
    quantize,
)

MAX_BLOCK = 1024  # the reference's kernel limit, kept for parity


def default_block(n: int) -> int:
    """The largest power of 2 ≤ min(n, 1024) that divides n."""
    bs = 1
    while bs * 2 <= min(n, MAX_BLOCK) and n % (bs * 2) == 0:
        bs *= 2
    return bs


def hadamard_transform(x: torch.Tensor,
                       block_size: Optional[int] = None) -> torch.Tensor:
    """Blocked orthonormal FWHT along the last dim, in fp32, returned in
    x's dtype.  ``block_size`` must be a power of 2 dividing the last dim
    (default :func:`default_block`)."""
    n = x.shape[-1]
    bs = default_block(n) if block_size is None else block_size
    if bs & (bs - 1) or n % bs:
        raise ValueError(f"block_size {bs} must be a power of 2 dividing {n}")
    lead = x.shape[:-1]
    y = x.float().reshape(*lead, n // bs, bs)
    h = 1
    while h < bs:
        # Stride-h butterfly: within each group of 2h, (a, b) → (a+b, a−b).
        y = y.reshape(*lead, n // bs, bs // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.cat([a + b, a - b], dim=-1).reshape(*lead, n // bs, bs)
        h *= 2
    return (y.reshape(*lead, n) * float(bs) ** -0.5).to(x.dtype)


def rotate_quantize(x: torch.Tensor, config: QuantConfig,
                    block_size: Optional[int] = None
                    ) -> Tuple[QuantizedTensor, int]:
    """Rotate then quantize; returns (tensor, block size used)."""
    bs = default_block(x.shape[-1]) if block_size is None else block_size
    return quantize(hadamard_transform(x, bs), config), bs


def dequantize_unrotate(t: QuantizedTensor, block_size: int) -> torch.Tensor:
    """Inverse of :func:`rotate_quantize` (the FWHT is its own inverse)."""
    return hadamard_transform(dequantize(t), block_size)

"""Parameter conversion between the JAX package's pytree and the port's dict.

``params_from_jax`` takes the JAX ``init_params`` (or ``init_mla_params``)
tree with every leaf already turned into a numpy array
(``jax.tree.map(np.asarray, params)`` on the JAX side), so this module
imports nothing of JAX.  The layouts are the same (``[in, out]`` weights;
MLA's 3-D ``w_uk [H, dh, d_c]`` and ``w_uv [H, d_c, dh]`` as they are),
so the conversion is a copy.
``params_to_numpy`` goes the other way, for parameters or their
gradients, so that a test can compare the two packages leaf by leaf.

Quantized parameters (the JAX ``quantize_weights`` or
``quantize_mla_weights`` output) carry across too.  After
``jax.tree.map(np.asarray, ...)`` their leaves are still the
JAX package's ``QuantizedTensor`` objects, with numpy fields; they are
recognised by their fields (``data``, ``scale``, ``zero_point``,
``config``, ``shape``), never by importing the JAX class, and their
config is mapped by the enums' values.  Payloads keep their integer
dtypes whatever ``dtype`` says.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import Params
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import QuantizedTensor

# Checked in this order: a numpy array has ``data`` and ``shape``, and
# reading ``data`` of a bfloat16 array raises.
_QT_FIELDS = ("config", "zero_point", "scale", "data", "shape")
_FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _is_quantized_leaf(node) -> bool:
    return all(hasattr(node, f) for f in _QT_FIELDS)


def _quantized_from_jax(node, device: torch.device) -> QuantizedTensor:
    cfg = node.config

    def raw(arr):
        return torch.from_numpy(np.array(arr)).to(device)

    return QuantizedTensor(
        data=raw(node.data),
        scale=raw(node.scale),
        zero_point=raw(node.zero_point),
        sums=None if getattr(node, "sums", None) is None else raw(node.sums),
        config=QuantConfig(
            bits=cfg.bits,
            granularity=QuantGranularity(cfg.granularity.value),
            strategy=QuantStrategy(cfg.strategy.value),
            block_size=cfg.block_size,
            block_rows=cfg.block_rows,
            compute_sums=cfg.compute_sums,
        ),
        shape=tuple(node.shape),
        orig_dtype=_FLOAT_DTYPES[np.dtype(getattr(
            node, "orig_dtype", np.float32)).name],
    )


def _to_tensor(arr, device: torch.device, dtype: Optional[torch.dtype]):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's comes from ml_dtypes);
        # widening to fp32 is exact, and narrowing back restores the bits.
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(arr)
    # Weight matrices take ``dtype``; the fp32 norm vectors stay fp32.
    if dtype is not None and t.dim() >= 2:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(
    tree: Any,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """JAX transformer or MLA params (numpy leaves) → the port's params.

    ``dtype=None`` keeps each leaf's own dtype; otherwise weights of two
    or more dimensions are cast to ``dtype``.
    """
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if _is_quantized_leaf(node):
            return _quantized_from_jax(node, dev)
        return _to_tensor(node, dev, dtype)

    return conv(tree)


def params_to_numpy(tree: Any, grad: bool = False) -> Any:
    """The port's params (or, with ``grad=True``, their ``.grad``s) as a
    numpy tree in the JAX layout.  bf16 leaves widen to fp32, exactly
    (numpy has no bfloat16 of its own); a missing gradient raises.  A
    :class:`QuantizedTensor` becomes a dict of its arrays (``data``,
    ``scale``, ``zero_point`` and, where present, ``sums``)."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if isinstance(node, QuantizedTensor):
            arrays = dict(data=node.data, scale=node.scale,
                          zero_point=node.zero_point, sums=node.sums)
            return {k: v.detach().cpu().numpy() for k, v in arrays.items()
                    if v is not None}
        t = node.grad if grad else node
        if t is None:
            raise ValueError("a parameter has no gradient")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return conv(tree)

"""Parameter conversion between the JAX package's pytree and the port's dict.

``params_from_jax`` takes the JAX ``init_params`` tree with every leaf
already turned into a numpy array (``jax.tree.map(np.asarray, params)``
on the JAX side), so this module imports nothing of JAX.  The layouts are
the same (``[in, out]`` weights), so the conversion is a copy.
``params_to_numpy`` goes the other way, for parameters or their
gradients, so that a test can compare the two packages leaf by leaf.
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
    """JAX transformer params (numpy leaves) → the port's params.

    ``dtype=None`` keeps each leaf's own dtype; otherwise weight matrices
    are cast to ``dtype``.
    """
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, dev, dtype)

    return conv(tree)


def params_to_numpy(tree: Any, grad: bool = False) -> Any:
    """The port's params (or, with ``grad=True``, their ``.grad``s) as a
    numpy tree in the JAX layout.  bf16 leaves widen to fp32, exactly
    (numpy has no bfloat16 of its own); a missing gradient raises."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        t = node.grad if grad else node
        if t is None:
            raise ValueError("a parameter has no gradient")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return conv(tree)

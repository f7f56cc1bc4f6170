"""Versioned ``QuantizedTensor`` serialization.

The port of the JAX package's ``quant/serialization.py``, in its file
format: one ``.npz`` per tensor holding

- ``header``: JSON as uint8 bytes, with ``version``, ``config`` (the
  ``QuantConfig`` fields), ``shape``, ``orig_dtype`` (the numpy dtype name:
  ``"bfloat16"``, ``"float32"``, ...) and ``has_sums``;
- ``data``, ``scale``, ``zero_point`` and, where ``has_sums``, ``sums``.

A file written by either package loads in the other with the same bytes.
Loading rebuilds the tensor on ``device`` (``None``: the card).
"""

from __future__ import annotations

import io
import json
from typing import Union

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import QuantizedTensor

FORMAT_VERSION = 1

# orig_dtype by its numpy name (the JAX package writes jnp.dtype(...).name).
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.float64: "float64"}
_DTYPES = {name: dt for dt, name in DTYPE_NAMES.items()}


def _config_to_dict(c: QuantConfig) -> dict:
    return dict(
        bits=c.bits,
        granularity=c.granularity.value,
        strategy=c.strategy.value,
        block_size=c.block_size,
        block_rows=c.block_rows,
        compute_sums=c.compute_sums,
    )


def _config_from_dict(d: dict) -> QuantConfig:
    return QuantConfig(
        bits=d["bits"],
        granularity=QuantGranularity(d["granularity"]),
        strategy=QuantStrategy(d["strategy"]),
        block_size=d["block_size"],
        block_rows=d["block_rows"],
        compute_sums=d["compute_sums"],
    )


def save_quantized(t: QuantizedTensor, path_or_file: Union[str, io.IOBase]):
    """Write ``t`` (on any device) as the ``.npz`` described above."""
    header = dict(
        version=FORMAT_VERSION,
        config=_config_to_dict(t.config),
        shape=list(t.shape),
        orig_dtype=DTYPE_NAMES[t.orig_dtype],
        has_sums=t.sums is not None,
    )
    arrays = dict(
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        data=t.data.cpu().numpy(),
        scale=t.scale.cpu().numpy(),
        zero_point=t.zero_point.cpu().numpy(),
    )
    if t.sums is not None:
        arrays["sums"] = t.sums.cpu().numpy()
    np.savez(path_or_file, **arrays)


def load_quantized(path_or_file: Union[str, io.IOBase],
                   device: DeviceLike = None) -> QuantizedTensor:
    """Read a file :func:`save_quantized` (or the JAX package's) wrote;
    raises ``ValueError`` for a format newer than this library's."""
    dev = resolve_device(device)
    with np.load(path_or_file) as z:
        header = json.loads(bytes(z["header"]).decode())
        version = header["version"]
        if version > FORMAT_VERSION:
            raise ValueError(
                f"quantized tensor format v{version} is newer than this "
                f"library (v{FORMAT_VERSION})"
            )

        def tensor(name):
            return torch.from_numpy(np.array(z[name])).to(dev)

        return QuantizedTensor(
            data=tensor("data"),
            scale=tensor("scale"),
            zero_point=tensor("zero_point"),
            sums=tensor("sums") if header["has_sums"] else None,
            config=_config_from_dict(header["config"]),
            shape=tuple(header["shape"]),
            orig_dtype=_DTYPES[header["orig_dtype"]],
        )

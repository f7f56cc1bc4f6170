"""``QuantizedTensor`` and the golden quantize/dequantize.

The twin of the JAX package's ``quant/tensor.py``; payloads, scales and
zero points are byte-identical with it.  What that takes: every step in
fp32, the scale by division (``absmax / qmax``, never a multiply by its
inverse), ``x / scale`` divided too, and ``torch.round``, which rounds half
to even as ``jnp.round`` does.

- Symmetric: scale = absmax/qmax, q = clip(round(x/scale), qmin, qmax).
- Centered: per-cell mean; scale = max|x − mean|/qmax; zp = round(−mean/
  scale); q = clip(round(x/scale + zp)); x ≈ (q − zp)·scale.
- Asymmetric: scale = (max − min)/(qmax − qmin); zp = qmin − round(min/
  scale).

int4 payloads are packed two per byte, GROUP-PLANAR: within each
256-element group of the last dim, the low nibbles of the 128 bytes hold
elements [0, 128) and the high nibbles [128, 256) (a short tail group
splits at its midpoint), each stored as value + 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)

INT4_GROUP = 256  # element columns per planar packing group


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Values in [-8, 7] → uint8 nibbles along the last dim, group-planar."""
    k = q.shape[-1]
    if k % 2 != 0:
        raise ValueError("int4 packing requires an even last dimension")
    u = (q.to(torch.int32) + 8).to(torch.uint8)
    out = []
    for base in range(0, k, INT4_GROUP):
        g = min(INT4_GROUP, k - base)
        lo = u[..., base: base + g // 2]
        hi = u[..., base + g // 2: base + g]
        out.append(lo | (hi << 4))
    return torch.cat(out, dim=-1)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; int8 values in [-8, 7]."""
    kp = packed.shape[-1]
    out = []
    for base in range(0, kp, INT4_GROUP // 2):
        g = min(INT4_GROUP // 2, kp - base)
        byte = packed[..., base: base + g]
        out.append((byte & 0xF).to(torch.int8) - 8)
        out.append((byte >> 4).to(torch.int8) - 8)
    return torch.cat(out, dim=-1)


@dataclasses.dataclass
class QuantizedTensor:
    """Integer payload and its quantization parameters.

    ``data``: int8 ``[..., K]`` (bits=8) or packed uint8 ``[..., K//2]``
    (bits=4).  ``scale``/``zero_point`` shapes by granularity over a
    ``[..., R, K]`` logical view:

      TENSOR   → [1, 1]
      ROW      → [..., R, 1]
      CHANNEL  → [..., 1, K]
      BLOCK    → [..., 1, K/bs]   (K-blocks shared across rows)
      BLOCK_2D → [..., R/br, K/bs]

    ``sums``: optional int32 Σq per scale cell.
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    sums: Optional[torch.Tensor]
    config: QuantConfig
    shape: Tuple[int, ...]
    orig_dtype: torch.dtype = torch.float32

    @property
    def bits(self) -> int:
        return self.config.bits

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)

    @property
    def nbytes_payload(self) -> int:
        return self.data.numel() * self.data.element_size()

    def to(self, device) -> "QuantizedTensor":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self,
            data=self.data.to(device),
            scale=self.scale.to(device),
            zero_point=self.zero_point.to(device),
            sums=None if self.sums is None else self.sums.to(device),
        )


def _scale_reduce(x: torch.Tensor, config: QuantConfig):
    """(x viewed per cell, scale, zero point) for x of shape [..., R, K];
    scale and zero point keep the reduced dims for broadcasting."""
    qmax, qmin = float(config.qmax), float(config.qmin)
    g = config.granularity
    eps = 1e-12
    if g == QuantGranularity.TENSOR:
        red = tuple(range(x.dim()))
        sel = x
    elif g == QuantGranularity.ROW:
        red = (-1,)
        sel = x
    elif g == QuantGranularity.CHANNEL:
        red = (-2,)
        sel = x
    elif g == QuantGranularity.BLOCK:
        k, bs = x.shape[-1], config.block_size
        if k % bs:
            raise ValueError(f"K={k} not divisible by block_size={bs}")
        sel = x.reshape(*x.shape[:-1], k // bs, bs)
        red = (-3, -1)  # rows and within the block: blocks shared by rows
    elif g == QuantGranularity.BLOCK_2D:
        r, k = x.shape[-2], x.shape[-1]
        br, bs = config.block_rows, config.block_size
        if r % br or k % bs:
            raise ValueError(
                f"shape ({r},{k}) not divisible by block ({br},{bs})")
        sel = x.reshape(*x.shape[:-2], r // br, br, k // bs, bs)
        red = (-3, -1)
    else:
        raise NotImplementedError(g)

    if config.strategy == QuantStrategy.SYMMETRIC:
        absmax = sel.abs().amax(dim=red, keepdim=True)
        scale = absmax.clamp_min(eps) / qmax
        zp = torch.zeros_like(scale, dtype=torch.int32)
    elif config.strategy == QuantStrategy.CENTERED:
        mean = sel.mean(dim=red, keepdim=True)
        absmax = (sel - mean).abs().amax(dim=red, keepdim=True)
        scale = absmax.clamp_min(eps) / qmax
        zp = torch.round(-mean / scale).to(torch.int32)
    elif config.strategy == QuantStrategy.ASYMMETRIC:
        hi = sel.amax(dim=red, keepdim=True)
        lo = sel.amin(dim=red, keepdim=True)
        scale = (hi - lo).clamp_min(eps) / (qmax - qmin)
        zp = (qmin - torch.round(lo / scale)).to(torch.int32)
    else:
        raise NotImplementedError(config.strategy)
    return sel, scale, zp, red


def quantize(x: torch.Tensor, config: QuantConfig) -> QuantizedTensor:
    """Quantize ``x`` (any [..., R, K]-shaped float tensor)."""
    if x.dim() < 2:
        x = x.reshape(1, -1)
    # Contiguous first: elementwise ops keep a transposed input's strides,
    # and the kernels take contiguous payloads.
    sel, scale, zp, red = _scale_reduce(x.float().contiguous(), config)
    q = torch.round(sel / scale + zp.float())
    q = q.clamp(config.qmin, config.qmax).to(torch.int32)

    sums = None
    if config.compute_sums:
        sums = _squeeze_cells(q.sum(dim=red, keepdim=True, dtype=torch.int32),
                              config, x.shape)
    q = q.reshape(x.shape)
    data = pack_int4(q) if config.bits == 4 else q.to(torch.int8)
    return QuantizedTensor(
        data=data,
        scale=_squeeze_cells(scale, config, x.shape).float(),
        zero_point=_squeeze_cells(zp, config, x.shape),
        sums=sums,
        config=config,
        shape=tuple(x.shape),
        orig_dtype=x.dtype,
    )


def _squeeze_cells(arr: torch.Tensor, config: QuantConfig, xshape):
    """Per-cell arrays in the canonical shapes of :class:`QuantizedTensor`."""
    g = config.granularity
    if g == QuantGranularity.TENSOR:
        return arr.reshape(1, 1)
    if g == QuantGranularity.ROW:
        return arr.reshape(*xshape[:-1], 1)
    lead = tuple(xshape[:-2])
    if g == QuantGranularity.CHANNEL:
        return arr.reshape(*lead, 1, xshape[-1])
    if g == QuantGranularity.BLOCK:
        return arr.reshape(*lead, 1, xshape[-1] // config.block_size)
    if g == QuantGranularity.BLOCK_2D:
        return arr.reshape(*lead, xshape[-2] // config.block_rows,
                           xshape[-1] // config.block_size)
    raise NotImplementedError(g)


def _broadcast_cells(arr: torch.Tensor, config: QuantConfig, xshape):
    """Canonical per-cell arrays expanded to broadcast over the elements."""
    g = config.granularity
    if g == QuantGranularity.TENSOR:
        return arr.reshape((1,) * len(xshape))
    if g in (QuantGranularity.ROW, QuantGranularity.CHANNEL):
        return arr
    if g == QuantGranularity.BLOCK:
        return arr.repeat_interleave(config.block_size, dim=-1)
    if g == QuantGranularity.BLOCK_2D:
        out = arr.repeat_interleave(config.block_rows, dim=-2)
        return out.repeat_interleave(config.block_size, dim=-1)
    raise NotImplementedError(g)


def dequantize(t: QuantizedTensor) -> torch.Tensor:
    """Reconstruct float32: ``x = (q − zp) · scale``."""
    q = unpack_int4(t.data) if t.bits == 4 else t.data
    q = q.to(torch.int32).reshape(t.shape)
    scale = _broadcast_cells(t.scale, t.config, t.shape)
    zp = _broadcast_cells(t.zero_point, t.config, t.shape)
    return (q - zp).float() * scale


"""Quantization configuration: granularity, strategy and the frozen
``QuantConfig``.

A copy of the JAX package's ``quant/params.py``, kept here so that the port
imports nothing of that package.  ``storage_dtype`` names torch dtypes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class QuantGranularity(enum.Enum):
    """Scale/zero-point granularity."""

    TENSOR = "tensor"  # one (scale, zp) for the whole tensor
    ROW = "row"  # one (scale, zp) per row (= per token for K/V)
    CHANNEL = "channel"  # one (scale, zp) per last-dim channel, shared
    #                      across rows
    BLOCK = "block"  # 1D blocks of block_size along the last (reduction) dim
    BLOCK_2D = "block_2d"  # 2D (block_rows × block_size) blocks


class QuantStrategy(enum.Enum):
    """Scale derivation."""

    SYMMETRIC = "symmetric"  # scale = absmax / qmax, zp = 0
    ASYMMETRIC = "asymmetric"  # scale = (max-min)/(qmax-qmin), zp = qmin - round(min/scale)
    CENTERED = "centered"  # scale = max|x-mean|/qmax, zp = round(-mean/scale)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization spec.

    ``bits``: 8 (int8) or 4 (packed uint8 nibbles, value = nibble - 8).
    """

    bits: int = 8
    granularity: QuantGranularity = QuantGranularity.TENSOR
    strategy: QuantStrategy = QuantStrategy.SYMMETRIC
    block_size: Optional[int] = None  # reduction-dim block (BLOCK / BLOCK_2D)
    block_rows: Optional[int] = None  # row-dim block (BLOCK_2D only)
    compute_sums: bool = False  # precompute per-cell Σq for compensation

    def __post_init__(self):
        if self.bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {self.bits}")
        if self.granularity in (QuantGranularity.BLOCK,
                                QuantGranularity.BLOCK_2D):
            if not self.block_size:
                raise ValueError(f"{self.granularity} requires block_size")
            if self.block_size % 8 != 0:
                raise ValueError("block_size must be a multiple of 8")
        if self.granularity == QuantGranularity.BLOCK_2D and not self.block_rows:
            raise ValueError("BLOCK_2D requires block_rows")

    @property
    def qmax(self) -> int:
        return 127 if self.bits == 8 else 7

    @property
    def qmin(self) -> int:
        return -128 if self.bits == 8 else -8

    @property
    def storage_dtype(self) -> torch.dtype:
        return torch.int8 if self.bits == 8 else torch.uint8


INT8_TENSOR = QuantConfig(bits=8)
INT4_TENSOR = QuantConfig(bits=4)
INT8_ROW = QuantConfig(bits=8, granularity=QuantGranularity.ROW)


def int8_blockwise(block_size: int = 64,
                   compute_sums: bool = True) -> QuantConfig:
    return QuantConfig(
        bits=8,
        granularity=QuantGranularity.BLOCK,
        strategy=QuantStrategy.CENTERED,
        block_size=block_size,
        compute_sums=compute_sums,
    )


STANDARD_BLOCK_SIZES = (16, 32, 64, 128, 256)
DEFAULT_BLOCK_SIZE = 64


def optimal_block_size(k_dim: int) -> int:
    """Prefer the largest standard block that divides K, else the one that
    wastes the least padding."""
    divisors = [b for b in STANDARD_BLOCK_SIZES if k_dim % b == 0]
    if divisors:
        return max(divisors)
    waste = [(-(k_dim % -b), b) for b in STANDARD_BLOCK_SIZES]
    return min(waste)[1]

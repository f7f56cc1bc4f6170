"""Problem descriptors: what an attention call is, independent of its data.

The twin of the JAX package's ``attention/descriptor.py``.  A frozen,
hashable :class:`AttentionDescriptor` names the head geometry, the mask,
the softmax scale, the GQA head mapping and the precision policy; tensors
that travel with a call (sparse ranges, a bias) stay arguments of the
call.  :class:`~attention.multi_head.MultiHeadAttention` dispatches on it.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import (
    FULL,
    MaskSpec,
)


class BroadcastMode(enum.Enum):
    """How query heads share KV heads.

    STANDARD: num_q_heads == num_kv_heads.
    GQA: num_q_heads % num_kv_heads == 0; q head ``h`` reads kv head
      ``h // (num_q_heads // num_kv_heads)`` (grouped), or ``h %
      num_kv_heads`` with ``interleaved_kv=True``.
    MQA: one shared KV head.
    CROSS: a distinct kv sequence length (encoder-decoder).
    """

    STANDARD = "standard"
    GQA = "gqa"
    MQA = "mqa"
    CROSS = "cross"


@dataclasses.dataclass(frozen=True)
class MultiHeadShape:
    """A (batch, heads, sequence, head dim) shape."""

    batch: int
    num_heads: int
    seq_len: int
    head_dim: int

    def as_tuple(self):
        return (self.batch, self.num_heads, self.seq_len, self.head_dim)


@dataclasses.dataclass(frozen=True)
class AttentionDescriptor:
    """A static attention problem.

    ``softmax_scale`` of None means ``1/sqrt(head_dim)``.  ``input_dtype``
    is the dtype of Q/K/V in memory; ``output_dtype`` is O's (L and the
    softmax statistics are always fp32).  The forward always returns L.
    """

    head_dim: int
    num_q_heads: int = 1
    num_kv_heads: Optional[int] = None  # None: equal to num_q_heads
    mask: MaskSpec = FULL
    softmax_scale: Optional[float] = None
    interleaved_kv: bool = False  # q head h reads kv head h % num_kv_heads
    input_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        nkv = self.num_kv_heads
        if nkv is not None and self.num_q_heads % nkv != 0:
            raise ValueError(
                f"num_q_heads={self.num_q_heads} must be divisible by "
                f"num_kv_heads={nkv}"
            )

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_q_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_q_heads // self.kv_heads

    @property
    def broadcast_mode(self) -> BroadcastMode:
        if self.kv_heads == self.num_q_heads:
            return BroadcastMode.STANDARD
        if self.kv_heads == 1:
            return BroadcastMode.MQA
        return BroadcastMode.GQA

    def kv_head_for(self, q_head: int) -> int:
        """The KV head query head ``q_head`` reads."""
        if self.interleaved_kv:
            return q_head % self.kv_heads
        return q_head // self.q_per_kv

    def scale_or_default(self) -> float:
        if self.softmax_scale is not None:
            return float(self.softmax_scale)
        return float(self.head_dim) ** -0.5

"""``MultiHeadAttention``: the dispatch facade over the flash kernels.

The twin of the JAX package's ``attention/multi_head.py``.  A stateless
object bound to an :class:`AttentionDescriptor` checks the tensors against
it and calls the flash entry points with its mask, scale and head mapping:
:meth:`~MultiHeadAttention.forward` → ``flash_attention_forward`` (O and
L), ``__call__`` → the differentiable ``flash_attention``,
:meth:`~MultiHeadAttention.backward` → ``flash_attention_backward`` from
saved residuals.  Block sizes come from the :class:`AttentionTuner` unless
given; the flash kernels choose their own tiles and read none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch.attention.descriptor import (
    AttentionDescriptor,
)
from metal_flash_attention_plus_tpu_torch.attention.masking import (
    MaskKind,
    Ranges,
)
from metal_flash_attention_plus_tpu_torch.attention.tuning import (
    AttentionTuner,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention,
    flash_attention_forward,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_backward,
)


@dataclasses.dataclass(frozen=True)
class MultiHeadAttention:
    """Dispatcher bound to a static :class:`AttentionDescriptor`.

    ``block_sizes=None`` asks :meth:`AttentionTuner.recommend` (a stored
    calibration, else the cold-start table) at each call.
    """

    descriptor: AttentionDescriptor
    block_sizes: Optional[BlockSizes] = None

    def _blocks(self, seq_len: int, kind: str = "fwd") -> BlockSizes:
        if self.block_sizes is not None:
            return self.block_sizes
        return AttentionTuner.shared().recommend(
            kind, self.descriptor.head_dim, seq_len,
            causal=self.descriptor.mask.kind != MaskKind.NONE,
        )

    def _validate(self, q, k, v):
        d = self.descriptor
        b, hq, sq, hd = q.shape
        bk, hkv, skv, hdk = k.shape
        if hd != d.head_dim or hdk != d.head_dim:
            raise ValueError(
                f"head_dim mismatch: tensors {hd}/{hdk} vs descriptor "
                f"{d.head_dim}")
        if hq != d.num_q_heads or hkv != d.kv_heads:
            raise ValueError(
                f"head counts ({hq}, {hkv}) do not match descriptor "
                f"({d.num_q_heads}, {d.kv_heads})")
        if v.shape != k.shape or bk != b:
            raise ValueError(
                f"k/v/batch mismatch: {tuple(q.shape)} {tuple(k.shape)} "
                f"{tuple(v.shape)}")

    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        *,
        mask_ranges: Optional[Ranges] = None,
        bias: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (O [B, H, Sq, D] in ``descriptor.output_dtype``, L [B, H, Sq]
        fp32)."""
        self._validate(q, k, v)
        d = self.descriptor
        return flash_attention_forward(
            q, k, v, mask=d.mask, mask_ranges=mask_ranges, bias=bias,
            scale=d.scale_or_default(), block_sizes=self._blocks(q.shape[2]),
            interleaved_kv=d.interleaved_kv, out_dtype=d.output_dtype,
        )

    def __call__(self, q, k, v, bias=None, mask_ranges=None, **kw):
        """Differentiable forward (O only): the production entry point."""
        self._validate(q, k, v)
        d = self.descriptor
        return flash_attention(
            q, k, v, bias, mask_ranges, mask=d.mask,
            scale=d.scale_or_default(), block_sizes=self._blocks(q.shape[2]),
            interleaved_kv=d.interleaved_kv, **kw,
        )

    def backward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        o: torch.Tensor,
        logsumexp: torch.Tensor,
        do: torch.Tensor,
        *,
        bias: Optional[torch.Tensor] = None,
        mask_ranges: Optional[Ranges] = None,
    ):
        """Backward from the saved residuals (the forward's fp32 O and L) →
        (dq, dk, dv), fp32."""
        d = self.descriptor
        dq, dk, dv, _ = flash_attention_backward(
            q, k, v, o, logsumexp, do, mask=d.mask, mask_ranges=mask_ranges,
            bias=bias, scale=d.scale_or_default(),
            block_sizes=self._blocks(q.shape[2], "bwd"),
            interleaved_kv=d.interleaved_kv,
        )
        return dq, dk, dv

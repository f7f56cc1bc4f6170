"""Multi-Latent Attention (MLA): decompression and latent-space attention.

The twin of the JAX package's ``ops/mla.py``:

- :func:`mla_decompress` decompresses a latent KV cache with two GEMMs
  (K = latent·W_uk, V = latent·W_uv over [B·S, d_c] × [d_c, H·dh]); over
  quantized weights (``QuantizedTensor`` s stored transposed [H·dh, d_c])
  they run :func:`ops.quantized_gemm.quantized_matmul`, the weight-only
  GEMM kernels.
- :func:`mla_absorbed_attention` attends in the latent space with W_uk
  absorbed into Q and W_uv applied after attention: the latent cache
  c_kv [B, S, d_c] is shared by every head (MQA at head dim d_c, or
  d_c + d_r with the decoupled RoPE slice), so one flash call serves it;
  a per-token quantized latent runs the quantized attention kernel.

Absorption: with K_h = C·W_uk[h]ᵀ and V_h = C·W_uv[h],
S_h = (Q_h·W_uk[h])·Cᵀ and O_h = (P_h·C)·W_uv[h].  The absorbing and
projecting einsums run in fp32 whatever Q's dtype (the JAX package rounds
them to bf16-class precision for a bf16 Q).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import (
    FULL,
    MaskSpec,
    Ranges,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    quantized_flash_attention,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    quantized_matmul,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import QuantizedTensor


def mla_decompress(
    latent: torch.Tensor,
    w_uk: Union[torch.Tensor, QuantizedTensor],
    w_uv: Union[torch.Tensor, QuantizedTensor],
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent [B, S, d_c] × W_uk / W_uv → K, V [B, H, S, dh].

    Float weights are [d_c, H·dh]; a :class:`QuantizedTensor` is stored
    transposed, [H·dh, d_c], and runs the weight-only GEMM (M = B·S,
    N = H·dh, K = d_c).  A model's ``w_uk [H, dh, d_c]`` is that Bᵀ as
    ``w_uk.reshape(H·dh, d_c)``, its ``w_uv [H, d_c, dh]`` as
    ``w_uv.transpose(1, 2).reshape(H·dh, d_c)``.
    """
    b, s, dc = latent.shape

    def proj(w):
        if isinstance(w, QuantizedTensor):
            n, k2 = w.shape
            if k2 != dc:
                raise ValueError(f"quantized weight {w.shape} does not take "
                                 f"d_c={dc}")
            flat = quantized_matmul(latent.reshape(b * s, dc), w)
            return flat.reshape(b, s, n)
        if w.shape[0] != dc:
            raise ValueError(f"weight {tuple(w.shape)} does not take "
                             f"d_c={dc}")
        return latent @ w

    k = proj(w_uk)
    v = proj(w_uv)
    dh = k.shape[-1] // num_heads
    k = k.reshape(b, s, num_heads, dh).transpose(1, 2)
    v = v.reshape(b, s, num_heads, dh).transpose(1, 2)
    return k, v


def mla_absorbed_attention(
    q: torch.Tensor,
    c_kv: Union[torch.Tensor, QuantizedTensor],
    w_uk: torch.Tensor,
    w_uv: torch.Tensor,
    *,
    q_rope: Optional[torch.Tensor] = None,
    k_rope: Optional[torch.Tensor] = None,
    mask: MaskSpec = FULL,
    mask_ranges: Optional[Ranges] = None,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
) -> torch.Tensor:
    """Attention computed in the latent space.

    Args:
      q: [B, H, Sq, dh] per-head queries (the NoPE part).
      c_kv: the latent KV cache [B, Skv, d_c]: a float tensor, or a
        per-token :class:`QuantizedTensor` of logical shape
        [B, 1, Skv, d_c].
      w_uk: [H, dh, d_c] key decompression (absorbed into Q).
      w_uv: [H, d_c, dh] value decompression (applied after attention).
      q_rope, k_rope: optional decoupled-RoPE slices, [B, H, Sq, d_r] and
        [B, Skv, d_r] (k_rope shared by every head).
      scale: softmax scale; default 1/sqrt(dh + d_r), the scale of the
        uncompressed attention.

    Returns [B, H, Sq, dh] in q's dtype.
    """
    dh = q.shape[-1]
    quantized = isinstance(c_kv, QuantizedTensor)
    if quantized:
        if c_kv.shape[1] != 1:
            raise ValueError("a quantized latent cache is head-shared "
                             "([B, 1, Skv, d_c])")
        dc = c_kv.shape[3]
    else:
        dc = c_kv.shape[2]
    d_r = 0 if q_rope is None else q_rope.shape[-1]
    if scale is None:
        scale = float(dh + d_r) ** -0.5

    # q_lat[b,h,s,c] = Σ_d q[b,h,s,d]·w_uk[h,d,c]
    q_lat = torch.einsum("bhsd,hdc->bhsc", q.float(),
                         w_uk.float()).to(q.dtype)
    if q_rope is not None:
        if k_rope is None:
            raise ValueError("q_rope requires k_rope")
        q_lat = torch.cat([q_lat, q_rope.to(q.dtype)], dim=-1)

    if quantized:
        if q_rope is not None:
            raise NotImplementedError(
                "decoupled RoPE with a quantized latent cache: quantize "
                "[C | K_rope] jointly instead")
        o_lat = quantized_flash_attention(q_lat, c_kv, c_kv, mask=mask,
                                          scale=scale, block_sizes=block_sizes)
    else:
        kv = c_kv[:, None]  # [B, 1, Skv, d_c]: MQA over the shared latent
        if q_rope is not None:
            k_full = torch.cat([kv, k_rope[:, None].to(kv.dtype)], dim=-1)
            # V is the bare latent, zero-padded over the rope slice so that
            # one call serves both (the zero tail adds nothing to O).
            v_full = torch.cat([kv, torch.zeros_like(k_rope[:, None],
                                                     dtype=kv.dtype)], dim=-1)
        else:
            k_full = v_full = kv
        o_lat = flash_attention(
            q_lat, k_full.to(q_lat.dtype), v_full.to(q_lat.dtype), mask=mask,
            mask_ranges=mask_ranges, scale=scale, block_sizes=block_sizes)

    o_lat = o_lat[..., :dc]  # the rope tail of O is zero by construction
    # o[b,h,s,d] = Σ_c o_lat[b,h,s,c]·w_uv[h,c,d]
    o = torch.einsum("bhsc,hcd->bhsd", o_lat.float(), w_uv.float())
    return o.to(q.dtype)

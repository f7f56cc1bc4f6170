"""Plain dense fp32 attention — the port's golden model.

Conventions follow the JAX package's ``reference/attention.py``:

- tensors are BHSD: ``q [B, Hq, Sq, D]``, ``k/v [B, Hkv, Skv, D]``;
- ``l`` is the natural-log row logsumexp ``m + log(sum(exp(s - m)))``,
  shape ``[B, Hq, Sq]``;
- ``d = rowsum(dO ⊙ O)``, shape ``[B, Hq, Sq]``, the backward's D;
- GQA maps q head ``h`` to kv head ``h // group`` (grouped) or
  ``h % Hkv`` (interleaved).

Masking comes first, then the additive bias.  A row whose mask is empty
gets the mean of V here (every score is the sentinel); the flash path
gives O = 0 and L = -inf there instead, as the JAX flash kernels do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import (
    CAUSAL,
    DEFAULT_MASK_VALUE,
    FULL,
    MaskSpec,
    Ranges,
    materialize_mask,
)

__all__ = [
    "CAUSAL",
    "DEFAULT_MASK_VALUE",
    "FULL",
    "reference_attention",
    "reference_attention_bwd",
    "reference_attention_vjp",
]


def _expand_kv_heads(
    t: torch.Tensor, num_q_heads: int, interleaved: bool
) -> torch.Tensor:
    """Broadcast [B, Hkv, S, D] KV to [B, Hq, S, D] per the GQA mapping."""
    hkv = t.shape[1]
    if hkv == num_q_heads:
        return t
    group = num_q_heads // hkv
    if interleaved:
        return t.repeat(1, group, 1, 1)  # q head h -> kv head h % hkv
    return t.repeat_interleave(group, dim=1)  # q head h -> kv head h // group


def _reduce_kv_heads(
    t: torch.Tensor, num_kv_heads: int, interleaved: bool
) -> torch.Tensor:
    """Sum [B, Hq, S, D] per-q-head gradients back to [B, Hkv, S, D]."""
    b, hq, s, d = t.shape
    if hq == num_kv_heads:
        return t
    group = hq // num_kv_heads
    if interleaved:
        return t.reshape(b, group, num_kv_heads, s, d).sum(dim=1)
    return t.reshape(b, num_kv_heads, group, s, d).sum(dim=2)


def _masked_scores(q, k, scale, mask, mask_ranges, bias, mask_value):
    sq, skv = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    keep = materialize_mask(mask, sq, skv, ranges=mask_ranges,
                            device=q.device)
    s = torch.where(keep, s, torch.full_like(s, mask_value))
    if bias is not None:
        s = s + bias.float()
    return s


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    mask: MaskSpec = FULL,
    mask_ranges: Optional[Ranges] = None,
    bias: Optional[torch.Tensor] = None,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense golden attention forward → (o [B, Hq, Sq, D] fp32,
    l [B, Hq, Sq] natural logsumexp fp32).

    Args:
      q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D], Hkv dividing Hq.
      scale: softmax scale, default D^-0.5.
      mask: a :class:`MaskSpec`; ``mask_ranges`` carries the ranges of
        SPARSE_RANGES ([Sq, 2]) and BLOCK_SPARSE ([row blocks, 2]).
      bias: additive bias broadcastable to [B, Hq, Sq, Skv], added after
        masking.
      interleaved_kv: the ``h % Hkv`` GQA mapping.
    """
    hq, dd = q.shape[1], q.shape[3]
    if scale is None:
        scale = float(dd) ** -0.5
    kf = _expand_kv_heads(k, hq, interleaved_kv).float()
    vf = _expand_kv_heads(v, hq, interleaved_kv).float()
    s = _masked_scores(q.float(), kf, scale, mask, mask_ranges, bias,
                       mask_value)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / lsum
    return o, (m + torch.log(lsum))[..., 0]


def reference_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    l: torch.Tensor,
    do: torch.Tensor,
    *,
    scale: Optional[float] = None,
    mask: MaskSpec = FULL,
    mask_ranges: Optional[Ranges] = None,
    bias: Optional[torch.Tensor] = None,
    interleaved_kv: bool = False,
    mask_value: float = DEFAULT_MASK_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Golden analytic backward from saved (o, l) residuals:

      D  = rowsum(dO ⊙ O)
      P  = exp(S·scale − L)           (recomputed from L)
      dP = dO · Vᵀ
      dS = P ⊙ (dP − D)
      dQ = scale · dS · K;  dK = scale · dSᵀ · Q;  dV = Pᵀ · dO

    Returns (dq, dk, dv, d), fp32, dk/dv reduced back to Hkv heads.
    """
    hq, dd = q.shape[1], q.shape[3]
    hkv = k.shape[1]
    if scale is None:
        scale = float(dd) ** -0.5
    kx = _expand_kv_heads(k, hq, interleaved_kv).float()
    vx = _expand_kv_heads(v, hq, interleaved_kv).float()
    qf, of, dof = q.float(), o.float(), do.float()
    s = _masked_scores(qf, kx, scale, mask, mask_ranges, bias, mask_value)
    p = torch.exp(s - l[..., None])  # normalized probabilities
    d = (dof * of).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    ds = p * (dp - d[..., None])
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kx)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return (dq, _reduce_kv_heads(dk, hkv, interleaved_kv),
            _reduce_kv_heads(dv, hkv, interleaved_kv), d)


def reference_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  **kwargs) -> torch.Tensor:
    """:func:`reference_attention`'s output alone (its keyword arguments
    pass through)."""
    return reference_attention(q, k, v, **kwargs)[0]


def reference_attention_vjp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by ``torch.autograd`` through the dense forward — a
    second golden model, independent of the analytic backward above."""
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        o, _ = reference_attention(*leaves, **kwargs)
        grads = torch.autograd.grad(o, leaves, grad_outputs=do.float())
    return tuple(grads)

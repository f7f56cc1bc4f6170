"""Plain dense fp32 attention — the port's golden model.

Conventions follow the JAX package's ``reference/attention.py``:

- tensors are BHSD: ``q [B, Hq, Sq, D]``, ``k/v [B, Hkv, Skv, D]``;
- ``l`` is the natural-log row logsumexp ``m + log(sum(exp(s - m)))``,
  shape ``[B, Hq, Sq]``;
- GQA maps q head ``h`` to kv head ``h // group`` (grouped) or
  ``h % Hkv`` (interleaved).

Only the FULL and CAUSAL masks exist here so far; the rest of the mask
zoo comes with the flash-attention slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

FULL = "full"
CAUSAL = "causal"
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


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


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    mask: str = FULL,
    interleaved_kv: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense golden attention forward → (o [B, Hq, Sq, D] fp32,
    l [B, Hq, Sq] natural logsumexp fp32).

    CAUSAL aligns the query rows to the END of the keys (row ``i`` sees
    keys ``≤ i + Skv - Sq``), which is plain causal when ``Sq == Skv``.
    """
    if mask not in (FULL, CAUSAL):
        raise ValueError(f"mask must be {FULL!r} or {CAUSAL!r}, got {mask!r}")
    hq, sq, dd = q.shape[1], q.shape[2], q.shape[3]
    if scale is None:
        scale = float(dd) ** -0.5
    kf = _expand_kv_heads(k, hq, interleaved_kv).float()
    vf = _expand_kv_heads(v, hq, interleaved_kv).float()
    skv = kf.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if mask == CAUSAL:
        row = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        col = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / lsum
    return o, (m + torch.log(lsum))[..., 0]

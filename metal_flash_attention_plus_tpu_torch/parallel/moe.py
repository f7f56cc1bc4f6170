"""Expert parallelism: a top-k routed MoE layer over a process group.

The port of the JAX package's ``parallel/moe.py`` (GShard-shaped):

- top-k (default 2) softmax gating with per-expert CAPACITY buffers: each
  expert accepts at most ``capacity`` tokens per rank, and the overflow is
  dropped from that expert (its gate weight is lost);
- dispatch and combine as one-hot einsums;
- EP over ``group``: each rank holds E/ep experts' SwiGLU weights, and two
  all-to-alls move the token buffers rank → expert owner → rank.

Every rank of ``group`` calls :func:`moe_ffn` on its own tokens.
Differentiable end to end (einsums and :func:`parallel.comm.all_to_all`,
whose gradient is the same all-to-all); the top-k assignment is piecewise
constant, and gradients flow through the gate values.  The expert products
are ``torch.einsum`` (the JAX package leaves them to XLA: no Pallas
kernel).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.parallel.comm import (
    all_to_all,
    rank_and_size,
)


def init_moe_params(
    generator: torch.Generator,
    d_model: int,
    d_ff: int,
    num_experts: int,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Router + per-expert SwiGLU weights, expert-major (shard dim 0 over
    the expert group).  Normals · fan_in^-0.5 from ``generator`` (a CPU
    generator: router, wg, wu, wd in turn; not ``jax.random``'s numbers);
    the router is fp32."""
    dev = resolve_device(device)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(device=dev, dtype=dtype)

    router = dense((d_model, num_experts), d_model).float()
    return dict(
        router=router,
        wg=dense((num_experts, d_model, d_ff), d_model),
        wu=dense((num_experts, d_model, d_ff), d_model),
        wd=dense((num_experts, d_ff, d_model), d_ff),
    )


def _top_k_gates(logits: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax, the top-k experts and their gates renormalized over the
    selected ones → (gates [T, k], expert ids [T, k])."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, expert_idx


def _gating(
    logits: torch.Tensor, num_experts: int, top_k: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (dispatch [T, E, C] 0/1, combine [T, E, C] fp32).

    A token's place in an expert's buffer is its rank among the tokens
    routed to that expert, earlier slots' claims counted first (tokens past
    ``capacity`` are dropped for that expert).  Gates are renormalized over
    the SELECTED experts before capacity (dropped weight is lost, the
    GShard convention)."""
    t = logits.shape[0]
    gate_vals, expert_idx = _top_k_gates(logits, top_k)
    dev = logits.device
    dispatch = torch.zeros((t, num_experts, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    for slot in range(top_k):
        onehot = F.one_hot(expert_idx[:, slot], num_experts).float()  # [T, E]
        prior = dispatch.sum(dim=2)  # [T, E]: claims from earlier slots
        rank = (torch.cumsum(onehot, dim=0) - onehot) + prior.sum(
            dim=0, keepdim=True)
        pos = (rank * onehot).sum(dim=1).long()  # [T]
        keep = pos < capacity
        pos_oh = F.one_hot(torch.where(keep, pos, capacity),
                           capacity + 1).float()[:, :capacity]
        slot_dispatch = onehot[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch + slot_dispatch
        combine = combine + slot_dispatch * gate_vals[:, slot][:, None, None]
    return dispatch, combine


def moe_ffn(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [T_local, d_model]: this rank's tokens
    group=None,
    *,
    top_k: int = 2,
    capacity_factor: float = 2.0,
) -> torch.Tensor:
    """Expert-parallel SwiGLU MoE over the ranks of ``group`` (``None``:
    the default group).

    ``params['wg' / 'wu' / 'wd']`` hold this rank's E/ep experts
    ([E/ep, ...], experts r·E/ep … (r+1)·E/ep − 1 on rank r);
    ``params['router']`` is the whole [d_model, E] router on every rank.
    Returns [T_local, d_model] in x's dtype."""
    ep = rank_and_size(group)[1]
    t, d_model = x.shape
    e_local = params["wg"].shape[0]
    num_experts = e_local * ep
    capacity = max(1, int(capacity_factor * top_k * t / num_experts))

    logits = x.float() @ params["router"]  # [T, E]
    dispatch, combine = _gating(logits, num_experts, top_k, capacity)

    # [T, E, C] × [T, d] → [E, C, d]: expert-major token buffers.
    buffers = torch.einsum("tec,td->ecd", dispatch, x.float()).to(x.dtype)
    # The JAX tiled all_to_all(split_axis=0, concat_axis=1): expert block
    # j goes to rank j, and the blocks that arrive line up peer-major
    # along the token axis: [E, C, d] → [E/ep, ep·C, d].
    recv = all_to_all(buffers.reshape(ep, e_local, capacity, d_model), group)
    recv = recv.transpose(0, 1).reshape(e_local, ep * capacity, d_model)

    h = torch.einsum("ecd,edf->ecf", recv, params["wg"])
    u = torch.einsum("ecd,edf->ecf", recv, params["wu"])
    y = (F.silu(h.float()) * u.float()).to(x.dtype)
    out_buf = torch.einsum("ecf,efd->ecd", y, params["wd"])

    # The inverse (split_axis=1, concat_axis=0): peer j's token block goes
    # home, and the expert axis regrows to E in global (rank-major) order.
    back = all_to_all(out_buf.reshape(e_local, ep, capacity, d_model)
                      .transpose(0, 1), group)
    back = back.reshape(num_experts, capacity, d_model)
    return torch.einsum("tec,ecd->td", combine, back.float()).to(x.dtype)


def moe_ffn_dense_reference(params_full: Dict[str, torch.Tensor],
                            x: torch.Tensor, *, top_k: int = 2
                            ) -> torch.Tensor:
    """Unsharded golden: every expert computes every token, combined by
    the gates (no capacity drops): what :func:`moe_ffn` gives with ample
    capacity."""
    logits = x.float() @ params_full["router"]
    gate_vals, expert_idx = _top_k_gates(logits, top_k)
    num_experts = params_full["router"].shape[1]
    gates = torch.zeros_like(logits)
    for slot in range(top_k):
        gates = gates + F.one_hot(expert_idx[:, slot], num_experts).float() \
            * gate_vals[:, slot][:, None]

    h = torch.einsum("td,edf->tef", x.float(), params_full["wg"])
    u = torch.einsum("td,edf->tef", x.float(), params_full["wu"])
    y = F.silu(h) * u
    out = torch.einsum("tef,efd->ted", y, params_full["wd"])
    return torch.einsum("te,ted->td", gates, out).to(x.dtype)

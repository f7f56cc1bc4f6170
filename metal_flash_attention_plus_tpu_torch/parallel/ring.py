"""Ring attention: context parallelism over KV chunks passed around a ring.

The port of the JAX package's ``parallel/ring.py``.  Each rank of a
process group (the JAX context mesh axis) owns one sequence chunk of Q, K
and V.  The KV chunks travel around the ring, one rank a step; each step
runs the flash forward kernel on the local Q against the chunk it holds,
and the partial (O, L) are merged with the log-sum-exp combine

    M' = max(M, l_s);  O' = O·e^{M−M'} + o_s·e^{l_s−M'};  W' = W·e^{M−M'} + e^{l_s−M'}

in the JAX package's step order.  The backward runs the dQ and dK/dV
kernels per step with the globally merged (O, L) as residuals, so each
step's partials are exact: dQ sums on its own rank, and the dK/dV partials
travel with their KV chunk and arrive home reduced.

Causal scheduling: at step s rank i holds chunk (i − s) mod N.  A chunk
past i is EMPTY (no kernel is launched for it), chunk i is the causal
diagonal, an earlier one is dense.  The zigzag layout
(:func:`ring_attention_zigzag`) gives rank i chunks i and 2N−1−i of 2N,
which balances the causal work: every rank runs 2N + 1 live sub-chunk
pairs over the N steps.

The ring shift is ``torch.distributed.batch_isend_irecv`` to rank
(r + 1) mod N and from (r − 1) mod N (:mod:`parallel.comm`); each step's
shift is started before its kernels and waited for after them.  A rank
sends its KV chunk N − 1 times (the JAX loop's last rotation, which only
brings the chunks home, is skipped), its dK/dV partials N times.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import (
    CAUSAL,
    FULL,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention_forward,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_backward,
)
from metal_flash_attention_plus_tpu_torch.parallel.comm import (
    RingShift,
    rank_and_size,
)

EMPTY, DIAG, DENSE = 0, 1, 2
_MASKS = {DIAG: CAUSAL, DENSE: FULL}


def _safe_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp(a − b) with exp(−inf − −inf) := 0 (the empty accumulator)."""
    return torch.where(torch.isneginf(a), torch.zeros_like(a),
                       torch.exp(a - b))


def _merge(acc, m, w, o_s, l_s):
    """Online-softmax merge of a partial (o_s, l_s) into (acc, m, w)."""
    m_new = torch.maximum(m, l_s)
    c_prev = _safe_exp(m, m_new)
    c_new = _safe_exp(l_s, m_new)
    acc = acc * c_prev[..., None] + o_s * c_new[..., None]
    w = w * c_prev + c_new
    return acc, m_new, w


def _finish(acc, m, w):
    """(O, L) from the merged accumulators: O = acc / W, L = M + ln W,
    and L = −inf where no key was live."""
    w_safe = torch.clamp(w, min=torch.finfo(torch.float32).tiny)
    o = acc / w_safe[..., None]
    lse = torch.where(w > 0, m + torch.log(w_safe),
                      torch.full_like(m, -float("inf")))
    return o, lse


def _step_kind(kv_idx: int, my_idx: int, causal: bool) -> int:
    if not causal:
        return DENSE
    return EMPTY if kv_idx > my_idx else DIAG if kv_idx == my_idx else DENSE


def _shift(tensors: Sequence[torch.Tensor], group, last: bool):
    """Start the ring shift of ``tensors`` unless this is the last step."""
    return None if last else RingShift(tensors, group)


class _Ring(torch.autograd.Function):
    """``custom_vjp`` analog of the JAX ``ring_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, interleaved_kv):
        rank, n = rank_and_size(group)
        b, hq, s_loc, d = q.shape
        acc = torch.zeros((b, hq, s_loc, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, hq, s_loc), -float("inf"), dtype=torch.float32,
                       device=q.device)
        w = torch.zeros((b, hq, s_loc), dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for s in range(n):
            shift = _shift((k_cur, v_cur), group, s == n - 1)
            kind = _step_kind((rank - s) % n, rank, causal)
            if kind != EMPTY:
                o_s, l_s = flash_attention_forward(
                    q, k_cur, v_cur, mask=_MASKS[kind], scale=scale,
                    interleaved_kv=interleaved_kv, out_dtype=torch.float32)
                acc, m, w = _merge(acc, m, w, o_s, l_s)
            if shift is not None:
                k_cur, v_cur = shift.wait()
        o, lse = _finish(acc, m, w)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, causal, scale, interleaved_kv)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale, interleaved_kv = ctx.args
        rank, n = rank_and_size(group)
        # D = rowsum(dO ⊙ O) depends only on (O, dO): once, not per step.
        di = (do.float() * o).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for s in range(n):
            shift = _shift((k_cur, v_cur), group, s == n - 1)
            kind = _step_kind((rank - s) % n, rank, causal)
            if kind != EMPTY:
                dq_s, dk_s, dv_s, _ = flash_attention_backward(
                    q, k_cur, v_cur, o, lse, do, mask=_MASKS[kind],
                    scale=scale, interleaved_kv=interleaved_kv, di=di)
                dq = dq + dq_s
                dk = dk + dk_s
                dv = dv + dv_s
            # The dK/dV partials travel with their chunk: after N shifts
            # each chunk's gradient is home, reduced over every Q chunk.
            dk, dv = RingShift((dk, dv), group, tag=2).wait()
            if shift is not None:
                k_cur, v_cur = shift.wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal: bool = True,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
) -> torch.Tensor:
    """Context-parallel flash attention over the ranks of ``group``.

    Args:
      q: the local [B, Hq, S_local, D] chunk (chunk r on rank r).
      k, v: the local [B, Hkv, S_local, D] chunks.
      group: the process group of the context axis (``None``: the default
        group); rank and size come from it.
      causal: causal masking in GLOBAL sequence coordinates.
      block_sizes: accepted for parity with the JAX package; unused.

    Returns the local O chunk [B, Hq, S_local, D] in q's dtype;
    differentiable in q, k and v.
    """
    del block_sizes  # the Hopper kernels choose their own tiles
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), group,
                       causal, scale, interleaved_kv)


# ---------------------------------------------------------------------------
# Zigzag ring: causal load balancing
# ---------------------------------------------------------------------------


def zigzag_order(num_devices: int) -> List[int]:
    """The chunk permutation that puts (i, 2N−1−i) together for rank i."""
    n = num_devices
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    return order


def zigzag_inverse(num_devices: int) -> List[int]:
    order = zigzag_order(num_devices)
    inv = [0] * len(order)
    for pos, c in enumerate(order):
        inv[c] = pos
    return inv


def _zz_apply(x: torch.Tensor, perm: Sequence[int], seq_axis: int):
    parts = torch.chunk(x, len(perm), dim=seq_axis)
    if len(parts) != len(perm) or x.shape[seq_axis] % len(perm):
        raise ValueError(f"sequence length {x.shape[seq_axis]} does not "
                         f"split into {len(perm)} equal chunks")
    return torch.cat([parts[p] for p in perm], dim=seq_axis)


def zigzag_preshard(x: torch.Tensor, num_devices: int, seq_axis: int = 2):
    """Global [.., S, ..] → zigzag chunk order: rank i's share is then the
    i-th of N equal slices along ``seq_axis``."""
    return _zz_apply(x, zigzag_order(num_devices), seq_axis)


def zigzag_postshard(x: torch.Tensor, num_devices: int, seq_axis: int = 2):
    """Invert :func:`zigzag_preshard` on gathered outputs."""
    return _zz_apply(x, zigzag_inverse(num_devices), seq_axis)


def _zz_chunk_kind(qc: int, kc: int) -> int:
    return EMPTY if kc > qc else DIAG if kc == qc else DENSE


def _zz_pairs(rank: int, n: int, s: int):
    """Step s's four (q sub-chunk, kv sub-chunk, kind) in JAX's order."""
    j = (rank - s) % n
    kv_chunks = (j, 2 * n - 1 - j)
    q_chunks = (rank, 2 * n - 1 - rank)
    return [(qi, ki, _zz_chunk_kind(q_chunks[qi], kv_chunks[ki]))
            for qi in range(2) for ki in range(2)]


class _Zigzag(torch.autograd.Function):
    """``custom_vjp`` analog of the JAX ``ring_attention_zigzag``."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale, interleaved_kv):
        rank, n = rank_and_size(group)
        b, hq, s2, d = q.shape
        c = s2 // 2
        q_subs = (q[:, :, :c], q[:, :, c:])
        accs = [torch.zeros((b, hq, c, d), dtype=torch.float32,
                            device=q.device) for _ in range(2)]
        ms = [torch.full((b, hq, c), -float("inf"), dtype=torch.float32,
                         device=q.device) for _ in range(2)]
        ws = [torch.zeros((b, hq, c), dtype=torch.float32, device=q.device)
              for _ in range(2)]
        k_cur, v_cur = k, v
        for s in range(n):
            shift = _shift((k_cur, v_cur), group, s == n - 1)
            for qi, ki, kind in _zz_pairs(rank, n, s):
                if kind == EMPTY:
                    continue
                o_s, l_s = flash_attention_forward(
                    q_subs[qi], k_cur[:, :, ki * c:(ki + 1) * c],
                    v_cur[:, :, ki * c:(ki + 1) * c], mask=_MASKS[kind],
                    scale=scale, interleaved_kv=interleaved_kv,
                    out_dtype=torch.float32)
                accs[qi], ms[qi], ws[qi] = _merge(accs[qi], ms[qi], ws[qi],
                                                  o_s, l_s)
            if shift is not None:
                k_cur, v_cur = shift.wait()
        outs = [_finish(accs[i], ms[i], ws[i]) for i in range(2)]
        o = torch.cat([outs[0][0], outs[1][0]], dim=2)
        lse = torch.cat([outs[0][1], outs[1][1]], dim=2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, scale, interleaved_kv)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, scale, interleaved_kv = ctx.args
        rank, n = rank_and_size(group)
        c = q.shape[2] // 2
        di = (do.float() * o).sum(dim=-1)

        def sub(x, i):
            return x[:, :, i * c:(i + 1) * c]

        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # [dK (2c) | dV (2c)] along the sequence: one buffer travels.
        b, hkv, _, d = k.shape
        dkv = torch.zeros((b, hkv, 4 * c, d), dtype=torch.float32,
                          device=k.device)
        k_cur, v_cur = k, v
        for s in range(n):
            shift = _shift((k_cur, v_cur), group, s == n - 1)
            for qi, ki, kind in _zz_pairs(rank, n, s):
                if kind == EMPTY:
                    continue
                dq_s, dk_s, dv_s, _ = flash_attention_backward(
                    sub(q, qi), sub(k_cur, ki), sub(v_cur, ki), sub(o, qi),
                    sub(lse, qi), sub(do, qi), mask=_MASKS[kind],
                    scale=scale, interleaved_kv=interleaved_kv,
                    di=sub(di, qi))
                dq[:, :, qi * c:(qi + 1) * c] += dq_s
                dkv[:, :, ki * c:(ki + 1) * c] += dk_s
                dkv[:, :, (2 + ki) * c:(3 + ki) * c] += dv_s
            (dkv,) = RingShift((dkv,), group, tag=2).wait()
            if shift is not None:
                k_cur, v_cur = shift.wait()
        return (dq.to(q.dtype), dkv[:, :, :2 * c].to(k.dtype),
                dkv[:, :, 2 * c:].to(v.dtype), None, None, None)


def ring_attention_zigzag(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    scale: Optional[float] = None,
    block_sizes: BlockSizes = BlockSizes(),
    interleaved_kv: bool = False,
) -> torch.Tensor:
    """Causal context-parallel attention, zigzag-balanced.

    The local operands hold chunks (i, 2N−1−i) concatenated along the
    sequence (:func:`zigzag_preshard` the global tensors first, then take
    rank i's i-th slice).  Returns the local O in the same zigzag layout,
    in q's dtype; differentiable in q, k and v.
    """
    del block_sizes  # the Hopper kernels choose their own tiles
    if q.shape[2] % 2 or k.shape[2] != q.shape[2]:
        raise ValueError("zigzag operands hold two equal chunks of Q and KV")
    return _Zigzag.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                         group, scale, interleaved_kv)

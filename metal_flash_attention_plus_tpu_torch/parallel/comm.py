"""The collectives of the distributed layer over a ``torch.distributed``
process group: a ring shift, an all-to-all, an all-reduce and an
all-gather.

They take the place of the JAX package's ``ppermute``, ``all_to_all``,
``psum`` / ``pmax`` and the gathers of ``shard_map``'s outputs over a mesh
axis: the group plays the axis (``None``: the default group), and a
rank's place on the axis is its rank in the group.  :func:`ring_shift`
and :func:`all_to_all` are differentiable (the shift's gradient is the
shift the other way round, the all-to-all's is the same all-to-all);
:func:`all_reduce` and :func:`all_gather` are not: ``parallel/spmd.py``
wraps the all-reduce in the gradients its callers need.

Transport: gloo's collectives take CPU tensors only, so under a gloo group
a CUDA tensor goes through host memory (copied out before the send,
copied back after the receive), and the CPU and the card sum in the same
order; every other backend (NCCL) sends the CUDA tensor itself.  The
copies move bytes only: the work around them still runs on the tensors'
device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def rank_and_size(group=None) -> Tuple[int, int]:
    """(this process's rank in ``group``, the group's size); raises unless
    a process group is initialized (the layer never starts one)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group is initialized: call "
            "torch.distributed.init_process_group first")
    return dist.get_rank(group), dist.get_world_size(group)


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` travels through host memory in ``group``."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


class RingShift:
    """Sends each tensor to the next rank of ``group`` ((r + 1) mod n) and
    receives its counterpart from the previous one ((r − 1) mod n), all
    in one ``batch_isend_irecv``; ``reverse`` sends to the previous rank
    and receives from the next.  :meth:`wait` returns the received
    tensors, on the sent tensors' devices and with their dtypes and
    shapes.  Started before a step's work and waited for after it, the
    transfer overlaps the work.  Tensor i goes under tag ``tag + i``, so
    two shifts in flight at once take disjoint tags."""

    def __init__(self, tensors: Sequence[torch.Tensor], group=None,
                 tag: int = 0, reverse: bool = False):
        rank, n = rank_and_size(group)
        step = -1 if reverse else 1
        nxt, prv = (_global(group, (rank + step) % n),
                    _global(group, (rank - step) % n))
        self._devices = [t.device for t in tensors]
        # The send buffers are held until wait(): the sends read them.
        self._sends = [t.detach().contiguous() for t in tensors]
        self._sends = [s.cpu() if _staged(group, s) else s
                       for s in self._sends]
        if n == 1:  # the ring of one rank: the tensors come back
            self._recvs, self._works = [s.clone() for s in self._sends], []
            return
        self._recvs = [torch.empty_like(s) for s in self._sends]
        ops = [dist.P2POp(dist.isend, s, nxt, group, tag=tag + i)
               for i, s in enumerate(self._sends)]
        ops += [dist.P2POp(dist.irecv, r, prv, group, tag=tag + i)
                for i, r in enumerate(self._recvs)]
        self._works = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._sends = None
        return [r.to(d) for r, d in zip(self._recvs, self._devices)]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(RingShift(tensors, group).wait())

    @staticmethod
    def backward(ctx, *grads):
        return (None, *RingShift(grads, ctx.group, reverse=True).wait())


def ring_shift(*tensors: torch.Tensor, group=None) -> Tuple[torch.Tensor, ...]:
    """:class:`RingShift` started and waited for, differentiable: the
    tensors received from the previous rank.  Its backward is the shift
    the other way round, so every rank whose forward shifted must run the
    backward too (a rank whose received tensors feed nothing still has to
    send its gradients on)."""
    return _RingShift.apply(group, *tensors)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    rank_and_size(group)
    src = x.contiguous()
    src = src.cpu() if _staged(group, src) else src
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_to_all_single`` over dim 0: ``x [n, ...]`` sends
    ``x[j]`` to rank j of ``group`` and returns ``out`` with ``out[j]``
    from rank j.  Differentiable: the gradient goes back through the same
    all-to-all."""
    return _AllToAll.apply(x, group)


def all_reduce(x: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` (``ReduceOp.SUM`` or ``ReduceOp.MAX``) of ``x`` over the
    ranks of ``group``, as a new tensor on x's device; ``x`` is left as it
    is.  Every rank gets the same bits.  Not differentiable."""
    n = rank_and_size(group)[1]
    if n == 1:
        return x.detach().clone()
    staged = _staged(group, x)
    buf = x.detach().to("cpu" if staged else x.device, copy=True)
    buf = buf.contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reassembly of a tensor sharded over ``group``).  Not
    differentiable."""
    n = rank_and_size(group)[1]
    if n == 1:
        return x.detach().clone()
    src = x.detach().contiguous()
    src = src.cpu() if _staged(group, src) else src
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)

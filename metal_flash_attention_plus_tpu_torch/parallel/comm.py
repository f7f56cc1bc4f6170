"""The collectives of the context-parallel layer: a ring shift and an
all-to-all over a ``torch.distributed`` process group.

They take the place of the JAX package's ``ppermute`` and ``all_to_all``
over a mesh axis: the group plays the axis (``None``: the default group),
and a rank's place on the axis is its rank in the group.

Transport: gloo's point-to-point and all-to-all take CPU tensors only, so
under a gloo group a CUDA tensor goes through host memory (copied out
before the send, copied back after the receive); every other backend
(NCCL) sends the CUDA tensor itself.  The copies move bytes only: the
attention around them still runs on the tensors' device.
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
    in one ``batch_isend_irecv``.  :meth:`wait` returns the received
    tensors, on the sent tensors' devices and with their dtypes and
    shapes.  Started before a step's work and waited for after it, the
    transfer overlaps the work.  Tensor i goes under tag ``tag + i``, so
    two shifts in flight at once take disjoint tags."""

    def __init__(self, tensors: Sequence[torch.Tensor], group=None,
                 tag: int = 0):
        rank, n = rank_and_size(group)
        nxt, prv = _global(group, (rank + 1) % n), _global(group,
                                                           (rank - 1) % n)
        self._devices = [t.device for t in tensors]
        # The send buffers are held until wait(): the sends read them.
        self._sends = [t.detach().contiguous() for t in tensors]
        self._sends = [s.cpu() if _staged(group, s) else s
                       for s in self._sends]
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


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_to_all_single`` over dim 0: ``x [n, ...]`` sends
    ``x[j]`` to rank j of ``group`` and returns ``out`` with ``out[j]``
    from rank j."""
    rank_and_size(group)
    src = x.contiguous()
    src = src.cpu() if _staged(group, src) else src
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)

"""Pipeline parallelism: GPipe fill–drain stages over a process group.

The port of the JAX package's ``parallel/pipeline.py``.  Every rank of the
group runs the same schedule; its rank is its stage, and activations flow
stage → stage + 1 with one ring shift (:func:`parallel.comm.ring_shift`)
per schedule step, the last stage's wrapping round to stage 0 as the JAX
``ppermute`` does.

Schedule: ``n_micro + n_stages − 1`` steps.  At step t, stage s works on
microbatch ``t − s`` (when 0 ≤ t − s < n_micro); stage 0 injects
microbatches, the last stage banks the outputs, and an inactive step sends
zeros.  Bubble fraction (S − 1) / (M + S − 1).

Differentiable: autograd runs the shifts' backward, each the shift the
other way round.  A rank must run all of them, also those whose tensors
depend on nothing differentiable (the last stage's before its first
microbatch) or feed nothing (stage 0's, and every stage's last): a zero
scalar, the link, is made from the inputs that require grad (an empty
slice of each), travels with each shift and is added to the output.  So
every shift of every rank lies on a path from the output to those inputs
(``torch.autograd.grad`` runs only such nodes), and the chain of links
orders the shifts' backward alike on every rank.  Hence every rank's loss
must depend on the output (as through :func:`broadcast_from_last_stage`),
and ``stage_fn``'s trainable tensors come in through ``stage_params`` or
``microbatches``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from metal_flash_attention_plus_tpu_torch.parallel.comm import (
    rank_and_size,
    ring_shift,
)
from metal_flash_attention_plus_tpu_torch.parallel.spmd import (
    _leaves,
    psum_id,
)


def pipeline_apply(
    stage_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: torch.Tensor,
    microbatches: torch.Tensor,  # [n_micro, micro_size, ...], every rank
    group=None,
    remat: bool = False,
) -> torch.Tensor:
    """Run ``stage_fn(params_local, x)`` as a pipeline over the ranks of
    ``group`` (``None``: the default group), rank r being stage r.

    Args:
      stage_fn: one stage's computation on one microbatch; its output has
        the microbatch's shape and dtype.
      stage_params: THIS stage's parameters (a tensor, or a dict or list
        of them).
      microbatches: all microbatches (the same on every rank; only stage 0
        reads them).
      remat: recompute each (stage, microbatch) forward in the backward
        (``torch.utils.checkpoint``) instead of keeping its activations.

    Returns [n_micro, micro_size, ...]: the outputs on the LAST stage,
    zeros on the others.
    """
    if remat:
        fn = (lambda p, x: checkpoint(stage_fn, p, x,  # noqa: E731
                                      use_reentrant=False))
    else:
        fn = stage_fn
    stage, n_stages = rank_and_size(group)
    n_micro = microbatches.shape[0]
    zeros = torch.zeros_like(microbatches[0])
    outputs = [zeros] * n_micro
    carry = zeros
    link = torch.zeros((), dtype=microbatches.dtype,
                       device=microbatches.device)
    if torch.is_grad_enabled():
        for x in _leaves(stage_params) + [microbatches]:
            if x.requires_grad:
                link = link + x.reshape(-1)[:0].sum()
    for t in range(n_micro + n_stages - 1):
        m = t - stage  # the microbatch this stage works on at step t
        y = zeros
        if 0 <= m < n_micro:
            y = fn(stage_params, microbatches[m] if stage == 0 else carry)
            if stage == n_stages - 1:
                outputs[m] = y
        carry, link = ring_shift(y, link, group=group)
    return torch.stack(outputs) + link


def broadcast_from_last_stage(x: torch.Tensor, group=None) -> torch.Tensor:
    """The last stage's ``x`` on every rank of ``group``.

    Through :func:`parallel.spmd.psum_id` (backward identity): every stage
    computes the same downstream loss from the broadcast value, so a plain
    sum's gradient would multiply by the group's size."""
    stage, n = rank_and_size(group)
    last = torch.tensor(stage == n - 1, device=x.device)
    return psum_id(torch.where(last, x, torch.zeros_like(x)), group)

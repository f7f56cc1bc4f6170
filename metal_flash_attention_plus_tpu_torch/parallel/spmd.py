"""Manual 3D-parallel (DP × TP × CP) transformer over process groups.

The port of the JAX package's ``parallel/spmd.py``: the line-for-line
sharding of ``models/transformer.py`` (the single-device model), in the
Megatron factoring.  A ``DeviceMesh`` of :func:`parallel.mesh.make_mesh`
stands where JAX has a mesh, and each axis's process group where JAX names
an axis inside ``shard_map``:

- ``data``: the batch sharded; gradients summed over it.
- ``model``: attention heads, the MLP's hidden width and the vocabulary
  sharded; ONE all-reduce after the attention out-projection and ONE after
  the MLP down-projection per layer.
- ``context``: the sequence sharded; attention runs as ring attention
  (``parallel/ring.py``) or the Ulysses all-to-all
  (``parallel/ulysses.py``), both over the flash kernels.

Every rank runs the same program on its own shards: :func:`shard_params`
cuts them out of the full parameters by the rank's mesh coordinate, the
loss and the train step take the GLOBAL batch (every rank passes the same
tokens, as a ``shard_map`` caller passes global arrays) and each rank
takes its data × context block of it.

Gradient correctness by construction, as in the JAX package: no gradient
flows through a plain collective.  The model-axis reductions inside the
network are :func:`psum_tp` (forward all-reduce, backward all-reduce: the
residual stream's cotangent is model-partial there), those at the loss
head :func:`psum_id` (backward identity: every model rank computes the
same loss from them), the log-sum-exp's max is taken on a detached tensor,
ring and Ulysses carry their own backward, and the mean over ranks happens
OUTSIDE autograd: the local loss SUM is differentiated, then each gradient
is summed over every axis its parameter is replicated on and divided by
the global token count.  The collectives of the backward run in the
autograd graph's order, which is the same on every rank (each rank's graph
has the same nodes, on one device).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    _merge_heads,
    _split_heads,
    rms_norm,
    rope,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from metal_flash_attention_plus_tpu_torch.parallel.comm import (
    all_gather,
    all_reduce,
)
from metal_flash_attention_plus_tpu_torch.parallel.mesh import AXES, MeshAxes
from metal_flash_attention_plus_tpu_torch.parallel.ring import ring_attention
from metal_flash_attention_plus_tpu_torch.parallel.ulysses import (
    ulysses_attention,
)


class _PsumTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct, ctx.group), None


class _PsumId(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def psum_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Tensor-parallel reduction: forward all-reduce (sum), backward
    all-reduce (the partial-cotangent regime: see the module docstring)."""
    return _PsumTP.apply(x, group)


def psum_id(x: torch.Tensor, group=None) -> torch.Tensor:
    """Loss-head reduction: forward all-reduce (sum), backward identity
    (the replicated-cotangent regime)."""
    return _PsumId.apply(x, group)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    axes: MeshAxes = AXES
    attn_mode: str = "ring"  # "ring" | "ulysses" | "local"

    def __post_init__(self):
        if self.attn_mode not in ("ring", "ulysses", "local"):
            raise ValueError(self.attn_mode)


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (dicts and lists), with
    the nodes at the same places in ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _leaves(tree) -> List:
    out: List = []
    _tree_map(out.append, tree)
    return out


def _placements(axes: MeshAxes, model_dim: Optional[int]
                ) -> Tuple[Placement, ...]:
    """Placements over the mesh axes (data, model, context): ``model_dim``
    sharded over ``model``, replicated everywhere else."""
    return tuple(Shard(model_dim) if name == axes.model
                 and model_dim is not None else Replicate()
                 for name in axes.all)


def param_specs(cfg: TransformerConfig, sc: ShardingConfig = ShardingConfig()):
    """The DTensor placements of ``init_params``' tree over the mesh axes
    (data, model, context): column-parallel ``wq wk wv wg wu unembed``
    (``Shard(1)`` over ``model``), row-parallel ``wo wd`` (``Shard(0)``),
    the rest replicated."""
    col, row, rep = (_placements(sc.axes, d) for d in (1, 0, None))
    layer = dict(ln1=rep, wq=col, wk=col, wv=col, wo=row, ln2=rep, wg=col,
                 wu=col, wd=row)
    return dict(
        embed=rep,
        layers=[dict(layer) for _ in range(cfg.num_layers)],
        ln_f=rep,
        unembed=col,
    )


def _grad_sync_groups(cfg: TransformerConfig):
    """'dc' = sum over (data, context); 'dcm' = additionally over model
    (parameters replicated across the model axis)."""
    layer = dict(
        ln1="dcm", wq="dc", wk="dc", wv="dc", wo="dc",
        ln2="dcm", wg="dc", wu="dc", wd="dc",
    )
    return dict(
        embed="dcm",
        layers=[dict(layer) for _ in range(cfg.num_layers)],
        ln_f="dcm",
        unembed="dc",
    )


def _size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def validate_mesh(cfg: TransformerConfig, mesh: DeviceMesh,
                  sc: ShardingConfig):
    """Early, readable shape checks, with the JAX package's messages."""
    ax = sc.axes
    tp = _size(mesh, ax.model)
    cp = _size(mesh, ax.context)
    if cfg.num_kv_heads % tp != 0:
        raise ValueError(
            f"num_kv_heads={cfg.num_kv_heads} must be divisible by the "
            f"model-axis size {tp} (KV-head replication across tp subgroups "
            "is not implemented)"
        )
    if cfg.num_heads % tp != 0:
        raise ValueError(
            f"num_heads={cfg.num_heads} not divisible by model axis {tp}"
        )
    if cfg.d_ff % tp != 0 or cfg.vocab_size % tp != 0:
        raise ValueError("d_ff and vocab_size must divide the model axis")
    if sc.attn_mode == "ulysses" and (cfg.num_heads // tp) % cp != 0:
        raise ValueError(
            f"ulysses: local heads {cfg.num_heads // tp} not divisible by "
            f"context axis {cp}"
        )
    if sc.attn_mode == "local" and cp != 1:
        raise ValueError("attn_mode='local' requires context axis of size 1")


def shard_params(params: Params, mesh: DeviceMesh, cfg: TransformerConfig,
                 sc: ShardingConfig = ShardingConfig()) -> Params:
    """This rank's shards of the full ``params`` (every rank passes the
    same), by its ``model`` coordinate: contiguous slices, so local query
    head j keeps its GQA kv head.  Fresh tensors on the parameters'
    devices, detached from ``params``."""
    validate_mesh(cfg, mesh, sc)
    tp, m = _size(mesh, sc.axes.model), mesh.get_local_rank(sc.axes.model)
    model_at = sc.axes.all.index(sc.axes.model)

    def cut(x: torch.Tensor, placements):
        p = placements[model_at]
        x = x.detach()
        if p.is_shard():
            n = x.shape[p.dim] // tp
            x = x.narrow(p.dim, m * n, n)
        return x.clone()

    return _tree_map(cut, params, param_specs(cfg, sc))


def unshard_params(shards: Dict[int, Params], cfg: TransformerConfig,
                   sc: ShardingConfig = ShardingConfig()) -> Params:
    """The inverse of :func:`shard_params`: {model coordinate: a rank's
    tree of shards (parameters or their gradients)} → the full tree, each
    sharded leaf concatenated along its ``param_specs`` dim in model
    order, each replicated leaf taken from model coordinate 0."""
    model_at = sc.axes.all.index(sc.axes.model)

    def join(placements, *parts):
        p = placements[model_at]
        return torch.cat(parts, dim=p.dim) if p.is_shard() else parts[0]

    return _tree_map(join, param_specs(cfg, sc),
                     *(shards[m] for m in sorted(shards)))


def mesh_rank(coord: Sequence[int], shape: Sequence[int]) -> int:
    """The global rank at mesh coordinate ``coord`` (data, model,
    context) of a :func:`parallel.mesh.make_mesh` mesh of ``shape``:
    row-major, context fastest."""
    (d, m, c), (_, mm, cc) = coord, shape
    return (d * mm + m) * cc + c


def local_batch(x: torch.Tensor, mesh: DeviceMesh,
                sc: ShardingConfig = ShardingConfig()) -> torch.Tensor:
    """This rank's block of a global [B, S, ...] batch: B over ``data``, S
    over ``context`` (``parallel.mesh.batch_sharding``)."""
    for name, dim in ((sc.axes.data, 0), (sc.axes.context, 1)):
        n = x.shape[dim] // _size(mesh, name)
        x = x.narrow(dim, mesh.get_local_rank(name) * n, n)
    return x


def _local_attention(q, k, v, cfg: TransformerConfig, sc: ShardingConfig,
                     mesh: DeviceMesh):
    if sc.attn_mode == "ring":
        return ring_attention(q, k, v, mesh.get_group(sc.axes.context), True,
                              None, cfg.block_sizes)
    if sc.attn_mode == "ulysses":
        return ulysses_attention(q, k, v, mesh.get_group(sc.axes.context),
                                 mask=CAUSAL, block_sizes=cfg.block_sizes)
    # "local": the context axis has size 1.
    return flash_attention(q, k, v, mask=CAUSAL, block_sizes=cfg.block_sizes)


def local_forward(params: Params, tokens: torch.Tensor,
                  cfg: TransformerConfig, sc: ShardingConfig,
                  mesh: DeviceMesh) -> torch.Tensor:
    """Per-rank forward on local shards → local logits [b_l, s_l, V/tp]
    fp32."""
    ax = sc.axes
    s_loc = tokens.shape[1]
    positions = (mesh.get_local_rank(ax.context) * s_loc
                 + torch.arange(s_loc, device=tokens.device))
    model = mesh.get_group(ax.model)
    x = F.embedding(tokens, params["embed"])
    hd = cfg.head_dim

    def layer_fn(layer, x):
        h = rms_norm(x, layer["ln1"])
        qh, kh, vh = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
        q = _split_heads(qh, qh.shape[-1] // hd, hd)
        k = _split_heads(kh, kh.shape[-1] // hd, hd)
        v = _split_heads(vh, vh.shape[-1] // hd, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        o = _local_attention(q, k, v, cfg, sc, mesh)
        attn = _merge_heads(o.to(x.dtype)) @ layer["wo"]
        x = x + psum_tp(attn.float(), model).to(x.dtype)

        h2 = rms_norm(x, layer["ln2"])
        y = F.silu((h2 @ layer["wg"]).float()) * (h2 @ layer["wu"]).float()
        down = y.to(x.dtype) @ layer["wd"]
        return x + psum_tp(down.float(), model).to(x.dtype)

    for layer in params["layers"]:
        if cfg.remat:
            x = checkpoint(functools.partial(layer_fn, layer), x,
                           use_reentrant=False)
        else:
            x = layer_fn(layer, x)
    hf = rms_norm(x, params["ln_f"])
    return (hf @ params["unembed"]).float()


def local_loss_sum(params: Params, inputs: torch.Tensor,
                   targets: torch.Tensor, cfg: TransformerConfig,
                   sc: ShardingConfig, mesh: DeviceMesh) -> torch.Tensor:
    """Per-rank SUM of next-token cross entropy over local tokens.

    The vocabulary is model-sharded, so the log-sum-exp and the target
    logit are two-stage: a local reduction, then :func:`psum_id` over the
    model axis."""
    ax = sc.axes
    model = mesh.get_group(ax.model)
    logits = local_forward(params, inputs, cfg, sc, mesh)  # [b, s, V/tp]
    v_loc = logits.shape[-1]
    off = mesh.get_local_rank(ax.model) * v_loc

    # The max is a numerical shift (its gradient cancels in the softmax),
    # taken on a detached tensor: the all-reduced max has no gradient.
    vmax = all_reduce(logits.detach().amax(dim=-1), model, dist.ReduceOp.MAX)
    sumexp = psum_id(torch.exp(logits - vmax[..., None]).sum(dim=-1), model)
    lse = vmax + torch.log(sumexp)

    in_shard = (targets >= off) & (targets < off + v_loc)
    idx = torch.clamp(targets - off, 0, v_loc - 1).long()
    tgt_local = torch.gather(logits, -1, idx[..., None])[..., 0]
    tgt = psum_id(torch.where(in_shard, tgt_local,
                              torch.zeros_like(tgt_local)), model)
    return (lse - tgt).sum()


def make_spmd_loss_and_grad(
    cfg: TransformerConfig,
    mesh: DeviceMesh,
    sc: ShardingConfig = ShardingConfig(),
    total_tokens: Optional[int] = None,
):
    """``f(params, inputs, targets) → (loss, grads)`` on every rank.

    ``params``: this rank's shards (:func:`shard_params`); ``inputs`` and
    ``targets``: the GLOBAL [B, S] batch, the same on every rank.  ``loss``
    is the global mean (the same bits on every rank); ``grads`` mirror
    ``params``, each summed over the axes its parameter is replicated on
    (one flat fp32 buffer per sync group, all-reduced over data, then
    context, then, for ``dcm``, model) and divided by ``total_tokens``
    (default: B · S), in its parameter's dtype."""
    ax = sc.axes
    groups = _grad_sync_groups(cfg)

    def fn(params: Params, inputs: torch.Tensor, targets: torch.Tensor):
        n = total_tokens or inputs.shape[0] * inputs.shape[1]
        with torch.enable_grad():
            local = _tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            lsum = local_loss_sum(local, local_batch(inputs, mesh, sc),
                                  local_batch(targets, mesh, sc), cfg, sc,
                                  mesh)
            leaves = _leaves(local)
            grads = list(torch.autograd.grad(lsum, leaves))
        kinds = _leaves(_tree_map(lambda _, g: g, params, groups))
        for kind in ("dc", "dcm"):
            idx = [i for i, k in enumerate(kinds) if k == kind]
            buf = torch.cat([grads[i].float().reshape(-1) for i in idx])
            for name in (ax.data, ax.context) + (
                    (ax.model,) if kind == "dcm" else ()):
                buf = all_reduce(buf, mesh.get_group(name))
            buf = buf / n
            parts = buf.split([grads[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                grads[i] = part.view(grads[i].shape).to(leaves[i].dtype)
        total = lsum.detach()
        for name in (ax.data, ax.context):
            total = all_reduce(total, mesh.get_group(name))
        it = iter(grads)
        return total / n, _tree_map(lambda _: next(it), params)

    return fn


def make_spmd_train_step(
    cfg: TransformerConfig,
    mesh: DeviceMesh,
    optimizer: torch.optim.Optimizer,
    sc: ShardingConfig = ShardingConfig(),
):
    """The sharded train step: ``step(params, opt_state, tokens) →
    (params, opt_state, loss)``, the contract of
    ``models.transformer.make_train_step``.

    ``params`` are this rank's shards and ``optimizer`` a ``torch.optim``
    optimizer built over them (``trainable_parameters(params)``);
    ``opt_state`` is its ``state``.  Both are updated IN PLACE.
    ``tokens`` is the global [B, S + 1] batch, the same on every rank;
    ``loss`` the global mean before the update."""
    loss_and_grad = make_spmd_loss_and_grad(cfg, mesh, sc)

    def step(params: Params, opt_state, tokens: torch.Tensor):
        if opt_state is not optimizer.state:
            raise ValueError("opt_state must be optimizer.state")
        loss, grads = loss_and_grad(params, tokens[:, :-1], tokens[:, 1:])
        for p, g in zip(_leaves(params), _leaves(grads)):
            p.grad = g
        optimizer.step()
        return params, optimizer.state, loss

    return step


def spmd_forward(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig, mesh: DeviceMesh,
                 sc: ShardingConfig = ShardingConfig()) -> torch.Tensor:
    """Sharded inference forward: the global tokens [B, S] (the same on
    every rank) → the global logits [B, S, V] fp32 on every rank, the
    local logits gathered over model, context and data."""
    ax = sc.axes
    with torch.no_grad():
        logits = local_forward(params, local_batch(tokens, mesh, sc), cfg,
                               sc, mesh)
    for name, dim in ((ax.model, -1), (ax.context, 1), (ax.data, 0)):
        logits = all_gather(logits, mesh.get_group(name), dim)
    return logits

"""The port's twins of the repository's ``__graft_entry__.entry()`` and
``dryrun_multichip``.

``entry()`` returns ``(fn, (params, tokens))``: one forward step of the
flagship-style GQA transformer at ``entry()``'s shapes there (vocab 8192,
d_model 512, 4 layers, 8 query / 4 KV heads, head_dim 64, d_ff 1536, bf16,
batch 2 × 512 tokens), its attention the causal flash forward kernel.
Weights come from ``torch.Generator().manual_seed(0)`` and tokens from
``numpy.random.default_rng(1)``; neither matches ``jax.random``.

``dryrun_multichip(n)`` starts n ranks and runs one sharded train step,
the MoE layer and the pipeline on them (:func:`dryrun_multichip`); from
the shell, ``python -m metal_flash_attention_plus_tpu_torch.entry dryrun
N`` (with ``--device cpu``: the plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    trainable_parameters,
)

ENTRY_CONFIG = TransformerConfig(
    vocab_size=8192,
    d_model=512,
    num_layers=4,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1536,
    max_seq=1024,
    dtype=torch.bfloat16,
)


def entry(device: DeviceLike = None):
    """Return (fn, example_args): ``fn(params, tokens)`` → logits
    [2, 512, 8192] fp32, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cfg = ENTRY_CONFIG
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 512))
    ).to(dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


# The JAX dry run's model (``__graft_entry__.dryrun_multichip``).
DRYRUN_CONFIG = TransformerConfig(
    vocab_size=256,
    d_model=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=256,
    max_seq=512,
    dtype=torch.float32,
)


def _factor_mesh(n: int, max_tp: int):
    """Split n into (data, model, context) with model ≤ max_tp and every
    factor a divisor of n (powers of two preferred)."""

    def largest_pow2_divisor(x, cap):
        f = 1
        while f * 2 <= cap and x % (f * 2) == 0:
            f *= 2
        return f

    model = largest_pow2_divisor(n, max_tp)
    rest = n // model
    context = largest_pow2_divisor(rest, 2)
    data = rest // context
    return data, model, context


def _dryrun_rank(rank: int, world: int, tmp: str, device_type: str):
    """One rank of :func:`dryrun_multichip` (a process of ``mp.spawn``):
    gloo over a FileStore in ``tmp``; rank 0 writes the three lines to
    ``tmp/lines.txt``."""
    from metal_flash_attention_plus_tpu_torch.parallel import (
        broadcast_from_last_stage,
        init_moe_params,
        make_mesh,
        moe_ffn,
        pipeline_apply,
    )
    from metal_flash_attention_plus_tpu_torch.parallel.spmd import (
        ShardingConfig,
        make_spmd_train_step,
        shard_params,
    )

    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
    dev = torch.device(device_type)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), world_size=world, rank=rank)
    try:
        lines = []
        cfg = DRYRUN_CONFIG
        data, model, context = _factor_mesh(world, max_tp=cfg.num_kv_heads)
        mesh = make_mesh(data, model, context, device_type=device_type)
        sc = ShardingConfig(attn_mode="ring" if context > 1 else "local")
        params = shard_params(init_params(
            cfg, torch.Generator().manual_seed(0), device=dev), mesh, cfg, sc)
        # optax.adamw(1e-3)'s defaults (torch's own decay is 1e-2).
        optimizer = torch.optim.AdamW(trainable_parameters(params), lr=1e-3,
                                      weight_decay=1e-4)
        seq, batch = 128 * context, max(2, data)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (batch, seq + 1))).to(dev)
        step = make_spmd_train_step(cfg, mesh, optimizer, sc)
        params, _, loss = step(params, optimizer.state, tokens)
        loss_val = loss.item()
        if not np.isfinite(loss_val):
            raise RuntimeError(f"non-finite loss {loss_val}")
        lines.append(f"dryrun_multichip OK: mesh(data={data}, model={model}"
                     f", context={context}), loss={loss_val:.4f}")

        # EP and PP over the whole world, as the JAX dry run's 1-axis
        # meshes: 2 experts a rank, 64 tokens split over the ranks; 4
        # microbatches through one tanh stage a rank.
        ep = world
        moe_params = init_moe_params(torch.Generator().manual_seed(2), 64,
                                     128, ep * 2, device=dev)
        local = {k: v if k == "router" else v[rank * 2:(rank + 1) * 2]
                 for k, v in moe_params.items()}
        xtok = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (64, 64), np.float32)).to(dev)
        n_tok = 64 // ep
        moe_out = moe_ffn(local, xtok[rank * n_tok:(rank + 1) * n_tok],
                          capacity_factor=4.0)
        if not bool(torch.isfinite(moe_out).all()):
            raise RuntimeError("non-finite MoE output")
        lines.append(f"dryrun EP OK: {ep} experts-axis devices, out "
                     f"{(64, moe_out.shape[1])}")

        g = np.random.default_rng(4)
        ws = torch.from_numpy(g.standard_normal((ep, 32, 32), np.float32)
                              * 0.1).to(dev)
        micro = torch.from_numpy(g.standard_normal((4, 8, 32), np.float32)
                                 ).to(dev)
        pipe_out = broadcast_from_last_stage(pipeline_apply(
            lambda w, x: torch.tanh(x @ w), ws[rank], micro))
        if not bool(torch.isfinite(pipe_out).all()):
            raise RuntimeError("non-finite pipeline output")
        lines.append(f"dryrun PP OK: {ep} pipeline stages, out "
                     f"{tuple(pipe_out.shape)}")
        if rank == 0:
            with open(os.path.join(tmp, "lines.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Start ``n_devices`` ranks (``torch.multiprocessing`` spawn, gloo
    over a FileStore in a temporary directory) and run on them one
    sharded train step of the JAX dry run's model (AdamW; ring attention
    when the context axis is larger than 1), the MoE layer and the
    pipeline; print the JAX dry run's three ``OK`` lines.

    On the card (``device=None``) every rank runs on ``cuda:0``, and the
    kernels are built here, before the ranks start; ``device="cpu"`` runs
    the plain versions.  A rank's exception is raised here."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from metal_flash_attention_plus_tpu_torch import _build

        _build.load_library("kernels")
    with tempfile.TemporaryDirectory(prefix="mfa-dryrun-") as tmp:
        mp.spawn(_dryrun_rank, args=(n_devices, tmp, dev.type),
                 nprocs=n_devices, join=True)
        with open(os.path.join(tmp, "lines.txt")) as f:
            print(f.read(), end="", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m metal_flash_attention_plus_tpu_torch.entry")
    sub = ap.add_subparsers(dest="command", required=True)
    dry = sub.add_parser("dryrun", help=dryrun_multichip.__doc__.split(
        "\n\n")[0])
    dry.add_argument("n_devices", type=int)
    dry.add_argument("--device", default=None,
                     help="cpu: run the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

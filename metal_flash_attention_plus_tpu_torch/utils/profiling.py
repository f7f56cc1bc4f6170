"""Where the serving engine's, the train step's, the fully quantized
forward's or the quantized fwd+bwd's time goes on the card.

    python -m metal_flash_attention_plus_tpu_torch.utils.profiling [--seed N]
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --quantized 8
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --mla \
        [--quantized 8]
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --train
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --quantized-attention packed
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --quantized-backward fullint

Serving (the default): serves the traffic of ``chip_smoke.py``'s engine
phase (:func:`smoke_requests` on the flagship model with random weights
from the seed, engine defaults) twice: once to warm up, once under
``torch.profiler`` with CPU and CUDA activities.

``--quantized 8`` / ``--quantized 4``: the same traffic with W8A8 weights
over an int8 page pool, or W4A8 weights (4-bit ROW symmetric) over an int4
pool, as in ``chip_smoke.py``'s quantized engine phase.

``--mla``: the same traffic on ``MLAConfig()`` (random weights from the
seed) through ``mla_executor()``, over a float latent pool or, with
``--quantized 8``, W8A8 weights (``quantize_mla_weights``) over an int8
one, as in ``chip_smoke.py`` phase 12 (g).

``--train``: the train step of ``chip_smoke.py``'s training phase (the
bf16 flagship, Adam at lr 3e-3, one seeded batch of 4 × 2049 tokens): two
steps to warm up, then the wall time of 3 unprofiled steps, then 3 steps
under the profiler.

``--quantized-attention packed`` / ``unpacked``: ``quantized_forward(...,
quantize_kv=True)`` of W8A8 weights on 2 × 2048 seeded tokens, as in
``chip_smoke.py`` phase 10 (d), in the packed head-pair layout or with
int8-Q scores: one call to warm up, the wall time of 3 unprofiled calls,
then 3 calls under the profiler.

``--quantized-backward fullint`` / ``exact``: one fwd+bwd of the JAX
package's north-star arm (bench.py: B=4, H=4, S=4096, D=256, FULL, bf16 Q,
int8 ROW / CHANNEL SYMMETRIC K / V, ``quantize_q=True``), the gradient of
sum(O·dO) with respect to q and the K/V scales, with the full-integer or
the exact backward, as in ``chip_smoke.py`` phase 11 (b): one call to warm
up, the wall time of 3 unprofiled calls, then 3 calls under the profiler.

Prints JSON lines: the phase times and counts, the device's busy time
(sum of kernel times) and idle share of the profiled wall time, and the
kernels ranked by device time.  The profiler itself slows the host, so
the idle share it reads is an upper bound.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from metal_flash_attention_plus_tpu_torch.models.mla_transformer import (
    MLAConfig,
    init_mla_params,
)
from metal_flash_attention_plus_tpu_torch.models.quantized_inference import (
    quantize_mla_weights,
    quantize_weights,
    quantized_forward,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    make_train_step,
    trainable_parameters,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    quantized_flash_attention,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import quantize
from metal_flash_attention_plus_tpu_torch.serving.engine import (
    GenerationRequest,
    ServingEngine,
    mla_executor,
)


def smoke_requests(cfg, seed: int):
    """8 requests, seeded prompts of 100-1800 tokens, 32 new tokens each."""
    rng = np.random.default_rng(seed)
    return [
        GenerationRequest(
            rid, rng.integers(0, cfg.vocab_size, int(n)).tolist(),
            max_new_tokens=32,
        )
        for rid, n in enumerate(rng.integers(100, 1801, 8))
    ]


# The JAX package's north-star arm (bench.py run_fwd_bwd_config, the arm
# fwd_bwd_d256_int8_full): B=4, H=4, S=4096, D=256, FULL, bf16 Q and dO,
# int8 ROW SYMMETRIC K, int8 CHANNEL SYMMETRIC V, bench.py's block sizes.
NORTH_STAR_SHAPE = (4, 4, 4096, 256)
NORTH_STAR_BLOCKS = BlockSizes(
    block_q=512, block_kv=512, block_kv_major=2048, block_q_dq=1024,
    block_kv_dq=512, block_kv_dq_major=2048, block_q_dkv=1024,
    block_kv_dkv=512, block_q_dkv_major=2048)


def north_star_inputs(generator: torch.Generator):
    """bench.py's inputs drawn from ``generator`` on its device: bf16 Q and
    dO, K and V quantized int8 ROW / CHANNEL SYMMETRIC from fp32."""
    q, k, v, do = (torch.randn(NORTH_STAR_SHAPE, generator=generator,
                               device=generator.device) for _ in range(4))
    sym = QuantStrategy.SYMMETRIC
    return (q.to(torch.bfloat16),
            quantize(k, QuantConfig(bits=8, granularity=QuantGranularity.ROW,
                                    strategy=sym)),
            quantize(v, QuantConfig(bits=8,
                                    granularity=QuantGranularity.CHANNEL,
                                    strategy=sym)),
            do.to(torch.bfloat16))


def north_star_grads(q, kq, vq, do, fullint: bool):
    """bench.py's loss, sum(O·dO) through ``quantized_flash_attention(...,
    quantize_q=True, bwd_fullint=fullint)``, differentiated with respect to
    (q, K scales, V scales), the scales given by ``dataclasses.replace``."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (q, kq.scale, vq.scale)]
    o = quantized_flash_attention(
        leaves[0], dataclasses.replace(kq, scale=leaves[1]),
        dataclasses.replace(vq, scale=leaves[2]),
        block_sizes=NORTH_STAR_BLOCKS, quantize_q=True, bwd_fullint=fullint)
    return torch.autograd.grad((o.float() * do.float()).sum(), leaves)


def serve_once(cfg, params, seed: int, quantized_cache=False,
               executor=None) -> ServingEngine:
    """One engine with default settings serving the smoke traffic."""
    engine = ServingEngine(params, cfg, quantized_cache=quantized_cache,
                           executor=executor)
    for req in smoke_requests(cfg, seed):
        engine.submit(req)
    engine.run()
    torch.cuda.synchronize()
    return engine


def kernel_table(prof, top: int = 15):
    """(total device µs, kernel launches, [(name, µs, count)] ranked)."""
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            by_name[evt.key][0] += evt.self_device_time_total
            by_name[evt.key][1] += evt.count
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    return total, launches, [(k[:90], v[0], v[1]) for k, v in ranked[:top]]


def print_profile(prof, wall_s: float, calls: int, what: str) -> int:
    """The busy/idle line and the ranked kernels; 1 if no device time."""
    busy_us, launches, ranked = kernel_table(prof)
    if not busy_us:
        print("profiling: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches": launches,
        f"launches_per_{what}": launches / calls,
    }))
    for name, us, count in ranked:
        print(json.dumps({"kernel": name, "device_ms": us / 1e3,
                          "count": count, "share": us / busy_us}))
    return 0


def profile_serving(cfg, params, seed: int, quantized=None,
                    mla: bool = False) -> int:
    """``quantized`` 8 or 4: W8A8 / W4A8 weights over an int8 / int4
    pool.  ``mla``: an :class:`MLAConfig` model through ``mla_executor()``
    (``quantized`` 8 only: ``quantize_mla_weights``, an int8 latent
    pool)."""
    if quantized and mla:
        params = quantize_mla_weights(params)
    elif quantized:
        params = quantize_weights(params, QuantConfig(
            bits=quantized, granularity=QuantGranularity.ROW))
    pool = quantized or False
    executor = mla_executor() if mla else None
    serve_once(cfg, params, seed, pool, executor)  # warm-up: builds, plans
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine = serve_once(cfg, params, seed, pool, executor)
        wall_s = time.perf_counter() - t0
    stats = engine.stats
    print(json.dumps({"device": torch.cuda.get_device_name(0), "mla": mla,
                      "quantized": quantized, "engine_stats": stats,
                      "profiled_wall_s": wall_s}))
    return print_profile(prof, wall_s,
                         stats["prefill_calls"] + stats["decode_calls"],
                         "model_call")


def profile_train(cfg, params, seed: int, steps: int = 3) -> int:
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 2049))).cuda()
    optimizer = torch.optim.Adam(trainable_parameters(params), lr=3e-3)
    step = make_train_step(cfg, optimizer)

    def run(n):
        nonlocal params
        t0 = time.perf_counter()
        for _ in range(n):
            params, _, loss = step(params, optimizer.state, tokens)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss.item()

    run(2)  # warm-up: kernel build, cuBLAS plans, optimizer state
    wall_s, loss = run(steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_s, _ = run(steps)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": steps,
        "tokens_per_step": 4 * 2048, "step_s": wall_s / steps,
        "tokens_per_s": steps * 4 * 2048 / wall_s, "loss": loss,
        "profiled_step_s": prof_wall_s / steps,
    }))
    return print_profile(prof, prof_wall_s, steps, "step")


def profile_quantized_attention(cfg, params, seed: int, layout: str,
                                calls: int = 3) -> int:
    qparams = quantize_weights(params)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 2048))).cuda()
    packed = None if layout == "packed" else False

    def run(n):
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(n):
                quantized_forward(qparams, tokens, cfg, quantize_kv=True,
                                  packed_d64=packed)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1)  # warm-up: kernel build, cuBLAS plans
    wall_s = run(calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_s = run(calls)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "layout": layout,
        "calls": calls, "tokens_per_call": tokens.numel(),
        "call_s": wall_s / calls, "tokens_per_s": calls * tokens.numel()
        / wall_s, "profiled_call_s": prof_wall_s / calls,
    }))
    return print_profile(prof, prof_wall_s, calls, "call")


def profile_quantized_backward(seed: int, arm: str, calls: int = 3) -> int:
    q, kq, vq, do = north_star_inputs(
        torch.Generator(device="cuda").manual_seed(seed))

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            north_star_grads(q, kq, vq, do, arm == "fullint")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1)  # warm-up: kernel build
    wall_s = run(calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_s = run(calls)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arm": arm,
        "shape": list(NORTH_STAR_SHAPE), "calls": calls,
        "fwd_bwd_s": wall_s / calls,
        "profiled_fwd_bwd_s": prof_wall_s / calls,
    }))
    return print_profile(prof, prof_wall_s, calls, "fwd_bwd")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the engine")
    ap.add_argument("--quantized", type=int, choices=(8, 4),
                    help="serve W8A8 weights over an int8 pool (8) or W4A8 "
                    "weights over an int4 pool (4)")
    ap.add_argument("--mla", action="store_true",
                    help="serve MLAConfig() through mla_executor() (with "
                    "--quantized 8: W8A8 weights over an int8 latent pool)")
    ap.add_argument("--quantized-attention", choices=("packed", "unpacked"),
                    help="profile quantized_forward(quantize_kv=True)")
    ap.add_argument("--quantized-backward", choices=("fullint", "exact"),
                    help="profile the north-star quantized fwd+bwd with the "
                    "full-integer or the exact backward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiling: no CUDA device is available", file=sys.stderr)
        return 2
    if args.quantized_backward:
        return profile_quantized_backward(args.seed, args.quantized_backward)
    if args.mla:
        if args.quantized == 4:
            ap.error("MLA latent pools are float or int8")
        cfg = MLAConfig()
        params = init_mla_params(cfg, torch.Generator().manual_seed(args.seed))
        return profile_serving(cfg, params, args.seed, args.quantized,
                               mla=True)
    cfg = TransformerConfig()
    params = init_params(cfg, torch.Generator().manual_seed(args.seed))
    if args.train:
        return profile_train(cfg, params, args.seed)
    if args.quantized_attention:
        return profile_quantized_attention(cfg, params, args.seed,
                                           args.quantized_attention)
    return profile_serving(cfg, params, args.seed, args.quantized)


if __name__ == "__main__":
    sys.exit(main())

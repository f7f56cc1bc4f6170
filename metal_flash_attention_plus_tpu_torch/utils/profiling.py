"""Where the serving engine's, the train step's, the fully quantized
forward's, the quantized fwd+bwd's or the GEMM engine's time goes on the
card.

    python -m metal_flash_attention_plus_tpu_torch.utils.profiling [--seed N]
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --quantized 8
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --mla \
        [--quantized 8]
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --train
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --quantized-attention packed
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --quantized-backward fullint
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --gemm
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --wo-tiles
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --determinism [STEPS]

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

``--gemm``: the GEMM engine at ``benchmarks/gemm_bench.py``'s shapes (M =
128 and 4096, N = K = 8192; :data:`GEMM_SHAPES`) in its arms and the
folded weight-only, quantized-A and small-block ones (:data:`GEMM_ARMS`,
operands from :func:`gemm_arm`, which ``chip_smoke.py`` phase 13 reuses):
each arm's time by CUDA events over 5 calls after one to warm up, with its
TFLOP/s and weight GB/s as gemm_bench reports them, then one call of every
arm under the profiler.

``--wo-tiles``: the weight-only kernels (bf16 A and out; int8 ROW folded,
int8 BLOCK 256 and int4 BLOCK 256 dequant-on-load) at MLA's decompression
and gemm_bench's shapes (:data:`WO_TILE_SHAPES`) over tile plans (rows of
the tile, K splits: :data:`WO_TILE_PLANS`), each forced in place of
``ops.quantized_gemm.wo_tile``'s choice, which the output marks: each
plan's time by CUDA events over 20 calls after 3 to warm up, and its
kernels' device time over 20 more under the profiler (the events' time
includes the host's launch where it is the longer).

``--determinism [STEPS]``: the train step of ``--train`` run twice from
one seeded initial state for STEPS steps (default 8) in turn, the two
copies compared bit for bit after every step (:func:`train_twice`: the
parameters and their gradients that differ), then one step under PyTorch's
deterministic-algorithm check in its warning mode
(:func:`nondeterministic_ops`: the operations it flags, and the loss with
the allocator's new memory filled with NaN).  Ends with a digest of the
parameters after a third run of STEPS steps, so that two processes can be
compared.

Prints JSON lines: the phase times and counts, the device's busy time
(sum of kernel times) and idle share of the profiled wall time, and the
kernels ranked by device time.  The profiler itself slows the host, so
the idle share it reads is an upper bound.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Tuple

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
from metal_flash_attention_plus_tpu_torch.ops.gemm import matmul
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    quantized_flash_attention,
)
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    dynamic_quantized_matmul,
    wo_arguments,
    wo_call,
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


# benchmarks/gemm_bench.py's shapes (M, N, K): decode-like and prefill-like.
GEMM_SHAPES = ((128, 8192, 8192), (4096, 8192, 8192))
# gemm_bench's arms (weight-only int8 / int4 BLOCK 256, dynamic W8A8 /
# W4A8, compensated int8 BLOCK 512) and the other four kernels' arms of
# the GEMM engine's quantized operands: the folded weight-only GEMM (int8
# ROW SYMMETRIC weights), the folded quantized A (int8 ROW SYMMETRIC), the
# dequantizing one (int8 ROW ASYMMETRIC) and small compensated blocks
# (int8 BLOCK 64 CENTERED).
GEMM_ARMS = ("weight_only_int8", "weight_only_int4", "dynamic_w8a8",
             "dynamic_w4a8", "compensated_int8", "weight_only_folded_int8_row",
             "qa_folded_int8_row", "qa_int8_row_asymmetric",
             "compensated_small_int8_b64")


def gemm_arm(arm: str, m: int, n: int, k: int, generator: torch.Generator):
    """(entry point, operands) of one GEMM arm, drawn from ``generator`` on
    its device as gemm_bench draws them: a bf16 A [M, K] and an fp32
    weight [N, K] (Bᵀ), quantized as the arm says; quantized-A arms take A
    quantized from fp32 and B = the weight transposed, in bf16."""
    dev = generator.device
    a = torch.randn((m, k), generator=generator, device=dev).to(
        torch.bfloat16)
    w = torch.randn((n, k), generator=generator, device=dev)
    block, row = QuantGranularity.BLOCK, QuantGranularity.ROW
    if arm.startswith("weight_only_int"):
        return matmul, (a, quantize(w, QuantConfig(
            bits=int(arm[-1]), granularity=block, block_size=256)))
    if arm == "weight_only_folded_int8_row":
        return matmul, (a, quantize(w, QuantConfig(bits=8, granularity=row)))
    if arm.startswith("dynamic_w"):
        return dynamic_quantized_matmul, (a, quantize(w, QuantConfig(
            bits=int(arm[len("dynamic_w")]), granularity=row)))
    if arm.startswith("compensated"):
        cfg = (QuantConfig(bits=8, granularity=block, block_size=512)
               if arm == "compensated_int8" else QuantConfig(
                   bits=8, granularity=block, block_size=64,
                   strategy=QuantStrategy.CENTERED))
        return matmul, (quantize(a.float(), cfg), quantize(w, cfg))
    if arm.startswith("qa_"):
        strategy = (QuantStrategy.ASYMMETRIC if arm.endswith("asymmetric")
                    else QuantStrategy.SYMMETRIC)
        aq = quantize(a.float(), QuantConfig(bits=8, granularity=row,
                                             strategy=strategy))
        return matmul, (aq, w.t().contiguous().to(torch.bfloat16))
    raise ValueError(f"unknown GEMM arm {arm!r}")


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


def named_parameters(params) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, in :func:`trainable_parameters`' order
    (which marks them as requiring grad)."""
    names = ["embed"]
    for i, layer in enumerate(params["layers"]):
        names += [f"layers.{i}.{k}" for k in sorted(layer)]
    names += ["ln_f", "unembed"]
    return list(zip(names, trainable_parameters(params)))


def clone_params(params):
    """A detached copy of a parameter tree."""
    return {"embed": params["embed"].detach().clone(),
            "layers": [{k: v.detach().clone() for k, v in layer.items()}
                       for layer in params["layers"]],
            "ln_f": params["ln_f"].detach().clone(),
            "unembed": params["unembed"].detach().clone()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers: equal exactly when bitwise
    equal (``-0.0 != 0.0``, a NaN equals itself)."""
    return t.detach().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _differ(a: torch.Tensor, b: torch.Tensor) -> bool:
    return not torch.equal(_bits(a), _bits(b))


def train_twice(cfg, params, tokens, steps: int, lr: float = 3e-3):
    """Train two copies of ``params`` (left as they are) from one state,
    one after the other, with ``make_train_step`` and Adam at ``lr`` on
    ``tokens`` for ``steps`` steps, and compare the copies bit for bit
    after every step.  → (per step: both losses, and the names of the
    parameters and of the gradients that differ, empty when the step is
    deterministic; the second copy's final parameters).  Holds the first
    copy's parameters and gradients of every step."""
    first, out = [], []
    for run in range(2):
        p = clone_params(params)
        named = named_parameters(p)
        optimizer = torch.optim.Adam([t for _, t in named], lr=lr)
        step = make_train_step(cfg, optimizer)
        for i in range(steps):
            p, _, loss = step(p, optimizer.state, tokens)
            snap = [(t.detach().clone(), t.grad.detach().clone())
                    for _, t in named]
            if run == 0:
                first.append((loss.item(), snap))
                continue
            loss0, snap0 = first[i]
            out.append({
                "step": i + 1, "losses": [loss0, loss.item()],
                "params_differ": [n for (n, _), (a, _), (b, _) in zip(
                    named, snap0, snap) if _differ(a, b)],
                "grads_differ": [n for (n, _), (_, a), (_, b) in zip(
                    named, snap0, snap) if _differ(a, b)],
            })
            first[i] = None
    return out, p


def nondeterministic_ops(cfg, params, tokens, lr: float = 3e-3):
    """One train step on a copy of ``params`` under PyTorch's
    deterministic-algorithm check in its warning mode, restored after.
    → (the distinct messages it gave: the operations PyTorch documents as
    nondeterministic that the step ran, the loss).  In that mode the
    allocator's new memory is filled with NaN, so a finite loss also says
    that no kernel of the step read memory it had not written."""
    p = clone_params(params)
    optimizer = torch.optim.Adam([t for _, t in named_parameters(p)], lr=lr)
    step = make_train_step(cfg, optimizer)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _, _, loss = step(p, optimizer.state, tokens)
            loss = loss.item()
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    return sorted({str(w.message).splitlines()[0] for w in caught}), loss


def params_digest(params) -> str:
    """sha256 of every parameter's bytes, in :func:`named_parameters`'
    order."""
    h = hashlib.sha256()
    for _, t in named_parameters(params):
        h.update(_bits(t).cpu().numpy().tobytes())
    return h.hexdigest()


def train_tokens(cfg, seed: int, device) -> torch.Tensor:
    """The train phase's batch: 4 × 2049 seeded tokens."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 2049))).to(device)


def profile_determinism(cfg, params, seed: int, steps: int) -> int:
    tokens = train_tokens(cfg, seed, "cuda")
    rows, _ = train_twice(cfg, params, tokens, steps)
    for row in rows:
        print(json.dumps(row))
    ops, loss = nondeterministic_ops(cfg, params, tokens)
    print(json.dumps({"flagged_by_deterministic_mode": ops,
                      "loss_with_nan_filled_new_memory": loss}))
    optimizer = torch.optim.Adam(trainable_parameters(params), lr=3e-3)
    step = make_train_step(cfg, optimizer)
    for _ in range(steps):
        params, _, loss = step(params, optimizer.state, tokens)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "steps": steps, "final_loss": loss.item(),
                      "final_params_sha256": params_digest(params)}))
    return 0


def profile_train(cfg, params, seed: int, steps: int = 3) -> int:
    tokens = train_tokens(cfg, seed, "cuda")
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


def cuda_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_gemm(seed: int, iters: int = 5) -> int:
    g = torch.Generator(device="cuda").manual_seed(seed)
    calls = []
    for m, n, k in GEMM_SHAPES:
        for arm in GEMM_ARMS:
            fn, args = gemm_arm(arm, m, n, k, g)
            run = (lambda fn=fn, args=args: fn(*args))
            run()  # warm-up: kernel build
            ms = cuda_ms(run, iters)
            weight = args[1] if arm.startswith(("weight", "dynamic", "comp")) \
                else args[0]
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "arm": arm,
                "m": m, "n": n, "k": k, "ms": ms,
                "tflops": 2.0 * m * n * k / ms / 1e9,
                "quantized_operand_gbs": weight.nbytes_payload / ms / 1e6,
            }))
            calls.append(run)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for run in calls:
            run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return print_profile(prof, wall_s, len(calls), "gemm_call")


# MLA's decompression (M = B·S = 4096, N = H·dh = 1024, K = d_c = 256) and
# gemm_bench's shapes; the weight-only tile plans (tile rows, K splits)
# timed there (K splits only where the 128-row tiles leave SMs idle).
WO_TILE_SHAPES = ((4096, 1024, 256),) + GEMM_SHAPES
WO_TILE_PLANS = ((64, 1), (128, 1), (64, 2), (64, 4), (128, 2), (128, 4),
                 (128, 8))


def profile_wo_tiles(seed: int, iters: int = 20) -> int:
    g = torch.Generator(device="cuda").manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = quantized_gemm.wo_tile
    block = QuantGranularity.BLOCK
    arms = {"folded_int8_row": QuantConfig(bits=8,
                                           granularity=QuantGranularity.ROW),
            "int8_block256": QuantConfig(bits=8, granularity=block,
                                         block_size=256),
            "int4_block256": QuantConfig(bits=4, granularity=block,
                                         block_size=256)}
    for m, n, k in WO_TILE_SHAPES:
        a = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn((n, k), generator=g, device="cuda")
        for arm, cfg in arms.items():
            folded, args, kw = wo_arguments(a, quantize(w, cfg))
            for plan in WO_TILE_PLANS:
                if plan[1] > 1 and -(-m // 128) * -(-n // 128) >= sms:
                    continue
                quantized_gemm.wo_tile = lambda *_, plan=plan: plan
                try:
                    run = (lambda: wo_call(folded, args, kw, torch.bfloat16))
                    for _ in range(3):
                        run()
                    ms = cuda_ms(run, iters)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(iters):
                            run()
                        torch.cuda.synchronize()
                finally:
                    quantized_gemm.wo_tile = chosen
                print(json.dumps({
                    "device": torch.cuda.get_device_name(0), "arm": arm,
                    "m": m, "n": n, "k": k, "tile_rows": plan[0],
                    "k_splits": plan[1], "ms": ms,
                    "device_ms": kernel_table(prof)[0] / 1e3 / iters,
                    "chosen": plan == chosen(m, n, k, sms)}))
    return 0


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
    ap.add_argument("--gemm", action="store_true",
                    help="profile the GEMM engine at gemm_bench's shapes")
    ap.add_argument("--wo-tiles", action="store_true",
                    help="time the weight-only kernels over tile plans")
    ap.add_argument("--determinism", type=int, nargs="?", const=8,
                    metavar="STEPS",
                    help="train twice from one state and compare bit for "
                    "bit after each of STEPS steps (default 8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiling: no CUDA device is available", file=sys.stderr)
        return 2
    if args.gemm:
        return profile_gemm(args.seed)
    if args.wo_tiles:
        return profile_wo_tiles(args.seed)
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
    if args.determinism:
        return profile_determinism(cfg, params, args.seed, args.determinism)
    if args.train:
        return profile_train(cfg, params, args.seed)
    if args.quantized_attention:
        return profile_quantized_attention(cfg, params, args.seed,
                                           args.quantized_attention)
    return profile_serving(cfg, params, args.seed, args.quantized)


if __name__ == "__main__":
    sys.exit(main())

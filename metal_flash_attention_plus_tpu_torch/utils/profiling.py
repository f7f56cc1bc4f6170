"""Where the serving engine's, the train step's, the fully quantized
forward's, the quantized fwd+bwd's or the GEMM engine's time goes on the
card.

    python -m metal_flash_attention_plus_tpu_torch.utils.profiling [--seed N]
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --quantized 8
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --mla \
        [--v2-lite] [--quantized 8]
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --train
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --mla \
        [--v2-lite] --train
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --quantized-attention packed
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --quantized-backward fullint
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --gemm
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --wo-tiles
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling --dyn-tiles
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --decode-splits
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --dkv-splits
    python -m metal_flash_attention_plus_tpu_torch.utils.profiling \
        --fwd-splits
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
one, as in ``chip_smoke.py`` phase 12 (g).  ``--mla --v2-lite``: the same
on :data:`DEEPSEEK_V2_LITE` (DeepSeek-V2-Lite's widths: the paged kernels
at D = 576; random weights drawn on the card from the seed), as in
``chip_smoke.py`` phase 20 (c).

``--train``: the train step of ``chip_smoke.py``'s training phase (the
bf16 flagship, Adam at lr 3e-3, one seeded batch of 4 × 2049 tokens): two
steps to warm up, then the wall time of 3 unprofiled steps, then 3 steps
under the profiler.  ``--mla --train``: the same for ``MLAConfig()``'s
``mla_loss_fn`` (``make_train_step(..., loss=mla_loss_fn)``) on the
batch's first 2 × 2049 tokens, as ``chip_smoke.py`` phase 15 trains it;
``--mla --v2-lite --train`` for :data:`DEEPSEEK_V2_LITE` (the flash
kernels at D = 576), as ``chip_smoke.py`` phase 21 (c) trains it.

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

``--dyn-tiles``: the s8 tile's kernels over tile plans (rows of the tile,
K splits: :data:`DYN_TILE_PLANS`), each forced in place of
``ops.quantized_gemm.dyn_tile``'s or ``comp_small_tile``'s choice, which
the output marks: the dynamic GEMM (W8A8, int8 ROW weights) at the
flagship's projection and unembedding shapes for decode (M = 8), a
prefill chunk (M = 256) and the fully quantized forward (M = 4096); the
small-block compensated GEMM (BLOCK 64 CENTERED) at gemm_bench's shapes.
Timed as ``--wo-tiles`` times its plans.

``--decode-splits``: the paged decode (bf16 q) at ``chip_smoke.py``'s
phase 8 geometry (the 8 smoke prompts' lengths + 16, 256-token pages, 16
pages a table) with a float pool at D = 64 and 128, an int8 pool at
D = 64, and MLA's one-state latent pages (Hq = 16 over Hkv = 1, D = 288,
``v_tail_zero`` 32; DeepSeek's D = 576, ``v_tail_zero`` 64), over split
counts (:data:`DECODE_SPLIT_PLANS`), each
forced in place of ``serving.paged_attention.decode_splits``' choice,
which the output marks: the time by CUDA events over 50 calls after 3 to
warm up, and the device time of the split kernel and of the merge over 50
more under the profiler.

``--dkv-splits``: the flash dK/dV (bf16, causal) at MLA's training shape
(B = 2, Hq = 16 over Hkv = 1, S = 2048, D = 288: the wide body; and D =
576, DeepSeek-V2-Lite's: the latent body) over split counts of the GQA
group (:data:`DKV_SPLIT_PLANS`), each forced in place of
``ops.flash_attention_bwd.dkv_splits``' choice, which the output marks:
the time by CUDA events over 20 calls after 3 to warm up, and the device
time of the split kernel and of the merge over 20 more under the
profiler.

``--fwd-splits``: first the occupancy API's CTAs an SM for every
instance of the split-D forwards (``split_d_fwd_kernel``,
``split_d_qattn_kernel``), then both at Perceiver IO's image
cross-attention (:data:`PERCEIVER_IO`; the bf16 flash forward, and the
quantized one over int8 ROW CENTERED K/V) over run counts of the KV axis
(:data:`FWD_SPLIT_PLANS`), each forced in place of
``ops.flash_attention.split_d_fwd_splits``' choice, which the output
marks: the time by CUDA events over 5 calls after one to warm up, and
the device time of the split kernel and of the merge over 5 more under
the profiler.

``--rtq-clusters``: the runtime block quantizer on a [4096, 1024] bf16
activation, CENTERED with Σq, at bs 64 and 128, over cluster sizes
(:data:`RTQ_CLUSTER_PLANS`), each forced in place of
``ops.runtime_quantization.block_cluster``'s choice, which the output
marks, and held bit for bit to the plain version over the same cluster
(whose summation order it sets): the time by CUDA events over 50 calls
after 3 to warm up, the device time over 50 more under the profiler, and
how many such clusters the card holds at once (``mfa_rtq_max_clusters``).

``--determinism [STEPS]``: the train step of ``--train`` run twice from
one seeded initial state for STEPS steps (default 8) in turn, the two
copies compared bit for bit after every step (:func:`train_twice`: the
parameters and their gradients that differ), then one step under PyTorch's
deterministic-algorithm check in its warning mode
(:func:`nondeterministic_ops`: the operations it flags, and the loss with
the allocator's new memory filled with NaN).  Ends with a digest of the
parameters after a third run of STEPS steps, so that two processes can be
compared.

The module also holds the JAX package's timing helpers, which the tuner
and ``QuantizedAttention.benchmark`` call: :func:`measure` (the least of
fenced trains: CUDA events on the card, the host clock on the CPU),
:func:`measure_chained` (dependent calls back to back), :func:`tflops`,
:func:`measure_held` (CUDA events around a train that a spin kernel holds
back until the host has enqueued it) and :func:`measure_device` (the
profiler's kernel time a call, else :func:`measure_held`'s).

Prints JSON lines: the phase times and counts, the device's busy time
(sum of kernel times) and idle share of the profiled wall time, and the
kernels ranked by device time.  The profiler itself slows the host, so
the idle share it reads is an upper bound.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
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

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.models.mla_transformer import (
    MLAConfig,
    init_mla_params,
    mla_loss_fn,
)
from metal_flash_attention_plus_tpu_torch.models.quantized_inference import (
    quantize_mla_weights,
    quantize_weights,
    quantized_forward,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    loss_fn,
    make_train_step,
    trainable_parameters,
)
from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL, FULL
from metal_flash_attention_plus_tpu_torch.ops import flash_attention_bwd
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_fwd,
    row_ranges_tensor,
)
from metal_flash_attention_plus_tpu_torch.ops.gemm import matmul
from metal_flash_attention_plus_tpu_torch.ops import quantized_attention
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    quantized_flash_attention,
)
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm
from metal_flash_attention_plus_tpu_torch.ops import runtime_quantization
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
from metal_flash_attention_plus_tpu_torch.serving import paged_attention


# DeepSeek-V2-Lite at full width, from
# https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json:
# no q_lora_rank, so MLAConfig's fields express its attention exactly (16
# heads of 128, kv_lora_rank 512 + qk_rope_head_dim 64 = the paged
# kernels' D = 576); its 26 MoE layers as dense SwiGLU at the dense first
# layer's intermediate_size, no YaRN RoPE scaling (MLAConfig has neither).
# chip_smoke.py phase 20 serves the same configuration, phase 21 trains it.
DEEPSEEK_V2_LITE = MLAConfig(
    vocab_size=102400, d_model=2048, num_layers=27, num_heads=16,
    head_dim=128, latent_dim=512, rope_dim=64, d_ff=10944,
    rope_theta=10000.0, max_seq=4096)


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
    """(total device µs, kernel launches, [(name, µs, count)] ranked).
    A region that the host annotates (``Optimizer.step#Adam.step``) also
    shows on the device's timeline, over kernels that are counted on their
    own, so it is left out."""
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA and evt.self_device_time_total
                and not getattr(evt, "is_user_annotation", False)):
            by_name[evt.key][0] += evt.self_device_time_total
            by_name[evt.key][1] += evt.count
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    return total, launches, [(k[:90], v[0], v[1]) for k, v in ranked[:top]]


def _leaf(out) -> torch.Tensor:
    """The first tensor of a call's result (a tensor, or a tuple of them)."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _run_train(f, args, iters: int) -> float:
    """Seconds for ``iters`` calls of ``f(*args)``, fenced: CUDA events and
    a synchronize where the arguments lie on the card, the host clock on
    the CPU (whose calls return when done)."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            f(*args)
        return time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        f(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def measure(f, *args, iters: int = 100, warmup: int = 5,
            trains: int = 5) -> float:
    """Seconds a call of ``f(*args)``: the least of ``trains`` fenced trains
    of ``iters`` calls, after ``warmup`` calls (the JAX package's
    ``measure``: interference only adds time, so the least train is the
    steadiest).  On the card a train's time includes the host's launches
    where they are the longer."""
    _run_train(f, args, max(1, warmup))
    best = min(_run_train(f, args, iters) / iters for _ in range(trains))
    return max(best, 1e-9)


def measure_chained(f, *args, chain: int = 8, iters: int = 4,
                    warmup: int = 1, trains: int = 3,
                    eps: float = 1e-30) -> float:
    """Seconds a call when ``chain`` calls run back to back, each one
    depending on the last: before each call one element of the first
    argument (a private copy) moves by ``eps`` times an element of the
    previous output, which leaves its value as it was.  The JAX package
    chains calls inside one jit this way; here the chain is
    :func:`measure`'s train of ``chain`` dependent calls."""
    x = args[0].clone()
    flat = x.view(-1)[:1]

    def chained(*a):
        out = None
        for _ in range(chain):
            out = f(*a)
            flat.add_(_leaf(out).reshape(-1)[:1].to(x.dtype) * eps)
        return out

    best = measure(chained, x, *args[1:], iters=iters, warmup=warmup,
                   trains=trains)
    return max(best / chain, 1e-9)


def measure_held(f, *args, iters: int = 20, warmup: int = 3,
                 spin_cycles: int = 10_000_000, tries: int = 4) -> float:
    """Seconds of device time a call of ``f(*args)`` on the card, without
    the profiler: a spin kernel holds the stream while the host enqueues
    ``iters`` calls between two CUDA events, so the card runs them back to
    back and the events' gap holds no host time.  Where the spin ended
    before the host had enqueued the train (the first event was reached
    early), the spin is made four times longer and the train run again;
    raises after ``tries`` such runs (``f`` waits for the card)."""
    for _ in range(warmup):
        f(*args)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(tries):
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            f(*args)
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return max(start.elapsed_time(end) / 1e3 / iters, 1e-9)
        spin_cycles *= 4
    raise RuntimeError(f"the host did not enqueue {iters} calls within "
                       f"a spin of {spin_cycles // 4} cycles")


def measure_device(f, *args, iters: int = 20, warmup: int = 3) -> float:
    """Seconds of device time a call of ``f(*args)`` on the card: the
    profiler's kernel time over ``iters`` calls (the host's launches
    excluded).  The profiler at times records no kernel in a session; then
    the time is :func:`measure_held`'s (which also counts the card's short
    gaps between the kernels of a call)."""
    for _ in range(warmup):
        f(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            f(*args)
        torch.cuda.synchronize()
    busy_us = kernel_table(prof)[0]
    if not busy_us:
        return measure_held(f, *args, iters=iters, warmup=0)
    return busy_us / 1e6 / iters


def tflops(flop_count: float, seconds: float) -> float:
    return flop_count / seconds / 1e12


def print_profile(prof, wall_s: float, calls: int, what: str) -> int:
    """The busy/idle line and the ranked kernels; 1 if no device time."""
    busy_us, launches, ranked = kernel_table(prof, top=25)
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


def train_twice(cfg, params, tokens, steps: int, lr: float = 3e-3,
                loss=loss_fn):
    """Train two copies of ``params`` (left as they are) from one state,
    one after the other, with ``make_train_step`` over ``loss`` and Adam
    at ``lr`` on ``tokens`` for ``steps`` steps, and compare the copies
    bit for bit after every step.  → (per step: both losses, and the
    names of the parameters and of the gradients that differ, empty when
    the step is deterministic; the second copy's final parameters).
    Holds the first copy's parameters and gradients of every step."""
    first, out = [], []
    for run in range(2):
        p = clone_params(params)
        named = named_parameters(p)
        optimizer = torch.optim.Adam([t for _, t in named], lr=lr)
        step = make_train_step(cfg, optimizer, loss=loss)
        for i in range(steps):
            p, _, value = step(p, optimizer.state, tokens)
            snap = [(t.detach().clone(), t.grad.detach().clone())
                    for _, t in named]
            if run == 0:
                first.append((value.item(), snap))
                continue
            value0, snap0 = first[i]
            out.append({
                "step": i + 1, "losses": [value0, value.item()],
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


def profile_train(cfg, params, seed: int, steps: int = 3, loss=loss_fn,
                  batch: int = 4) -> int:
    """``make_train_step`` over ``loss`` (``mla_loss_fn`` for MLA) on the
    first ``batch`` rows of the train phase's tokens."""
    tokens = train_tokens(cfg, seed, "cuda")[:batch]
    optimizer = torch.optim.Adam(trainable_parameters(params), lr=3e-3)
    step = make_train_step(cfg, optimizer, loss=loss)

    def run(n):
        nonlocal params
        t0 = time.perf_counter()
        for _ in range(n):
            params, _, value = step(params, optimizer.state, tokens)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, value.item()

    run(2)  # warm-up: kernel build, cuBLAS plans, optimizer state
    wall_s, final = run(steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_s, _ = run(steps)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": steps,
        "tokens_per_step": batch * 2048, "step_s": wall_s / steps,
        "tokens_per_s": steps * batch * 2048 / wall_s, "loss": final,
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
                    dev_ms = measure_device(run, iters=iters, warmup=0) * 1e3
                finally:
                    quantized_gemm.wo_tile = chosen
                print(json.dumps({
                    "device": torch.cuda.get_device_name(0), "arm": arm,
                    "m": m, "n": n, "k": k, "tile_rows": plan[0],
                    "k_splits": plan[1], "ms": ms, "device_ms": dev_ms,
                    "chosen": plan == chosen(m, n, k, sms)}))
    return 0


# The s8 tile's plans (tile rows, K splits) timed by --dyn-tiles, and the
# flagship's (N, K) of its projections and unembedding.
DYN_TILE_PLANS = ((16, 1), (16, 2), (16, 4), (16, 8), (64, 1), (64, 2),
                  (64, 4), (64, 8), (128, 1), (128, 2), (128, 4))
DYN_TILE_NK = ((1024, 1024), (256, 1024), (4096, 1024), (1024, 4096),
               (32768, 1024))


def _time_plans(label, run, shape, planner, fallback, plans, iters,
                **extra) -> None:
    """Time ``run`` with each of ``plans`` forced on the module's planner
    ``planner`` (restored to ``fallback`` after), as --wo-tiles does."""
    m, n, k = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for plan in plans:
        setattr(quantized_gemm, planner, lambda *_, plan=plan: plan)
        try:
            for _ in range(3):
                run()
            ms = cuda_ms(run, iters)
            dev_ms = measure_device(run, iters=iters, warmup=0) * 1e3
        finally:
            setattr(quantized_gemm, planner, fallback)
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "kernel": label,
            "m": m, "n": n, "k": k, **extra, "tile_rows": plan[0],
            "k_splits": plan[1], "ms": ms, "device_ms": dev_ms,
            "chosen": plan == fallback(m, n, k, *extra.values(), sms)}))


def profile_dyn_tiles(seed: int, iters: int = 20) -> int:
    g = torch.Generator(device="cuda").manual_seed(seed)
    for m in (8, 256, 4096):
        a = torch.randn((m, 4096), generator=g, device="cuda").to(
            torch.bfloat16)
        for n, k in DYN_TILE_NK:
            wq = quantize(torch.randn((n, k), generator=g, device="cuda"),
                          QuantConfig(bits=8,
                                      granularity=QuantGranularity.ROW))
            qa, sa, rs = quantized_gemm.quantize_rows(a[:, :k])
            sb, zb = quantized_gemm.weight_scales(wq)
            steps = -(-k // 128)
            plans = [p for p in DYN_TILE_PLANS
                     if p[1] <= steps and (m > 16) == (p[0] > 16)]
            _time_plans("dyn_gemm", lambda: quantized_gemm.dyn_gemm(
                qa, wq.data, sa, rs, sb, zb, bits=8), (m, n, k), "dyn_tile",
                quantized_gemm.dyn_tile, plans, iters)
    for m, n, k in GEMM_SHAPES:
        _, (aq, bq) = gemm_arm("compensated_small_int8_b64", m, n, k, g)
        _, args, kw = quantized_gemm.comp_arguments(aq, bq)
        plans = [p for p in DYN_TILE_PLANS if p[0] > 16]
        _time_plans("comp_small_gemm",
                    lambda: quantized_gemm.comp_small_gemm(*args, **kw),
                    (m, n, k), "comp_small_tile",
                    quantized_gemm.comp_small_tile, plans,
                    iters if m <= 128 else 5, bs=64)
    return 0


# Split counts --decode-splits forces on the paged decode.
DECODE_SPLIT_PLANS = (4, 8, 16, 32, 64)


def decode_split_inputs(geom: str, lengths, g: torch.Generator):
    """(q, pool, table, lengths, kwargs) of the paged decode at
    ``chip_smoke.py``'s phase 8 geometry: ``flagship64`` / ``flagship128``
    (bf16 pool, Hq = 16 over Hkv = 4), ``int8`` (int8 halves at D = 64),
    ``mla`` (one-state bf16 latent pages, Hq = 16 over Hkv = 1, D = 288,
    ``v_tail_zero`` 32), ``deepseek`` (the same at D = 576,
    ``v_tail_zero`` 64); pages scattered, the trash page last."""
    pt, num_pages, max_pages = 256, 256, 16
    hq, hkv, d, states = {"flagship64": (16, 4, 64, 2),
                          "flagship128": (16, 4, 128, 2),
                          "int8": (16, 4, 64, 2),
                          "mla": (16, 1, 288, 1),
                          "deepseek": (16, 1, 576, 1)}[geom]
    shape = (hkv, num_pages + 1, states * pt, d)
    kw = dict(page_tokens=pt)
    if geom == "int8":
        pool = torch.randint(-128, 128, shape, generator=g,
                             device="cuda").to(torch.int8)
        kw.update(k_scales=torch.rand((hkv, num_pages + 1, 1, pt),
                                      generator=g, device="cuda") / 127,
                  v_scales=torch.rand((hkv, num_pages + 1, 1, pt),
                                      generator=g, device="cuda") / 127)
    else:
        pool = torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    if geom == "mla":
        kw.update(v_tail_zero=32, scale=(64 + 32) ** -0.5)
    elif geom == "deepseek":
        kw.update(v_tail_zero=64, scale=(128 + 64) ** -0.5)
    perm = torch.randperm(num_pages, generator=g, device="cuda").to(
        torch.int32)
    table = torch.full((len(lengths), max_pages), num_pages,
                       dtype=torch.int32, device="cuda")
    nxt = 0
    for i, n in enumerate(lengths):
        pages = -(-n // pt)
        table[i, :pages] = perm[nxt: nxt + pages]
        nxt += pages
    q = torch.randn((len(lengths), hq, d), generator=g, device="cuda").to(
        torch.bfloat16)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool, table, ln, kw


def profile_decode_splits(seed: int, iters: int = 50) -> int:
    cfg = TransformerConfig()
    lengths = [len(r.prompt) + 16 for r in smoke_requests(cfg, seed)]
    g = torch.Generator(device="cuda").manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planner = paged_attention.decode_splits
    for geom in ("flagship64", "flagship128", "int8", "mla", "deepseek"):
        q, pool, table, ln, kw = decode_split_inputs(geom, lengths, g)
        hkv = pool.shape[0]
        chosen = planner(len(lengths), hkv, q.shape[1] // hkv,
                         table.shape[1] * kw["page_tokens"], sms)
        for splits in sorted({chosen, *DECODE_SPLIT_PLANS}):
            paged_attention.decode_splits = lambda *_, s=splits: s
            try:
                def run():
                    paged_attention.paged_decode_attention(q, pool, table,
                                                           ln, **kw)
                for _ in range(3):
                    run()
                ms = cuda_ms(run, iters)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(iters):
                        run()
                    torch.cuda.synchronize()
            finally:
                paged_attention.decode_splits = planner
            by_kernel = {("merge" if "merge" in name else "split"):
                         us / 1e3 / iters
                         for name, us, _ in kernel_table(prof)[2]}
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "kernel":
                "paged_decode", "geometry": geom, "lengths": lengths,
                "splits": splits, "ms": ms,
                "device_ms": sum(by_kernel.values()), **{
                    f"device_ms_{k}": v for k, v in by_kernel.items()},
                "chosen": splits == chosen}))
    return 0


# Split counts --dkv-splits forces on the dK/dV's wide and latent bodies.
DKV_SPLIT_PLANS = (1, 2, 4, 8, 16)


def profile_dkv_splits(seed: int, iters: int = 20) -> int:
    for d in (288, 576):
        profile_dkv_splits_at(seed, d, iters)
    return 0


def profile_dkv_splits_at(seed: int, d: int, iters: int) -> None:
    b, hq, hkv, s = 2, 16, 1, 2048
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b, hq, s, d), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    rr = row_ranges_tensor(CAUSAL, s, s, None, "cuda")
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, rr, scale=scale)
    di = (do.float() * o).sum(-1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planner = flash_attention_bwd.dkv_splits
    chosen = planner(q.dtype, d, b, hq, hkv, s, sms)
    for splits in sorted({chosen, *DKV_SPLIT_PLANS}):
        flash_attention_bwd.dkv_splits = lambda *_, n=splits: n
        try:
            def run():
                flash_attention_bwd.flash_dkv(q, k, v, do, lse, di, rr,
                                              scale=scale)
            for _ in range(3):
                run()
            ms = cuda_ms(run, iters)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    run()
                torch.cuda.synchronize()
        finally:
            flash_attention_bwd.dkv_splits = planner
        by_kernel = {("merge" if "merge" in name else "split"):
                     us / 1e3 / iters
                     for name, us, _ in kernel_table(prof)[2]
                     if "flash_dkv" in name}
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "kernel": "flash_dkv",
            "shape": [b, hq, hkv, s, d], "splits": splits, "ms": ms,
            "device_ms": sum(by_kernel.values()), **{
                f"device_ms_{k}": v for k, v in by_kernel.items()},
            "chosen": splits == chosen}))


# Run counts --fwd-splits times beside split_d_fwd_splits' choice, at
# Perceiver IO's image cross-attention (B, H, Sq, Skv, D: 512 latents of
# 1024 over 224 x 224 inputs, one head, FULL).
FWD_SPLIT_PLANS = (1, 2, 4, 16)
PERCEIVER_IO = (1, 1, 512, 224 * 224, 1024)


def profile_fwd_splits(seed: int, iters: int = 5) -> int:
    """The split-D forwards at Perceiver IO's shape over run counts of
    their KV axis (the bf16 flash forward, and the quantized one over int8
    ROW CENTERED K/V, QuantizedAttention's default): events and the
    profiler's device ms (kernel and merge), one JSON line a count; first
    the occupancy API's CTAs an SM for every instance of both kernels."""
    fa = sys.modules[flash_fwd.__module__]
    occupancy = {}
    for dtype, name in ((0, "float"), (1, "bf16")):
        for static in (0, 1):
            occupancy[f"split_d_fwd_kernel<{name}, static_max={static}>"] = (
                _build.kernel_function("mfa_split_d_fwd_ctas_per_sm",
                                       [ctypes.c_int] * 2)(dtype, static))
    for qtype, name in ((0, "float Q"), (1, "bf16 Q"),
                        (2, "int8 Q, bf16 P"), (3, "int8 Q, fp32 P")):
        for ring in (0, 1):
            occupancy[f"split_d_qattn_kernel<{name}, ring={ring}>"] = (
                _build.kernel_function("mfa_split_d_qattn_ctas_per_sm",
                                       [ctypes.c_int] * 2)(qtype, ring))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ctas_per_sm": occupancy}))
    b, h, sq, skv, d = PERCEIVER_IO
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, d), generator=g, device="cuda").to(
        torch.bfloat16) for n in (sq, skv, skv))
    rr = row_ranges_tensor(FULL, sq, skv, None, "cuda")
    row8c = QuantConfig(bits=8, granularity=QuantGranularity.ROW,
                        strategy=QuantStrategy.CENTERED)
    args, kw = quantized_attention.qattn_arguments(
        q, quantize(k, row8c), quantize(v, row8c))
    calls = {"flash_fwd": lambda: flash_fwd(q, k, v, rr, scale=d ** -0.5),
             "qattn_fwd": lambda: quantized_attention.qattn_fwd(*args, **kw)}
    planner = fa.split_d_fwd_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = planner(d, b, h, sq, skv, sms)
    for splits in sorted({chosen, *FWD_SPLIT_PLANS}):
        fa.split_d_fwd_splits = quantized_attention.split_d_fwd_splits = (
            lambda *_, n=splits, **__: n)
        try:
            for name, run in calls.items():
                run()
                ms = cuda_ms(run, iters)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(iters):
                        run()
                    torch.cuda.synchronize()
                by_kernel = {("merge" if "merge" in k else "split"):
                             us / 1e3 / iters
                             for k, us, _ in kernel_table(prof)[2]
                             if "split_d" in k}
                print(json.dumps({
                    "device": torch.cuda.get_device_name(0), "kernel": name,
                    "shape": [b, h, sq, skv, d], "splits": splits, "ms": ms,
                    "device_ms": sum(by_kernel.values()), **{
                        f"device_ms_{k}": v for k, v in by_kernel.items()},
                    "chosen": splits == chosen}))
        finally:
            fa.split_d_fwd_splits = quantized_attention.split_d_fwd_splits = (
                planner)
    return 0


# Cluster sizes --rtq-clusters times beside block_cluster's choice.
RTQ_CLUSTER_PLANS = (4, 8, 16)


def profile_rtq_clusters(seed: int, iters: int = 50) -> int:
    g = torch.Generator(device="cuda").manual_seed(seed)
    act = torch.randn((4096, 1024), generator=g, device="cuda").to(
        torch.bfloat16)
    centered = QuantStrategy.CENTERED
    planner = runtime_quantization.block_cluster
    active = _build.kernel_function("mfa_rtq_max_clusters", [ctypes.c_int])
    for bs in (64, 128):
        chosen = planner(act.shape[1], bs)
        for cluster in sorted({chosen, *RTQ_CLUSTER_PLANS}):
            runtime_quantization.block_cluster = lambda *_, c=cluster: c
            try:
                def run():
                    return runtime_quantization.rtq_blocks(act, bs, centered,
                                                           8, True)
                want = runtime_quantization.rtq_blocks_plain(
                    act, bs, centered, 8, True)
                same = all(torch.equal(a, b) for a, b in zip(run(), want))
                for _ in range(3):
                    run()
                ms = cuda_ms(run, iters)
                dev_ms = measure_device(run, iters=iters, warmup=0) * 1e3
            finally:
                runtime_quantization.block_cluster = planner
            print(json.dumps({
                "device": torch.cuda.get_device_name(0),
                "kernel": "rtq_block_kernel", "shape": list(act.shape),
                "bs": bs, "cluster": cluster,
                "ctas": act.shape[1] // bs * cluster,
                "max_active_clusters": active(cluster),
                "bit_identical": same, "ms": ms, "device_ms": dev_ms,
                "chosen": cluster == chosen}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the engine "
                    "(with --mla: MLAConfig()'s mla_loss_fn)")
    ap.add_argument("--quantized", type=int, choices=(8, 4),
                    help="serve W8A8 weights over an int8 pool (8) or W4A8 "
                    "weights over an int4 pool (4)")
    ap.add_argument("--mla", action="store_true",
                    help="serve MLAConfig() through mla_executor() (with "
                    "--quantized 8: W8A8 weights over an int8 latent pool)")
    ap.add_argument("--v2-lite", action="store_true",
                    help="with --mla: serve (or, with --train, train) "
                    "DeepSeek-V2-Lite's widths (DEEPSEEK_V2_LITE) instead "
                    "of MLAConfig()")
    ap.add_argument("--quantized-attention", choices=("packed", "unpacked"),
                    help="profile quantized_forward(quantize_kv=True)")
    ap.add_argument("--quantized-backward", choices=("fullint", "exact"),
                    help="profile the north-star quantized fwd+bwd with the "
                    "full-integer or the exact backward")
    ap.add_argument("--gemm", action="store_true",
                    help="profile the GEMM engine at gemm_bench's shapes")
    ap.add_argument("--wo-tiles", action="store_true",
                    help="time the weight-only kernels over tile plans")
    ap.add_argument("--dyn-tiles", action="store_true",
                    help="time the s8 tile's kernels (the dynamic and the "
                    "small-block compensated GEMMs) over tile plans")
    ap.add_argument("--decode-splits", action="store_true",
                    help="time the paged decode over split counts")
    ap.add_argument("--dkv-splits", action="store_true",
                    help="time the flash dK/dV at MLA's training shape over "
                    "split counts of its GQA group")
    ap.add_argument("--fwd-splits", action="store_true",
                    help="time the split-D forwards at Perceiver IO's shape "
                    "over run counts of their KV axis, and print each "
                    "instance's CTAs an SM")
    ap.add_argument("--rtq-clusters", action="store_true",
                    help="time the runtime block quantizer over cluster "
                    "sizes")
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
    if args.dyn_tiles:
        return profile_dyn_tiles(args.seed)
    if args.decode_splits:
        return profile_decode_splits(args.seed)
    if args.dkv_splits:
        return profile_dkv_splits(args.seed)
    if args.rtq_clusters:
        return profile_rtq_clusters(args.seed)
    if args.fwd_splits:
        return profile_fwd_splits(args.seed)
    if args.quantized_backward:
        return profile_quantized_backward(args.seed, args.quantized_backward)
    if args.v2_lite and not args.mla:
        ap.error("--v2-lite takes --mla")
    if args.mla:
        if args.quantized == 4:
            ap.error("MLA latent pools are float or int8")
        if args.v2_lite:
            cfg = DEEPSEEK_V2_LITE
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
        else:
            cfg = MLAConfig()
            gen = torch.Generator().manual_seed(args.seed)
        params = init_mla_params(cfg, gen, device="cuda")
        if args.train:
            return profile_train(cfg, params, args.seed,
                                 loss=mla_loss_fn, batch=2)
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Builds the port's CUDA kernels and native runtime from the sources in the
checkout, then, on the card:

1. device and build: the card's name and power limit, build seconds;
2. each paged kernel against its plain PyTorch version in bf16, at the
   flagship shapes (decode also at head_dim 128; prefill at three chunk
   offsets);
3. the flash forward, dQ and dK/dV kernels against their plain versions
   at the train shapes (B=4, Hq=16, Hkv=4, S=2048, D=64, causal) in bf16
   and fp32, and at small shapes over the rest of the mask zoo, bias,
   interleaved GQA, head dims 128 and 256, and ragged rectangular S;
4. full-width serving logits: the flagship model (random weights from the
   seed) through ``prefill_chunk`` and ``decode_step``, against the plain
   fp32 ``forward`` (``attn_fn=plain_attention``, no kernel) on fp32
   copies of the same weights;
5. the serving path: a ``ServingEngine`` with its defaults serves 8
   requests, with the paged kernels' launch counts set to 0 just before
   and read after;
6. full-width fp32 gradients: one ``loss_fn`` gradient at B=2, S=1024 on
   fp32 copies of the flagship weights, through the flash kernels against
   the same call with ``attn_fn=plain_attention``;
7. the training path: ``make_train_step`` trains the bf16 flagship with
   Adam for 8 steps on one seeded batch of 4 × 2049 tokens, with the flash
   kernels' launch counts set to 0 just before and read after; then the
   same 8 steps twice more from the same initial parameters, the two runs
   equal bit for bit after every step (parameters and gradients) and their
   final parameters equal to the first run's;
8. kernel, plain-version and library (SDPA) times at the engine's and the
   train step's shapes;
9. the quantized serving slice (inputs from a second generator, seed + 1,
   so the phases above see the same numbers as before it was added):
   (a) the dynamic W8A8/W4A8 GEMM kernel against its plain version, bit
   for bit, at the flagship's and MLAConfig()'s projection shapes; (b) the paged kernels'
   int8 and int4 pool modes against their plain versions in bf16; (c)
   full-width logits of ``quantize_weights`` params (W8A8 over an int8
   pool, W4A8 over an int4 pool) through ``prefill_chunk`` and
   ``decode_step`` against the fp32 ``forward`` on the dequantized weights
   (``attn_fn=plain_attention``, no kernel), gated on the weights after
   phase 7's train steps and reported without a gate, before phase 7, on
   the random-init weights; (d) a ``ServingEngine`` with
   W8A8 weights and an int8 pool, and one with W4A8 weights and an int4
   pool, each serving the 8 requests with the launch counts set to 0 just
   before and read after; (e) times of the GEMM summed over one model
   call's projections and of the paged kernels' quantized modes, beside
   their bounds, plain versions and library calls;
10. the quantized-attention slice (inputs from a third generator, seed +
   2): (a) the quantized forward kernel against its plain version in bf16,
   at the flagship's attention shapes (B=2, Hq=16, Hkv=4, S=2048, D=64,
   causal) in the unpacked model's mode (int8 Q, ROW K/V), dequant-on-load
   ROW CENTERED int8 and int4 and folded TENSOR and ROW scales, and at
   small shapes over int8 P·V with CHANNEL/TENSOR V, BLOCK_2D, bias, a
   sliding window, interleaved GQA, D=128, ragged S and D=80 / 96 (run
   zero-padded at 128; at D=96 also BLOCK_2D with 48-wide blocks, which
   do not tile 128); (b) the head-pair
   kernel against its plain version at the flagship shapes in the packed
   layout, int8 and int4, causal and full; (c) both runtime quantization
   kernels against their plain versions, bit for bit; (d) full-width
   ``quantized_forward(quantize_weights(params), tokens, cfg,
   quantize_kv=True)`` on 2 x 2048 tokens, packed (auto) and unpacked,
   against the fp32 ``forward`` on the dequantized weights, gated on the
   weights after phase 7's train steps and reported without a gate, before
   phase 7, on the random-init weights, with 8 head-pair (packed) or 8
   quantized-forward (unpacked) and 57 GEMM launches per call; (e)
   ``QuantizedAttention`` (int8 CENTERED, and int4 with the Hadamard
   rotation, causal) at the flagship attention shapes against the dense
   fp32 attention, with 2 row-kernel and 1 quantized-forward launches per
   call, and ``runtime_quantize`` with the blockwise-centered
   configuration, the block kernel's entry point; (f) times of the four
   kernels beside their bounds, plain versions and library calls;
11. the quantized backward (inputs from a fourth generator, seed + 3): (a)
   the full-integer dQ and dK/dV kernels against their plain versions at
   the JAX package's north-star shape (bench.py: B=4, H=4, S=4096, D=256,
   FULL), levels 1 and 2, ROW and TENSOR K; the exact quantized dQ and
   dK/dV kernels at the flagship's attention shapes in folded ROW /
   CHANNEL / TENSOR and dequant ROW CENTERED int8 / int4 modes, and at
   small shapes over BLOCK_2D, bias with dbias, a sliding window,
   interleaved GQA, D=128 / 256, ragged S and D=80 / 96 (zero-padded at
   128, at D=96 also BLOCK_2D with 48-wide blocks; the full-integer pair
   too, level 1), and the full-integer pair at level 2 over 8-wide spans
   (S=200), the width its scalar kernels take; (b) bench.py's loss,
   sum(O·dO) through ``quantized_flash_attention(quantize_q=True,
   bwd_fullint=True | False)`` at the north-star shape, differentiated with
   respect to (q, K scales, V scales) with one full-integer (or exact) dQ
   and dK/dV launch each, the full-integer gradients against the exact
   ones and the exact ones against the fp32 dense VJP on the dequantized
   K/V (rel L2 ≤ 0.05 each); (c) ``quantized_flash_attention_qat`` and the
   ``QuantizedAttention`` gradient with respect to q at the flagship's
   attention shapes against the dense VJP (< 0.05); (d) on (b)'s own
   inputs, the kernels it launched against their plain versions in the
   modes it launched them (the quantized forward with int8 Q and P at
   D=256, both full-integer and both exact kernels), then the four
   backward kernels' and that forward's times beside their bounds, plain
   versions and SDPA, the full-integer pair at level 2 too (512-key and
   1024-query spans);
12. MLA serving and the weight-only GEMM (inputs from a fifth generator,
   seed + 4): (a) both paged kernels at MLA's geometry (Hq=16 over Hkv=1,
   D=288, one-state latent pages, v_tail_zero=32) with bf16 and int8
   pools against their plain versions; (b) the flash forward, dQ and
   dK/dV kernels at D=80 and 288; (c) the quantized forward's int8 P over
   the TPU's block_kv spans (NORTH_STAR_BLOCKS' and 128) at the
   north-star shape against ``qattn_fwd_plain(kv_tile=block_kv)``; (d)
   both weight-only GEMM kernels against their plain versions at the
   decompression shape (M=4096, N=1024, K=256): folded int8 / int4 ROW and
   int8 TENSOR, dequant-on-load BLOCK 128, ASYMMETRIC ROW and an fp32 A,
   each with and without ``c=``, in fp32, and their bf16 results equal to
   the fp32 ones rounded; (e) ``mla_decompress`` over quantized
   W_uk / W_uv (int8 ROW, int8 BLOCK 128) then ``flash_attention`` at B=2,
   S=2048 against ``mla_absorbed_attention`` on the dequantized weights
   (rel L2 ≤ 0.05), 2 GEMM launches per call, the path's time, and
   ``mla_absorbed_attention`` over a per-token int8 latent at B=2, S=2048
   (the quantized forward at Hq=16 over Hkv=1, D=256) with its one launch
   held to the plain version on the same arguments; (f) full-width
   ``MLAConfig()`` serving logits (random weights from the seed) through
   ``mla_prefill_chunk`` and ``mla_decode_step`` against the fp32
   ``mla_forward`` with the dense decompress-then-attend attention (no
   kernel): float latent pool (rel L2 ≤ 0.05) and ``quantize_mla_weights``
   over an int8 latent pool, on the dequantized weights (≤ 0.25); (g)
   ``ServingEngine(..., executor=mla_executor())`` serving the 8 requests,
   float and W8A8 + int8 latent, the launch counts set to 0 just before
   and read after; (h) times of the paged kernels at MLA's geometry, the
   flash kernels at D=288 and both GEMM kernels beside their bounds, plain
   versions and library calls;
13. the GEMM engine (inputs from a sixth generator, seed + 5): (a) the
   quantized-A kernels (folded int8 / int4 ROW and int8 TENSOR; dequant
   ROW ASYMMETRIC, BLOCK 128 and an fp32 B) and the compensated ones
   (BLOCK 128 and 512 with asymmetric zero points, bit for bit; small
   blocks 32 and 64; each with and without ``c=``) against their plain
   versions at the flagship's projection shapes (M=4096) and
   benchmarks/gemm_bench.py's (M=128 and 4096, N=K=8192); (b)
   ``ops.gemm.matmul`` at M=4096, N=K=1024 over every operand kind and
   dispatch arm (the degraded QT × QT arms: int4 A, unequal blocks, ROW
   B, no fast int8 path; ``transpose_a``; ``c=``) against the dequantized
   reference, with exactly one launch of the expected GEMM kernel per
   call; (c) the four kernels' times at gemm_bench's shapes, on
   utils/profiling.py's arms, beside their bounds, plain versions and
   library calls, and both weight-only kernels' there (gemm_bench's
   weight-only int8 / int4 BLOCK 256 arms through ``wo_gemm``, int8 ROW
   SYMMETRIC through ``wo_folded_gemm``), first held to their plain
   versions in fp32 and their bf16 results to the fp32 ones rounded.

Phase 10 and 11 hold the quantized forward to its plain version over the
key spans the main path gives it: the TPU's ``block_kv`` where P is int8.
Phases 10 (f), 13 (c), 8, 11 (d) and 12 (h) log which body the quantized
forward and the head-pair call, the quantized-A and the weight-only GEMMs
(folded and dequantizing), the flash forward and the dQ and dK/dV kernels,
the exact and the full-integer ones, run (``qattn_body``,
``qa_gemm_body``, ``wo_gemm_body``, ``fwd_body``, ``dq_body``,
``dkv_body``, ``fullint_body``: tensor cores, or fp32 FMAs / ``__dp4a``).

``--parent DIR`` (a checkout of the parent commit, e.g. ``git archive``
into a directory ``.gitignore`` lists) also builds DIR's kernels, at once
with this checkout's, and times every kernel the phases time on both
libraries in turns (parent, change, change, parent) through the same
wrappers (a parent whose weight-only kernels write fp32 only runs
``quantized_matmul`` as it did then: fp32, then the cast); the turns go
into the log, a summary line each, and the redesigned kernels' record
entries.

Every phase raises on failure, so the script exits non-zero.  It prints
the kernels' record as one JSON line and, as the very last line,
``{"ok": true, "device": {...}}``.  It needs a CUDA device: without one it
exits 2 and prints no result.  The port is imported from the checkout, so
the script alone, outside the repository, fails at import.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention import masking
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.attention.quantized import (
    QuantizedAttention,
    QuantizedAttentionConfig,
)
from metal_flash_attention_plus_tpu_torch.models.cached import (
    decode_step,
    init_cache,
    prefill_chunk,
)
from metal_flash_attention_plus_tpu_torch.models.mla_transformer import (
    MLAConfig,
    init_mla_params,
    mla_forward,
    plain_mla_attention,
)
from metal_flash_attention_plus_tpu_torch.models.quantized_inference import (
    WEIGHT_CFG,
    quantize_mla_weights,
    quantize_weights,
    quantized_forward,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    plain_attention,
    trainable_parameters,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    flash_attention_bwd as fbwd,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    quantized_attention as tqa,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention,
    flash_attention_forward_plain,
    flash_fwd,
    fwd_body,
    row_ranges_tensor,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    dkv_body,
    dq_body,
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_dkv,
    flash_dq,
    fullint_body,
)
from metal_flash_attention_plus_tpu_torch.ops.mla import (
    mla_absorbed_attention,
    mla_decompress,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    KV_TILE,
    QAttnMode,
    hpack_arguments,
    hpack_fwd,
    hpack_fwd_plain,
    int8_p_tile,
    pack_heads,
    qattn_arguments,
    qattn_body,
    qattn_fwd,
    qattn_fwd_plain,
    quantized_flash_attention_forward,
    quantized_flash_attention_qat,
)
from metal_flash_attention_plus_tpu_torch.ops.gemm import (
    GEMMDescriptor,
    matmul,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    comp_arguments,
    comp_gemm,
    comp_gemm_plain,
    comp_small_gemm,
    comp_small_gemm_plain,
    dyn_gemm,
    dyn_gemm_plain,
    qa_arguments,
    qa_folded_gemm,
    qa_folded_gemm_plain,
    qa_gemm,
    qa_gemm_body,
    qa_gemm_plain,
    quantize_rows,
    weight_scales,
    wo_arguments,
    wo_call,
    wo_folded_gemm,
    wo_folded_gemm_plain,
    wo_gemm,
    wo_gemm_body,
    wo_gemm_plain,
    wo_tile,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    quantized_gemm as qgemm,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    runtime_quantization as rtq,
)
from metal_flash_attention_plus_tpu_torch.quant import capabilities
from metal_flash_attention_plus_tpu_torch.quant.compensation import (
    dequantized_gemm_reference,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
    int8_blockwise,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    dequantize,
    quantize,
    unpack_int4,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
    reference_attention_vjp,
)
from metal_flash_attention_plus_tpu_torch.serving.engine import (
    ServingEngine,
    mla_executor,
)
from metal_flash_attention_plus_tpu_torch.serving.kv_cache import unpack_kv4
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from metal_flash_attention_plus_tpu_torch.utils.roofline import H100_SXM
from metal_flash_attention_plus_tpu_torch.utils.profiling import (
    GEMM_SHAPES,
    NORTH_STAR_BLOCKS,
    NORTH_STAR_SHAPE,
    north_star_grads,
    north_star_inputs,
    gemm_arm,
    clone_params,
    params_digest,
    smoke_requests,
    train_tokens,
    train_twice,
)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core flop/s and int8 tensor-core op/s (utils/roofline.py's
# H100_SXM).
HBM_BYTES_PER_S = H100_SXM.hbm_gbps * 1e9
BF16_FLOPS = H100_SXM.bf16_tflops * 1e12
INT8_OPS = H100_SXM.int8_tops * 1e12

# Kernel vs plain version, both on identical bf16 inputs: they round the
# same values to bf16 at the same places (q after scaling, P before P.V);
# what differs is the order of the fp32 sums and of exp, and the online vs
# one-pass rescaling of P before its bf16 rounding.  Max abs error; no
# looser than TOLERANCES["mixed"].
KERNEL_TOL = 2e-2
# Cached bf16 serving path vs the fp32 oracle, relative L2 over the logits:
# bf16 activations and bf16 K/V through 8 layers.
LOGITS_REL_L2_TOL = TOLERANCES["mixed"]

# Flash kernels vs plain versions: max abs error over the plain version's
# max abs.  bf16 as the paged kernels (the same roundings at the same
# places, fp32 sums in another order); L in bf16 at TOLERANCES["lse"];
# fp32 at TOLERANCES["fp32"].
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: TOLERANCES["fp32"]}
LSE_TOL = {torch.bfloat16: TOLERANCES["lse"],
           torch.float32: TOLERANCES["fp32"]}
# Full-width fp32 gradients, flash kernels vs the dense plain attention:
# relative L2 per parameter; fp32 throughout, sums in another order.
GRAD_REL_L2_TOL = 1e-3
# Quantized serving logits vs the fp32 oracle on the dequantized weights,
# relative L2: the repo's quantized gates (W8A8 + int8 pool, W4A8 + int4
# pool); the difference is the run-time int8 activations and the
# quantized K/V.
QUANT_LOGITS_TOL = {8: TOLERANCES["int8_rel"], 4: TOLERANCES["int4_rel"]}
# The flagship's projections (N, K) in the order of one layer, and the
# unembedding: one model call runs 8 × 7 + 1 = 57 dynamic GEMMs.
PROJ_SHAPES = {"wq": (1024, 1024), "wk": (256, 1024), "wv": (256, 1024),
               "wo": (1024, 1024), "wg": (4096, 1024), "wu": (4096, 1024),
               "wd": (1024, 4096)}
UNEMBED_SHAPE = (32768, 1024)
# MLAConfig()'s projections (N, K) that the flagship has not: the RoPE
# queries and the shared RoPE key (wq, wdkv, wo and the MLP are above).
MLA_PROJ_SHAPES = {"wqr": (512, 1024), "wkr": (32, 1024)}
# The train step's shapes: the flagship at batch 4 × 2048 tokens.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8

DEV = torch.device("cuda")
SOURCE = "metal_flash_attention_plus_tpu_torch/csrc/paged_attention.cu"
GEMM_SOURCE = "metal_flash_attention_plus_tpu_torch/csrc/quantized_gemm.cu"
GEMM_TPU = "metal_flash_attention_plus_tpu/ops/quantized_gemm.py"
TPU_FILE = "metal_flash_attention_plus_tpu/serving/paged_attention.py"
FLASH_SOURCE = "metal_flash_attention_plus_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "metal_flash_attention_plus_tpu/ops/flash_attention.py"
FLASH_BWD_TPU = "metal_flash_attention_plus_tpu/ops/flash_attention_bwd.py"
QATTN_SOURCE = ("metal_flash_attention_plus_tpu_torch/csrc/"
                "quantized_attention.cu")
RTQ_SOURCE = ("metal_flash_attention_plus_tpu_torch/csrc/"
              "runtime_quantization.cu")
QATTN_TPU = "metal_flash_attention_plus_tpu/ops/quantized_attention.py"
RTQ_TPU = "metal_flash_attention_plus_tpu/ops/runtime_quantization.py"
# What the record says of the kernels moved onto the tensor cores.
REDESIGNED = ("mma.sync tensor-core body for its bf16 (and int8) instances, "
              "cp.async staging")
QBWD_SOURCE = ("metal_flash_attention_plus_tpu_torch/csrc/"
               "quantized_attention_bwd.cu")
# The device kernel each record entry's wrapper launches at the entry's
# (main-path) shape.
DEVICE_KERNELS = {
    "paged_decode": "paged_decode_kernel",
    "paged_prefill": "paged_prefill_kernel", "dyn_gemm": "dyn_gemm_kernel",
    "flash_fwd": "flash_fwd_tc_kernel", "flash_dq": "flash_dq_tc_kernel",
    "flash_dkv": "flash_dkv_tc_kernel", "qattn_fwd": "qattn_fwd_tc_kernel",
    "hpack_fwd": "qattn_fwd_tc_kernel",
    "runtime_quantize_row": "rtq_row_kernel",
    "runtime_quantize_block": "rtq_block_kernel",
    "qflash_dq": "qflash_dq_tc_kernel", "qflash_dkv": "qflash_dkv_tc_kernel",
    "fullint_dq": "fullint_dq_tc_kernel",
    "fullint_dkv": "fullint_dkv_tc_kernel",
    "wo_folded_gemm": "wo_tc_kernel", "wo_gemm": "wo_tc_kernel",
    "qa_folded_gemm": "qa_tc_kernel", "qa_gemm": "qa_tc_kernel",
    "comp_gemm": "comp_tc_kernel", "comp_small_gemm": "comp_small_kernel",
}


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# The kernels library of a parent checkout (``--parent DIR``) and the
# timings taken on it beside this checkout's, in turns: (label, {"parent":
# [ms, ms], "change": [ms, ms]}).
PARENT = {"lib": None, "turns": []}


# The weight-only entry points' arguments from the out type to the stream
# (out type, tile rows, K splits, workspace), by the out type's index: a
# library from before the kernels stored the caller's dtype (it has no
# ``mfa_wo_tc_body``) lacks them; its kernels write fp32 and choose their
# own tile (the workspace goes unused).
WO_OTYPE_ARG = {"mfa_wo_folded_gemm": 9, "mfa_wo_gemm": 12}


@contextlib.contextmanager
def kernels_of(lib):
    """Run the port's kernel wrappers on ``lib``'s kernels (the same C
    interface) instead of this checkout's.  A library whose weight-only
    kernels write fp32 only is called without the out-type argument, and
    ``quantized_matmul`` stores fp32 and casts meanwhile, as it did over
    those kernels."""
    own, own_types = _build.kernel_function, qgemm.WO_OUT_TYPES
    legacy = not hasattr(lib, "mfa_wo_tc_body")

    def function(name, argtypes):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if not (legacy and name in WO_OTYPE_ARG):
            fn.argtypes = list(argtypes)
            return fn
        i = WO_OTYPE_ARG[name]
        fn.argtypes = list(argtypes[:i]) + list(argtypes[-1:])

        def fp32_only(*args):
            if args[i] != qgemm.WO_OUT_TYPES[torch.float32]:
                raise ValueError(f"{name} of this library writes fp32 only")
            return fn(*args[:i], args[-1])
        return fp32_only

    _build.kernel_function = function
    if legacy:
        qgemm.WO_OUT_TYPES = {torch.float32: own_types[torch.float32]}
    try:
        yield
    finally:
        _build.kernel_function, qgemm.WO_OUT_TYPES = own, own_types


def parent_turns(label, t, kernel, iters):
    """With ``--parent``: ``kernel`` timed on the parent's library and on
    this checkout's in turns (parent, change, change, parent), into
    ``t["parent_turns_ms"]`` and the summary; nothing otherwise."""
    if PARENT["lib"] is None:
        return
    turns = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        with (kernels_of(PARENT["lib"]) if who == "parent"
              else contextlib.nullcontext()):
            turns[who].append(time_ms(kernel, iters, warmup=1))
    t["parent_turns_ms"] = turns
    PARENT["turns"].append((label, turns))
    log(f"{label} parent / change turns: " + json.dumps(turns))


def log_parent_summary():
    """One line per timing taken in turns: the parent's and the change's
    times and the change's mean over the parent's."""
    for label, t in PARENT["turns"]:
        p, c = t["parent"], t["change"]
        log(f"turns {label}: parent {p[0]:.5g} / {p[1]:.5g} ms, change "
            f"{c[0]:.5g} / {c[1]:.5g} ms, change/parent "
            f"{sum(c) / sum(p):.4f}")


# --------------------------------------------------------------------------
# Phase 1: build
# --------------------------------------------------------------------------


def build_all(parent=None):
    """nvcc (kernels) and g++ (runtime) started together; with ``parent``
    (a checkout of the parent commit), its kernels too, into
    ``PARENT["lib"]``."""
    errors = []

    def run(name):
        try:
            if name == "parent":
                csrc = Path(parent) / _build.CSRC_DIR.relative_to(
                    _build.REPO_ROOT)
                PARENT["lib"] = ctypes.CDLL(str(_build.build_kernels(
                    csrc.resolve(), "mfa_kernels_parent")))
            else:
                _build.load_library(name)
        except BaseException as exc:  # reported and re-raised below
            errors.append(exc)

    names = ("kernels", "runtime") + (("parent",) if parent else ())
    threads = [threading.Thread(target=run, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log("build seconds: " + json.dumps(
        {k: round(v, 2) for k, v in _build.build_seconds.items()}))


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------


def paged_inputs(rng, lengths, hkv, d, pt, num_pages, max_pages,
                 dtype=torch.bfloat16):
    """Random pool [Hkv, NP+1, 2PT, D] (trash page random too) and
    trash-padded tables over scattered pages."""
    pool = torch.from_numpy(
        rng.standard_normal((hkv, num_pages + 1, 2 * pt, d), np.float32)
    ).to(DEV, dtype)
    return pool, page_tables(rng, lengths, pt, num_pages, max_pages)


def page_tables(rng, lengths, pt, num_pages, max_pages):
    """Trash-padded page tables [len(lengths), max_pages] over scattered
    pages, on the card."""
    perm = rng.permutation(num_pages)
    table = np.full((len(lengths), max_pages), num_pages, np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        pages = -(-int(n) // pt)
        table[i, :pages] = perm[nxt: nxt + pages]
        nxt += pages
    assert nxt <= num_pages
    return torch.from_numpy(table).to(DEV)


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# --------------------------------------------------------------------------
# Phase 2: paged kernels vs plain versions
# --------------------------------------------------------------------------


def check_decode(rng, d):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    pool, table = paged_inputs(rng, lengths, hkv, d, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    out = paged_decode_attention(q, pool, table, ln, page_tokens=pt)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q, pool, table, ln, page_tokens=pt)
    err = max_abs(out, ref)
    log(f"decode D={d}: max abs err {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged decode D={d} disagrees: {err}")
    return err


def check_prefill(rng, offset):
    hq, hkv, d, pt, chunk, num_pages, max_pages = 16, 4, 64, 256, 256, 64, 16
    pool, table = paged_inputs(rng, [offset + chunk], hkv, d, pt, num_pages,
                               max_pages)
    row = table[0].contiguous()
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    out = paged_prefill_attention(q, pool, row, offset, page_tokens=pt)
    torch.cuda.synchronize()
    ref = paged_prefill_attention_plain(q, pool, row, offset, page_tokens=pt)
    err = max_abs(out, ref)
    log(f"prefill offset={offset}: max abs err {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged prefill offset={offset} disagrees: {err}")
    return err


# --------------------------------------------------------------------------
# Phase 3: flash kernels vs plain versions
# --------------------------------------------------------------------------


def rel_err(out, ref) -> float:
    """Max abs error over the reference's max abs; -inf (empty rows) must
    match exactly."""
    out, ref = out.float(), ref.float()
    finite = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(out), finite) or not torch.equal(
            out[~finite], ref[~finite]):
        return float("inf")
    scale = ref[finite].abs().max().clamp_min(1e-30)
    return ((out[finite] - ref[finite]).abs().max() / scale).item()


def flash_inputs(rng, b, hq, hkv, sq, skv, d, dtype, bias_shape=None):
    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32)).to(DEV)

    q, k, v, do = t(b, hq, sq, d), t(b, hkv, skv, d), t(b, hkv, skv, d), t(
        b, hq, sq, d)
    bias = None if bias_shape is None else t(*bias_shape)
    return [x.to(dtype) for x in (q, k, v, do)] + [bias]


def check_flash(rng, label, b, hq, hkv, sq, skv, d, dtype,
                mask=masking.CAUSAL, ranges=None, bias_shape=None,
                interleaved=False):
    """Forward, dQ and dK/dV kernels against their plain versions on the
    same inputs → {output: (rel err, max abs err)}; raises past a gate."""
    q, k, v, do, bias = flash_inputs(rng, b, hq, hkv, sq, skv, d, dtype,
                                     bias_shape)
    rr = row_ranges_tensor(mask, sq, skv, ranges, DEV)
    kw = dict(bias=bias, scale=d ** -0.5, interleaved_kv=interleaved)
    want_dbias = bias is not None
    o, lse = flash_fwd(q, k, v, rr, **kw)
    torch.cuda.synchronize()
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    di = (do.float() * o_ref).sum(-1)
    dq, dbias = flash_dq(q, k, v, do, l_ref, di, rr, want_dbias=want_dbias,
                         **kw)
    dk, dv = flash_dkv(q, k, v, do, l_ref, di, rr, **kw)
    torch.cuda.synchronize()
    dq_ref, dbias_ref = flash_attention_dq_plain(
        q, k, v, do, l_ref, di, rr, want_dbias=want_dbias, **kw)
    dk_ref, dv_ref = flash_attention_dkv_plain(q, k, v, do, l_ref, di, rr,
                                               **kw)
    pairs = {"o": (o, o_ref), "l": (lse, l_ref), "dq": (dq, dq_ref),
             "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    if want_dbias:
        pairs["dbias"] = (dbias, dbias_ref)
    errs = {}
    for name, (got, want) in pairs.items():
        finite = torch.isfinite(want)
        abs_err = (got.float()[finite] - want.float()[finite]).abs().max()
        errs[name] = (rel_err(got, want), abs_err.item())
    log(f"flash {label} {str(dtype)[6:]}: " + " ".join(
        f"{n} {e[0]:.2e}" for n, e in errs.items()))
    bad = {n: e[0] for n, e in errs.items()
           if not e[0] <= (LSE_TOL if n == "l" else FLASH_TOL)[dtype]}
    if bad:
        raise AssertionError(f"flash {label} {dtype} disagrees: {bad}")
    return errs


def check_flash_all(rng):
    """The train shapes in bf16 and fp32, then the mask zoo at small
    shapes; returns the train-shape bf16 errors and the worst small one."""
    train = {}
    for dtype in (torch.bfloat16, torch.float32):
        train[dtype] = check_flash(rng, "train-shape causal", 4, 16, 4, 2048,
                                   2048, 64, dtype)
    seg = masking.build_segment_ranges(np.repeat(np.arange(6), 50))
    seg[77] = (10, 10)  # an empty row
    block = masking.build_block_sparse_ranges(
        np.tril(np.ones((6, 6), bool)) & ~np.eye(6, k=-3, dtype=bool), 64)
    small = [  # (label, head dim, options); B=2, Hq=8, Hkv=2, S=300
        ("d128", 128, {}),
        ("d256", 256, {}),
        ("window-causal", 64,
         dict(mask=masking.sliding_window(96, causal=True))),
        ("segments-empty-row", 64, dict(
            mask=masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
            ranges=seg)),
        ("block-sparse", 64, dict(
            mask=masking.MaskSpec(masking.MaskKind.BLOCK_SPARSE,
                                  block_size=64), ranges=block)),
        ("bias-dbias", 64, dict(bias_shape=(1, 8, 300, 300))),
        ("interleaved", 64, dict(interleaved=True)),
    ]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for label, d, kw in small:
            errs = check_flash(rng, label, 2, 8, 2, 300, 300, d, dtype, **kw)
            worst = max(worst, *(e[0] for e in errs.values()))
        errs = check_flash(rng, "ragged Sq=125 < Skv=1000", 1, 4, 4, 125,
                           1000, 64, dtype)
        worst = max(worst, *(e[0] for e in errs.values()))
    return train, worst


# --------------------------------------------------------------------------
# Phase 4: full-width serving logits vs the fp32 oracle
# --------------------------------------------------------------------------


def rel_l2(x, ref) -> float:
    return ((x.float() - ref).norm() / ref.norm()).item()


GQA_EXECUTOR = types.SimpleNamespace(
    init_cache=init_cache, prefill_chunk=prefill_chunk,
    decode_step=decode_step)
# (forward, attn_fn) of a model family's fp32 oracle: dense attention that
# runs no kernel.
GQA_ORACLE = (forward, plain_attention)
MLA_ORACLE = (mla_forward, plain_mla_attention)


def check_logits(cfg, params, rng, *, params32=None, quantized=False,
                 tol=LOGITS_REL_L2_TOL, label="serving",
                 executor=GQA_EXECUTOR, oracle=GQA_ORACLE):
    """The cached path (``executor``'s calls, as the engine makes them) vs
    the fp32 ``oracle`` on ``params32`` (default: fp32 copies of
    ``params``); ``quantized`` is the pool's ``init_cache`` argument;
    ``tol=None`` reports without a gate."""
    init, prefill, decode = (executor.init_cache, executor.prefill_chunk,
                             executor.decode_step)
    fwd, attn = oracle
    if params32 is None:
        params32 = {
            "embed": params["embed"].float(),
            "unembed": params["unembed"].float(),
            "ln_f": params["ln_f"],
            "layers": [{k: v.float() for k, v in layer.items()}
                       for layer in params["layers"]],
        }
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    pt, chunk, num_pages, max_pages = 256, 256, 16, 8
    cache = init(cfg, num_pages, pt, quantized=quantized, device=DEV)
    seqs = [list(rng.integers(0, cfg.vocab_size, n)) for n in (300, 420)]
    rows = torch.full((2, max_pages), num_pages, dtype=torch.int32)
    rows[0, :3] = torch.tensor([5, 0, 9])
    rows[1, :3] = torch.tensor([2, 11, 7])
    rows = rows.to(DEV)

    def oracle(seq):  # dense fp32 attention: independent of the kernels
        return fwd(params32, torch.tensor([seq], device=DEV), cfg32,
                   attn_fn=attn)[0, -1]

    worst = 0.0
    last = []
    for s, seq in enumerate(seqs):
        for start in range(0, len(seq), chunk):
            part = seq[start: start + chunk]
            padded = torch.zeros(chunk, dtype=torch.long)
            padded[: len(part)] = torch.tensor(part)
            logits, cache = prefill(
                params, padded.to(DEV), start, len(part) - 1, cache,
                rows[s].contiguous(), cfg)
        err = rel_l2(logits, oracle(seq))
        worst = max(worst, err)
        log(f"{label} prefill seq {s} ({len(seq)} tokens): logits rel L2 "
            f"{err:.3e}")
        last.append(int(torch.argmax(logits)))
    for _ in range(8):
        for s in range(2):
            seqs[s].append(last[s])
        tokens = torch.tensor(last, device=DEV)
        lengths = torch.tensor([len(x) for x in seqs], dtype=torch.int32,
                               device=DEV)
        logits, cache = decode(params, tokens, lengths, rows, cache, cfg)
        for s in range(2):
            err = rel_l2(logits[s], oracle(seqs[s]))
            worst = max(worst, err)
        last = torch.argmax(logits, dim=-1).tolist()
    log(f"{label} logits rel L2, worst over prefill + 8 decode steps: "
        f"{worst:.3e} ({'not gated' if tol is None else f'tol {tol}'})")
    if tol is not None and not (np.isfinite(worst) and worst <= tol):
        raise AssertionError(f"{label} logits disagree with the oracle: "
                             f"{worst}")
    return worst


# --------------------------------------------------------------------------
# Phase 5: the engine (the serving path)
# --------------------------------------------------------------------------


def run_engine(cfg, params, seed, quantized_cache=False, label="engine",
               executor=None, layer_gemms=7):
    """Serve the 8 smoke requests; with quantized weights every model call
    must run layers × ``layer_gemms`` + 1 dynamic GEMMs (8 × 7 + 1 for the
    flagship, 8 × 8 + 1 for MLA), and none without."""
    requests = smoke_requests(cfg, seed)
    prompt_lens = [len(r.prompt) for r in requests]
    engine = ServingEngine(params, cfg, quantized_cache=quantized_cache,
                           executor=executor, device=DEV)
    for req in requests:
        engine.submit(req)
    paged_prefill_attention.launches = 0
    paged_decode_attention.launches = 0
    dyn_gemm.launches = 0
    t0 = time.perf_counter()
    outputs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_prefill": paged_prefill_attention.launches,
                "paged_decode": paged_decode_attention.launches}
    gemms = dyn_gemm.launches
    stats = engine.stats
    for rid in range(len(prompt_lens)):
        toks = outputs[rid]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{label}: request {rid} did not finish: "
                                 f"{toks}")
    want = {"paged_prefill": cfg.num_layers * stats["prefill_calls"],
            "paged_decode": cfg.num_layers * stats["decode_calls"]}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    calls = stats["prefill_calls"] + stats["decode_calls"]
    quantized_weights = not isinstance(params["unembed"], torch.Tensor)
    want_gemms = ((layer_gemms * cfg.num_layers + 1) * calls
                  if quantized_weights else 0)
    if gemms != want_gemms:
        raise AssertionError(f"{label}: {gemms} dyn_gemm launches, expected "
                             f"{want_gemms}")
    rates = {
        "prefill_tokens_per_s": stats["prefill_tokens"] / stats["prefill_s"],
        "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
    }
    log(f"{label} prompts: " + json.dumps(prompt_lens))
    log(f"{label} stats: " + json.dumps(stats))
    log(f"{label} rates: " + json.dumps(rates) + f" wall_s {wall:.3f}")
    log(f"{label} launches: " + json.dumps(launches) + " per model call: "
        + json.dumps({k: v / max(1, stats[c]) for (k, v), c in zip(
            launches.items(), ("prefill_calls", "decode_calls"))})
        + f"; dyn_gemm {gemms} ({gemms / max(1, calls):g} per model call)")
    if quantized_weights:
        launches["dyn_gemm"] = gemms
    return launches, stats, prompt_lens, rates


# --------------------------------------------------------------------------
# Phase 6: full-width fp32 gradients, kernels vs plain attention
# --------------------------------------------------------------------------


def fp32_copy(params):
    return {
        "embed": params["embed"].detach().float(),
        "unembed": params["unembed"].detach().float(),
        "ln_f": params["ln_f"].detach().clone(),
        "layers": [{k: v.detach().float().clone() for k, v in layer.items()}
                   for layer in params["layers"]],
    }


def check_train_grads(cfg, params, rng):
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = fp32_copy(params)
    leaves = trainable_parameters(params32)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 1025))).to(DEV)
    grads, losses = {}, {}
    for name, attn in (("kernels", None), ("plain", plain_attention)):
        for t in leaves:
            t.grad = None
        loss = loss_fn(params32, tokens, cfg32, attn_fn=attn)
        loss.backward()
        grads[name] = [t.grad.detach().clone() for t in leaves]
        losses[name] = loss.item()
    worst = max(rel_l2(g, p) for g, p in zip(grads["kernels"],
                                             grads["plain"]))
    log(f"full-width fp32 grads (B=2, S=1024): loss kernels "
        f"{losses['kernels']:.6f} plain {losses['plain']:.6f}; worst "
        f"parameter rel L2 {worst:.3e} (tol {GRAD_REL_L2_TOL})")
    if not worst <= GRAD_REL_L2_TOL:
        raise AssertionError(f"fp32 gradients disagree: {worst}")
    return worst


# --------------------------------------------------------------------------
# Phase 7: the training path
# --------------------------------------------------------------------------


def run_train(cfg, params, seed):
    tokens = train_tokens(cfg, seed, DEV)  # 4 x 2049: TRAIN_BATCH, TRAIN_SEQ
    optimizer = torch.optim.Adam(trainable_parameters(params), lr=3e-3)
    step = make_train_step(cfg, optimizer)
    state = optimizer.state
    flash_fwd.launches = flash_dq.launches = flash_dkv.launches = 0
    losses, t_first, t0 = [], 0.0, time.perf_counter()
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.launches, "flash_dq": flash_dq.launches,
                "flash_dkv": flash_dkv.launches}
    losses = [x.item() for x in losses]
    tokens_per_s = (TRAIN_STEPS - 1) * TRAIN_BATCH * TRAIN_SEQ / wall
    log("train losses: " + json.dumps(losses))
    log(f"train: first step {t_first:.3f} s; steps 2-{TRAIN_STEPS} "
        f"{wall:.3f} s, {wall / (TRAIN_STEPS - 1) * 1e3:.1f} ms/step, "
        f"{tokens_per_s:.0f} tokens/s")
    log("train launches: " + json.dumps(launches))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    want = cfg.num_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {want} "
                             "each")
    return launches, tokens_per_s


def check_train_determinism(cfg, init, seed, trained):
    """Phase 7's training, from its initial parameters ``init``, run twice
    more (``train_twice``): the two runs equal bit for bit after each step,
    and their final parameters equal phase 7's (``trained``)."""
    rows, final = train_twice(cfg, init, train_tokens(cfg, seed, DEV),
                              TRAIN_STEPS)
    digests = (params_digest(final), params_digest(trained))
    differ = [r for r in rows if r["params_differ"] or r["grads_differ"]
              or r["losses"][0] != r["losses"][1]]
    log(f"train determinism: two runs of {TRAIN_STEPS} steps from phase "
        f"7's initial parameters equal bit for bit after every step: "
        f"{not differ}; their final parameters equal phase 7's: "
        f"{digests[0] == digests[1]} (sha256 {digests[0][:16]})")
    if differ or digests[0] != digests[1]:
        raise AssertionError(f"training is not deterministic: {differ[:2]} "
                             f"{digests}")
    return {"steps": TRAIN_STEPS, "bitwise_equal": True,
            "params_sha256": digests[0]}


# --------------------------------------------------------------------------
# Phase 8: times at the engine's and the train step's shapes
# --------------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dense_kv(pool, row, n, pt):
    """One sequence's first n tokens of K and V, [Hkv, n, D]."""
    t = torch.arange(n, device=DEV)
    pidx = row.long()[t // pt]
    return pool[:, pidx, t % pt], pool[:, pidx, pt + t % pt]


def time_decode(rng, lengths, d=64):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray(lengths, np.int32)
    pool, table = paged_inputs(rng, lengths, hkv, d, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    kernel = lambda: paged_decode_attention(q, pool, table, ln,  # noqa: E731
                                            page_tokens=pt)
    plain = lambda: paged_decode_attention_plain(  # noqa: E731
        q, pool, table, ln, page_tokens=pt)
    s_max = int(lengths.max())
    k = torch.zeros(b, hkv, s_max, d, device=DEV, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    for i, n in enumerate(lengths):
        k[i, :, :n], v[i, :, :n] = dense_kv(pool, table[i], int(n), pt)
    mask = (torch.arange(s_max, device=DEV)[None, :]
            < ln[:, None].long()).view(b, 1, 1, s_max)
    q4 = q.view(b, hq, 1, d)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k, v, attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 100),
             "library_ms": time_ms(library, 100)}
    times["plain_ms_2"] = time_ms(plain, 10)
    times["ms_2"] = time_ms(kernel, 100)
    parent_turns(f"paged_decode D={d}", times, kernel, 100)
    live = int(lengths.sum())
    nbytes = (live * hkv * 2 * d * 2  # live K and V, bf16
              + 2 * b * hq * d * 2  # q in, out
              + table.numel() * 4 + b * 4)
    flops = 4 * hq * live * d
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    log(f"decode D={d} times at lengths {lengths.tolist()}: "
        + json.dumps(times)
        + f" bound {bound[by]:.5f} ms by {by}")
    return times, bound[by], by


def time_prefill(rng, offset):
    hq, hkv, d, pt, chunk, num_pages, max_pages = 16, 4, 64, 256, 256, 64, 16
    pool, table = paged_inputs(rng, [offset + chunk], hkv, d, pt, num_pages,
                               max_pages)
    row = table[0].contiguous()
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    kernel = lambda: paged_prefill_attention(q, pool, row, offset,  # noqa
                                             page_tokens=pt)
    plain = lambda: paged_prefill_attention_plain(  # noqa: E731
        q, pool, row, offset, page_tokens=pt)
    n = offset + chunk
    k, v = dense_kv(pool, row, n, pt)
    mask = (torch.arange(n, device=DEV)[None, :]
            <= offset + torch.arange(chunk, device=DEV)[:, None])
    q4, k4, v4 = q[None], k[None], v[None]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 50),
             "library_ms": time_ms(library, 50)}
    times["plain_ms_2"] = time_ms(plain, 10)
    times["ms_2"] = time_ms(kernel, 50)
    parent_turns(f"paged_prefill offset {offset}", times, kernel, 50)
    # What this chunk needs: row c sees offset + c + 1 columns.
    visible = chunk * offset + chunk * (chunk + 1) // 2
    flops = 4 * hq * d * visible
    nbytes = n * hkv * 2 * d * 2 + 2 * hq * chunk * d * 2 + row.numel() * 4
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    log(f"prefill times at offset {offset}: " + json.dumps(times)
        + f" bound {bound[by]:.5f} ms by {by}")
    return times, bound[by], by


def bound_of(flops: float, nbytes: float):
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def time_flash(rng, b=TRAIN_BATCH, hq=16, hkv=4, s=TRAIN_SEQ, d=64):
    """Forward, dQ and dK/dV at the train step's attention shapes (or the
    ones given; bf16, causal), beside their plain versions and SDPA."""
    q, k, v, do, _ = flash_inputs(rng, b, hq, hkv, s, s, d, torch.bfloat16)
    rr = row_ranges_tensor(masking.CAUSAL, s, s, None, DEV)
    kw = dict(scale=d ** -0.5)
    o, lse = flash_fwd(q, k, v, rr, **kw)
    di = (do.float() * o).sum(-1)
    bwd_args = (q, k, v, do, lse, di, rr)
    fns = {
        "flash_fwd": (lambda: flash_fwd(q, k, v, rr, **kw),
                      lambda: flash_attention_forward_plain(q, k, v, rr,
                                                            **kw)),
        "flash_dq": (lambda: flash_dq(*bwd_args, **kw),
                     lambda: flash_attention_dq_plain(*bwd_args, **kw)),
        "flash_dkv": (lambda: flash_dkv(*bwd_args, **kw),
                      lambda: flash_attention_dkv_plain(*bwd_args, **kw)),
    }
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         enable_gqa=True)
    library = {
        "fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
        "bwd": time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 20),
    }
    pairs = b * hq * s * (s + 1) // 2  # (query, key) pairs causal keeps
    elems_q, elems_kv, rows = b * hq * s * d, b * hkv * s * d, b * hq * s
    read_bwd = 2 * (2 * elems_q + 2 * elems_kv) + 2 * 4 * rows + 8 * s
    work = {  # (flops, bytes) from the kernels' GEMM counts and I/O
        "flash_fwd": (4 * d * pairs,
                      2 * (elems_q + 2 * elems_kv) + 8 * s
                      + 4 * (elems_q + rows)),
        "flash_dq": (6 * d * pairs, read_bwd + 4 * elems_q),
        "flash_dkv": (8 * d * pairs, read_bwd + 4 * 2 * elems_kv),
    }
    times = {}
    for name, (kernel, plain) in fns.items():
        t = {"plain_ms": time_ms(plain, 3, warmup=1),
             "ms": time_ms(kernel, 10, warmup=2)}
        t["plain_ms_2"] = time_ms(plain, 3, warmup=0)
        t["ms_2"] = time_ms(kernel, 10, warmup=0)
        t["library_ms"] = library["fwd" if name == "flash_fwd" else "bwd"]
        t["bound_ms"], t["bound_by"] = bound_of(*work[name])
        t["body"] = {"flash_fwd": fwd_body, "flash_dq": dq_body,
                     "flash_dkv": dkv_body}[name](q.dtype, d)
        log(f"{name} at D={d} runs the {t['body']} body")
        parent_turns(f"{name} B={b} S={s} D={d}", t, kernel, 10)
        times[name] = t
        log(f"{name} times at B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal "
            "bf16: " + json.dumps(t))
    return times


# --------------------------------------------------------------------------
# Phase 9: the quantized serving slice
# --------------------------------------------------------------------------

W8_CFG = QuantConfig(bits=8, granularity=QuantGranularity.ROW)
W4_CFG = QuantConfig(bits=4, granularity=QuantGranularity.ROW)


def device_generator(rng):
    """A generator on the card seeded from ``rng``: the large inputs of
    phase 9 are drawn there, not on the host."""
    return torch.Generator(device=DEV).manual_seed(int(rng.integers(2**62)))


def gemm_operands(rng, m, n, k, cfg, with_c=False):
    """bf16 activations [M, K] quantized per row, a random weight [N, K]
    quantized with ``cfg``: the kernel's arguments."""
    g = device_generator(rng)
    a = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=DEV)
    wq = quantize(w * k ** -0.5, cfg)
    qa, sa, rs = quantize_rows(a)
    sb, zb = weight_scales(wq)
    c = torch.randn((m, n), generator=g, device=DEV) if with_c else None
    return (qa, wq.data, sa, rs, sb, zb), dict(bits=cfg.bits, c=c)


def check_dyn_gemm(rng):
    """(a) The GEMM kernel against its plain version, bit for bit, at every
    (N, K) of the flagship and of MLAConfig() (N=32 is less than one
    64-column tile), M in {8, 256, 1}, int8 and int4 ROW symmetric
    weights; plus CENTERED ROW, TENSOR and c= cases.  → max abs error."""
    shapes = sorted(set(PROJ_SHAPES.values()) | set(MLA_PROJ_SHAPES.values())
                    | {UNEMBED_SHAPE})
    cases = [(m, n, k, cfg, False) for m in (8, 256, 1) for n, k in shapes
             for cfg in (W8_CFG, W4_CFG)]
    cases += [
        (256, 4096, 1024, QuantConfig(
            bits=8, granularity=QuantGranularity.ROW,
            strategy=QuantStrategy.CENTERED), False),
        (8, 1024, 4096, QuantConfig(bits=8), False),  # TENSOR symmetric
        (256, 1024, 1024, W8_CFG, True),
    ]
    worst = 0.0
    for m, n, k, cfg, with_c in cases:
        args, kw = gemm_operands(rng, m, n, k, cfg, with_c)
        out = dyn_gemm(*args, **kw)
        torch.cuda.synchronize()
        ref = dyn_gemm_plain(*args, **kw)
        err = max_abs(out, ref)
        worst = max(worst, err)
        if not torch.equal(out, ref):
            raise AssertionError(
                f"dyn_gemm M={m} N={n} K={k} {cfg.bits}-bit "
                f"{cfg.granularity.value} {cfg.strategy.value} c={with_c} "
                f"differs from its plain version: max abs {err}")
    log(f"dyn_gemm: {len(cases)} cases (M 8/256/1 x {len(shapes)} shapes x "
        "int8/int4 ROW, CENTERED, TENSOR, c=) bit-identical to the plain "
        f"version (max abs {worst})")
    return worst


def quantized_pool(rng, bits, hkv, d, pt, num_pages):
    """A random int8 pool (int8 halves [.., 2PT, D] or the int4 byte
    [.., PT, D]: every byte value) and per-token scales around 1/127
    (int8) or 1/7 (int4)."""
    rows = pt if bits == 4 else 2 * pt
    g = device_generator(rng)
    pool = torch.randint(-128, 128, (hkv, num_pages + 1, rows, d),
                         generator=g, device=DEV).to(torch.int8)
    step = 7.0 if bits == 4 else 127.0
    ks, vs = ((torch.rand((hkv, num_pages + 1, 1, pt), generator=g,
                          device=DEV) * 1.5 + 0.5) / step for _ in range(2))
    return pool, dict(k_scales=ks, v_scales=vs, kv_bits=bits)


def check_decode_quantized(rng, d, bits):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    table = page_tables(rng, lengths, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    out = paged_decode_attention(q, pool, table, ln, page_tokens=pt, **kw)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q, pool, table, ln, page_tokens=pt,
                                       **kw)
    err = max_abs(out, ref)
    log(f"decode int{bits} D={d}: max abs err {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged decode int{bits} D={d} disagrees: {err}")
    return err


def check_prefill_quantized(rng, offset, bits):
    hq, hkv, d, pt, chunk, num_pages, max_pages = 16, 4, 64, 256, 256, 64, 16
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    row = page_tables(rng, [offset + chunk], pt, num_pages, max_pages)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    out = paged_prefill_attention(q, pool, row, offset, page_tokens=pt, **kw)
    torch.cuda.synchronize()
    ref = paged_prefill_attention_plain(q, pool, row, offset, page_tokens=pt,
                                        **kw)
    err = max_abs(out, ref)
    log(f"prefill int{bits} offset={offset}: max abs err {err:.3e} "
        f"(tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged prefill int{bits} offset={offset} "
                             f"disagrees: {err}")
    return err


def dequantized_fp32(qparams):
    """The fp32 oracle's weights: each quantized projection dequantized and
    transposed back to [in, out], the float leaves in fp32."""
    def w(t):
        if isinstance(t, QuantizedTensor):
            return dequantize(t).t().contiguous()
        return t.float()

    return {
        "embed": qparams["embed"].float(),
        "unembed": w(qparams["unembed"]),
        "ln_f": qparams["ln_f"],
        "layers": [{k: w(v) for k, v in layer.items()}
                   for layer in qparams["layers"]],
    }


def gemm_bound(m, n, k, bits, with_c=False):
    """(ms, by) of one dynamic GEMM: int8 operations over the int8 peak, or
    its bytes (int8 A, the weight payload, scales and sums, fp32 out) over
    the memory rate."""
    nbytes = (m * k + n * k * bits // 8 + 8 * (m + n) + 4 * m * n
              + (4 * m * n if with_c else 0))
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": 2 * m * n * k / INT8_OPS * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def time_dyn_gemm(rng, m, cfg):
    """One model call's 57 GEMMs (8 × the 7 projections at M rows, the
    unembedding at 1 row in a prefill chunk, M rows in decode): kernel and
    plain times, the summed bound, and two library yardsticks:
    ``torch._int_mm`` on the same int8 operands (M padded to 32 where
    M ≤ 16, as its shape rules ask; int4 weights unpacked to int8 first) and
    ``torch.matmul`` of bf16 activations by the dequantized bf16 weights."""
    m_unembed = 1 if m > 8 else m
    work = [(8, m, n, k) for n, k in PROJ_SHAPES.values()]
    work.append((1, m_unembed, *UNEMBED_SHAPE))
    ops = []
    for count, mm, n, k in work:
        args, kw = gemm_operands(rng, mm, n, k, cfg)
        qa, qb = args[0], args[1]
        wi8 = unpack_int4(qb) if cfg.bits == 4 else qb
        pad = qa if mm > 16 else torch.cat([qa, qa.new_zeros(32 - mm, k)])
        wb = (wi8.float() * args[4][:, None]).to(torch.bfloat16).t()
        wb = wb.contiguous()
        ab = torch.from_numpy(rng.standard_normal((mm, k), np.float32)).to(
            DEV, torch.bfloat16)
        ops.append((count, args, kw, pad, wi8.t(), ab, wb))

    def run(fn):
        def go():
            for count, *rest in ops:
                for _ in range(count):
                    fn(*rest)
        return go

    kernel = run(lambda args, kw, *_: dyn_gemm(*args, **kw))
    plain = run(lambda args, kw, *_: dyn_gemm_plain(*args, **kw))
    int_mm = run(lambda args, kw, pad, wt, *_: torch._int_mm(pad, wt))
    bf16 = run(lambda args, kw, pad, wt, ab, wb: ab @ wb)
    t = {"plain_ms": time_ms(plain, 2, warmup=1), "ms": time_ms(kernel, 10),
         "library_ms": time_ms(int_mm, 10),
         "library_bf16_matmul_ms": time_ms(bf16, 10)}
    t["plain_ms_2"] = time_ms(plain, 2, warmup=0)
    t["ms_2"] = time_ms(kernel, 10)
    parent_turns(f"dyn_gemm W{cfg.bits}A8 57 GEMMs at M={m}", t, kernel, 10)
    bounds = [(count, gemm_bound(mm, n, k, cfg.bits))
              for count, mm, n, k in work]
    t["bound_ms"] = sum(count * b for count, (b, _) in bounds)
    by_bytes = sum(count * b for count, (b, by) in bounds if by == "bytes")
    t["bound_by"] = ("bytes" if by_bytes >= t["bound_ms"] / 2
                     else "operations")
    log(f"dyn_gemm W{cfg.bits}A8 times, one model call at M={m} (57 "
        "launches): " + json.dumps(t))
    return t


def dense_kv_quantized(pool, kw, row, n, pt):
    """One sequence's first n tokens of K and V dequantized to bf16."""
    t = torch.arange(n, device=DEV)
    pidx, off = row.long()[t // pt], t % pt
    if kw["kv_bits"] == 4:
        k, v = unpack_kv4(pool[:, pidx, off])
    else:
        k, v = pool[:, pidx, off], pool[:, pidx, pt + off]
    ks = kw["k_scales"][:, :, 0][:, pidx, off]
    vs = kw["v_scales"][:, :, 0][:, pidx, off]
    return ((k.float() * ks[..., None]).to(torch.bfloat16),
            (v.float() * vs[..., None]).to(torch.bfloat16))


def kv_token_bytes(bits, hkv, d):
    """Live cache bytes per token: K and V payloads and two fp32 scales
    per KV head."""
    return hkv * (2 * d * bits // 8 + 8)


def time_decode_quantized(rng, lengths, bits, d=64):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray(lengths, np.int32)
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    table = page_tables(rng, lengths, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    kernel = lambda: paged_decode_attention(  # noqa: E731
        q, pool, table, ln, page_tokens=pt, **kw)
    plain = lambda: paged_decode_attention_plain(  # noqa: E731
        q, pool, table, ln, page_tokens=pt, **kw)
    s_max = int(lengths.max())
    k = torch.zeros(b, hkv, s_max, d, device=DEV, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    for i, n in enumerate(lengths):
        k[i, :, :n], v[i, :, :n] = dense_kv_quantized(pool, kw, table[i],
                                                      int(n), pt)
    mask = (torch.arange(s_max, device=DEV)[None, :]
            < ln[:, None].long()).view(b, 1, 1, s_max)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.view(b, hq, 1, d), k, v, attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 100),
             "library_ms": time_ms(library, 100)}
    times["ms_2"] = time_ms(kernel, 100)
    live = int(lengths.sum())
    nbytes = (live * kv_token_bytes(bits, hkv, d) + 2 * b * hq * d * 2
              + table.numel() * 4 + b * 4)
    times["bound_ms"], times["bound_by"] = bound_of(4 * hq * live * d,
                                                    nbytes)
    log(f"decode int{bits} D={d} times at lengths {lengths.tolist()}: "
        + json.dumps(times))
    return times


def time_prefill_quantized(rng, offset, bits):
    hq, hkv, d, pt, chunk, num_pages, max_pages = 16, 4, 64, 256, 256, 64, 16
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    row = page_tables(rng, [offset + chunk], pt, num_pages, max_pages)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    kernel = lambda: paged_prefill_attention(  # noqa: E731
        q, pool, row, offset, page_tokens=pt, **kw)
    plain = lambda: paged_prefill_attention_plain(  # noqa: E731
        q, pool, row, offset, page_tokens=pt, **kw)
    n = offset + chunk
    k, v = dense_kv_quantized(pool, kw, row, n, pt)
    mask = (torch.arange(n, device=DEV)[None, :]
            <= offset + torch.arange(chunk, device=DEV)[:, None])
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 50),
             "library_ms": time_ms(library, 50)}
    times["ms_2"] = time_ms(kernel, 50)
    visible = chunk * offset + chunk * (chunk + 1) // 2
    nbytes = (n * kv_token_bytes(bits, hkv, d) + 2 * hq * chunk * d * 2
              + row.numel() * 4)
    times["bound_ms"], times["bound_by"] = bound_of(4 * hq * d * visible,
                                                    nbytes)
    log(f"prefill int{bits} times at offset {offset}: " + json.dumps(times))
    return times


def quantized_logits_at_init(cfg, params, seed):
    """Phase 9 (c) on the random-init weights, reported without a gate
    (run before phase 7 trains ``params`` in place).  Their logits are
    nearly flat, so the int4 pool's noise weighs far more in the relative
    L2 than it does on the trained weights that (c) gates."""
    out = {}
    with torch.inference_mode():
        for bits, wcfg in ((8, W8_CFG), (4, W4_CFG)):
            qparams = quantize_weights(params, wcfg)
            out[f"w{bits}a8+int{bits}"] = check_logits(
                cfg, qparams, np.random.default_rng(seed + 2),
                params32=dequantized_fp32(qparams), quantized=bits,
                tol=None, label=f"random-init w{bits}a8+int{bits}")
            del qparams
    return out


def run_quantized(cfg, params, seed, rng, dec_lens):
    """Phase 9 (a)-(e) → the record's quantized fields.  ``params`` are the
    flagship's weights after phase 7's 8 Adam steps.  The logits checks
    draw their token sequences from a generator of their own (seed + 2),
    so they see the same tokens whatever the kernel checks draw."""
    out = {"errors": {}, "logits_rel_l2": {}, "engines": {}, "times": {}}
    phase = {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["errors"]["dyn_gemm"] = check_dyn_gemm(rng)
        for bits in (8, 4):
            out["errors"][f"decode_int{bits}"] = max(
                check_decode_quantized(rng, d, bits) for d in (64, 128))
            out["errors"][f"prefill_int{bits}"] = max(
                check_prefill_quantized(rng, off, bits)
                for off in (0, 300, 512))
    phase["quant_kernels"] = time.perf_counter() - t
    for bits, wcfg in ((8, W8_CFG), (4, W4_CFG)):
        label = f"w{bits}a8+int{bits}"
        t = time.perf_counter()
        with torch.inference_mode():
            qparams = quantize_weights(params, wcfg)
            out["logits_rel_l2"][label] = check_logits(
                cfg, qparams, np.random.default_rng(seed + 2),
                params32=dequantized_fp32(qparams),
                quantized=bits, tol=QUANT_LOGITS_TOL[bits], label=label)
        phase[f"logits_{label}"] = time.perf_counter() - t
        t = time.perf_counter()
        launches, stats, _, rates = run_engine(
            cfg, qparams, seed, quantized_cache=bits, label=f"engine {label}")
        out["engines"][label] = {"launches": launches, "rates": rates,
                                 "model_calls": stats["prefill_calls"]
                                 + stats["decode_calls"]}
        phase[f"engine_{label}"] = time.perf_counter() - t
        del qparams
    t = time.perf_counter()
    with torch.inference_mode():
        for bits, wcfg in ((8, W8_CFG), (4, W4_CFG)):
            for m in (8, 256):
                out["times"][f"dyn_gemm_w{bits}_m{m}"] = time_dyn_gemm(
                    rng, m, wcfg)
            out["times"][f"decode_int{bits}"] = time_decode_quantized(
                rng, dec_lens, bits)
            out["times"][f"prefill_int{bits}"] = time_prefill_quantized(
                rng, 512, bits)
    phase["quant_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 10: the quantized-attention slice
# --------------------------------------------------------------------------

# The flagship's attention shapes (B=2 sequences of 2048 tokens).
ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_D = 2, 16, 4, 2048, 64
QFWD_TOKENS = (2, 2048)  # the fully quantized forward's batch
# The fully quantized forward and the facade vs their fp32 oracles,
# relative L2: the int8 gate (weights, activations, Q and K/V in int8),
# the JAX facade test's 0.05, and the int4 gate.
QFWD_LOGITS_TOL = TOLERANCES["int8_rel"]
FACADE_TOL = {8: 0.05, 4: TOLERANCES["int4_rel"]}


def qcfg(bits=8, gran="row", strategy="symmetric", **kw):
    return QuantConfig(bits=bits, granularity=QuantGranularity(gran),
                       strategy=QuantStrategy(strategy), **kw)


def attn_inputs(rng, b, hq, hkv, sq, skv, d, dtype=torch.bfloat16):
    """bf16 Q and K/V (the float K/V as the model makes them) drawn on the
    card."""
    g = device_generator(rng)
    return tuple(torch.randn(shape, generator=g, device=DEV).to(dtype)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))


def check_pair(label, kernel, plain):
    """A kernel's (O, L) against its plain version's → (rel err of O, rel
    err of L, max abs err of O); raises past the flash kernels' bf16
    gates."""
    (o, lse), (o_ref, l_ref) = kernel, plain
    errs = (rel_err(o, o_ref), rel_err(lse, l_ref), max_abs(o, o_ref))
    log(f"{label}: o {errs[0]:.2e} l {errs[1]:.2e} (max abs {errs[2]:.2e})")
    if not (errs[0] <= FLASH_TOL[torch.bfloat16]
            and errs[1] <= LSE_TOL[torch.bfloat16]):
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{errs}")
    return errs


def main_path_tile(kw, skv, block_sizes=BlockSizes()):
    """The key span ``quantized_flash_attention_forward`` hands the kernel:
    the TPU's resolved ``block_kv`` where P is int8, else None (the
    kernel's 64-key tiles)."""
    return int8_p_tile(block_sizes, skv) if kw["mode"].p_int8 else None


def check_qattn(rng, label, b, hq, hkv, sq, skv, d, kcfg, vcfg,
                mask=masking.CAUSAL, bias_shape=None, **opts):
    q, k, v = attn_inputs(rng, b, hq, hkv, sq, skv, d)
    if bias_shape is not None:
        opts["bias"] = torch.randn(bias_shape, device=DEV,
                                   generator=device_generator(rng))
    args, kw = qattn_arguments(q, quantize(k.float(), kcfg),
                               quantize(v.float(), vcfg), mask=mask, **opts)
    tile = main_path_tile(kw, skv)
    out = qattn_fwd(*args, **kw, kv_tile=tile)
    torch.cuda.synchronize()
    return check_pair(f"qattn_fwd {label}", out,
                      qattn_fwd_plain(*args, **kw, kv_tile=tile or KV_TILE))


def check_qattn_all(rng):
    """(a) The quantized forward kernel in each mode: the flagship shapes,
    then small ones.  → {label: errors}."""
    shapes = (ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S, ATTN_D)
    row8, row8c, row4c = qcfg(), qcfg(strategy="centered"), qcfg(
        bits=4, strategy="centered")
    ten8, ch8 = qcfg(gran="tensor"), qcfg(gran="channel")
    b2d = qcfg(gran="block_2d", strategy="centered", block_rows=4,
               block_size=32)
    b2d48 = qcfg(gran="block_2d", strategy="centered", block_rows=4,
                 block_size=48)
    errs = {
        "quantize_q_row": check_qattn(rng, "quantize_q ROW (flagship)",
                                      *shapes, row8, row8, quantize_q=True),
        "dequant_row8c": check_qattn(rng, "dequant ROW CENTERED int8 "
                                     "(flagship)", *shapes, row8c, row8c),
        "dequant_row4c": check_qattn(rng, "dequant ROW CENTERED int4 "
                                     "(flagship)", *shapes, row4c, row4c),
        "folded_tensor": check_qattn(rng, "folded TENSOR (flagship)",
                                     *shapes, ten8, ten8),
        "folded_row": check_qattn(rng, "folded ROW (flagship)", *shapes,
                                  row8, row8),
    }
    small = (2, 8, 2, 300, 300)
    cases = [  # (label, head dim, K, V, options)
        ("int8_pv CHANNEL V", 64, row8, ch8, dict(quantize_q=True)),
        ("int8_pv TENSOR V", 64, ten8, ten8, dict(quantize_q=True)),
        ("BLOCK_2D", 64, b2d, b2d, {}),
        ("bias", 64, row8c, row8c, dict(bias_shape=(1, 8, 300, 300))),
        ("window-causal", 64, row8c, row8c,
         dict(mask=masking.sliding_window(96, causal=True))),
        ("interleaved", 64, row8c, row8c, dict(interleaved_kv=True)),
        ("d128", 128, row8c, row8c, {}),
        # Head dims run zero-padded to the next built width.
        ("quantize_q d80", 80, row8, row8, dict(quantize_q=True)),
        ("int4 ROW CENTERED d96", 96, row4c, row4c, {}),
        ("folded CHANNEL d96", 96, ch8, ch8, {}),
        ("BLOCK_2D 48 d96", 96, b2d48, b2d48, {}),
    ]
    for label, d, kcfg, vcfg, opts in cases:
        errs[label] = check_qattn(rng, label, *small, d, kcfg, vcfg, **opts)
    errs["ragged"] = check_qattn(rng, "ragged Sq=125 < Skv=1000", 1, 4, 4,
                                 125, 1000, 64, row8c, row8c)
    return errs


def check_hpack_all(rng):
    """(b) The head-pair kernel at the flagship shapes in the packed
    layout, int8 and int4 CHANNEL scales, causal and full."""
    errs = {}
    for bits in (8, 4):
        cfg = qcfg(bits=bits, gran="channel")
        for mask, name in ((masking.CAUSAL, "causal"), (masking.FULL, "full")):
            q, k, v = attn_inputs(rng, ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S,
                                  ATTN_S, ATTN_D)
            args, kw = hpack_arguments(pack_heads(q), quantize(k.float(), cfg),
                                       quantize(v.float(), cfg), mask=mask)
            out = hpack_fwd(*args, **kw)
            torch.cuda.synchronize()
            errs[f"int{bits}_{name}"] = check_pair(
                f"hpack_fwd int{bits} {name} (flagship, packed)", out,
                hpack_fwd_plain(*args, **kw))
    return errs


def check_runtime_quantization(rng):
    """(c) Both runtime quantization kernels against their plain versions,
    bit for bit: the row kernel on the facade's K/V rows ([2·4·2048, 64]
    bf16) in each strategy, the block kernel on a [4096, 1024] bf16
    activation at bs 64 in each strategy and at bs 128 (CENTERED, int8
    and int4).  → the number of outputs compared."""
    g = device_generator(rng)
    rows = (torch.randn((ATTN_B * ATTN_HKV * ATTN_S, ATTN_D), generator=g,
                        device=DEV) * 2 + 0.3).to(torch.bfloat16)
    act = (torch.randn((4096, 1024), generator=g, device=DEV) * 2
           + 0.3).to(torch.bfloat16)
    cases = [("row", s, 8, None) for s in QuantStrategy]
    cases += [("block", s, 8, 64) for s in QuantStrategy]
    cases += [("block", QuantStrategy.CENTERED, bits, 128) for bits in (8, 4)]
    for kind, strategy, bits, bs in cases:
        if kind == "row":
            got = rtq.rtq_rows(rows, strategy, bits, True)
            torch.cuda.synchronize()
            want = rtq.rtq_rows_plain(rows, strategy, bits, True)
        else:
            got = rtq.rtq_blocks(act, bs, strategy, bits, True)
            torch.cuda.synchronize()
            want = rtq.rtq_blocks_plain(act, bs, strategy, bits, True)
        for name, a, b in zip(("codes", "scale", "zero point", "sums"),
                              got, want):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"runtime quantization {kind} {strategy.value} int{bits}"
                    f" bs={bs}: {name} differs from the plain version")
    log(f"runtime quantization: {len(cases)} cases (rows [16384, 64]: 3 "
        "strategies; blocks [4096, 1024]: bs 64 x 3 strategies, bs 128 "
        "int8/int4) bit-identical to the plain versions")
    return len(cases)


def run_quantized_attention_forward(cfg, qparams, seed, packed, tol, label):
    """(d) ``quantized_forward(..., quantize_kv=True)`` on QFWD_TOKENS
    tokens with the launch counts set to 0 just before and read after, against
    the fp32 ``forward`` on the dequantized weights (plain attention, no
    kernel); ``tol=None`` reports without a gate."""
    tokens = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, QFWD_TOKENS)).to(DEV)
    qattn_fwd.launches = hpack_fwd.launches = dyn_gemm.launches = 0
    t0 = time.perf_counter()
    logits = quantized_forward(qparams, tokens, cfg, quantize_kv=True,
                               packed_d64=None if packed else False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qattn_fwd": qattn_fwd.launches,
                "hpack_fwd": hpack_fwd.launches,
                "dyn_gemm": dyn_gemm.launches}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = forward(dequantized_fp32(qparams), tokens, cfg32,
                  attn_fn=plain_attention)
    err = rel_l2(logits, ref)
    finite = bool(torch.isfinite(logits).all())
    del ref
    log(f"{label}: logits rel L2 {err:.3e} "
        f"({'not gated' if tol is None else f'tol {tol}'}), "
        f"{wall:.3f} s, launches " + json.dumps(launches))
    want = {"qattn_fwd": 0 if packed else cfg.num_layers,
            "hpack_fwd": cfg.num_layers if packed else 0,
            "dyn_gemm": 7 * cfg.num_layers + 1}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, expected "
                             f"{want}")
    if tuple(logits.shape) != (*QFWD_TOKENS, cfg.vocab_size) or not finite:
        raise AssertionError(f"{label}: logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    if tol is not None and not err <= tol:
        raise AssertionError(f"{label}: logits disagree with the oracle: "
                             f"{err}")
    return err, launches


def run_quantized_attention_forwards(cfg, params, seed, tol, tag):
    """(d) packed (auto) and unpacked, W8A8 weights of ``params``."""
    out = {}
    with torch.inference_mode():
        qparams = quantize_weights(params, W8_CFG)
        for packed in (True, False):
            name = "packed" if packed else "unpacked"
            out[name] = run_quantized_attention_forward(
                cfg, qparams, seed, packed, tol,
                f"{tag} quantized_forward(quantize_kv=True) {name}")
        del qparams
    return out


def run_facade(rng):
    """(e) ``QuantizedAttention`` at the flagship attention shapes, int8
    CENTERED and int4 with the Hadamard rotation, causal, against the dense
    fp32 attention over the float K/V, with the launch counts set to 0
    just before each call and read after."""
    q, k, v = attn_inputs(rng, ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S,
                          ATTN_D)
    ref = reference_attention(q.float(), k.float(), v.float(),
                              mask=masking.CAUSAL)[0]
    out = {}
    for bits, hadamard in ((8, False), (4, True)):
        facade = QuantizedAttention(
            config=QuantizedAttentionConfig(key_bits=bits, value_bits=bits,
                                            hadamard=hadamard),
            mask=masking.CAUSAL)
        rtq.rtq_rows.launches = qattn_fwd.launches = 0
        with torch.inference_mode():
            o = facade(q, k, v)
        torch.cuda.synchronize()
        launches = {"runtime_quantize_row": rtq.rtq_rows.launches,
                    "qattn_fwd": qattn_fwd.launches}
        err = rel_l2(o, ref)
        label = f"QuantizedAttention int{bits}" + (" hadamard" if hadamard
                                                   else " CENTERED")
        log(f"{label}: O rel L2 {err:.3e} (tol {FACADE_TOL[bits]}), "
            "launches " + json.dumps(launches))
        if launches != {"runtime_quantize_row": 2, "qattn_fwd": 1}:
            raise AssertionError(f"{label}: launch counts {launches}")
        if o.shape != q.shape or not err <= FACADE_TOL[bits]:
            raise AssertionError(f"{label}: O rel L2 {err}")
        out[f"int{bits}"] = (err, launches)
    return out


def run_block_quantizer(rng):
    """The block kernel's entry point: ``runtime_quantize`` of a [4096,
    1024] bf16 activation with the blockwise-centered configuration at bs
    64 and 128, the launch count set to 0 just before and read after."""
    act = torch.randn((4096, 1024), generator=device_generator(rng),
                      device=DEV).to(torch.bfloat16)
    rtq.rtq_blocks.launches = 0
    for bs in (64, 128):
        t = rtq.runtime_quantize(act, int8_blockwise(bs))
        if tuple(t.data.shape) != (4096, 1024) or t.scale.shape != (
                1, 1024 // bs):
            raise AssertionError(f"runtime_quantize bs={bs}: shapes "
                                 f"{tuple(t.data.shape)} {tuple(t.scale.shape)}")
    torch.cuda.synchronize()
    launches = rtq.rtq_blocks.launches
    log(f"runtime_quantize(int8_blockwise(64 | 128)) on [4096, 1024]: "
        f"{launches} block-kernel launches")
    if launches != 2:
        raise AssertionError(f"block kernel launches {launches}, expected 2")
    return launches


def attn_bound(pairs, ops_int8, ops_bf16, nbytes):
    """(ms, by): bytes over the memory rate, or int8 and bf16 products over
    their peaks, whichever is larger."""
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": (ops_int8 * pairs / INT8_OPS
                            + ops_bf16 * pairs / BF16_FLOPS) * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def dequantized_bf16(t):
    return dequantize(t).to(torch.bfloat16)


def time_quantized_attention(rng):
    """(f) Kernel, plain and library times of the four kernels at the
    shapes above: the quantized forward in the unpacked model's mode
    (quantize_q, ROW K/V) and in the facade's (ROW CENTERED), the
    head-pair kernel in the packed model's (CHANNEL, causal), the row
    kernel on the facade's K/V rows and the block kernel on a [4096, 1024]
    activation at bs 64.  Library: SDPA over the dequantized bf16 K/V for
    attention; none for runtime quantization."""
    b, hq, hkv, s, d = ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_D
    pairs = b * hq * s * (s + 1) // 2
    q, k, v = attn_inputs(rng, b, hq, hkv, s, s, d)
    out_bytes = 4 * b * hq * s * d + 4 * b * hq * s + 8 * s  # O, L, ranges
    kv_bytes = 2 * b * hkv * s * d  # int8 K and V payloads
    times = {}

    def timed(name, kernel, plain, library, bound, extra=None):
        t = {"plain_ms": time_ms(plain, 2, warmup=1),
             "ms": time_ms(kernel, 10, warmup=2)}
        t["plain_ms_2"] = time_ms(plain, 2, warmup=0)
        t["ms_2"] = time_ms(kernel, 10, warmup=0)
        t["library_ms"] = None if library is None else time_ms(library, 10)
        parent_turns(name, t, kernel, 10)
        t["bound_ms"], t["bound_by"] = bound
        t.update(extra or {})
        log(f"{name} times: " + json.dumps(t))
        return t

    def sdpa(kq, vq):
        kd, vd = dequantized_bf16(kq), dequantized_bf16(vq)
        return lambda: F.scaled_dot_product_attention(
            q, kd, vd, is_causal=True, enable_gqa=True)

    row8, row8c = qcfg(), qcfg(strategy="centered")
    kq, vq = quantize(k.float(), row8), quantize(v.float(), row8)
    args, kw = qattn_arguments(q, kq, vq, mask=masking.CAUSAL,
                               quantize_q=True)
    tile = main_path_tile(kw, s)
    body = qattn_body(args[0].dtype, kw["mode"])
    log(f"qattn_fwd quantize_q ROW runs the {body} body")
    times["qattn_fwd"] = timed(
        "qattn_fwd quantize_q ROW (B=2 Hq=16 Hkv=4 S=2048 D=64 causal)",
        lambda: qattn_fwd(*args, **kw, kv_tile=tile),
        lambda: qattn_fwd_plain(*args, **kw, kv_tile=tile),
        sdpa(kq, vq),
        attn_bound(pairs, 2 * d, 2 * d,
                   b * hq * s * d + 4 * b * hq * s + kv_bytes
                   + 12 * b * hkv * s + out_bytes), {"body": body})
    kq, vq = quantize(k.float(), row8c), quantize(v.float(), row8c)
    args, kw = qattn_arguments(q, kq, vq, mask=masking.CAUSAL)
    log("qattn_fwd dequant ROW CENTERED runs the "
        f"{qattn_body(args[0].dtype, kw['mode'])} body")
    facade_t = timed(
        "qattn_fwd dequant ROW CENTERED (the facade's mode)",
        lambda: qattn_fwd(*args, **kw), lambda: qattn_fwd_plain(*args, **kw),
        sdpa(kq, vq),
        attn_bound(pairs, 0, 4 * d, 2 * b * hq * s * d + kv_bytes
                   + 16 * b * hkv * s + out_bytes))
    times["qattn_fwd"].update({f"{key}_facade_mode": facade_t[key] for key in
                               ("ms", "plain_ms", "library_ms", "bound_ms",
                                "parent_turns_ms") if key in facade_t})
    ch8 = qcfg(gran="channel")
    kq, vq = quantize(k.float(), ch8), quantize(v.float(), ch8)
    args, kw = hpack_arguments(pack_heads(q), kq, vq, mask=masking.CAUSAL)
    body = qattn_body(args[0].dtype, QAttnMode("none", "store"), packed=True)
    log(f"hpack_fwd ({args[0].dtype} packed Q) runs the {body} body")
    times["hpack_fwd"] = timed(
        "hpack_fwd int8 CHANNEL causal (packed, the packed model's mode)",
        lambda: hpack_fwd(*args, **kw), lambda: hpack_fwd_plain(*args, **kw),
        sdpa(kq, vq),
        attn_bound(pairs, 0, 4 * d, 2 * b * hq * s * d + kv_bytes
                   + 4 * b * hkv * d + out_bytes), {"body": body})
    g = device_generator(rng)
    rows = torch.randn((b * hkv * s, d), generator=g, device=DEV).to(
        torch.bfloat16)
    centered = QuantStrategy.CENTERED
    times["runtime_quantize_row"] = timed(
        "runtime_quantize_row CENTERED [16384, 64] bf16",
        lambda: rtq.rtq_rows(rows, centered, 8),
        lambda: rtq.rtq_rows_plain(rows, centered, 8, False), None,
        bound_of(0, 3 * rows.numel() + 8 * rows.shape[0]))
    act = torch.randn((4096, 1024), generator=g, device=DEV).to(
        torch.bfloat16)
    times["runtime_quantize_block"] = timed(
        "runtime_quantize_block CENTERED [4096, 1024] bf16 bs 64",
        lambda: rtq.rtq_blocks(act, 64, centered, 8, True),
        lambda: rtq.rtq_blocks_plain(act, 64, centered, 8, True), None,
        bound_of(0, 3 * act.numel() + 12 * 16))
    return times


def run_quantized_attention(cfg, params, seed, rng):
    """Phase 10 (a)-(f) except the random-init logits → its record."""
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["qattn_errors"] = check_qattn_all(rng)
        out["hpack_errors"] = check_hpack_all(rng)
        out["rtq_cases"] = check_runtime_quantization(rng)
    phase["qattn_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["forward"] = run_quantized_attention_forwards(
        cfg, params, seed, QFWD_LOGITS_TOL, "trained")
    phase["qattn_forward"] = time.perf_counter() - t
    t = time.perf_counter()
    out["facade"] = run_facade(rng)
    out["block_launches"] = run_block_quantizer(rng)
    with torch.inference_mode():
        out["times"] = time_quantized_attention(rng)
    phase["qattn_facade_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 11: the quantized backward
# --------------------------------------------------------------------------

# The JAX package's north-star arm (bench.py's B=4, H=4, S=4096, D=256,
# FULL, int8 ROW K / CHANNEL V, its block sizes), as utils/profiling.py
# defines it.
NS_B, NS_H, NS_S, NS_D = NORTH_STAR_SHAPE
NS_BLOCKS = NORTH_STAR_BLOCKS
# Relative L2 per gradient: full-integer vs exact is the JAX package's gate
# (tests/test_quantized_attention.py:781, 840); the exact call and QAT vs
# the fp32 dense VJP on the dequantized K/V, and the facade's dq, the int8
# gate (test_quantized_attention.py:208).
QBWD_TOL = 0.05
BWD_KERNELS = (fbwd.qflash_dq, fbwd.qflash_dkv, fbwd.fullint_dq,
               fbwd.fullint_dkv, qattn_fwd, rtq.rtq_rows)


def reset_bwd_counts():
    for fn in BWD_KERNELS:
        fn.launches = 0


def bwd_counts():
    return {fn.__name__: fn.launches for fn in BWD_KERNELS if fn.launches}


def bwd_inputs(q, kq, vq, g, mask=masking.FULL, **opts):
    """(dO, L, D) of the quantized forward over (q, K, V); dO drawn on the
    card from ``g``."""
    o, lse = quantized_flash_attention_forward(q, kq, vq, mask=mask, **opts)
    do = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
    return do, lse, (do.float() * o).sum(-1)


def check_bwd_pair(label, got, want, names):
    """Kernel outputs against the plain versions' → {name: (rel err, max
    abs err)}; raises past the flash kernels' bf16 gate on the rel err."""
    errs = {n: (rel_err(g, w), max_abs(g, w))
            for n, g, w in zip(names, got, want) if w is not None}
    log(f"{label}: " + " ".join(f"{n} {e[0]:.2e}" for n, e in errs.items()))
    if not all(e[0] <= FLASH_TOL[torch.bfloat16] for e in errs.values()):
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{errs}")
    return errs


def check_qflash(rng, label, b, hq, hkv, sq, skv, d, kcfg, vcfg,
                 mask=masking.CAUSAL, bias_shape=None, **opts):
    """K1/K2 (the exact quantized dQ, dK/dV) against their plain versions
    in the mode the JAX package's selection gives these configurations."""
    q, k, v = attn_inputs(rng, b, hq, hkv, sq, skv, d)
    kq, vq = quantize(k.float(), kcfg), quantize(v.float(), vcfg)
    g = device_generator(rng)
    bias = (None if bias_shape is None
            else torch.randn(bias_shape, generator=g, device=DEV))
    do, lse, di = bwd_inputs(q, kq, vq, g, mask=mask, bias=bias, **opts)
    rr = row_ranges_tensor(mask, sq, skv, None, DEV)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, bias, scale=d ** -0.5,
        want_dbias=bias is not None, **opts)
    got = (*fbwd.qflash_dq(*dq_a, **dq_kw), *fbwd.qflash_dkv(*dkv_a,
                                                              **dkv_kw))
    torch.cuda.synchronize()
    want = (*fbwd.qflash_dq_plain(*dq_a, **dq_kw),
            *fbwd.qflash_dkv_plain(*dkv_a, **dkv_kw))
    return check_bwd_pair(f"qflash {label} ({dq_kw['mode'].k}/"
                          f"{dkv_kw['mode'].k} K)", got, want,
                          ("dq", "dbias", "dk", "dv"))


def check_fullint(rng, label, b, h, s, d, kcfg, vcfg, level2):
    """K3/K4 (the full-integer dQ, dK/dV) against their plain versions;
    level 2 quantizes over bench.py's tiles (512 keys, 1024 queries)."""
    q, k, v = attn_inputs(rng, b, h, h, s, s, d)
    kq, vq = quantize(k.float(), kcfg), quantize(v.float(), vcfg)
    do, lse, di = bwd_inputs(q, kq, vq, device_generator(rng),
                             quantize_q=True)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.fullint_arguments(
        q, kq, vq, None, lse, do, scale=d ** -0.5, block_sizes=NS_BLOCKS,
        di=di, int8_grads=level2)
    got = (fbwd.fullint_dq(*dq_a, **dq_kw), *fbwd.fullint_dkv(*dkv_a,
                                                               **dkv_kw))
    torch.cuda.synchronize()
    want = (fbwd.fullint_dq_plain(*dq_a, **dq_kw),
            *fbwd.fullint_dkv_plain(*dkv_a, **dkv_kw))
    return check_bwd_pair(
        f"fullint {label} level {2 if level2 else 1} (widths "
        f"{dq_kw['width']}/{dkv_kw['width']})", got, want, ("dq", "dk", "dv"))


def check_bwd_kernels_all(rng):
    """(a) K3/K4 at the north-star shape (levels 1 and 2, ROW and TENSOR K),
    K1/K2 at the flagship's attention shapes in five modes, then small
    shapes.  → {label: errors}."""
    ns = (NS_B, NS_H, NS_S, NS_D)
    row8, row8c, row4c = qcfg(), qcfg(strategy="centered"), qcfg(
        bits=4, strategy="centered")
    ten8, ch8 = qcfg(gran="tensor"), qcfg(gran="channel")
    errs = {}
    for level2 in (False, True):
        lv = 2 if level2 else 1
        errs[f"fullint_row_l{lv}"] = check_fullint(
            rng, "ROW K / CHANNEL V (north-star)", *ns, row8, ch8, level2)
        errs[f"fullint_tensor_l{lv}"] = check_fullint(
            rng, "TENSOR K / TENSOR V (north-star)", *ns, ten8, ten8, level2)
    flagship = (ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S, ATTN_D)
    for name, kcfg, vcfg in (("folded_row", row8, row8),
                             ("folded_channel", ch8, ch8),
                             ("folded_tensor", ten8, ten8),
                             ("dequant_row8c", row8c, row8c),
                             ("dequant_row4c", row4c, row4c)):
        errs[name] = check_qflash(rng, f"{name} (flagship)", *flagship,
                                  kcfg, vcfg)
    b2d = qcfg(gran="block_2d", strategy="centered", block_rows=4,
               block_size=32)
    b2d48 = qcfg(gran="block_2d", strategy="centered", block_rows=4,
                 block_size=48)
    small = (2, 8, 2, 300, 300)
    for label, d, kcfg, vcfg, opts in (
            ("BLOCK_2D", 64, b2d, b2d, {}),
            ("bias-dbias", 64, row8c, row8c,
             dict(bias_shape=(1, 8, 300, 300))),
            ("window-causal", 64, row8c, row8c,
             dict(mask=masking.sliding_window(96, causal=True))),
            ("interleaved", 64, row8c, row8c, dict(interleaved_kv=True)),
            ("folded CHANNEL interleaved", 64, ch8, ch8,
             dict(interleaved_kv=True)),
            ("d128", 128, row8c, row8c, {}),
            ("d256 folded ROW", 256, row8, row8, {}),
            # Head dims run zero-padded to the next built width.
            ("d80", 80, row8c, row8c, {}),
            ("d96 int4", 96, row4c, row4c, {}),
            ("d96 folded ROW", 96, row8, row8, {}),
            ("BLOCK_2D 48 d96", 96, b2d48, b2d48, {})):
        errs[label] = check_qflash(rng, label, *small, d, kcfg, vcfg, **opts)
    for d in (80, 96):
        errs[f"fullint_d{d}_l1"] = check_fullint(
            rng, f"ROW K / CHANNEL V D={d}", 2, 4, 512, d, row8, ch8, False)
    # S=200 resolves to 8-wide level-2 spans: the scalar kernels' widths.
    errs["fullint_w8_l2"] = check_fullint(
        rng, "ROW K / CHANNEL V S=200 (scalar widths)", 1, 4, 200, 64, row8,
        ch8, True)
    errs["ragged"] = check_qflash(rng, "ragged Sq=125 < Skv=1000", 1, 4, 4,
                                  125, 1000, 64, row8c, row8c)
    return errs


def bench_grads(q, kq, vq, do, fullint):
    """bench.py's gradients (``north_star_grads``), the launch counts set to
    0 just before and read after → (grads, launches, s)."""
    reset_bwd_counts()
    t0 = time.perf_counter()
    grads = north_star_grads(q, kq, vq, do, fullint)
    torch.cuda.synchronize()
    return grads, bwd_counts(), time.perf_counter() - t0


def dense_grads(q, kq, vq, do, mask=masking.FULL):
    """The fp32 dense VJP (dq, dk, dv) on the dequantized K/V, one batch
    element at a time."""
    kd, vd = dequantize(kq), dequantize(vq)
    parts = [reference_attention_vjp(q[i:i + 1].float(), kd[i:i + 1],
                                     vd[i:i + 1], do[i:i + 1].float(),
                                     mask=mask)
             for i in range(q.shape[0])]
    return [torch.cat(p) for p in zip(*parts)]


def gate_grads(label, got, want, names):
    errs = {n: rel_l2(g, w) for n, g, w in zip(names, got, want)}
    log(f"{label}: rel L2 " + json.dumps(errs) + f" (tol {QBWD_TOL})")
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    shapes = all(g.shape == w.shape for g, w in zip(got, want))
    if not (finite and shapes and all(e <= QBWD_TOL for e in errs.values())):
        raise AssertionError(f"{label}: {errs}, finite {finite}, shapes "
                             f"{shapes}")
    return errs


def run_north_star(rng):
    """(b) The full-width fwd+bwd, full-integer and exact, gated against
    each other and the exact one against the dense VJP."""
    q, kq, vq, do = north_star_inputs(device_generator(rng))
    names = ("dq", "dk_scale", "dv_scale")
    full, full_launches, full_s = bench_grads(q, kq, vq, do, True)
    exact, exact_launches, exact_s = bench_grads(q, kq, vq, do, False)
    log(f"north-star fwd+bwd (B={NS_B} H={NS_H} S={NS_S} D={NS_D} FULL): "
        f"full-integer {full_s:.3f} s, launches {json.dumps(full_launches)};"
        f" exact {exact_s:.3f} s, launches {json.dumps(exact_launches)}")
    if full_launches != {"qattn_fwd": 1, "fullint_dq": 1, "fullint_dkv": 1}:
        raise AssertionError(f"full-integer launches {full_launches}")
    if exact_launches != {"qattn_fwd": 1, "qflash_dq": 1, "qflash_dkv": 1}:
        raise AssertionError(f"exact launches {exact_launches}")
    out = {"fullint_vs_exact": gate_grads(
        "north-star full-integer vs exact", full, exact, names)}
    dq, dk, dv = dense_grads(q, kq, vq, do)
    dense = (dq, tqa._scale_zp_cotangents(dk, kq)[0],
             tqa._scale_zp_cotangents(dv, vq)[0])
    out["exact_vs_dense"] = gate_grads(
        "north-star exact vs fp32 dense VJP on the dequantized K/V", exact,
        dense, names)
    out["fullint_vs_dense_not_gated"] = {
        n: rel_l2(g, w) for n, g, w in zip(names, full, dense)}
    out["launches"] = {"fullint": full_launches, "exact": exact_launches}
    out["seconds"] = {"fullint": full_s, "exact": exact_s}
    return out, (q, kq, vq, do)


def run_qat(rng):
    """(c) ``quantized_flash_attention_qat`` (int8 ROW CENTERED, causal) at
    the flagship's attention shapes against the dense VJP on the
    dequantized K/V, and the ``QuantizedAttention`` gradient with respect
    to q; launch counts set to 0 just before each call and read after."""
    q, k, v = attn_inputs(rng, ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S,
                          ATTN_D)
    do = torch.randn(q.shape, generator=device_generator(rng),
                     device=DEV).to(torch.bfloat16)
    cfg = qcfg(strategy="centered")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_bwd_counts()
    o = quantized_flash_attention_qat(*leaves, cfg, masking.CAUSAL)
    grads = torch.autograd.grad((o.float() * do.float()).sum(), leaves)
    torch.cuda.synchronize()
    qat_launches = bwd_counts()
    want = {"qattn_fwd": 1, "qflash_dq": 1, "qflash_dkv": 1}
    if qat_launches != want:
        raise AssertionError(f"QAT launches {qat_launches}, expected {want}")
    dense = dense_grads(q, quantize(k.float(), cfg), quantize(v.float(), cfg),
                        do, masking.CAUSAL)
    out = {"qat": gate_grads("QAT int8 ROW CENTERED (flagship, causal)",
                             grads, dense, ("dq", "dk", "dv"))}
    facade = QuantizedAttention(mask=masking.CAUSAL)
    qg = q.clone().requires_grad_(True)
    reset_bwd_counts()
    of = facade(qg, k, v)
    (dq,) = torch.autograd.grad((of.float() * do.float()).sum(), [qg])
    torch.cuda.synchronize()
    facade_launches = bwd_counts()
    want = {"rtq_rows": 2, "qattn_fwd": 1, "qflash_dq": 1, "qflash_dkv": 1}
    if facade_launches != want:
        raise AssertionError(f"facade launches {facade_launches}, expected "
                             f"{want}")
    kq, vq = facade.quantize_kv(k, v)
    out["facade"] = gate_grads(
        "QuantizedAttention dq (int8 CENTERED, flagship, causal)", [dq],
        dense_grads(q, kq, vq, do, masking.CAUSAL)[:1], ("dq",))
    out["launches"] = {"qat": qat_launches, "facade": facade_launches}
    return out, (q, k, v, do)


def check_north_star_kernels(q, kq, vq, do):
    """The main path's kernels against their plain versions on its own
    north-star inputs, in the modes it launches them: the quantized
    forward with int8 Q and int8 P (D=256), the full-integer dQ / dK/dV
    (level 1, ROW K / CHANNEL V) and the exact ones (folded ROW K /
    CHANNEL V) → ({name: errors}, the kernels' arguments)."""
    d = q.shape[-1]
    f_args, f_kw = qattn_arguments(q, kq, vq, quantize_q=True)
    f_kw["kv_tile"] = main_path_tile(f_kw, q.shape[2], NS_BLOCKS)
    o, lse = qattn_fwd(*f_args, **f_kw)
    torch.cuda.synchronize()
    errs = {"qattn_fwd": check_pair(
        f"qattn_fwd int8 Q / int8 P D=256 over {f_kw['kv_tile']}-key spans "
        "(north-star)", (o, lse), qattn_fwd_plain(*f_args, **f_kw))}
    # Not gated: the one-pass softmax rounds the int8 P against each row's
    # final max, where the kernel (as the TPU's) rounds against the running
    # one over block_kv spans; over 4096 keys that moves O by ~0.1 of its
    # max abs.
    o_1, l_1 = qattn_fwd_plain(*f_args, **{**f_kw, "kv_tile": None})
    errs["qattn_fwd_one_pass"] = (rel_err(o, o_1), rel_err(lse, l_1),
                                  max_abs(o, o_1))
    log("qattn_fwd vs the one-pass plain version (not gated): o "
        f"{errs['qattn_fwd_one_pass'][0]:.2e} l "
        f"{errs['qattn_fwd_one_pass'][1]:.2e}")
    del o_1, l_1
    di = (do.float() * o).sum(-1)
    (f_dq, f_dq_kw), (f_dkv, f_dkv_kw) = fbwd.fullint_arguments(
        q, kq, vq, None, lse, do, scale=d ** -0.5, block_sizes=NS_BLOCKS,
        di=di)
    rr = row_ranges_tensor(masking.FULL, q.shape[2], q.shape[2], None, DEV)
    (e_dq, e_dq_kw), (e_dkv, e_dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, scale=d ** -0.5)
    args = {"qattn_fwd": (f_args, f_kw), "fullint_dq": (f_dq, f_dq_kw),
            "fullint_dkv": (f_dkv, f_dkv_kw), "qflash_dq": (e_dq, e_dq_kw),
            "qflash_dkv": (e_dkv, e_dkv_kw)}
    for name, outs, mode in (
            ("fullint_dq", ("dq",), "level 1, ROW K / CHANNEL V"),
            ("fullint_dkv", ("dk", "dv"), "level 1, ROW K / CHANNEL V"),
            ("qflash_dq", ("dq", "dbias"), f"{e_dq_kw['mode'].k} K"),
            ("qflash_dkv", ("dk", "dv"), f"{e_dkv_kw['mode'].k} K")):
        a, kw = args[name]
        got = getattr(fbwd, name)(*a, **kw)
        torch.cuda.synchronize()
        want = getattr(fbwd, f"{name}_plain")(*a, **kw)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        errs[name] = check_bwd_pair(f"{name} {mode} (north-star)", got,
                                    want, outs)
    return errs, args


def time_quantized_backward(ns_args, qat_inputs):
    """(d) K1-K4 times beside their bounds, plain versions and the SDPA
    backward over the dequantized bf16 K/V (dq, dk, dv together; a
    yardstick): K3/K4 at the north-star shape (level 1, the main path's),
    K1/K2 there in the exact arm's mode (folded ROW K / CHANNEL V) and at
    the flagship's attention shapes in QAT's (dequant ROW CENTERED); the
    quantized forward in the north-star's mode beside SDPA."""
    (q, kq, vq, do), args = ns_args
    b, h, s, d = q.shape
    pairs = b * h * s * s
    n_q, n_kv, rows = b * h * s * d, b * h * s * d, b * h * s
    (f_dq, f_dq_kw), (f_dkv, f_dkv_kw) = args["fullint_dq"], args[
        "fullint_dkv"]
    (e_dq, e_dq_kw), (e_dkv, e_dkv_kw) = args["qflash_dq"], args[
        "qflash_dkv"]
    fwd_a, fwd_kw = args["qattn_fwd"]

    def sdpa_bwd(q_, kd, vd, do_, causal):
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q_, kd, vd))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=True)
        return lambda: torch.autograd.grad(out, (qg, kg, vg), do_,
                                           retain_graph=True)

    def timed(name, kernel, plain, library, bound):
        t = {"plain_ms": time_ms(plain, 2, warmup=1),
             "ms": time_ms(kernel, 5, warmup=1)}
        t["plain_ms_2"] = time_ms(plain, 2, warmup=0)
        t["ms_2"] = time_ms(kernel, 5, warmup=0)
        t["library_ms"] = time_ms(library, 5, warmup=1)
        parent_turns(name, t, kernel, 5)
        t["bound_ms"], t["bound_by"] = bound
        log(f"{name} times: " + json.dumps(t))
        return t

    kd, vd = dequantized_bf16(kq), dequantized_bf16(vq)
    lib = sdpa_bwd(q, kd, vd, do, False)
    stats = 4 * rows  # one fp32 [B, H, S] vector
    int8_in = 2 * n_q + 2 * n_kv  # Q and dO (one copy), K and V payloads
    times = {
        "fullint_dq": timed(
            "fullint_dq level 1 ROW K (north-star)",
            lambda: fbwd.fullint_dq(*f_dq, **f_dq_kw),
            lambda: fbwd.fullint_dq_plain(*f_dq, **f_dq_kw), lib,
            attn_bound(pairs, 4 * d, 2 * d, int8_in + 4 * stats
                       + 4 * b * h * s + 4 * n_q)),
        "fullint_dkv": timed(
            "fullint_dkv level 1 ROW K (north-star)",
            lambda: fbwd.fullint_dkv(*f_dkv, **f_dkv_kw),
            lambda: fbwd.fullint_dkv_plain(*f_dkv, **f_dkv_kw), lib,
            attn_bound(pairs, 4 * d, 4 * d, int8_in + n_q + 5 * stats
                       + 4 * b * h * s + 8 * n_kv)),
        "qflash_dq": timed(
            "qflash_dq folded ROW K / CHANNEL V (north-star, the exact arm)",
            lambda: fbwd.qflash_dq(*e_dq, **e_dq_kw),
            lambda: fbwd.qflash_dq_plain(*e_dq, **e_dq_kw), lib,
            attn_bound(pairs, 0, 6 * d, 4 * n_q + 2 * n_kv + 3 * stats
                       + 4 * b * h * d + 4 * n_q + 8 * s)),
        "qflash_dkv": timed(
            "qflash_dkv token K / channel V (north-star, the exact arm)",
            lambda: fbwd.qflash_dkv(*e_dkv, **e_dkv_kw),
            lambda: fbwd.qflash_dkv_plain(*e_dkv, **e_dkv_kw), lib,
            attn_bound(pairs, 0, 8 * d, 4 * n_q + 2 * n_kv + 4 * stats
                       + 4 * b * h * d + 8 * n_kv + 8 * s)),
        # int8 Q with its scales, K with its per-token scales, V with its
        # per-channel ones in; O and L out; int8 QK and int8 PV products.
        "qattn_fwd": timed(
            "qattn_fwd int8 Q / int8 P D=256 (north-star)",
            lambda: qattn_fwd(*fwd_a, **fwd_kw),
            lambda: qattn_fwd_plain(*fwd_a, **fwd_kw),
            lambda: F.scaled_dot_product_attention(q, kd, vd),
            attn_bound(pairs, 4 * d, 0, n_q + stats + 2 * n_kv
                       + 4 * b * h * s + 4 * b * h * d + 4 * n_q + stats
                       + 8 * s)),
    }
    for name, body in (("qflash_dq", dq_body), ("qflash_dkv", dkv_body)):
        times[name]["body"] = body(e_dkv[0].dtype, d)
        log(f"{name} at the north-star (D={d}) runs the "
            f"{times[name]['body']} body")
    # K3/K4 at level 2 on the same inputs: dS (P^T, dS^T) row-quantized
    # over bench.py's 512-key (1024-query) spans, every product int8.
    lse, di = f_dq[7], f_dq[8]  # fullint_dq's L (-inf as 0) and D
    (l2_dq, l2_dq_kw), (l2_dkv, l2_dkv_kw) = fbwd.fullint_arguments(
        q, kq, vq, None, lse, do, scale=d ** -0.5, block_sizes=NS_BLOCKS,
        di=di, int8_grads=True)
    for name, kernel, plain, a, kw, ops, nbytes in (
            ("fullint_dq", fbwd.fullint_dq, fbwd.fullint_dq_plain, l2_dq,
             l2_dq_kw, 6 * d, int8_in + 4 * stats + 4 * b * h * s + 4 * n_q),
            ("fullint_dkv", fbwd.fullint_dkv, fbwd.fullint_dkv_plain,
             l2_dkv, l2_dkv_kw, 8 * d,
             int8_in + n_q + 5 * stats + 4 * b * h * s + 8 * n_kv)):
        t = timed(f"{name} level 2 ROW K, width {kw['width']} (north-star)",
                  lambda: kernel(*a, **kw), lambda: plain(*a, **kw), lib,
                  attn_bound(pairs, ops, 0, nbytes))
        times[name].update({f"{key}_level2": t[key] for key in (
            "ms", "ms_2", "plain_ms", "bound_ms", "bound_by",
            "parent_turns_ms") if key in t})
        times[name]["width_level2"] = kw["width"]
        times[name]["body"] = fullint_body(d, 0)
        times[name]["body_level2"] = fullint_body(d, kw["width"])
        log(f"{name} at the north-star (D={d}) runs the "
            f"{times[name]['body']} body at level 1, the "
            f"{times[name]['body_level2']} body at level 2")
    del lib, kd, vd, args, f_dq, f_dkv, e_dq, e_dkv, fwd_a, l2_dq, l2_dkv
    # K1/K2 in QAT's mode at the flagship's attention shapes (causal).
    q, k, v, do = qat_inputs
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    cfg = qcfg(strategy="centered")
    kq, vq = quantize(k.float(), cfg), quantize(v.float(), cfg)
    o, lse = quantized_flash_attention_forward(q, kq, vq,
                                               mask=masking.CAUSAL)
    di = (do.float() * o).sum(-1)
    rr = row_ranges_tensor(masking.CAUSAL, s, s, None, DEV)
    (e_dq, e_dq_kw), (e_dkv, e_dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, scale=d ** -0.5)
    lib = sdpa_bwd(q, dequantized_bf16(kq), dequantized_bf16(vq), do, True)
    pairs = b * hq * s * (s + 1) // 2
    n_q, n_kv, stats = b * hq * s * d, b * hkv * s * d, 4 * b * hq * s
    for name, kernel, plain, ops, out_bytes in (
            ("qflash_dq", fbwd.qflash_dq, fbwd.qflash_dq_plain, 6 * d,
             4 * n_q + 4 * b * hkv * d),
            ("qflash_dkv", fbwd.qflash_dkv, fbwd.qflash_dkv_plain, 8 * d,
             8 * n_kv)):
        a, kw = (e_dq, e_dq_kw) if name == "qflash_dq" else (e_dkv, e_dkv_kw)
        t = timed(f"{name} dequant ROW CENTERED (flagship, causal: QAT's "
                  "mode)", lambda: kernel(*a, **kw), lambda: plain(*a, **kw),
                  lib, attn_bound(pairs, 0, ops, 4 * n_q + 2 * n_kv
                                  + 16 * b * hkv * s + 2 * stats + out_bytes
                                  + 8 * s))
        times[name].update({f"{key}_qat_mode": t[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms")})
    for name, body in (("qflash_dq", dq_body), ("qflash_dkv", dkv_body)):
        times[name]["body_qat_mode"] = body(e_dkv[0].dtype, d)
        log(f"{name} in QAT's mode (D={d}) runs the "
            f"{times[name]['body_qat_mode']} body")
    return times


def run_quantized_backward(seed):
    """Phase 11 (a)-(d), inputs from a fourth generator (seed + 3) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 3)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["errors"] = check_bwd_kernels_all(rng)
    phase["qbwd_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["north_star"], ns_inputs = run_north_star(rng)
    phase["qbwd_north_star"] = time.perf_counter() - t
    t = time.perf_counter()
    out["qat"], qat_inputs = run_qat(rng)
    phase["qbwd_qat"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        out["north_star_errors"], ns_args = check_north_star_kernels(
            *ns_inputs)
    phase["qbwd_north_star_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["times"] = time_quantized_backward((ns_inputs, ns_args), qat_inputs)
    phase["qbwd_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 12: MLA serving and the weight-only GEMM
# --------------------------------------------------------------------------

# MLAConfig()'s latent attention: 16 query heads over one head-shared
# latent state of d_c + d_r = 256 + 32 lanes, V's rope tail of 32 zeroed,
# softmax scale (dh + d_r)^-0.5 (models/cached_mla.py).
MLA_HQ, MLA_D, MLA_VTZ = 16, 288, 32
MLA_SCALE = (64 + 32) ** -0.5
# The decompression (mla_decompress at B=2, S=2048): GEMMs of M = B·S
# latent rows, N = H·dh = 16·64, K = d_c = 256.
DEC_B, DEC_S, DEC_H, DEC_DH, DEC_DC = 2, 2048, 16, 64, 256
# The weight-only GEMM kernels vs their plain versions on the same
# arguments, fp32 results: the same products (exact for bf16 × int8 and
# bf16 × bf16) summed in another order.  Max abs over the plain's max abs.
WO_TOL = TOLERANCES["fp32"]
# The decompression path vs the absorbed path on the dequantized weights,
# relative L2: bf16 K/V against bf16 absorbed queries.
DECOMPRESS_TOL = TOLERANCES["mixed"]
# The absorbed attention over a per-token int8 latent vs the fp32 dense
# attention on the dequantized latent, relative L2: tests/test_mla.py's
# int8 gate.
ABSORBED_INT8_TOL = TOLERANCES["int8_rel"] / 5
# (label, weight config, A dtype): the folded kernel's modes, then the
# dequant-on-load kernel's.
WO_CASES = (
    ("folded int8 ROW", WEIGHT_CFG, torch.bfloat16),
    ("folded int4 ROW", QuantConfig(bits=4, granularity=QuantGranularity.ROW),
     torch.bfloat16),
    ("folded int8 TENSOR", QuantConfig(bits=8), torch.bfloat16),
    ("wo int8 BLOCK 128", int8_blockwise(128), torch.bfloat16),
    ("wo int8 ASYMMETRIC ROW", QuantConfig(
        bits=8, granularity=QuantGranularity.ROW,
        strategy=QuantStrategy.ASYMMETRIC), torch.bfloat16),
    ("wo int8 ROW fp32 A", WEIGHT_CFG, torch.float32),
)


def mla_pool(rng, quantized, num_pages, pt):
    """A latent pool [1, NP+1, PT, 288] (one state per token): bf16
    states, or int8 ones with one scale per token for K and V."""
    g = device_generator(rng)
    shape = (1, num_pages + 1, pt, MLA_D)
    if not quantized:
        pool = torch.randn(shape, generator=g, device=DEV)
        return pool.to(torch.bfloat16), {}
    pool = torch.randint(-128, 128, shape, generator=g, device=DEV)
    sc = (torch.rand((1, num_pages + 1, 1, pt), generator=g, device=DEV)
          * 1.5 + 0.5) / 127
    return pool.to(torch.int8), dict(k_scales=sc, v_scales=sc)


def mla_gate(label, out, ref):
    """A paged kernel's output at MLA's geometry against its plain
    version's → (rel err, max abs err); raises past the bf16 gate or if
    the rope tail of the output is not zero."""
    errs = (rel_err(out, ref), max_abs(out, ref))
    tail = out[..., MLA_D - MLA_VTZ:].float().abs().max().item()
    log(f"{label}: rel {errs[0]:.2e} max abs {errs[1]:.2e} (tol "
        f"{FLASH_TOL[torch.bfloat16]}), rope-tail max {tail}")
    if not (errs[0] <= FLASH_TOL[torch.bfloat16] and tail == 0.0):
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{errs}, tail {tail}")
    return errs


def check_mla_paged(rng):
    """(a) Both paged kernels at MLA's geometry (Hq=16 over Hkv=1, D=288,
    one-state pages, v_tail_zero=32) with bf16 and int8 pools: decode at
    phase 2's lengths, prefill of a 256-token chunk at three offsets.
    → {label: (rel err, max abs err)}."""
    pt, num_pages, max_pages, chunk = 256, 256, 16, 256
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    errs = {}
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        pool, kw = mla_pool(rng, quantized, num_pages, pt)
        kw.update(page_tokens=pt, v_tail_zero=MLA_VTZ, scale=MLA_SCALE)
        table = page_tables(rng, lengths, pt, num_pages, max_pages)
        q = torch.from_numpy(rng.standard_normal(
            (len(lengths), MLA_HQ, MLA_D), np.float32)).to(DEV, torch.bfloat16)
        ln = torch.from_numpy(lengths).to(DEV)
        out = paged_decode_attention(q, pool, table, ln, **kw)
        torch.cuda.synchronize()
        errs[f"decode_{kind}"] = mla_gate(
            f"paged_decode MLA {kind} pool", out,
            paged_decode_attention_plain(q, pool, table, ln, **kw))
        for offset in (0, 300, 512):
            row = page_tables(rng, [offset + chunk], pt, num_pages,
                              max_pages)[0]
            q = torch.from_numpy(rng.standard_normal(
                (MLA_HQ, chunk, MLA_D), np.float32)).to(DEV, torch.bfloat16)
            out = paged_prefill_attention(q, pool, row, offset, **kw)
            torch.cuda.synchronize()
            errs[f"prefill_{kind}_{offset}"] = mla_gate(
                f"paged_prefill MLA {kind} pool offset={offset}", out,
                paged_prefill_attention_plain(q, pool, row, offset, **kw))
    return errs


def check_mla_flash(rng):
    """(b) The flash forward, dQ and dK/dV kernels at MLA's latent head
    dims: D=80 (tests/test_mla_serving.py's d_c + d_r) and D=288
    (MLAConfig()'s), 16 query heads over one KV head, bf16 and fp32 at
    S=300, and D=288 bf16 at mla_forward's B=2, S=2048.  → {label:
    {output: (rel err, max abs err)}}."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for d in (80, 288):
            errs[f"d{d}_{str(dtype)[6:]}"] = check_flash(
                rng, f"MLA latent D={d}", 2, MLA_HQ, 1, 300, 300, d, dtype)
    errs["d288_mla_forward"] = check_flash(
        rng, "MLA latent D=288 (B=2 S=2048)", DEC_B, MLA_HQ, 1, DEC_S, DEC_S,
        MLA_D, torch.bfloat16)
    return errs


def check_int8_p_spans(rng):
    """(c) The quantized forward in the north-star's int8-Q / int8-P mode
    against ``qattn_fwd_plain(kv_tile=block_kv)`` at the north-star shape,
    for NORTH_STAR_BLOCKS' block_kv and for 128.  → {label: errors}."""
    q, kq, vq, _ = north_star_inputs(device_generator(rng))
    args, kw = qattn_arguments(q, kq, vq, quantize_q=True)
    errs = {}
    for block_kv in (NS_BLOCKS.block_kv, 128):
        tile = int8_p_tile(BlockSizes(block_kv=block_kv), NS_S)
        out = qattn_fwd(*args, **kw, kv_tile=tile)
        torch.cuda.synchronize()
        errs[f"block_kv_{block_kv}"] = check_pair(
            f"qattn_fwd int8 Q / int8 P over {tile}-key spans (north-star)",
            out, qattn_fwd_plain(*args, **kw, kv_tile=tile))
    return errs


def wo_pair(a, wq, c=None):
    """(kernel, plain, args, kw) of ``quantized_matmul(a, wq, c=c)``."""
    folded, args, kw = wo_arguments(a, wq, c)
    if folded:
        return wo_folded_gemm, wo_folded_gemm_plain, args, kw
    return wo_gemm, wo_gemm_plain, args, kw


def check_wo(name, a, wq, c=None):
    """The weight-only kernel of ``quantized_matmul(a, wq, c=c)`` against
    its plain version, fp32 out, at WO_TOL, and its bf16 result equal to
    the fp32 one rounded, bit for bit.  → (kernel, (rel err, max abs
    err))."""
    kernel, plain, args, kw = wo_pair(a, wq, c)
    out = kernel(*args, **kw)
    out16 = kernel(*args, **kw, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    e = (rel_err(out, ref), max_abs(out, ref))
    log(f"{kernel.__name__} {name} (M={a.shape[0]} N={wq.shape[0]} "
        f"K={a.shape[1]}, {wo_gemm_body(args[0].dtype)} tile): rel "
        f"{e[0]:.2e} max abs {e[1]:.2e} (tol {WO_TOL}); bf16 out = fp32 out "
        "rounded")
    if not e[0] <= WO_TOL:
        raise AssertionError(f"{name} disagrees with its plain version: {e}")
    if not torch.equal(out16, out.to(torch.bfloat16)):
        raise AssertionError(f"{name}: the bf16 result is not the fp32 one "
                             "rounded")
    return kernel, e


def check_wo_gemm(rng):
    """(d) Both weight-only GEMM kernels against their plain versions at the
    decompression shape in each mode of WO_CASES, with and without ``c=``
    (``check_wo``).  → {label: (rel err, max abs err)}."""
    m, n, k = DEC_B * DEC_S, DEC_H * DEC_DH, DEC_DC
    g = device_generator(rng)
    errs = {}
    for label, cfg, adtype in WO_CASES:
        for with_c in (False, True):
            a = torch.randn((m, k), generator=g, device=DEV).to(adtype)
            wq = quantize(torch.randn((n, k), generator=g, device=DEV)
                          * k ** -0.5, cfg)
            c = (torch.randn((m, n), generator=g, device=DEV) if with_c
                 else None)
            name = f"{label}{' c=' if with_c else ''}"
            kernel, errs[name] = check_wo(name, a, wq, c)
            if (kernel is wo_folded_gemm) != label.startswith("folded"):
                raise AssertionError(f"{name}: dispatched to {kernel}")
    return errs


def run_decompression(rng):
    """(e) The decompression path: ``mla_decompress(latent, W_uk_q, W_uv_q,
    16)`` then ``flash_attention(q, k, v, CAUSAL)`` at B=2, S=2048, against
    ``mla_absorbed_attention`` on the dequantized weights; W_uk/W_uv int8
    ROW (the folded kernel) and int8 BLOCK 128 (the dequant-on-load one),
    the launch counts set to 0 just before and read after; then the path's
    time (with ``--parent``, in turns).  → {config: {rel_l2, launches,
    times}}."""
    b, s, h, dh, dc = DEC_B, DEC_S, DEC_H, DEC_DH, DEC_DC
    g = device_generator(rng)
    latent = torch.randn((b, s, dc), generator=g, device=DEV).to(
        torch.bfloat16)
    q = torch.randn((b, h, s, dh), generator=g, device=DEV).to(torch.bfloat16)
    w_uk = torch.randn((h, dh, dc), generator=g, device=DEV) * dc ** -0.5
    w_uv = torch.randn((h, dc, dh), generator=g, device=DEV) * dc ** -0.5
    out = {}
    for name, cfg in (("int8 ROW", WEIGHT_CFG),
                      ("int8 BLOCK 128", int8_blockwise(128))):
        wk = quantize(w_uk.reshape(h * dh, dc), cfg)
        wv = quantize(w_uv.transpose(1, 2).reshape(h * dh, dc), cfg)
        wo_folded_gemm.launches = wo_gemm.launches = flash_fwd.launches = 0
        k, v = mla_decompress(latent, wk, wv, h)
        o = flash_attention(q, k, v, mask=masking.CAUSAL)
        torch.cuda.synchronize()
        launches = {"wo_folded_gemm": wo_folded_gemm.launches,
                    "wo_gemm": wo_gemm.launches,
                    "flash_fwd": flash_fwd.launches}
        folded = cfg is WEIGHT_CFG
        want = {"wo_folded_gemm": 2 * folded, "wo_gemm": 2 * (not folded),
                "flash_fwd": 1}
        ref = mla_absorbed_attention(
            q, latent, dequantize(wk).reshape(h, dh, dc),
            dequantize(wv).reshape(h, dh, dc).transpose(1, 2),
            mask=masking.CAUSAL)
        err = rel_l2(o, ref.float())
        log(f"decompression {name}: mla_decompress + flash_attention vs "
            f"absorbed, rel L2 {err:.3e} (tol {DECOMPRESS_TOL}); launches "
            + json.dumps(launches))
        if launches != want:
            raise AssertionError(f"decompression {name}: launches "
                                 f"{launches}, expected {want}")
        if not (np.isfinite(err) and err <= DECOMPRESS_TOL
                and o.shape == (b, h, s, dh)):
            raise AssertionError(f"decompression {name} disagrees with the "
                                 f"absorbed path: {err}")
        path = (lambda wk=wk, wv=wv: flash_attention(  # noqa: E731
            q, *mla_decompress(latent, wk, wv, h), mask=masking.CAUSAL))
        times = {"ms": time_ms(path, 10), "ms_2": time_ms(path, 10)}
        parent_turns(f"decompression {name}: mla_decompress + "
                     "flash_attention", times, path, 10)
        log(f"decompression {name} path times (B={b} S={s}): "
            + json.dumps(times))
        out[name] = {"rel_l2": err, "launches": launches, "times": times}
    return out


def run_absorbed_quantized(rng):
    """(e) ``mla_absorbed_attention`` over a per-token int8 latent (ROW
    CENTERED, logical [B, 1, S, d_c], as tests/test_mla.py quantizes it) at
    B=2, S=2048, causal: the quantized forward at MLA's geometry (Hq=16
    over Hkv=1, D=256), its launch count set to 0 just before and read
    after.  The kernel on that call's arguments (rebuilt as
    ``quantized_flash_attention_forward`` builds them) against its plain
    version, the path's output against the plain O carried through W_uv,
    and against the fp32 dense attention on the dequantized latent
    (ABSORBED_INT8_TOL).  → {errors, launches}."""
    b, s, h, dh, dc = DEC_B, DEC_S, DEC_H, DEC_DH, DEC_DC
    g = device_generator(rng)
    latent = torch.randn((b, s, dc), generator=g, device=DEV)
    q = torch.randn((b, h, s, dh), generator=g, device=DEV).to(torch.bfloat16)
    w_uk = torch.randn((h, dh, dc), generator=g, device=DEV) * dc ** -0.5
    w_uv = torch.randn((h, dc, dh), generator=g, device=DEV) * dc ** -0.5
    c = quantize(latent[:, None], QuantConfig(
        granularity=QuantGranularity.ROW, strategy=QuantStrategy.CENTERED))
    qattn_fwd.launches = 0
    o = mla_absorbed_attention(q, c, w_uk, w_uv, mask=masking.CAUSAL)
    torch.cuda.synchronize()
    launches = qattn_fwd.launches
    if launches != 1:
        raise AssertionError(f"absorbed quantized latent: {launches} "
                             "qattn_fwd launches, expected 1")
    q_lat = torch.einsum("bhsd,hdc->bhsc", q.float(), w_uk.float()).to(q.dtype)
    args, kw = qattn_arguments(q_lat, c, c, mask=masking.CAUSAL,
                               scale=dh ** -0.5)
    tile = main_path_tile(kw, s)
    got = qattn_fwd(*args, **kw, kv_tile=tile)
    torch.cuda.synchronize()
    plain = qattn_fwd_plain(*args, **kw, kv_tile=tile or KV_TILE)
    errs = {"kernel": check_pair(
        f"qattn_fwd {kw['mode'].k_scales} K / {kw['mode'].v_scales} V, Hq=16 "
        "over Hkv=1, D=256 (MLA's quantized latent)", got, plain)}
    o_plain = torch.einsum("bhsc,hcd->bhsd", plain[0].to(q.dtype).float(),
                           w_uv.float())
    errs["path"] = (rel_err(o, o_plain), max_abs(o, o_plain))
    ref = plain_mla_attention(q, dequantize(c)[:, 0], w_uk, w_uv,
                              mask=masking.CAUSAL).float()
    errs["vs_fp32_rel_l2"] = rel_l2(o, ref)
    log(f"mla_absorbed_attention over an int8 latent (B={b} S={s}): vs the "
        f"plain O through W_uv rel {errs['path'][0]:.2e} (tol "
        f"{FLASH_TOL[torch.bfloat16]}), vs fp32 dense rel L2 "
        f"{errs['vs_fp32_rel_l2']:.3e} (tol {ABSORBED_INT8_TOL}); "
        f"qattn_fwd launches {launches}")
    if not (errs["path"][0] <= FLASH_TOL[torch.bfloat16]
            and errs["vs_fp32_rel_l2"] <= ABSORBED_INT8_TOL
            and o.shape == (b, h, s, dh)):
        raise AssertionError(f"absorbed quantized latent disagrees: {errs}")
    return {"errors": errs, "launches": launches}


def time_wo_call(label, a, wq, vectors, iters, plain_iters=5):
    """The weight-only kernel ``quantized_matmul(a, wq)`` launches, as it
    launches it (``wo_call``: the bf16 result stored by the kernel; by CUDA
    events, and its kernels' device time under the profiler, which the
    events exceed where the host's launch is the longer) and in fp32,
    beside its bound (A, the payload and its scale vectors read once,
    the bf16 result written once; or 2·M·N·K over the bf16 peak), its plain
    version at bf16 out (timed once, ``plain_iters`` calls) and
    ``torch.matmul`` of A by the pre-dequantized bf16 Wᵀ.  With
    ``--parent``, ``quantized_matmul``'s call in turns (the parent: its fp32
    kernel, then the cast)."""
    m, k = a.shape
    n = wq.shape[0]
    kernel, plain, args, kw = wo_pair(a, wq)
    bf16 = torch.bfloat16
    folded = kernel is wo_folded_gemm
    call = (lambda: wo_call(folded, args, kw, bf16))  # noqa: E731
    wbt = dequantize(wq).to(bf16).t().contiguous()
    t = {"plain_ms": time_ms(lambda: plain(*args, **kw, out_dtype=bf16),
                             plain_iters, warmup=1),
         "ms": time_ms(call, iters)}
    t["ms_2"] = time_ms(call, iters)
    t["ms_fp32_out"] = time_ms(lambda: kernel(*args, **kw), iters)
    t["library_ms"] = time_ms(lambda: a @ wbt, iters)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    t["device_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters
    t["body"] = wo_gemm_body(args[0].dtype)
    t["tile_rows"], t["k_splits"] = wo_tile(
        m, n, k, torch.cuda.get_device_properties(DEV).multi_processor_count)
    parent_turns(label, t, call, iters)
    t["bound_ms"], t["bound_by"] = bound_of(
        2 * m * n * k, 2 * m * k + wq.nbytes_payload + 4 * vectors + 2 * m * n)
    log(f"{label} times (M={m} N={n} K={k}, bf16 A, {t['body']} tile): "
        + json.dumps(t))
    return t


def time_wo_gemm(rng):
    """Both weight-only kernels at the decompression shape in
    ``mla_decompress``'s modes (bf16 latent; int8 ROW folded, int8 BLOCK
    128 dequant-on-load), by ``time_wo_call``."""
    m, n, k = DEC_B * DEC_S, DEC_H * DEC_DH, DEC_DC
    g = device_generator(rng)
    a = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=DEV) * k ** -0.5
    times = {}
    for name, cfg, vectors in (("wo_folded_gemm", WEIGHT_CFG, n),
                               ("wo_gemm", int8_blockwise(128), 2 * k)):
        times[name] = time_wo_call(f"{name} {cfg.granularity.value} M={m}",
                                   a, quantize(w, cfg), vectors, 20)
    return times


def mla_dense_kv(pool, row, n, pt):
    """One sequence's first n latent states as K [1, n, D] and V (the rope
    tail zeroed), bf16."""
    t = torch.arange(n, device=DEV)
    k = pool[:, row.long()[t // pt], t % pt]
    v = k.clone()
    v[..., MLA_D - MLA_VTZ:] = 0
    return k, v


def time_mla_paged(rng, lengths):
    """Both paged kernels at MLA's geometry with a bf16 latent pool: decode
    at the engine's decode lengths, a 256-token prefill chunk at offset
    512; beside their bounds (one state per live token read once; QK over
    288 lanes, PV over 256), plain versions and SDPA over the dense K/V."""
    pt, num_pages, max_pages, chunk, offset = 256, 256, 16, 256, 512
    hq, d, dv = MLA_HQ, MLA_D, MLA_D - MLA_VTZ
    lengths = np.asarray(lengths, np.int32)
    b = len(lengths)
    pool, _ = mla_pool(rng, False, num_pages, pt)
    kw = dict(page_tokens=pt, v_tail_zero=MLA_VTZ, scale=MLA_SCALE)
    table = page_tables(rng, lengths, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    s_max = int(lengths.max())
    k = torch.zeros(b, 1, s_max, d, device=DEV, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    for i, n in enumerate(lengths):
        k[i, :, :n], v[i, :, :n] = mla_dense_kv(pool, table[i], int(n), pt)
    mask = (torch.arange(s_max, device=DEV)[None, :]
            < ln[:, None].long()).view(b, 1, 1, s_max)
    q4 = q.view(b, hq, 1, d)
    dec = {"plain_ms": time_ms(lambda: paged_decode_attention_plain(
        q, pool, table, ln, **kw), 10),
        "ms": time_ms(lambda: paged_decode_attention(q, pool, table, ln,
                                                     **kw), 50),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True, scale=MLA_SCALE), 50)}
    dec["ms_2"] = time_ms(lambda: paged_decode_attention(q, pool, table, ln,
                                                         **kw), 50)
    live = int(lengths.sum())
    dec["bound_ms"], dec["bound_by"] = bound_of(
        2 * hq * live * (d + dv),
        live * d * 2 + 2 * b * hq * d * 2 + table.numel() * 4 + b * 4)
    log(f"paged_decode MLA bf16 times at lengths {lengths.tolist()}: "
        + json.dumps(dec))
    row = page_tables(rng, [offset + chunk], pt, num_pages, max_pages)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    n = offset + chunk
    k, v = mla_dense_kv(pool, row, n, pt)
    mask = (torch.arange(n, device=DEV)[None, :]
            <= offset + torch.arange(chunk, device=DEV)[:, None])
    pf = {"plain_ms": time_ms(lambda: paged_prefill_attention_plain(
        q, pool, row, offset, **kw), 10),
        "ms": time_ms(lambda: paged_prefill_attention(q, pool, row, offset,
                                                      **kw), 20),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask, enable_gqa=True,
            scale=MLA_SCALE), 20)}
    pf["ms_2"] = time_ms(lambda: paged_prefill_attention(q, pool, row, offset,
                                                         **kw), 20)
    visible = chunk * offset + chunk * (chunk + 1) // 2
    pf["bound_ms"], pf["bound_by"] = bound_of(
        2 * hq * visible * (d + dv),
        n * d * 2 + 2 * hq * chunk * d * 2 + row.numel() * 4)
    log(f"paged_prefill MLA bf16 times at offset {offset}: " + json.dumps(pf))
    return {"decode": dec, "prefill": pf}


def run_mla(seed, dec_lens):
    """Phase 12 (a)-(h), inputs from a fifth generator (seed + 4), the
    model's weights from ``seed`` → (record, phase seconds)."""
    rng = np.random.default_rng(seed + 4)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["paged_errors"] = check_mla_paged(rng)
        out["flash_errors"] = check_mla_flash(rng)
        out["int8_p_errors"] = check_int8_p_spans(rng)
        out["wo_errors"] = check_wo_gemm(rng)
        out["decompression"] = run_decompression(rng)
        out["absorbed_quantized"] = run_absorbed_quantized(rng)
    phase["mla_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = MLAConfig()  # 8 x 1024, 16 heads, d_c 256 + d_r 32, bf16
    params = init_mla_params(cfg, torch.Generator().manual_seed(seed),
                             device=DEV)
    qparams = quantize_mla_weights(params)
    out["logits_rel_l2"] = {}
    with torch.inference_mode():
        mla = dict(executor=mla_executor(), oracle=MLA_ORACLE)
        out["logits_rel_l2"]["float"] = check_logits(
            cfg, params, np.random.default_rng(seed + 5),
            label="MLA float latent", **mla)
        out["logits_rel_l2"]["w8a8+int8"] = check_logits(
            cfg, qparams, np.random.default_rng(seed + 5),
            params32=dequantized_fp32(qparams), quantized=8,
            tol=QUANT_LOGITS_TOL[8], label="MLA w8a8+int8 latent", **mla)
    phase["mla_logits"] = time.perf_counter() - t
    t = time.perf_counter()
    out["engines"] = {}
    for label, p, pool in (("float", params, False),
                           ("w8a8+int8", qparams, 8)):
        launches, stats, _, rates = run_engine(
            cfg, p, seed, quantized_cache=pool, label=f"MLA engine {label}",
            executor=mla_executor(), layer_gemms=8)
        out["engines"][label] = {"launches": launches, "rates": rates,
                                 "model_calls": stats["prefill_calls"]
                                 + stats["decode_calls"]}
    phase["mla_engines"] = time.perf_counter() - t
    del params, qparams
    t = time.perf_counter()
    with torch.inference_mode():
        out["paged_times"] = time_mla_paged(rng, dec_lens)
        out["wo_times"] = time_wo_gemm(rng)
    out["flash_times"] = time_flash(rng, DEC_B, MLA_HQ, 1, DEC_S, MLA_D)
    phase["mla_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 13: the GEMM engine
# --------------------------------------------------------------------------

# The flagship's projections over 2 × 2048 tokens: M rows, (N, K) of
# q/o, k/v, gate/up and down.
GEMM_M = 4096
ENGINE_SHAPES = ((1024, 1024), (256, 1024), (4096, 1024), (1024, 4096))
# The quantized-A and small-block kernels vs their plain versions on the
# same arguments, fp32 results: the same exact products (int × bf16,
# bf16 × bf16, fp32 × fp32) summed in another order.  Max abs over the
# plain's max abs.  comp_gemm is held bit for bit.
GEMM_KERNEL_TOL = TOLERANCES["fp32"]
# matmul vs dequantized_gemm_reference (or the exact fp32 product of the
# dequantized operands), relative L2: an fp32 compute dtype, and a bf16
# one (an operand or the result rounded to bf16).
MATMUL_TOL = {"fp32": 1e-5, "bf16": 1e-2}
GEMM_KERNELS = (qa_folded_gemm, qa_gemm, comp_gemm, comp_small_gemm,
                wo_folded_gemm, wo_gemm, dyn_gemm)
F16 = torch.float16


def blk(bs, strategy="centered"):
    return qcfg(gran="block", strategy=strategy, block_size=bs)


# (label, A config, B config or B dtype): the kernels' modes in (a).
GEMM_KERNEL_MODES = (
    ("qa folded int8 ROW", qcfg(), torch.bfloat16),
    ("qa folded int4 ROW", qcfg(bits=4), torch.bfloat16),
    ("qa folded int8 TENSOR", qcfg(gran="tensor"), torch.bfloat16),
    ("qa int8 ROW ASYMMETRIC", qcfg(strategy="asymmetric"), torch.bfloat16),
    ("qa int8 BLOCK 128", blk(128), torch.bfloat16),
    ("qa int8 ROW fp32 B", qcfg(), torch.float32),
    ("comp BLOCK 128 ASYMMETRIC", blk(128, "asymmetric"),
     blk(128, "asymmetric")),
    ("comp BLOCK 512 ASYMMETRIC", blk(512, "asymmetric"),
     blk(512, "asymmetric")),
    ("comp-small BLOCK 32", blk(32), blk(32)),
    ("comp-small BLOCK 64", blk(64), blk(64)),
)


def gemm_kernel_pair(a, b, c=None):
    """(kernel, plain, args, kw) of the GEMM kernel ``matmul(a, b, c=c)``
    launches for a quantized A (C only for a quantized B: the qa path
    adds it outside its kernel)."""
    if isinstance(b, QuantizedTensor):
        small, args, kw = comp_arguments(a, b, c)
        return ((comp_small_gemm, comp_small_gemm_plain) if small
                else (comp_gemm, comp_gemm_plain)) + (args, kw)
    folded, args, kw = qa_arguments(a, b)
    return ((qa_folded_gemm, qa_folded_gemm_plain) if folded
            else (qa_gemm, qa_gemm_plain)) + (args, kw)


def gemm_mode_operands(g, m, n, k, a_spec, b_spec, with_c=False):
    """A [M, K] quantized with ``a_spec`` (shifted, so asymmetric zero
    points are nonzero) or of that dtype; B [K, N] of dtype ``b_spec`` or
    Bᵀ [N, K] quantized with it; C fp32 [M, N] or None."""
    a = torch.randn((m, k), generator=g, device=DEV)
    a = (quantize(a + 0.25, a_spec) if isinstance(a_spec, QuantConfig)
         else a.to(a_spec))
    if isinstance(b_spec, QuantConfig):
        b = quantize(torch.randn((n, k), generator=g, device=DEV) - 0.2,
                     b_spec)
    else:
        b = (torch.randn((k, n), generator=g, device=DEV)
             * k ** -0.5).to(b_spec)
    c = torch.randn((m, n), generator=g, device=DEV) if with_c else None
    return a, b, c


def check_gemm_kernels(rng):
    """(a) The four kernels against their plain versions in each mode of
    GEMM_KERNEL_MODES at the flagship's projection shapes (M = 4096) and
    gemm_bench's (M = 128 and 4096, N = K = 8192); the compensated modes
    with and without ``c=``.  → {label: (rel err, max abs err)}, worst
    over the shapes."""
    g = device_generator(rng)
    shapes = [(GEMM_M, n, k) for n, k in ENGINE_SHAPES] + list(GEMM_SHAPES)
    errs = {}
    for label, a_cfg, b_spec in GEMM_KERNEL_MODES:
        cs = (False, True) if isinstance(b_spec, QuantConfig) else (False,)
        for with_c in cs:
            name = f"{label}{' c=' if with_c else ''}"
            worst = (0.0, 0.0)
            for m, n, k in shapes:
                a, b, c = gemm_mode_operands(g, m, n, k, a_cfg, b_spec,
                                             with_c)
                kernel, plain, args, kw = gemm_kernel_pair(a, b, c)
                out = kernel(*args, **kw)
                torch.cuda.synchronize()
                ref = plain(*args, **kw)
                e = (rel_err(out, ref), max_abs(out, ref))
                worst = max(worst[0], e[0]), max(worst[1], e[1])
                exact = kernel is comp_gemm
                if not (torch.equal(out, ref) if exact
                        else e[0] <= GEMM_KERNEL_TOL):
                    raise AssertionError(
                        f"{kernel.__name__} {name} M={m} N={n} K={k} "
                        f"disagrees with its plain version: {e}")
                del a, b, c, args, out, ref
            errs[name] = worst
            log(f"{kernel.__name__} {name}: {len(shapes)} shapes, worst rel "
                f"{worst[0]:.2e} max abs {worst[1]:.2e} (tol "
                f"{'bit for bit' if exact else GEMM_KERNEL_TOL})")
    return errs


# (label, A spec, B spec, the kernel matmul launches or None, compute
# dtype, with c, options): every operand kind and dispatch arm in (b).
MATMUL_CASES = (
    ("float x float fp32", torch.float32, torch.float32, None, "fp32",
     False, {}),
    ("float x float bf16", torch.bfloat16, torch.bfloat16, None, "bf16",
     False, {}),
    ("float x float fp32 transpose_a + c", torch.float32, torch.float32,
     None, "fp32", True, dict(transpose_a=True)),
    ("float x QT folded int8 ROW", torch.bfloat16, qcfg(), wo_folded_gemm,
     "bf16", False, {}),
    ("float x QT int8 BLOCK 128 + c", torch.bfloat16, blk(128), wo_gemm,
     "bf16", True, {}),
    ("float x QT fp32 A, int8 ROW ASYMMETRIC", torch.float32,
     qcfg(strategy="asymmetric"), wo_gemm, "fp32", False, {}),
    ("QT x float folded int8 ROW", qcfg(), torch.bfloat16, qa_folded_gemm,
     "bf16", False, {}),
    ("QT x float folded int4 ROW + c", qcfg(bits=4), torch.bfloat16,
     qa_folded_gemm, "bf16", True, {}),
    ("QT x float folded int8 TENSOR, fp16 B", qcfg(gran="tensor"), F16,
     qa_folded_gemm, "bf16", False, {}),
    ("QT x float int8 ROW ASYMMETRIC", qcfg(strategy="asymmetric"),
     torch.bfloat16, qa_gemm, "bf16", False, {}),
    ("QT x float int8 BLOCK 128", blk(128), torch.bfloat16, qa_gemm, "bf16",
     False, {}),
    ("QT x float int8 ROW, fp32 B + c", qcfg(), torch.float32, qa_gemm,
     "fp32", True, {}),
    ("QT x QT BLOCK 128 ASYMMETRIC", blk(128, "asymmetric"),
     blk(128, "asymmetric"), comp_gemm, "fp32", False, {}),
    ("QT x QT BLOCK 512 + c", blk(512), blk(512), comp_gemm, "fp32", True,
     {}),
    ("QT x QT BLOCK 32", blk(32), blk(32), comp_small_gemm, "fp32", False,
     {}),
    ("QT x QT BLOCK 64 ASYMMETRIC + c", blk(64, "asymmetric"),
     blk(64, "asymmetric"), comp_small_gemm, "fp32", True, {}),
    ("QT x QT degraded: int4 A", qcfg(bits=4, gran="block",
                                      strategy="centered", block_size=128),
     blk(128), wo_gemm, "bf16", False, {}),
    ("QT x QT degraded: blocks 128 / 64", blk(128), blk(64), wo_gemm,
     "bf16", False, {}),
    ("QT x QT degraded: ROW B", blk(128), qcfg(), wo_folded_gemm, "bf16",
     False, {}),
    ("QT x QT degraded: no fast int8 path + c", blk(128), blk(128), wo_gemm,
     "bf16", True, dict(no_int8=True)),
)


def matmul_reference(a, b, c):
    """The exact fp32 product of the dequantized operands (+ C):
    ``dequantized_gemm_reference`` for two quantized ones."""
    if isinstance(a, QuantizedTensor) and isinstance(b, QuantizedTensor):
        ref = dequantized_gemm_reference(a, b)
    else:
        af = dequantize(a) if isinstance(a, QuantizedTensor) else a.float()
        bf = (dequantize(b).t() if isinstance(b, QuantizedTensor)
              else b.float())
        ref = af @ bf
    return ref if c is None else ref + c


def run_matmul_paths(rng):
    """(b) ``matmul`` at M=4096, N=K=1024 over MATMUL_CASES, each call
    with every GEMM kernel's count set to 0 just before and read just
    after: exactly one launch of the expected kernel (none for float ×
    float), none of the others.  → {label: {rel_l2, launches}}."""
    g = device_generator(rng)
    m, n, k = GEMM_M, 1024, 1024
    probe = capabilities.probe_capabilities
    out = {}
    for label, a_spec, b_spec, want, compute, with_c, opts in MATMUL_CASES:
        a, b, c = gemm_mode_operands(g, m, n, k, a_spec, b_spec, with_c)
        a_in, desc = a, None
        if opts.get("transpose_a"):
            a_in = a.t().contiguous()
            desc = GEMMDescriptor(m=m, n=n, k=k, transpose_a=True)
        if opts.get("no_int8"):
            capabilities.probe_capabilities = (
                lambda device=None: dataclasses.replace(
                    probe(device), has_int8_mxu=False))
        for fn in GEMM_KERNELS:
            fn.launches = 0
        try:
            res = matmul(a_in, b, descriptor=desc, c=c)
            torch.cuda.synchronize()
        finally:
            capabilities.probe_capabilities = probe
        launches = {fn.__name__: fn.launches for fn in GEMM_KERNELS}
        expected = {fn.__name__: int(fn is want) for fn in GEMM_KERNELS}
        err = rel_l2(res, matmul_reference(a, b, c))
        log(f"matmul {label}: rel L2 {err:.3e} (tol {MATMUL_TOL[compute]}), "
            f"launches {[k_ for k_, v in launches.items() if v]}")
        if launches != expected:
            raise AssertionError(f"matmul {label}: launches {launches}, "
                                 f"expected {expected}")
        if not (np.isfinite(err) and err <= MATMUL_TOL[compute]
                and res.shape == (m, n)):
            raise AssertionError(f"matmul {label} disagrees with the "
                                 f"dequantized reference: {err}")
        out[label] = {"rel_l2": err, "launches": launches}
    return out


# gemm_bench-shape arm of utils/profiling.py each kernel is timed on (its
# label: the kernel's name, and the payload's for the weight-only ones),
# the library call it is set beside, and what bounds its operations.
GEMM_TIMED = (
    ("qa_folded_gemm", "qa_folded_int8_row", BF16_FLOPS),
    ("qa_gemm", "qa_int8_row_asymmetric", BF16_FLOPS),
    ("comp_gemm", "compensated_int8", INT8_OPS),
    ("comp_small_gemm", "compensated_small_int8_b64", INT8_OPS),
    ("wo_gemm int8", "weight_only_int8", BF16_FLOPS),
    ("wo_gemm int4", "weight_only_int4", BF16_FLOPS),
    ("wo_folded_gemm", "weight_only_folded_int8_row", BF16_FLOPS),
)
WO_LIBRARY = "torch.matmul of the bf16 A by the pre-dequantized bf16 Wᵀ"
GEMM_LIBRARY = {
    "qa_folded_gemm": "torch.matmul of the dequantized bf16 A by the bf16 B",
    "qa_gemm": "torch.matmul of the dequantized bf16 A by the bf16 B",
    "comp_gemm": "torch._int_mm over the int8 payloads (the raw int32 "
                 "product only)",
    "comp_small_gemm": "fp32 torch.matmul of the dequantized operands, TF32 "
                       "off",
    "wo_gemm": WO_LIBRARY,
    "wo_folded_gemm": WO_LIBRARY,
}


def time_gemm_kernels(rng):
    """(c) The seven kernels' arms at gemm_bench's shapes on
    utils/profiling.py's arms, beside their bounds (the operands read once,
    the fp32 result written once, bf16 for the weight-only ones; or
    2·M·N·K over the bf16 peak for the quantized-A and weight-only kernels,
    over the int8 peak for both compensated kernels: their operands are
    int8 payloads with per-block scales, whose block products the int8
    tensor cores take at any block that is a multiple of 32, so
    comp_small_gemm's exact-fp32 design, copied from the TPU kernel, is not
    the card's limit), plain versions and library calls (GEMM_LIBRARY).
    The weight-only kernels are first held to their plain versions there
    (``check_wo``) and timed by ``time_wo_call``.
    → {label: {"m{M}": times}}."""
    g = device_generator(rng)
    times = {}
    for name, arm, peak in GEMM_TIMED:
        times[name] = {}
        for m, n, k in GEMM_SHAPES:
            _, (a, b) = gemm_arm(arm, m, n, k, g)
            iters = 10 if m <= 128 else 3
            if name.startswith("wo"):
                _, err = check_wo(f"M={m} N={n} K={k}", a, b)
                folded = name == "wo_folded_gemm"
                t = time_wo_call(f"{name} M={m} N={n} K={k}", a, b,
                                 n if folded else 2 * k, iters,
                                 plain_iters=1 if m > 128 else 2)
                t["rel_err"], t["max_abs_err"] = err
                times[name][f"m{m}"] = t
                del a, b
                continue
            kernel, plain, args, kw = gemm_kernel_pair(a, b)
            if kernel in (qa_gemm, qa_folded_gemm):
                log(f"{name} at M={m} runs the "
                    f"{qa_gemm_body(args[1].dtype)} tile")
            if name.startswith("qa"):
                ad = dequantize(a).to(torch.bfloat16)
                library = (lambda ad=ad, b=b: ad @ b)
                vec = 2 * m * 4
            elif name == "comp_gemm":
                library = (lambda a=a, b=b: torch._int_mm(a.data, b.data.t()))
                vec = 4 * (m + n) * (k // 512) + 16 * (k // 512)
            else:
                ad, bd = dequantize(a), dequantize(b).t()
                library = (lambda ad=ad, bd=bd: ad @ bd)
                vec = 16 * k
            t = {"plain_ms": time_ms(lambda: plain(*args, **kw), 2,
                                     warmup=1),
                 "ms": time_ms(lambda: kernel(*args, **kw), iters,
                               warmup=1)}
            t["ms_2"] = time_ms(lambda: kernel(*args, **kw), iters, warmup=0)
            t["library_ms"] = time_ms(library, iters, warmup=1)
            parent_turns(f"{name} M={m} N={n} K={k}", t,
                         lambda: kernel(*args, **kw), iters)
            a_bytes = a.nbytes_payload
            b_bytes = (b.nbytes_payload if isinstance(b, QuantizedTensor)
                       else b.numel() * b.element_size())
            bound = {"bytes": (a_bytes + b_bytes + vec + 4 * m * n)
                     / HBM_BYTES_PER_S * 1e3,
                     "operations": 2 * m * n * k / peak * 1e3}
            t["bound_by"] = max(bound, key=bound.get)
            t["bound_ms"] = bound[t["bound_by"]]
            log(f"{name} times at M={m} N={n} K={k} ({arm}): "
                + json.dumps(t))
            times[name][f"m{m}"] = t
            del a, b, args, kw
    return times


def run_gemm_engine(seed):
    """Phase 13 (a)-(c), inputs from a sixth generator (seed + 5) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 5)
    out, phase = {}, {}
    with torch.inference_mode():
        t = time.perf_counter()
        out["kernel_errors"] = check_gemm_kernels(rng)
        phase["gemm_kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        out["matmul"] = run_matmul_paths(rng)
        phase["gemm_matmul"] = time.perf_counter() - t
        t = time.perf_counter()
        out["times"] = time_gemm_kernels(rng)
        phase["gemm_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None, help=(
        "a checkout of the parent commit: its kernels are built too, and "
        "every timed kernel is also timed on them in turns (parent, "
        "change, change, parent)"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    phase_s = {}

    t = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {smi}")
    build_all(args.parent)
    phase_s["build"] = time.perf_counter() - t

    t = time.perf_counter()
    err_dec = check_decode(rng, 64)
    err_dec128 = check_decode(rng, 128)
    err_pf = max(check_prefill(rng, off) for off in (0, 512, 300))
    phase_s["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    flash_train_errs, flash_small_worst = check_flash_all(rng)
    phase_s["flash_kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg = TransformerConfig()  # the flagship: 8 x 1024, 16/4 heads, bf16
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(cfg, gen, device=DEV)
    with torch.inference_mode():
        check_logits(cfg, params, rng)
    phase_s["logits"] = time.perf_counter() - t

    t = time.perf_counter()
    launches, stats, prompt_lens, float_rates = run_engine(cfg, params,
                                                           args.seed)
    phase_s["engine"] = time.perf_counter() - t

    t = time.perf_counter()
    grad_worst = check_train_grads(cfg, params, rng)
    phase_s["grads"] = time.perf_counter() - t

    t = time.perf_counter()
    init_logits = quantized_logits_at_init(cfg, params, args.seed)
    phase_s["quant_logits_init"] = time.perf_counter() - t

    t = time.perf_counter()
    init_qfwd = run_quantized_attention_forwards(cfg, params, args.seed, None,
                                                 "random-init")
    phase_s["qattn_forward_init"] = time.perf_counter() - t

    t = time.perf_counter()
    train_init = clone_params(params)
    train_launches, train_tps = run_train(cfg, params, args.seed)
    phase_s["train"] = time.perf_counter() - t
    t = time.perf_counter()
    train_det = check_train_determinism(cfg, train_init, args.seed, params)
    del train_init
    phase_s["train_determinism"] = time.perf_counter() - t

    t = time.perf_counter()
    with torch.inference_mode():
        dec_lens = [n + 16 for n in prompt_lens]
        dec_t, dec_bound, dec_by = time_decode(rng, dec_lens)
        # The same decode at D=128 (the TPU's _decode_kernel schedule; off
        # the flagship's path, so it has no launches there).
        d128_t, d128_bound, _ = time_decode(rng, dec_lens, d=128)
        pf_t, pf_bound, pf_by = time_prefill(rng, 512)
    flash_t = time_flash(rng)
    phase_s["times"] = time.perf_counter() - t

    quant, quant_phase = run_quantized(
        cfg, params, args.seed, np.random.default_rng(args.seed + 1),
        dec_lens)
    phase_s.update(quant_phase)
    qattn, qattn_phase = run_quantized_attention(
        cfg, params, args.seed, np.random.default_rng(args.seed + 2))
    phase_s.update(qattn_phase)
    qbwd, qbwd_phase = run_quantized_backward(args.seed)
    phase_s.update(qbwd_phase)
    mla, mla_phase = run_mla(args.seed, dec_lens)
    phase_s.update(mla_phase)
    gemm, gemm_phase = run_gemm_engine(args.seed)
    phase_s.update(gemm_phase)
    log_parent_summary()
    log("phase seconds: " + json.dumps(
        {k: round(v, 2) for k, v in phase_s.items()}))
    engines = quant["engines"]
    log("engine rates, float / W8A8+int8 / W4A8+int4: " + json.dumps(
        {"float": float_rates, **{k: v["rates"] for k, v in engines.items()}}))
    log("MLA engine rates, float / W8A8+int8 latent: " + json.dumps(
        {k: v["rates"] for k, v in mla["engines"].items()}))

    record = {"kernels": [
        {"name": "paged_decode", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_FILE}:209",
         "launches": launches["paged_decode"], "max_abs_err": err_dec,
         "max_abs_err_d128": err_dec128, "ms_d128": d128_t["ms"],
         "plain_ms_d128": d128_t["plain_ms"], "bound_ms_d128": d128_bound,
         "library_ms_d128": d128_t["library_ms"],
         "ms": dec_t["ms"], "plain_ms": dec_t["plain_ms"],
         "bound_ms": dec_bound, "bound_by": dec_by,
         "library_ms": dec_t["library_ms"]},
        {"name": "paged_prefill", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_FILE}:306",
         "launches": launches["paged_prefill"], "max_abs_err": err_pf,
         "ms": pf_t["ms"], "plain_ms": pf_t["plain_ms"],
         "bound_ms": pf_bound, "bound_by": pf_by,
         "library_ms": pf_t["library_ms"]},
    ]}
    # The paged kernels' int8 / int4 modes, from phase 9.
    for entry, kind in zip(record["kernels"], ("decode", "prefill")):
        for bits in (8, 4):
            qt = quant["times"][f"{kind}_int{bits}"]
            eng = engines[f"w{bits}a8+int{bits}"]["launches"]
            entry.update({
                f"launches_int{bits}": eng[f"paged_{kind}"],
                f"max_abs_err_int{bits}": quant["errors"][
                    f"{kind}_int{bits}"],
                **{f"{key}_int{bits}": qt[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
            })
    g8, g8p = (quant["times"][f"dyn_gemm_w8_m{m}"] for m in (8, 256))
    g4, g4p = (quant["times"][f"dyn_gemm_w4_m{m}"] for m in (8, 256))
    record["kernels"].append({
        "name": "dyn_gemm", "route": "cuda", "source": GEMM_SOURCE,
        "replaces": f"{GEMM_TPU}:1002",
        "launches": sum(e["launches"]["dyn_gemm"] for e in engines.values()),
        **{f"launches_{k.split('+')[0]}": e["launches"]["dyn_gemm"]
           for k, e in engines.items()},
        "max_abs_err": quant["errors"]["dyn_gemm"],
        "shape": "one model call's 57 GEMMs at M=8 (decode), W8A8",
        "ms": g8["ms"], "plain_ms": g8["plain_ms"],
        "bound_ms": g8["bound_ms"], "bound_by": g8["bound_by"],
        "library_ms": g8["library_ms"],
        "library": "torch._int_mm on the same int8 operands (M padded to 32)",
        "library_bf16_matmul_ms": g8["library_bf16_matmul_ms"],
        **{f"{key}_{tag}": t[key] for tag, t in (
            ("m256", g8p), ("w4_m8", g4), ("w4_m256", g4p))
           for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "library_bf16_matmul_ms")},
    })
    replaces = {"flash_fwd": f"{FLASH_TPU}:546",
                "flash_dq": f"{FLASH_BWD_TPU}:77",
                "flash_dkv": f"{FLASH_BWD_TPU}:954"}
    # The paged kernels at MLA's geometry, from phase 12.
    for entry, kind in zip(record["kernels"], ("decode", "prefill")):
        mt = mla["paged_times"][kind]
        errs_k = [e for n, e in mla["paged_errors"].items()
                  if n.startswith(kind)]
        entry.update({
            **{f"launches_mla_{k}": e["launches"][f"paged_{kind}"]
               for k, e in mla["engines"].items()},
            "rel_err_mla": max(e[0] for e in errs_k),
            "max_abs_err_mla": max(e[1] for e in errs_k),
            **{f"{key}_mla": mt[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    mla_flash = mla["flash_errors"]
    for name, t in flash_t.items():
        bf16 = flash_train_errs[torch.bfloat16]
        fp32 = flash_train_errs[torch.float32]
        keys = (("o", "l") if name == "flash_fwd" else
                ("dq",) if name == "flash_dq" else ("dk", "dv"))
        mt = mla["flash_times"][name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": max(bf16[k][1] for k in keys),
            "rel_err": max(bf16[k][0] for k in keys),
            "rel_err_fp32": max(fp32[k][0] for k in keys),
            "rel_err_small_shapes_worst": flash_small_worst,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": ("sdpa forward" if name == "flash_fwd" else
                        "sdpa backward (dq, dk, dv together)"),
            **{f"rel_err_mla_d{d}": max(
                errs[k][0] for label, errs in mla_flash.items()
                if label.startswith(f"d{d}") for k in keys)
               for d in (80, 288)},
            **{f"{key}_mla_d288": mt[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **({"body": t["body"], "body_mla_d288": mt["body"],
                "redesigned": REDESIGNED} if "body" in t else {}),
        })
    next(e for e in record["kernels"] if e["name"] == "flash_fwd")[
        "launches_mla_decompression"] = sum(
            d["launches"]["flash_fwd"] for d in mla["decompression"].values())
    qt, fwd = qattn["times"], qattn["forward"]
    flagship_modes = ("quantize_q_row", "dequant_row8c", "dequant_row4c",
                      "folded_tensor", "folded_row")
    small_worst = max(e[0] for n, e in qattn["qattn_errors"].items()
                      if n not in flagship_modes)
    qattn_entries = [
        ("qattn_fwd", QATTN_SOURCE, f"{QATTN_TPU}:87",
         fwd["unpacked"][1]["qattn_fwd"],
         max(qattn["qattn_errors"][m][2] for m in flagship_modes),
         {"rel_err": max(qattn["qattn_errors"][m][0]
                         for m in flagship_modes),
          "rel_err_small_shapes_worst": small_worst,
          "launches_facade": qattn["facade"]["int8"][1]["qattn_fwd"],
          "shape": "B=2 Hq=16 Hkv=4 S=2048 D=64 causal, quantize_q ROW "
                   "(the unpacked quantized_forward's mode)",
          "body": qt["qattn_fwd"]["body"],
          "redesigned": REDESIGNED}),
        ("hpack_fwd", QATTN_SOURCE, f"{QATTN_TPU}:654",
         fwd["packed"][1]["hpack_fwd"],
         max(e[2] for e in qattn["hpack_errors"].values()),
         {"rel_err": max(e[0] for e in qattn["hpack_errors"].values()),
          "shape": "packed [2, 8, 2048, 128], int8 CHANNEL, causal",
          "body": qt["hpack_fwd"]["body"],
          "redesigned": REDESIGNED}),
        ("runtime_quantize_row", RTQ_SOURCE, f"{RTQ_TPU}:79",
         qattn["facade"]["int8"][1]["runtime_quantize_row"], 0.0,
         {"shape": "[16384, 64] bf16 CENTERED (the facade's K/V rows)"}),
        ("runtime_quantize_block", RTQ_SOURCE, f"{RTQ_TPU}:63",
         qattn["block_launches"], 0.0,
         {"shape": "[4096, 1024] bf16 CENTERED bs 64"}),
    ]
    for name, source, replaces, launches, err, extra in qattn_entries:
        t = qt[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **({"library": "sdpa over the dequantized bf16 K/V"}
               if t["library_ms"] is not None else {}),
            **extra,
            **{k: v for k, v in t.items() if k.endswith("_facade_mode")
               or k == "parent_turns_ms"},
        })
    bt, ns, qat = qbwd["times"], qbwd["north_star"], qbwd["qat"]
    errs, ns_errs = qbwd["errors"], qbwd["north_star_errors"]
    next(e for e in record["kernels"] if e["name"] == "qattn_fwd").update({
        "launches_north_star": ns["launches"]["fullint"]["qattn_fwd"],
        "max_abs_err_north_star": ns_errs["qattn_fwd"][2],
        "rel_err_north_star": ns_errs["qattn_fwd"][0],
        "rel_err_l_north_star": ns_errs["qattn_fwd"][1],
        "rel_err_one_pass_north_star_not_gated": ns_errs[
            "qattn_fwd_one_pass"][0],
        **{f"{key}_north_star": bt["qattn_fwd"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "parent_turns_ms") if key in bt["qattn_fwd"]},
        "shape_north_star": "B=4 H=4 S=4096 D=256 FULL, int8 Q and int8 P, "
                            "ROW K / CHANNEL V (both arms of the north-star "
                            "fwd+bwd)",
        "launches_mla_quantized_latent": mla["absorbed_quantized"][
            "launches"],
        "rel_err_mla_quantized_latent": mla["absorbed_quantized"][
            "errors"]["kernel"][0],
        "max_abs_err_mla_quantized_latent": mla["absorbed_quantized"][
            "errors"]["kernel"][2],
        "shape_mla_quantized_latent": "B=2 Hq=16 Hkv=1 S=2048 D=256 causal, "
                                      "bf16 Q, ROW CENTERED int8 latent "
                                      "(mla_absorbed_attention)",
    })

    def worst(name, index):
        """The worst (rel, max abs) error of a kernel over phase 11 (a)."""
        outs = ("dq", "dbias") if name.endswith("_dq") else ("dk", "dv")
        return max(e[index] for check, es in errs.items()
                   if check.startswith("fullint") == name.startswith(
                       "fullint")
                   for out, e in es.items() if out in outs)

    bwd_entries = [
        ("qflash_dq", f"{FLASH_BWD_TPU}:77",
         ns["launches"]["exact"]["qflash_dq"], "qflash",
         "B=4 H=4 S=4096 D=256 FULL, folded ROW K / CHANNEL V (the exact "
         "arm of the north-star fwd+bwd)"),
        ("qflash_dkv", f"{FLASH_BWD_TPU}:954",
         ns["launches"]["exact"]["qflash_dkv"], "qflash",
         "B=4 H=4 S=4096 D=256 FULL, per-token K / channel V dequant"),
        ("fullint_dq", f"{FLASH_BWD_TPU}:511",
         ns["launches"]["fullint"]["fullint_dq"], "fullint",
         "B=4 H=4 S=4096 D=256 FULL, level 1, ROW K (the north-star)"),
        ("fullint_dkv", f"{FLASH_BWD_TPU}:584",
         ns["launches"]["fullint"]["fullint_dkv"], "fullint",
         "B=4 H=4 S=4096 D=256 FULL, level 1, ROW K (the north-star)"),
    ]
    for name, replaces, launches, prefix, shape in bwd_entries:
        t = bt[name]
        extra = ({"launches_qat": qat["launches"]["qat"][name],
                  "launches_facade": qat["launches"]["facade"][name]}
                 if prefix == "qflash" else {})
        record["kernels"].append({
            "name": name, "route": "cuda", "source": QBWD_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(e[1] for e in ns_errs[name].values()),
            "rel_err": max(e[0] for e in ns_errs[name].values()),
            "max_abs_err_all_modes_worst": worst(name, 1),
            "rel_err_all_modes_worst": worst(name, 0),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "sdpa backward over the dequantized bf16 K/V (dq, dk,"
                       " dv together)",
            "shape": shape, **extra,
            **{k: v for k, v in t.items()
               if k.endswith(("_qat_mode", "_level2"))},
            **({"body": t["body"], "redesigned": REDESIGNED}
               if "body" in t else {}),
        })
    wo_modes = {"wo_folded_gemm": (f"{GEMM_TPU}:235", "int8 ROW (WEIGHT_CFG)"),
                "wo_gemm": (f"{GEMM_TPU}:196", "int8 BLOCK 128 CENTERED")}
    # gemm_bench's shapes, by record key: (label in 13 (c), mode).
    wo_bench = {"wo_folded_gemm": {"int8_row": ("wo_folded_gemm",
                                                "int8 ROW SYMMETRIC")},
                "wo_gemm": {"int8_block256": ("wo_gemm int8",
                                              "int8 BLOCK 256 SYMMETRIC"),
                            "int4_block256": ("wo_gemm int4",
                                              "int4 BLOCK 256 SYMMETRIC")}}
    wo_keys = ("ms", "device_ms", "ms_fp32_out", "plain_ms", "bound_ms",
               "bound_by", "library_ms", "body", "tile_rows", "k_splits",
               "rel_err", "max_abs_err", "parent_turns_ms")
    for name, (replaces, mode) in wo_modes.items():
        t = mla["wo_times"][name]
        errs_k = [e for n, e in mla["wo_errors"].items()
                  if n.startswith("folded") == (name == "wo_folded_gemm")]
        entry = {
            "name": name, "route": "cuda", "source": GEMM_SOURCE,
            "replaces": replaces,
            "launches": sum(d["launches"][name]
                            for d in mla["decompression"].values()),
            "launches_matmul_paths": sum(c["launches"][name]
                                         for c in gemm["matmul"].values()),
            "max_abs_err": max(e[1] for e in errs_k),
            "rel_err": max(e[0] for e in errs_k),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": WO_LIBRARY,
            "device_ms": t["device_ms"], "ms_fp32_out": t["ms_fp32_out"],
            "body": t["body"],
            "tile_rows": t["tile_rows"], "k_splits": t["k_splits"],
            "body_fp32_a": wo_gemm_body(torch.float32),
            "redesigned": REDESIGNED,
            "shape": f"M={DEC_B * DEC_S} N={DEC_H * DEC_DH} K={DEC_DC}, bf16 "
                     f"latent, {mode}, bf16 out (mla_decompress)",
            **({"parent_turns_ms": t["parent_turns_ms"]}
               if "parent_turns_ms" in t else {}),
        }
        for tag, (label, bench_mode) in wo_bench[name].items():
            for m, n, k in GEMM_SHAPES:
                bt_ = gemm["times"][label][f"m{m}"]
                entry[f"shape_{tag}_m{m}"] = (
                    f"M={m} N={n} K={k}, bf16 A, {bench_mode}, bf16 out "
                    "(benchmarks/gemm_bench.py)")
                entry.update({f"{key}_{tag}_m{m}": bt_[key]
                              for key in wo_keys if key in bt_})
        record["kernels"].append(entry)
    gemm_tpu = {"qa_folded_gemm": 498, "qa_gemm": 461, "comp_gemm": 707,
                "comp_small_gemm": 763}
    gemm_shape = {
        "qa_folded_gemm": "int8 ROW SYMMETRIC A x bf16 B",
        "qa_gemm": "int8 ROW ASYMMETRIC A x bf16 B",
        "comp_gemm": "int8 x int8 BLOCK 512 SYMMETRIC",
        "comp_small_gemm": "int8 x int8 BLOCK 64 CENTERED"}
    for name, line in gemm_tpu.items():
        t = gemm["times"][name]
        errs_k = [e for label, e in gemm["kernel_errors"].items()
                  if label.startswith(
                      "qa folded" if name == "qa_folded_gemm" else
                      "qa int8" if name == "qa_gemm" else
                      "comp BLOCK" if name == "comp_gemm" else "comp-small")]
        big, small = t[f"m{GEMM_SHAPES[1][0]}"], t[f"m{GEMM_SHAPES[0][0]}"]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": GEMM_SOURCE,
            "replaces": f"{GEMM_TPU}:{line}",
            "launches": sum(c["launches"][name]
                            for c in gemm["matmul"].values()),
            "max_abs_err": max(e[1] for e in errs_k),
            "rel_err": max(e[0] for e in errs_k),
            **{key: big[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "library": GEMM_LIBRARY[name],
            "shape": "M=%d N=%d K=%d, %s" % (*GEMM_SHAPES[1],
                                             gemm_shape[name]),
            **{f"{key}_m{GEMM_SHAPES[0][0]}": small[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "parent_turns_ms") if key in small},
            **({"parent_turns_ms": big["parent_turns_ms"]}
               if "parent_turns_ms" in big else {}),
            **({"body": (qa_gemm_body(torch.bfloat16)
                         if name.startswith("qa") else "tensor_core"),
                "redesigned": REDESIGNED}
               if name != "comp_small_gemm" else {}),
        })
    for entry in record["kernels"]:
        entry["device_kernel"] = DEVICE_KERNELS[entry["name"]]
    record["gemm_engine"] = {
        "matmul_rel_l2": {k: v["rel_l2"] for k, v in gemm["matmul"].items()},
    }
    record["mla"] = {
        "logits_rel_l2": mla["logits_rel_l2"],
        "decompression_rel_l2": {k: v["rel_l2"]
                                 for k, v in mla["decompression"].items()},
        "decompression_path_times": {
            k: v["times"] for k, v in mla["decompression"].items()},
        "absorbed_int8_latent_rel_l2": mla["absorbed_quantized"]["errors"][
            "vs_fp32_rel_l2"],
        "int8_p_span_rel_err": {k: v[0]
                                for k, v in mla["int8_p_errors"].items()},
        "rates": {k: v["rates"] for k, v in mla["engines"].items()},
    }
    record["quantized_backward"] = {
        key: ns[key] for key in ("fullint_vs_exact", "exact_vs_dense",
                                 "fullint_vs_dense_not_gated", "seconds")}
    record["quantized_backward"].update(qat_rel_l2=qat["qat"],
                                        facade_dq_rel_l2=qat["facade"])
    record["quantized_attention"] = {
        "logits_rel_l2": {k: v[0] for k, v in fwd.items()},
        "logits_rel_l2_random_init_not_gated": {
            k: v[0] for k, v in init_qfwd.items()},
        "facade_rel_l2": {k: v[0] for k, v in qattn["facade"].items()},
    }
    record["train"] = {"tokens_per_s": train_tps,
                       "grad_rel_l2_worst": grad_worst,
                       "determinism": train_det}
    record["quantized_serving"] = {
        "logits_rel_l2": quant["logits_rel_l2"],
        "logits_rel_l2_random_init_not_gated": init_logits,
        "rates": {"float": float_rates,
                  **{k: v["rates"] for k, v in engines.items()}},
    }
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

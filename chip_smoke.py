#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels and native runtime from the sources in the
checkout, then, on the card:

1. device and build: the card's name and power limit, build seconds;
2. each kernel against its plain PyTorch version in bf16, at the flagship
   shapes (decode also at head_dim 128; prefill at three chunk offsets);
3. full-width logits: the flagship model (random weights from the seed)
   through ``prefill_chunk`` and ``decode_step``, against the plain fp32
   ``forward`` on fp32 copies of the same weights;
4. the main path: a ``ServingEngine`` with its defaults serves 8 requests,
   with every kernel's launch count set to 0 just before and read after;
5. kernel, plain-version and library (SDPA) times at the engine's shapes.

Every phase raises on failure, so the script exits non-zero.  It prints
the kernels' record as one JSON line and, as the very last line,
``{"ok": true, "device": {...}}``.  It needs a CUDA device: without one it
exits 2 and prints no result.  The port is imported from the checkout, so
the script alone, outside the repository, fails at import.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.models.cached import (
    decode_step,
    init_cache,
    prefill_chunk,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
)
from metal_flash_attention_plus_tpu_torch.serving.engine import ServingEngine
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from metal_flash_attention_plus_tpu_torch.utils.profiling import (
    smoke_requests,
)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core flop/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Kernel vs plain version, both on identical bf16 inputs: they round the
# same values to bf16 at the same places (q after scaling, P before P.V);
# what differs is the order of the fp32 sums and of exp, and the online vs
# one-pass rescaling of P before its bf16 rounding.  Max abs error; no
# looser than TOLERANCES["mixed"].
KERNEL_TOL = 2e-2
# Cached bf16 serving path vs the fp32 oracle, relative L2 over the logits:
# bf16 activations and bf16 K/V through 8 layers.
LOGITS_REL_L2_TOL = TOLERANCES["mixed"]

DEV = torch.device("cuda")
SOURCE = "metal_flash_attention_plus_tpu_torch/csrc/paged_attention.cu"
TPU_FILE = "metal_flash_attention_plus_tpu/serving/paged_attention.py"


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 1: build
# --------------------------------------------------------------------------


def build_all():
    """nvcc (kernels) and g++ (runtime) started together."""
    errors = []

    def run(name):
        try:
            _build.load_library(name)
        except BaseException as exc:  # reported and re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(n,))
               for n in ("kernels", "runtime")]
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
    perm = rng.permutation(num_pages)
    table = np.full((len(lengths), max_pages), num_pages, np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        pages = -(-int(n) // pt)
        table[i, :pages] = perm[nxt: nxt + pages]
        nxt += pages
    assert nxt <= num_pages
    return pool, torch.from_numpy(table).to(DEV)


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# --------------------------------------------------------------------------
# Phase 2: kernels vs plain versions
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
# Phase 3: full-width logits vs the fp32 oracle
# --------------------------------------------------------------------------


def rel_l2(x, ref) -> float:
    return ((x.float() - ref).norm() / ref.norm()).item()


def check_logits(cfg, params, rng):
    params32 = {
        "embed": params["embed"].float(),
        "unembed": params["unembed"].float(),
        "ln_f": params["ln_f"],
        "layers": [{k: v.float() for k, v in layer.items()}
                   for layer in params["layers"]],
    }
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    pt, chunk, num_pages, max_pages = 256, 256, 16, 8
    cache = init_cache(cfg, num_pages, pt, device=DEV)
    seqs = [list(rng.integers(0, cfg.vocab_size, n)) for n in (300, 420)]
    rows = torch.full((2, max_pages), num_pages, dtype=torch.int32)
    rows[0, :3] = torch.tensor([5, 0, 9])
    rows[1, :3] = torch.tensor([2, 11, 7])
    rows = rows.to(DEV)

    def oracle(seq):
        return forward(params32, torch.tensor([seq], device=DEV), cfg32)[0, -1]

    worst = 0.0
    last = []
    for s, seq in enumerate(seqs):
        for start in range(0, len(seq), chunk):
            part = seq[start: start + chunk]
            padded = torch.zeros(chunk, dtype=torch.long)
            padded[: len(part)] = torch.tensor(part)
            logits, cache = prefill_chunk(
                params, padded.to(DEV), start, len(part) - 1, cache,
                rows[s].contiguous(), cfg)
        err = rel_l2(logits, oracle(seq))
        worst = max(worst, err)
        log(f"prefill seq {s} ({len(seq)} tokens): logits rel L2 {err:.3e}")
        last.append(int(torch.argmax(logits)))
    for _ in range(8):
        for s in range(2):
            seqs[s].append(last[s])
        tokens = torch.tensor(last, device=DEV)
        lengths = torch.tensor([len(x) for x in seqs], dtype=torch.int32,
                               device=DEV)
        logits, cache = decode_step(params, tokens, lengths, rows, cache, cfg)
        for s in range(2):
            err = rel_l2(logits[s], oracle(seqs[s]))
            worst = max(worst, err)
        last = torch.argmax(logits, dim=-1).tolist()
    log(f"logits rel L2, worst over prefill + 8 decode steps: {worst:.3e} "
        f"(tol {LOGITS_REL_L2_TOL})")
    if not (np.isfinite(worst) and worst <= LOGITS_REL_L2_TOL):
        raise AssertionError(f"serving logits disagree with the oracle: {worst}")
    return worst


# --------------------------------------------------------------------------
# Phase 4: the engine (the main path)
# --------------------------------------------------------------------------


def run_engine(cfg, params, seed):
    requests = smoke_requests(cfg, seed)
    prompt_lens = [len(r.prompt) for r in requests]
    engine = ServingEngine(params, cfg, device=DEV)
    for req in requests:
        engine.submit(req)
    paged_prefill_attention.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    outputs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_prefill": paged_prefill_attention.launches,
                "paged_decode": paged_decode_attention.launches}
    stats = engine.stats
    for rid in range(len(prompt_lens)):
        toks = outputs[rid]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid} did not finish: {toks}")
    want = {"paged_prefill": cfg.num_layers * stats["prefill_calls"],
            "paged_decode": cfg.num_layers * stats["decode_calls"]}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    rates = {
        "prefill_tokens_per_s": stats["prefill_tokens"] / stats["prefill_s"],
        "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
    }
    log("engine prompts: " + json.dumps(prompt_lens))
    log("engine stats: " + json.dumps(stats))
    log("engine rates: " + json.dumps(rates) + f" wall_s {wall:.3f}")
    log("engine launches: " + json.dumps(launches) + " per model call: "
        + json.dumps({k: v / max(1, stats[c]) for (k, v), c in zip(
            launches.items(), ("prefill_calls", "decode_calls"))}))
    return launches, stats, prompt_lens


# --------------------------------------------------------------------------
# Phase 5: times at the engine's shapes
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


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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
    build_all()
    phase_s["build"] = time.perf_counter() - t

    t = time.perf_counter()
    err_dec = check_decode(rng, 64)
    err_dec128 = check_decode(rng, 128)
    err_pf = max(check_prefill(rng, off) for off in (0, 512, 300))
    phase_s["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg = TransformerConfig()  # the flagship: 8 x 1024, 16/4 heads, bf16
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(cfg, gen, device=DEV)
    with torch.inference_mode():
        check_logits(cfg, params, rng)
    phase_s["logits"] = time.perf_counter() - t

    t = time.perf_counter()
    launches, stats, prompt_lens = run_engine(cfg, params, args.seed)
    phase_s["engine"] = time.perf_counter() - t

    t = time.perf_counter()
    with torch.inference_mode():
        dec_lens = [n + 16 for n in prompt_lens]
        dec_t, dec_bound, dec_by = time_decode(rng, dec_lens)
        # The same decode at D=128 (the TPU's _decode_kernel schedule; off
        # the flagship's path, so it has no launches there).
        d128_t, d128_bound, _ = time_decode(rng, dec_lens, d=128)
        pf_t, pf_bound, pf_by = time_prefill(rng, 512)
    phase_s["times"] = time.perf_counter() - t
    log("phase seconds: " + json.dumps(
        {k: round(v, 2) for k, v in phase_s.items()}))

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
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the serving engine's time goes on the card.

    python -m metal_flash_attention_plus_tpu_torch.utils.profiling [--seed N]

Serves the traffic of ``chip_smoke.py``'s engine phase (:func:`smoke_requests`
on the flagship model with random weights from the seed, engine defaults)
twice: once to warm up, once under ``torch.profiler`` with CPU and CUDA
activities.  Prints JSON lines: the engine's phase times and token counts,
the device's busy time (sum of kernel times) and idle share of the
profiled wall time, and the kernels ranked by device time.  The profiler
itself slows the host, so the idle share it reads is an upper bound.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from metal_flash_attention_plus_tpu_torch.serving.engine import (
    GenerationRequest,
    ServingEngine,
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


def serve_once(cfg, params, seed: int) -> ServingEngine:
    """One engine with default settings serving the smoke traffic."""
    engine = ServingEngine(params, cfg)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiling: no CUDA device is available", file=sys.stderr)
        return 2
    cfg = TransformerConfig()
    params = init_params(cfg, torch.Generator().manual_seed(args.seed))
    serve_once(cfg, params, args.seed)  # warm-up: builds, cuBLAS plans
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine = serve_once(cfg, params, args.seed)
        wall_s = time.perf_counter() - t0
    stats = engine.stats
    busy_us, launches, ranked = kernel_table(prof)
    if not busy_us:
        print("profiling: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "engine_stats": stats, "profiled_wall_s": wall_s}))
    print(json.dumps({
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernel_launches": launches,
        "launches_per_model_call": launches / (
            stats["prefill_calls"] + stats["decode_calls"]),
    }))
    for name, us, count in ranked:
        print(json.dumps({"kernel": name, "device_ms": us / 1e3,
                          "count": count, "share": us / busy_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

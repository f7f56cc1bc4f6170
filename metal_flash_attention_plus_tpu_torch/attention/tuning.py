"""Block-size tables, the GEMM plans, and a calibrating tuner with a store.

The twin of the JAX package's ``attention/tuning.py``.  Two kinds of
numbers live here:

- The TPU's block-size tables (:func:`default_block_sizes`,
  :func:`default_gemm_blocks` and their buckets), carried over equal to the
  JAX package's on every input.  The Hopper kernels choose their own tiles,
  but the quantized numerics read these sizes: the int8 P rounds over
  ``block_kv`` spans (``ops.quantized_attention.int8_p_tile``) and the
  full-integer level 2 over ``block_kv_dq`` / ``block_q_dkv`` widths
  (``ops.flash_attention_bwd.fullint_widths``), so a facade that resolves
  them as the JAX facade does rounds where it rounds.
- The Hopper GEMM plans: what is worth tuning on this card is not a TPU
  tile but the plan the dispatched GEMM kernel runs, its tile rows and K
  splits (``ops.quantized_gemm.dyn_tile`` for the dynamic W8A8 / W4A8
  GEMM, ``wo_tile`` for the weight-only one).  A plan is written as the
  triple ``(tile rows, 128, K per split)``; :meth:`AttentionTuner.
  calibrate_gemm` times the candidates and stores the winner, and the two
  planners take a stored plan through one in-memory lookup
  (:func:`stored_gemm_plan`).  Without a stored plan every launch is what
  the planners choose from shapes.

:class:`CalibrationStore` keeps one JSON file a device kind, in the JAX
package's format and keys, under ``MFA_CACHE_DIR`` or
``~/.cache/metal_flash_attention_plus_tpu_torch/tuning``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
)

_SEQ_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def seq_bucket(seq_len: int) -> int:
    """The sequence bucket a calibration is keyed on."""
    for b in _SEQ_BUCKETS:
        if seq_len <= b:
            return b
    return _SEQ_BUCKETS[-1]


# The TPU generations' VMEM budgets (MiB a core) that key the cold-start
# table; the same mapping as cpp/mfa_runtime.cc::mfa_device_vmem_budget.
_GEN_VMEM_MIB = {
    "v4": 16, "v5e": 16, "v5p": 16, "v6e": 32,
}


def normalize_device_kind(kind: str) -> str:
    """A device kind string → its table generation ("v4", "v5e", "v5p",
    "v6e") or "unknown" (every CUDA card, and the CPU)."""
    k = (kind or "").lower()
    if "v5 lite" in k or "v5e" in k or "v5lite" in k:
        return "v5e"
    if "v5p" in k or "v5" in k:
        return "v5p"
    if "v6" in k or "trillium" in k:
        return "v6e"
    if "v4" in k:
        return "v4"
    return "unknown"


def default_block_sizes(
    head_dim: int, bits: int = 16, causal: bool = True,
    device_kind: Optional[str] = None,
) -> BlockSizes:
    """The JAX package's cold-start table, keyed on (head_dim, bits,
    causal) and the device generation: a roomier generation deepens the
    major slab (at most 4 inner tiles), an unknown one halves it.  The
    Hopper kernels read no field of it; the quantized numerics read
    ``block_kv`` and the backward widths (see the module docstring)."""
    if bits <= 8:
        if head_dim <= 64:
            bq, bkv, bkvm = 1024, 512, 1024
        elif head_dim <= 128:
            bq, bkv, bkvm = 1024, 1024, 2048
        else:
            bq, bkv, bkvm = 512, 512, 2048
    elif head_dim > 128:
        bq, bkv, bkvm = 1024, 512, 1024
    elif causal and head_dim <= 64:
        bq, bkv, bkvm = 512, 512, 4096
    elif head_dim <= 64:
        bq, bkv, bkvm = 1024, 1024, 2048
    else:
        bq, bkv, bkvm = 512, 512, 2048
    if device_kind is not None:
        budget = _GEN_VMEM_MIB.get(normalize_device_kind(device_kind))
        if budget is None:
            bkvm = max(bkv, (bkvm // 2 // bkv) * bkv)
        elif budget > 16:
            bkvm = min(bkvm * (budget // 16), 4 * bkv)
    return BlockSizes(
        block_q=bq,
        block_kv=bkv,
        block_kv_major=bkvm,
        block_q_dkv=min(bq, 512),
        block_kv_dkv=min(bkv, 512),
        block_q_dq=min(bq, 512),
        block_kv_dq=min(bkv, 512),
        block_kv_dq_major=2048,
        block_q_dkv_major=2048,
    )


_M_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


def m_bucket(m: int) -> int:
    """The GEMM row bucket (decode's small M apart from prefill's)."""
    for b in _M_BUCKETS:
        if m <= b:
            return b
    return _M_BUCKETS[-1]


def default_gemm_blocks(m: int, bits: int = 8) -> Tuple[int, int, int]:
    """The JAX package's TPU (block_m, block_n, block_k) for the dynamic
    GEMM; accepted by the port's GEMM entry points and unused (the CUDA
    kernels run :meth:`AttentionTuner.recommend_gemm`'s plans)."""
    if m <= 256:
        return (128, 1024, 2048)
    return (512, 1024, 1024)


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """A calibration key: what a block geometry depends on."""

    kind: str  # "fwd" | "fwd_q" (quantized) | "bwd"
    head_dim: int
    bits: int
    seq_bucket: int
    causal: bool = True

    def encode(self) -> str:
        m = "mC" if self.causal else "mF"
        return (f"{self.kind}:d{self.head_dim}:b{self.bits}"
                f":s{self.seq_bucket}:{m}")

    @staticmethod
    def decode(s: str) -> "TuneKey":
        parts = s.split(":")
        kind, d, b, sb = parts[:4]
        causal = parts[4] == "mC" if len(parts) > 4 else True
        return TuneKey(kind, int(d[1:]), int(b[1:]), int(sb[1:]), causal)


class CalibrationStore:
    """One JSON file of calibrated entries a device kind."""

    def __init__(self, cache_dir: Optional[str] = None):
        base = cache_dir or os.environ.get(
            "MFA_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "metal_flash_attention_plus_tpu_torch", "tuning"),
        )
        self._dir = Path(base)

    def _path(self, device_kind: str) -> Path:
        safe = "".join(c if c.isalnum() else "-" for c in device_kind)
        return self._dir / f"{safe}.json"

    def load(self, device_kind: str) -> Dict[str, dict]:
        p = self._path(device_kind)
        if not p.exists():
            return {}
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return {}

    def save(self, device_kind: str, entries: Dict[str, dict]) -> None:
        self._dir.mkdir(parents=True, exist_ok=True)
        tmp = self._path(device_kind).with_suffix(".tmp")
        tmp.write_text(json.dumps(entries, indent=1, sort_keys=True))
        tmp.replace(self._path(device_kind))


def _blocks_to_json(bs: BlockSizes) -> dict:
    return dataclasses.asdict(bs)


def _blocks_from_json(d: dict) -> BlockSizes:
    return BlockSizes(**d)


@functools.lru_cache(maxsize=1)
def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), or "cpu"; read
    once a process."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"


# The K granule each GEMM kernel splits over (dyn_tc_kernel: steps of 128;
# wo_tc_kernel: steps of 32), the most splits it takes, and the N width of
# its tile.
GEMM_K_UNIT = {"dynamic": 128, "weight_only": 32}
GEMM_MAX_SPLITS = {"dynamic": 8, "weight_only": 16}
GEMM_TILE_N = 128
# An H100 SXM's SMs: the count a plan is made for where no card is present.
H100_SMS = 132


def sm_count() -> int:
    """SMs of the current card, or an H100's where there is none."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return H100_SMS


def plan_of(tile: Tuple[int, int], kdim: int,
            mode: str) -> Tuple[int, int, int]:
    """A planner's (tile rows, K splits) → the plan ``(tile rows, 128, K
    per split)``."""
    unit = GEMM_K_UNIT[mode]
    units = -(-kdim // unit)
    return (tile[0], GEMM_TILE_N, -(-units // tile[1]) * unit)


def tile_of(plan, kdim: int, mode: str) -> Tuple[int, int]:
    """A plan ``(tile rows, 128, K per split)`` → (tile rows, K splits)."""
    unit = GEMM_K_UNIT[mode]
    units = -(-kdim // unit)
    splits = -(-units // max(1, int(plan[2]) // unit))
    return int(plan[0]), max(1, min(splits, GEMM_MAX_SPLITS[mode], units))


def stored_gemm_plan(m: int, n: int, k: int, bits: int,
                     mode: str) -> Optional[Tuple[int, int]]:
    """The (tile rows, K splits) of a plan stored for this GEMM in the
    shared tuner, or None: ``dyn_tile`` and ``wo_tile`` ask this first.
    After the shared tuner's first load, one dictionary lookup."""
    plan = AttentionTuner.shared().stored_plan(m, n, k, bits, mode)
    return None if plan is None else tile_of(plan, k, mode)


class AttentionTuner:
    """Process-global recommend / calibrate service over a
    :class:`CalibrationStore` (a lock-guarded cache of the device kind's
    entries, loaded once).

    ``device``: where :meth:`calibrate` and :meth:`calibrate_gemm` time
    their calls, resolved by ``_device.resolve_device`` when they run
    (None: the card, so that without one they raise; "cpu" only when
    named).  The store is keyed by that device's kind: "cpu" for the CPU,
    else the card's name (:func:`device_kind`)."""

    _instance: Optional["AttentionTuner"] = None
    _instance_lock = threading.Lock()

    def __init__(self, store: Optional[CalibrationStore] = None,
                 device: DeviceLike = None):
        self._lock = threading.Lock()
        self._store = store or CalibrationStore()
        self._cache: Dict[str, dict] = {}
        self._loaded_device: Optional[str] = None
        self._device_arg = device

    @classmethod
    def shared(cls) -> "AttentionTuner":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _device_kind(self) -> str:
        if (self._device_arg is not None
                and torch.device(self._device_arg).type == "cpu"):
            return "cpu"
        return device_kind()

    def _ensure_loaded(self):
        dk = self._device_kind()
        if self._loaded_device != dk:
            self._cache = self._store.load(dk)
            self._loaded_device = dk

    def _device(self) -> torch.device:
        return resolve_device(self._device_arg)

    def recommend(
        self, kind: str, head_dim: int, seq_len: int, bits: int = 16,
        causal: bool = True,
    ) -> BlockSizes:
        """Calibrated blocks if stored, else the cold-start table."""
        key = TuneKey(kind, head_dim, bits, seq_bucket(seq_len),
                      causal).encode()
        with self._lock:
            self._ensure_loaded()
            entry = self._cache.get(key)
        if entry is not None:
            return _blocks_from_json(entry["blocks"])
        return default_block_sizes(head_dim, bits, causal,
                                   device_kind=self._device_kind())

    def record(self, key: TuneKey, blocks: BlockSizes, tflops: float):
        self._store_entry(key.encode(), {"blocks": _blocks_to_json(blocks),
                                         "tflops": round(tflops, 3)})

    def _store_entry(self, key: str, entry: dict):
        with self._lock:
            self._ensure_loaded()
            self._cache[key] = entry
            self._store.save(self._device_kind(), self._cache)

    # -- the GEMM plans ---------------------------------------------------

    @staticmethod
    def _gemm_key(m: int, n: int, k: int, bits: int, mode: str) -> str:
        return f"gemm:{mode}:n{n}:k{k}:b{bits}:m{m_bucket(m)}"

    def stored_plan(self, m: int, n: int, k: int, bits: int,
                    mode: str) -> Optional[Tuple[int, int, int]]:
        """The plan stored under the GEMM's key, or None."""
        key = self._gemm_key(m, n, k, bits, mode)
        if self._loaded_device is None:
            with self._lock:
                self._ensure_loaded()
        entry = self._cache.get(key)
        if entry is None or "gemm_blocks" not in entry:
            return None
        return tuple(entry["gemm_blocks"])

    def recommend_gemm(
        self, m: int, n: int, k: int, bits: int = 8, mode: str = "dynamic"
    ) -> Tuple[int, int, int]:
        """The plan ``(tile rows, 128, K per split)`` the dispatched kernel
        runs for [M, N] over K: the stored one, else the planner's cold
        start (``dyn_tile`` for mode "dynamic", ``wo_tile`` for
        "weight_only", for the current card or an H100)."""
        if mode not in GEMM_K_UNIT:
            raise ValueError(f"unknown GEMM calibration mode {mode!r}")
        plan = self.stored_plan(m, n, k, bits, mode)
        if plan is not None:
            return plan
        return plan_of(_cold_tile(m, n, k, mode), k, mode)

    def calibrate_gemm(
        self,
        m: int,
        n: int,
        k: int,
        *,
        bits: int = 8,
        mode: str = "dynamic",
        candidates: Optional[Tuple[Tuple[int, int, int], ...]] = None,
        iters: int = 20,
    ) -> Tuple[int, int, int]:
        """Time the dispatched GEMM kernel on the card over plans and store
        the fastest under the JAX package's GEMM key; returns it.

        The kernel is ``dyn_gemm`` (mode "dynamic": A quantized per row
        once, outside the timing) or the weight-only GEMM of a bf16 A
        (mode "weight_only": folded for a ROW SYMMETRIC weight), over a
        ROW weight of ``bits``; each plan's time is the kernel's device
        time by ``utils.profiling.measure_held`` (CUDA events around a
        train that a spin kernel holds back, so that the host's launches,
        the longer at a small M, are not timed; the profiler at times
        records no kernel in a session).  ``candidates``: plans
        ``(tile rows, 128, K per split)``; by default the plans
        ``utils/profiling.py`` sweeps
        (``DYN_TILE_PLANS`` for the rows M takes, ``WO_TILE_PLANS``), each
        kept where it maps back to itself.  On the CPU (``device="cpu"``)
        the plain version reads no plan, so the cold start is timed once
        and stored.
        """
        from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm
        from metal_flash_attention_plus_tpu_torch.quant.params import (
            QuantConfig,
            QuantGranularity,
        )
        from metal_flash_attention_plus_tpu_torch.quant.tensor import (
            quantize,
        )
        from metal_flash_attention_plus_tpu_torch.utils import profiling

        if mode not in GEMM_K_UNIT:
            raise ValueError(f"unknown GEMM calibration mode {mode!r}")
        dev = self._device()
        g = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        wq = quantize(torch.randn((n, k), generator=g, device=dev),
                      QuantConfig(bits=bits, granularity=QuantGranularity.ROW))
        if mode == "dynamic":
            qa, sa, rs = quantized_gemm.quantize_rows(a)
            sb, zb = quantized_gemm.weight_scales(wq)

            def run(tile):
                return quantized_gemm.dyn_gemm(qa, wq.data, sa, rs, sb, zb,
                                               bits=bits, tile=tile)
        else:
            folded, args, kw = quantized_gemm.wo_arguments(a, wq)
            gemm = (quantized_gemm.wo_folded_gemm if folded
                    else quantized_gemm.wo_gemm)

            def run(tile):
                return gemm(*args, **kw, out_dtype=torch.bfloat16, tile=tile)

        cold = plan_of(_cold_tile(m, n, k, mode), k, mode)
        if dev.type == "cpu":
            candidates = (cold,)
        elif candidates is None:
            candidates = _default_candidates(m, n, k, mode)
        flops = 2.0 * m * n * k
        best: Tuple[float, Optional[Tuple[int, int, int]]] = (0.0, None)
        for plan in candidates:
            plan = tuple(int(x) for x in plan)
            tile = tile_of(plan, k, mode)
            if dev.type == "cpu":
                sec = profiling.measure(run, tile, iters=iters, warmup=1)
            else:
                sec = profiling.measure_held(run, tile, iters=iters)
            tf = flops / sec / 1e12
            if tf > best[0]:
                best = (tf, plan)
        self._store_entry(self._gemm_key(m, n, k, bits, mode), {
            "gemm_blocks": list(best[1]), "tflops": round(best[0], 3)})
        return best[1]

    # -- the attention kinds -------------------------------------------------

    def calibrate(
        self,
        head_dim: int,
        seq_len: int,
        *,
        kind: str = "fwd",  # "fwd" | "fwd_q" | "bwd"
        bits: int = 16,
        batch: int = 1,
        num_heads: int = 8,
        causal: bool = True,
        candidates: Optional[Tuple[Tuple[int, ...], ...]] = None,
        iters: int = 20,
    ) -> BlockSizes:
        """Time the dispatched call of ``kind`` on the tuner's device and
        store its blocks; returns them.

        ``kind``: "fwd" (the bf16 flash forward), "fwd_q" (the quantized
        forward over ROW CENTERED K/V of ``bits``) or "bwd" (dQ and dK/dV
        from saved residuals).  The JAX package ranks ``candidates`` here,
        because its TPU kernels tile by them.  None of these three Hopper
        kernels reads a field of :class:`BlockSizes` (the float and
        dequantizing kernels choose their own tiles; only the int8 P and
        the full-integer level 2 read spans, and neither runs here), so
        ranking candidates would rank one kernel against itself by noise:
        the cold-start table is timed once and recorded with its rate, and
        ``candidates`` is accepted and unused.
        """
        from metal_flash_attention_plus_tpu_torch.attention.masking import (
            CAUSAL,
            FULL,
        )
        from metal_flash_attention_plus_tpu_torch.utils.profiling import (
            measure,
        )
        from metal_flash_attention_plus_tpu_torch.utils.roofline import (
            attention_flops,
        )

        del candidates
        if kind not in ("fwd", "fwd_q", "bwd"):
            raise ValueError(f"unknown calibration kind {kind!r}")
        dev = self._device()
        g = torch.Generator(device=dev).manual_seed(0)
        shape = (batch, num_heads, seq_len, head_dim)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3))
        fwd_flops = attention_flops(seq_len, seq_len, head_dim,
                                    num_heads=num_heads, batch=batch) / (
            2 if causal else 1)
        flops = fwd_flops * ((7 * head_dim + 10) / (2 * head_dim + 5)
                             if kind == "bwd" else 1)
        mask = CAUSAL if causal else FULL
        bs = default_block_sizes(head_dim, bits, causal,
                                 device_kind=self._device_kind())
        f, args = _attention_call(kind, bits, mask, bs, q, k, v)
        sec = measure(f, *args, iters=iters, warmup=min(3, iters))
        self.record(TuneKey(kind, head_dim, bits, seq_bucket(seq_len),
                            causal), bs, flops / sec / 1e12)
        return bs

    def calibrate_all(
        self,
        head_dims=(64, 128, 256),
        seq_lens=(4096,),
        *,
        causals=(True, False),
        gemm_shapes=((128, 8192, 8192), (4096, 8192, 8192)),
        iters: int = 20,
    ) -> Dict[str, dict]:
        """{fwd, fwd_q(8), fwd_q(4), bwd} × head dims × sequence lengths ×
        masks, then both GEMM modes over ``gemm_shapes``; returns every
        stored entry."""
        for d in head_dims:
            for s in seq_lens:
                for causal in causals:
                    self.calibrate(d, s, kind="fwd", causal=causal,
                                   iters=iters)
                    for b in (8, 4):
                        self.calibrate(d, s, kind="fwd_q", bits=b,
                                       causal=causal, iters=iters)
                    self.calibrate(d, s, kind="bwd", causal=causal,
                                   iters=iters)
        for (m, n, k) in gemm_shapes:
            for mode in ("dynamic", "weight_only"):
                self.calibrate_gemm(m, n, k, mode=mode, iters=iters)
        with self._lock:
            self._ensure_loaded()
            return dict(self._cache)


def _cold_tile(m: int, n: int, k: int, mode: str) -> Tuple[int, int]:
    """The planner's (tile rows, K splits) from shapes alone."""
    from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm

    planner = (quantized_gemm.dyn_shape_tile if mode == "dynamic"
               else quantized_gemm.wo_shape_tile)
    return planner(m, n, k, sm_count())


def _default_candidates(m: int, n: int, k: int, mode: str):
    """``utils/profiling.py``'s plans for this GEMM, as plans that map back
    to the same (tile rows, K splits)."""
    from metal_flash_attention_plus_tpu_torch.utils.profiling import (
        DYN_TILE_PLANS,
        WO_TILE_PLANS,
    )

    unit = GEMM_K_UNIT[mode]
    units = -(-k // unit)
    if mode == "dynamic":
        tiles = [p for p in DYN_TILE_PLANS
                 if p[1] <= units and (m > 16) == (p[0] > 16)]
    else:
        full = -(-m // 128) * -(-n // 128) >= sm_count()
        tiles = [p for p in WO_TILE_PLANS
                 if p[1] <= units and not (p[1] > 1 and full)]
    plans = [plan_of(t, k, mode) for t in tiles]
    return tuple(p for p, t in zip(plans, tiles) if tile_of(p, k, mode) == t)


def _attention_call(kind, bits, mask, bs, q, k, v):
    """(callable, arguments) of the dispatched call ``calibrate`` times."""
    from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
    )

    if kind == "fwd":
        return (lambda q, k, v: flash_attention_forward(
            q, k, v, mask=mask, block_sizes=bs)[0]), (q, k, v)
    if kind == "fwd_q":
        from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (  # noqa: E501
            quantized_flash_attention_forward,
        )
        from metal_flash_attention_plus_tpu_torch.quant.params import (
            QuantConfig,
            QuantGranularity,
            QuantStrategy,
        )
        from metal_flash_attention_plus_tpu_torch.quant.tensor import quantize

        cfg = QuantConfig(bits=bits if bits in (4, 8) else 8,
                          granularity=QuantGranularity.ROW,
                          strategy=QuantStrategy.CENTERED)
        kq, vq = quantize(k.float(), cfg), quantize(v.float(), cfg)
        return (lambda q: quantized_flash_attention_forward(
            q, kq, vq, mask=mask, block_sizes=bs)[0]), (q,)
    from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
        flash_attention_backward,
    )

    o, l = flash_attention_forward(q, k, v, mask=mask)
    do = torch.ones_like(q)
    return (lambda q, k, v, o, l, do: flash_attention_backward(
        q, k, v, o, l, do, mask=mask, block_sizes=bs)[0]), (q, k, v, o, l, do)

"""Continuous-batching serving engine.

The C++ scheduler (``cpp/mfa_runtime.cc`` through :mod:`runtime.native`)
decides WHAT runs each step — admission under batch-slot and KV-page
budgets, prefill-before-decode ordering, completion and preemption — and
this module executes the decisions on the device: prefill chunks fill
pages, decodes run batched through the paged-decode kernel with padded
batch slots pointing at the trash page.

Greedy sampling; per-request EOS/max-token termination.  Everything runs
under ``torch.inference_mode()``.  An executor decides the model family:
the default serves the GQA transformer (``models/cached.py``) with float
or quantized (W8A8 / W4A8) weights from a float, int8 or int4 page pool;
:func:`mla_executor` serves MLA models (``models/cached_mla.py``) from a
float or int8 latent pool, with float or W8A8 weights.
Where the JAX engine fuses several decode steps into one ``lax.scan``
dispatch, this one loops over ``decode_step`` with the argmax kept on the
device; per-step CUDA graphs are later work.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)
from metal_flash_attention_plus_tpu_torch.models import cached
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
)
from metal_flash_attention_plus_tpu_torch.runtime.native import (
    PagePool,
    ScheduledItem,
    Scheduler,
)


@dataclasses.dataclass
class GenerationRequest:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    eos_token: Optional[int] = None


def _gqa_executor():
    return types.SimpleNamespace(
        init_cache=cached.init_cache,
        prefill_chunk=cached.prefill_chunk,
        decode_step=cached.decode_step,
    )


def mla_executor():
    """Executor for MLA models: latent-cache pages ([c | k_rope], Hkv = 1)."""
    from metal_flash_attention_plus_tpu_torch.models import cached_mla

    return types.SimpleNamespace(
        init_cache=cached_mla.init_mla_cache,
        prefill_chunk=cached_mla.mla_prefill_chunk,
        decode_step=cached_mla.mla_decode_step,
    )


class ServingEngine:
    """Single-host continuous-batching engine over the paged KV cache.

    ``params`` must already be on ``device`` (default: the CUDA card;
    without one the engine raises unless ``device="cpu"``).  ``executor``
    (default: the GQA transformer's) gives the cache and the model calls:
    ``init_cache``, ``prefill_chunk``, ``decode_step``; ``mla_executor()``
    for an :class:`MLAConfig` model.
    """

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        *,
        num_pages: int = 256,
        page_tokens: int = 256,
        max_batch: int = 8,
        max_pages_per_seq: Optional[int] = None,
        cache_dtype: torch.dtype = torch.bfloat16,
        chunk_size: Optional[int] = None,
        # False → float pages; True/8 → int8 K/V halves; 4 → the int4
        # shared byte (K low nibble, V high nibble).
        quantized_cache: Union[bool, int] = False,
        executor=None,
        decode_steps: int = 1,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.page_tokens = page_tokens
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq or min(
            num_pages, 4096 // page_tokens
        )
        self.pool = PagePool(num_pages, page_tokens)
        # Every prefill chunk pads to this size.
        self.chunk_size = chunk_size or max(page_tokens, 256)
        self.sched = Scheduler(
            self.pool, max_batch, token_budget=self.chunk_size
        )
        self.ex = executor or _gqa_executor()
        self.cache = self.ex.init_cache(
            cfg, num_pages, page_tokens, cache_dtype,
            quantized=quantized_cache, device=self.device,
        )
        self.requests: Dict[int, GenerationRequest] = {}
        self.outputs: Dict[int, List[int]] = {}
        self._last_token: Dict[int, int] = {}
        self._lengths: Dict[int, int] = {}
        self.decode_steps = max(1, int(decode_steps))
        self.sched.set_decode_chunk(self.decode_steps)
        # Occupancy (decode slots used / max_batch per decode tick), wall
        # time per phase, and the model calls made per phase.
        self._occ_slots = 0
        self._occ_ticks = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._prefill_calls = 0
        self._decode_calls = 0

    def submit(self, req: GenerationRequest):
        self.requests[req.request_id] = req
        self.outputs[req.request_id] = []
        self.sched.submit(req.request_id, len(req.prompt), req.max_new_tokens)

    def _page_row(self, seq_handle: int) -> np.ndarray:
        row = np.full(self.max_pages_per_seq, self.cache.trash_page, np.int32)
        pages = self.pool.pages(seq_handle, self.max_pages_per_seq)
        row[: len(pages)] = pages
        return row

    def _fence(self):
        """Wait for queued device work, so phase clocks do not bleed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def step(self) -> bool:
        """Run one scheduler step.  Returns False when fully drained."""
        with torch.inference_mode():
            return self._step()

    def _step(self) -> bool:
        items = self.sched.next_step()
        if not items:
            if self.sched.num_running > 0:
                # The scheduler preempts the youngest runner whenever every
                # running sequence is page-blocked, so an empty step with
                # runners means a scheduler invariant broke.
                raise RuntimeError(
                    "scheduler invariant violation: empty step with "
                    f"{self.sched.num_running} running sequences"
                )
            if self.sched.num_waiting == 0:
                return False
            raise RuntimeError(
                "scheduler stalled: waiting requests cannot be admitted "
                "(prompt larger than the page pool?)"
            )
        prefills = [i for i in items if i.kind == ScheduledItem.PREFILL]
        decodes = [i for i in items if i.kind == ScheduledItem.DECODE]

        t_phase = time.perf_counter()
        for it in prefills:
            req = self.requests[it.request_id]
            # Prompt + already-generated tokens: after a preemption the
            # scheduler re-queues the request with its generated tokens
            # folded into the prompt length, and this re-prefill rebuilds
            # their KV.
            full = req.prompt + self.outputs[it.request_id]
            chunk = full[it.chunk_start: it.chunk_start + it.chunk_len]
            padded = np.zeros(self.chunk_size, np.int64)
            padded[: len(chunk)] = chunk
            logits, self.cache = self.ex.prefill_chunk(
                self.params,
                self._to_device(padded),
                it.chunk_start,
                it.chunk_len - 1,
                self.cache,
                self._to_device(self._page_row(it.seq_handle)),
                self.cfg,
            )
            self._prefill_calls += 1
            self._prefill_tokens += it.chunk_len
            if it.chunk_start + it.chunk_len == len(full):
                # Sequence caught up: the last position's logits yield the
                # next generated token.
                self._emit(it.request_id, int(torch.argmax(logits)))
        if prefills:
            self._fence()
            self._prefill_s += time.perf_counter() - t_phase
            t_phase = time.perf_counter()

        if decodes:
            b = self.max_batch
            tokens = np.zeros(b, np.int64)
            lengths = np.ones(b, np.int32)
            pts = np.full(
                (b, self.max_pages_per_seq), self.cache.trash_page, np.int32
            )
            live = []
            for slot, it in enumerate(decodes[:b]):
                rid = it.request_id
                tokens[slot] = self._last_token[rid]
                # _lengths already counts the token being decoded (emitted
                # last step; its KV is appended during THIS step).
                lengths[slot] = self._lengths[rid]
                pts[slot] = self._page_row(it.seq_handle)
                live.append(rid)
            self._occ_slots += len(live)
            self._occ_ticks += 1
            # Multi-step tick: the common grant across the batch; a smaller
            # tail grant takes a single step.
            t_fused = min(
                (max(1, it.chunk_len) for it in decodes[:b]), default=1
            )
            n_steps = self.decode_steps if t_fused >= self.decode_steps else 1
            tok = self._to_device(tokens)
            ln = self._to_device(lengths)
            pt = self._to_device(pts)
            steps = []
            for _ in range(n_steps):
                logits, self.cache = self.ex.decode_step(
                    self.params, tok, ln, pt, self.cache, self.cfg
                )
                self._decode_calls += 1
                tok = torch.argmax(logits, dim=-1)
                ln = ln + 1
                steps.append(tok)
            toks = torch.stack(steps).cpu().numpy()  # [T, B]; readback fence
            for slot, rid in enumerate(live):
                for t in range(n_steps):
                    if self._done(rid):
                        break  # EOS/max inside a multi-step tick
                    self._emit(rid, int(toks[t, slot]))
                    self._decode_tokens += 1
            self._decode_s += time.perf_counter() - t_phase
        return True

    @property
    def stats(self) -> Dict[str, float]:
        """Per-phase wall time, tokens and model calls, and occupancy."""
        return dict(
            prefill_s=self._prefill_s,
            decode_s=self._decode_s,
            prefill_tokens=self._prefill_tokens,
            decode_tokens=self._decode_tokens,
            prefill_calls=self._prefill_calls,
            decode_calls=self._decode_calls,
            decode_occupancy=self.decode_occupancy,
        )

    def _done(self, rid: int) -> bool:
        req = self.requests[rid]
        out = self.outputs[rid]
        return len(out) >= req.max_new_tokens or (
            req.eos_token is not None and req.eos_token in out
        )

    @property
    def decode_occupancy(self) -> float:
        """Mean decode-slot occupancy (used slots / max_batch) over decode
        ticks so far."""
        if not self._occ_ticks:
            return 0.0
        return self._occ_slots / (self._occ_ticks * self.max_batch)

    def _emit(self, rid: int, token: int):
        req = self.requests[rid]
        self.outputs[rid].append(token)
        self._last_token[rid] = token
        self._lengths[rid] = len(req.prompt) + len(self.outputs[rid])
        done = token == req.eos_token or len(
            self.outputs[rid]
        ) >= req.max_new_tokens
        # The emitted token occupies a KV slot only once decoded; the
        # scheduler tracks lengths and completion.
        self.sched.report_token(rid, finished=done)

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.step():
                break
        return self.outputs

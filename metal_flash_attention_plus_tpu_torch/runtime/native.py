"""ctypes binding to the host runtime (``cpp/mfa_runtime.cc``).

The native library owns the serving-side host logic the engine needs: the
paged KV allocator (which physical page belongs to which sequence) and the
continuous-batching scheduler (admission under batch-slot and page budgets,
prefill-before-decode ordering, completion, preemption).  The port compiles
the repository's source into its own build directory
(:mod:`metal_flash_attention_plus_tpu_torch._build`) and binds the part of
its C interface that serving uses.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
from typing import List

from metal_flash_attention_plus_tpu_torch import _build


class _MfaRequest(ctypes.Structure):
    _fields_ = [
        ("request_id", ctypes.c_int64),
        ("prompt_len", ctypes.c_int32),
        ("max_new_tokens", ctypes.c_int32),
    ]


class _MfaScheduledItem(ctypes.Structure):
    _fields_ = [
        ("request_id", ctypes.c_int64),
        ("seq_handle", ctypes.c_int64),
        ("kind", ctypes.c_int32),
        ("chunk_start", ctypes.c_int32),
        ("chunk_len", ctypes.c_int32),
    ]


_SIGNATURES = {
    # name: (restype, argtypes)
    "mfa_pool_create": (ctypes.c_void_p, [ctypes.c_int32, ctypes.c_int32]),
    "mfa_pool_destroy": (None, [ctypes.c_void_p]),
    "mfa_pool_free_pages": (ctypes.c_int32, [ctypes.c_void_p]),
    "mfa_seq_create": (ctypes.c_int64, [ctypes.c_void_p]),
    "mfa_seq_reserve": (
        ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    ),
    "mfa_seq_pages": (
        ctypes.c_int32,
        [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
         ctypes.c_int32],
    ),
    "mfa_seq_len": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_int64]),
    "mfa_seq_set_len": (
        None, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    ),
    "mfa_seq_release": (None, [ctypes.c_void_p, ctypes.c_int64]),
    "mfa_sched_create": (
        ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    ),
    "mfa_sched_destroy": (None, [ctypes.c_void_p]),
    "mfa_sched_submit": (
        ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(_MfaRequest)]
    ),
    "mfa_sched_set_decode_chunk": (None, [ctypes.c_void_p, ctypes.c_int32]),
    "mfa_sched_next_step": (
        ctypes.c_int32,
        [ctypes.c_void_p, ctypes.POINTER(_MfaScheduledItem), ctypes.c_int32],
    ),
    "mfa_sched_token": (
        ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    ),
    "mfa_sched_num_waiting": (ctypes.c_int32, [ctypes.c_void_p]),
    "mfa_sched_num_running": (ctypes.c_int32, [ctypes.c_void_p]),
    "mfa_sched_num_preempted": (ctypes.c_int64, [ctypes.c_void_p]),
}


def _load() -> ctypes.CDLL:
    lib = _build.load_library("runtime")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_available() -> bool:
    """Whether the host runtime builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


class PagePool:
    """Native paged KV-cache allocator."""

    def __init__(self, num_pages: int, page_tokens: int):
        self._lib = _load()
        self._h = self._lib.mfa_pool_create(num_pages, page_tokens)
        if not self._h:
            raise ValueError("invalid pool parameters")
        self.page_tokens = page_tokens

    @property
    def free_pages(self) -> int:
        return self._lib.mfa_pool_free_pages(self._h)

    def create_seq(self) -> int:
        return self._lib.mfa_seq_create(self._h)

    def reserve(self, seq: int, num_tokens: int) -> bool:
        return self._lib.mfa_seq_reserve(self._h, seq, num_tokens) == 0

    def pages(self, seq: int, max_pages: int = 4096) -> List[int]:
        buf = (ctypes.c_int32 * max_pages)()
        n = self._lib.mfa_seq_pages(self._h, seq, buf, max_pages)
        return list(buf[:n])

    def seq_len(self, seq: int) -> int:
        return self._lib.mfa_seq_len(self._h, seq)

    def set_seq_len(self, seq: int, n: int):
        self._lib.mfa_seq_set_len(self._h, seq, n)

    def release(self, seq: int):
        self._lib.mfa_seq_release(self._h, seq)

    def destroy(self):
        if self._h:
            self._lib.mfa_pool_destroy(self._h)
            self._h = None


@dataclasses.dataclass(frozen=True)
class ScheduledItem:
    request_id: int
    seq_handle: int
    kind: int  # 0 = prefill, 1 = decode
    chunk_start: int
    chunk_len: int

    PREFILL = 0
    DECODE = 1


class Scheduler:
    """Native continuous-batching scheduler."""

    def __init__(self, pool: PagePool, max_batch: int, token_budget: int):
        self._lib = pool._lib
        self._h = self._lib.mfa_sched_create(pool._h, max_batch, token_budget)
        if not self._h:
            raise ValueError("invalid scheduler parameters")

    def submit(self, request_id: int, prompt_len: int, max_new_tokens: int):
        req = _MfaRequest(request_id, prompt_len, max_new_tokens)
        if self._lib.mfa_sched_submit(self._h, ctypes.byref(req)) != 0:
            raise RuntimeError("scheduler queue full")

    def next_step(self, max_items: int = 256) -> List[ScheduledItem]:
        buf = (_MfaScheduledItem * max_items)()
        n = self._lib.mfa_sched_next_step(self._h, buf, max_items)
        return [
            ScheduledItem(
                it.request_id, it.seq_handle, it.kind,
                it.chunk_start, it.chunk_len,
            )
            for it in buf[:n]
        ]

    def report_token(self, request_id: int, finished: bool = False):
        self._lib.mfa_sched_token(self._h, request_id, int(finished))

    def set_decode_chunk(self, n: int):
        """Decode tokens granted (and KV slots reserved) per decode item
        per step; >1 enables the engine's multi-step decode."""
        self._lib.mfa_sched_set_decode_chunk(self._h, int(n))

    @property
    def num_waiting(self) -> int:
        return self._lib.mfa_sched_num_waiting(self._h)

    @property
    def num_running(self) -> int:
        return self._lib.mfa_sched_num_running(self._h)

    @property
    def num_preempted(self) -> int:
        """Total mid-stream preemptions (recompute policy)."""
        return self._lib.mfa_sched_num_preempted(self._h)

    def destroy(self):
        if self._h:
            self._lib.mfa_sched_destroy(self._h)
            self._h = None

"""ctypes binding to the host runtime (``cpp/mfa_runtime.cc``).

The native library owns host logic: the block-size resolver and its
flat-file calibration cache (the JAX package's TPU tables, which the
quantized numerics read: :func:`resolve_blocks`, :func:`resolve_gemm_blocks`,
:func:`device_vmem_budget`, :class:`CalibCache`), the paged KV allocator
(which physical page belongs to which sequence) and the continuous-batching
scheduler (admission under batch-slot and page budgets, prefill-before-
decode ordering, completion, preemption).  The port compiles the
repository's source into its own build directory
(:mod:`metal_flash_attention_plus_tpu_torch._build`) and binds its C
interface.  Where the library does not build, the resolvers fall back to
the Python tables of :mod:`attention.tuning`, as the JAX package's do;
serving needs the library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
from typing import List, Optional, Tuple

from metal_flash_attention_plus_tpu_torch import _build


class _MfaBlockConfig(ctypes.Structure):
    _fields_ = [
        ("block_q", ctypes.c_int32),
        ("block_kv", ctypes.c_int32),
        ("block_kv_major", ctypes.c_int32),
        ("block_q_dkv", ctypes.c_int32),
        ("block_kv_dkv", ctypes.c_int32),
        ("block_q_dq", ctypes.c_int32),
        ("block_kv_dq", ctypes.c_int32),
    ]


class _MfaGemmBlockConfig(ctypes.Structure):
    _fields_ = [
        ("block_m", ctypes.c_int32),
        ("block_n", ctypes.c_int32),
        ("block_k", ctypes.c_int32),
    ]


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
    "mfa_resolve_blocks": (
        ctypes.c_int,
        [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_int64, ctypes.POINTER(_MfaBlockConfig)],
    ),
    "mfa_device_vmem_budget": (ctypes.c_int64, [ctypes.c_char_p]),
    "mfa_resolve_gemm_blocks": (
        ctypes.c_int,
        [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
         ctypes.POINTER(_MfaGemmBlockConfig)],
    ),
    "mfa_calib_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "mfa_calib_get": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(_MfaBlockConfig),
         ctypes.POINTER(ctypes.c_double)],
    ),
    "mfa_calib_put": (
        None,
        [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(_MfaBlockConfig),
         ctypes.c_double],
    ),
    "mfa_calib_save": (ctypes.c_int, [ctypes.c_void_p]),
    "mfa_calib_size": (ctypes.c_int, [ctypes.c_void_p]),
    "mfa_calib_close": (None, [ctypes.c_void_p]),
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


def _load_or_none() -> Optional[ctypes.CDLL]:
    """The host runtime, or None where it does not build or load."""
    try:
        return _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None


def native_available() -> bool:
    """Whether the host runtime builds and loads here."""
    return _load_or_none() is not None


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """The resolver's block sizes (the fields of ``MfaBlockConfig``)."""

    block_q: int
    block_kv: int
    block_kv_major: int
    block_q_dkv: int
    block_kv_dkv: int
    block_q_dq: int
    block_kv_dq: int

    @staticmethod
    def _from_c(c: _MfaBlockConfig) -> "BlockConfig":
        return BlockConfig(
            c.block_q, c.block_kv, c.block_kv_major, c.block_q_dkv,
            c.block_kv_dkv, c.block_q_dq, c.block_kv_dq,
        )

    def _to_c(self) -> _MfaBlockConfig:
        return _MfaBlockConfig(*dataclasses.astuple(self))

    def to_block_sizes(self):
        from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
            BlockSizes,
        )

        return BlockSizes(**dataclasses.asdict(self))


KIND_FWD, KIND_FWD_Q, KIND_BWD = 0, 1, 2


def device_vmem_budget(device_kind: str) -> int:
    """The resolver's budget in bytes for a device generation
    (``mfa_device_vmem_budget``; a conservative one for kinds it does not
    know, every CUDA card among them).  Without the library: the same
    mapping from :mod:`attention.tuning`'s table."""
    lib = _load_or_none()
    if lib is not None:
        return int(lib.mfa_device_vmem_budget(device_kind.encode()))
    from metal_flash_attention_plus_tpu_torch.attention.tuning import (
        _GEN_VMEM_MIB,
        normalize_device_kind,
    )

    mib = _GEN_VMEM_MIB.get(normalize_device_kind(device_kind))
    return ((mib - 2) << 20) if mib else (7 << 20)


def resolve_blocks(
    head_dim: int, bits: int = 16, kind: int = KIND_FWD,
    vmem_budget_bytes: int = 0, causal: bool = True,
    device_kind: Optional[str] = None,
) -> BlockConfig:
    """Block sizes for a descriptor (``mfa_resolve_blocks``): the cold-start
    table shrunk to the budget, which ``device_kind`` keys when
    ``vmem_budget_bytes`` is not given.  Without the library:
    :func:`attention.tuning.default_block_sizes`."""
    if not vmem_budget_bytes and device_kind is not None:
        vmem_budget_bytes = device_vmem_budget(device_kind)
    lib = _load_or_none()
    if lib is None:
        from metal_flash_attention_plus_tpu_torch.attention.tuning import (
            default_block_sizes,
        )

        bs = default_block_sizes(head_dim, bits, causal, device_kind)
        return BlockConfig(*(getattr(bs, f.name)
                             for f in dataclasses.fields(BlockConfig)))
    out = _MfaBlockConfig()
    rc = lib.mfa_resolve_blocks(head_dim, bits, kind, int(causal),
                                vmem_budget_bytes, ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"mfa_resolve_blocks failed for head_dim={head_dim}")
    return BlockConfig._from_c(out)


GEMM_DYNAMIC, GEMM_WEIGHT_ONLY = 0, 1


def resolve_gemm_blocks(
    m: int, bits: int = 8, mode: int = GEMM_DYNAMIC,
    vmem_budget_bytes: int = 0,
) -> Tuple[int, int, int]:
    """The quantized GEMM's TPU blocks (``mfa_resolve_gemm_blocks``);
    without the library, :func:`attention.tuning.default_gemm_blocks`."""
    lib = _load_or_none()
    if lib is None:
        from metal_flash_attention_plus_tpu_torch.attention.tuning import (
            default_gemm_blocks,
        )

        return default_gemm_blocks(m, bits)
    out = _MfaGemmBlockConfig()
    rc = lib.mfa_resolve_gemm_blocks(m, bits, mode, vmem_budget_bytes,
                                     ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"mfa_resolve_gemm_blocks failed for m={m}")
    return (out.block_m, out.block_n, out.block_k)


class CalibCache:
    """The native flat-file calibration cache (one line a key)."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.mfa_calib_open(path.encode())

    def get(self, key: str) -> Optional[Tuple[BlockConfig, float]]:
        cfg = _MfaBlockConfig()
        tf = ctypes.c_double()
        if self._lib.mfa_calib_get(self._h, key.encode(), ctypes.byref(cfg),
                                   ctypes.byref(tf)):
            return BlockConfig._from_c(cfg), tf.value
        return None

    def put(self, key: str, cfg: BlockConfig, tflops: float):
        c = cfg._to_c()
        self._lib.mfa_calib_put(self._h, key.encode(), ctypes.byref(c),
                                tflops)

    def save(self) -> bool:
        return self._lib.mfa_calib_save(self._h) == 0

    def __len__(self) -> int:
        return self._lib.mfa_calib_size(self._h)

    def close(self):
        if self._h:
            self._lib.mfa_calib_close(self._h)
            self._h = None


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

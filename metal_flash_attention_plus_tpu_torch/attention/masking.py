"""Masking specifications: the mask zoo as static specs plus per-row ranges.

The port's copy of the JAX package's ``attention/masking.py`` (same names,
same semantics), kept here so that the port imports nothing of that
package.  Every mask lowers to per-row ``[start, end)`` KV column ranges
(``ops/flash_attention.py::compute_row_ranges``); the kernels never build
the dense matrix that :func:`materialize_mask` returns.

- CAUSAL aligns the query rows to the END of the keys (row ``i`` sees keys
  ``≤ i + Skv - Sq``), which is plain causal when ``Sq == Skv``.
- SLIDING_WINDOW is the centered window of size ``w``: row ``i`` sees
  ``[max(0, i - w//2), min(S, i + w//2))``, optionally intersected with
  the causal triangle.
- SPARSE_RANGES takes one ``[start, end)`` per row; BLOCK_SPARSE one per
  block of ``block_size`` rows (:func:`build_block_sparse_ranges`); rows
  with no active block get the empty range ``[0, 0)``.

Range arrays are numpy (static) or torch tensors (built on the device, the
analog of JAX's traced ranges).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import numpy as np
import torch

# The masked-score sentinel: finite, so exp(s - m) never sees -inf - -inf.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

Ranges = Union[np.ndarray, torch.Tensor]


class MaskKind(enum.Enum):
    """Which structural sparsity pattern applies to the score matrix."""

    NONE = "none"
    CAUSAL = "causal"
    SLIDING_WINDOW = "sliding_window"
    SPARSE_RANGES = "sparse_ranges"
    BLOCK_SPARSE = "block_sparse"


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Static, hashable description of the attention mask.

    Attributes:
      kind: structural pattern.
      window_size: total sliding-window size (centered).
      causal: for SLIDING_WINDOW, also intersect with the causal triangle.
      block_size: rows per range for BLOCK_SPARSE.
    """

    kind: MaskKind = MaskKind.NONE
    window_size: Optional[int] = None
    causal: bool = False
    block_size: Optional[int] = None

    def __post_init__(self):
        if self.kind == MaskKind.SLIDING_WINDOW and not self.window_size:
            raise ValueError("SLIDING_WINDOW requires window_size >= 1")
        if self.kind == MaskKind.BLOCK_SPARSE and not self.block_size:
            raise ValueError("BLOCK_SPARSE requires block_size >= 1")

    @property
    def is_causal(self) -> bool:
        return self.kind == MaskKind.CAUSAL or (
            self.kind == MaskKind.SLIDING_WINDOW and self.causal
        )


CAUSAL = MaskSpec(kind=MaskKind.CAUSAL)
FULL = MaskSpec(kind=MaskKind.NONE)


def sliding_window(window_size: int, causal: bool = False) -> MaskSpec:
    return MaskSpec(
        kind=MaskKind.SLIDING_WINDOW, window_size=window_size, causal=causal
    )


def build_sliding_window_ranges(seq_len: int, window_size: int) -> np.ndarray:
    """Per-row [start, end) KV ranges of a centered sliding window:
    ``start = max(0, i - w//2)``, ``end = min(S, i + w//2)``.  Returns int32
    ``[seq_len, 2]``."""
    half = max(1, int(window_size)) // 2
    rows = np.arange(seq_len)
    start = np.maximum(0, rows - half)
    end = np.minimum(seq_len, rows + half)
    return np.stack([start, end], axis=-1).astype(np.int32)


def build_block_sparse_ranges(
    pattern: np.ndarray, block_size: int
) -> np.ndarray:
    """Lower a boolean ``[num_row_blocks, num_col_blocks]`` block pattern to
    per-row-block element ranges ``[first_active·bs, (last_active+1)·bs)``
    (int32 ``[num_row_blocks, 2]``); all-inactive rows get ``[0, 0)``."""
    pattern = np.asarray(pattern, dtype=bool)
    num_rows, num_cols = pattern.shape
    out = np.zeros((num_rows, 2), dtype=np.int32)
    for r in range(num_rows):
        active = np.nonzero(pattern[r])[0]
        if active.size:
            out[r, 0] = active[0] * block_size
            out[r, 1] = min((active[-1] + 1) * block_size,
                            num_cols * block_size)
    return out


def build_segment_ranges(segment_ids: Ranges, causal: bool = True) -> Ranges:
    """Per-row [start, end) KV ranges for PACKED SEQUENCES (document mask):
    row i attends only to tokens of its own segment, optionally causally.

    ``segment_ids`` is int ``[S]``, non-decreasing labels.  A torch tensor
    gives a torch int32 ``[S, 2]`` on its device (no host round trip, the
    analog of JAX's traced ranges); anything else gives numpy.
    """
    if isinstance(segment_ids, torch.Tensor):
        seg = segment_ids
        s = seg.shape[0]
        idx = torch.arange(s, device=seg.device)
        is_start = torch.cat([
            torch.ones(1, dtype=torch.bool, device=seg.device),
            seg[1:] != seg[:-1],
        ])
        start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
        if causal:
            end = idx + 1
        else:
            nxt = torch.where(is_start, idx, s)
            sm = torch.flip(
                torch.cummin(torch.flip(nxt, (0,)), dim=0).values, (0,))
            end = torch.cat([sm[1:], sm.new_full((1,), s)])
        return torch.stack([start, end], dim=-1).to(torch.int32)
    seg = np.asarray(segment_ids)
    s = seg.shape[0]
    idx = np.arange(s)
    is_start = np.concatenate([np.ones((1,), bool), seg[1:] != seg[:-1]])
    # start[i] = index of i's segment's first token (running max of starts)
    start = np.maximum.accumulate(np.where(is_start, idx, 0))
    if causal:
        end = idx + 1  # own position is always inside own segment
    else:
        # end[i] = the next segment's start (S if none): suffix-min of the
        # start positions, shifted one left.
        nxt = np.where(is_start, idx, s)
        sm = np.minimum.accumulate(nxt[::-1])[::-1]
        end = np.concatenate([sm[1:], np.full((1,), s, sm.dtype)])
    return np.stack([start, end], axis=-1).astype(np.int32)


def expand_block_ranges_to_rows(
    block_ranges: Ranges, block_size: int, seq_len: int
) -> Ranges:
    """Expand per-row-block ranges to per-row ranges of length ``seq_len``."""
    if isinstance(block_ranges, torch.Tensor):
        rows = torch.arange(seq_len, device=block_ranges.device) // block_size
        return block_ranges[rows.clamp(max=block_ranges.shape[0] - 1)]
    rows = np.minimum(np.arange(seq_len) // block_size,
                      block_ranges.shape[0] - 1)
    return block_ranges[rows]


def materialize_mask(
    spec: MaskSpec,
    seq_q: int,
    seq_kv: int,
    ranges: Optional[Ranges] = None,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Dense boolean ``[seq_q, seq_kv]`` mask (True = attend) on ``device``
    (default: the ranges' device, else the CPU).

    The golden-model materialization the dense reference and the tests
    use; the kernels never build this matrix.
    """
    if device is None:
        device = (ranges.device if isinstance(ranges, torch.Tensor)
                  else torch.device("cpu"))
    rows = torch.arange(seq_q, device=device)[:, None]
    cols = torch.arange(seq_kv, device=device)[None, :]
    if spec.kind == MaskKind.NONE:
        return torch.ones((seq_q, seq_kv), dtype=torch.bool, device=device)
    if spec.kind == MaskKind.CAUSAL:
        return cols <= rows + (seq_kv - seq_q)
    if spec.kind == MaskKind.SLIDING_WINDOW:
        half = max(1, spec.window_size) // 2
        mask = (cols >= rows - half) & (cols < rows + half)
        if spec.causal:
            mask &= cols <= rows + (seq_kv - seq_q)
        return mask
    if spec.kind in (MaskKind.SPARSE_RANGES, MaskKind.BLOCK_SPARSE):
        if ranges is None:
            raise ValueError(f"{spec.kind} requires a ranges array")
        r = torch.as_tensor(ranges, device=device)
        if spec.kind == MaskKind.BLOCK_SPARSE:
            r = expand_block_ranges_to_rows(r, spec.block_size, seq_q)
        start = r[:, 0][:, None]
        end = r[:, 1][:, None]
        return (cols >= start) & (cols < end)
    raise NotImplementedError(spec.kind)

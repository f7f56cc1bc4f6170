"""Port parity: the mask zoo, row ranges and tile bounds vs the JAX package.

Every range function is integer bookkeeping, so the two packages must agree
exactly (the dense masks bit for bit).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jm
from metal_flash_attention_plus_tpu.ops.flash_attention_bwd import (
    build_kv_block_bounds as j_build_kv_block_bounds,
)
from metal_flash_attention_plus_tpu_torch.attention import masking as tm
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    build_kv_block_bounds,
)

# The port's ops/__init__ re-exports a function of the same name too.
tfa = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")

# The JAX package's ops/__init__ re-exports a function of the same name.
jfa = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention")

SEGMENTS = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 4, 4], np.int32)
PATTERN = np.array([[1, 0, 1], [0, 0, 0], [0, 1, 1], [1, 1, 0]], bool)


def _specs():
    """(torch spec, JAX spec, numpy ranges) for every mask kind."""
    sparse = np.stack([np.arange(40) % 7, 10 + np.arange(40) % 23], -1)
    sparse[5] = (9, 9)  # an empty row
    return [
        (tm.FULL, jm.FULL, None),
        (tm.CAUSAL, jm.CAUSAL, None),
        (tm.sliding_window(9), jm.sliding_window(9), None),
        (tm.sliding_window(8, causal=True), jm.sliding_window(8, causal=True),
         None),
        (tm.MaskSpec(tm.MaskKind.SPARSE_RANGES),
         jm.MaskSpec(jm.MaskKind.SPARSE_RANGES), sparse.astype(np.int32)),
        (tm.MaskSpec(tm.MaskKind.BLOCK_SPARSE, block_size=16),
         jm.MaskSpec(jm.MaskKind.BLOCK_SPARSE, block_size=16),
         jm.build_block_sparse_ranges(PATTERN[:3], 16)),
    ]


SPEC_IDS = ["full", "causal", "window", "window_causal", "sparse", "block"]


def test_range_functions_match_jax():
    np.testing.assert_array_equal(tm.build_sliding_window_ranges(37, 10),
                                  jm.build_sliding_window_ranges(37, 10))
    np.testing.assert_array_equal(tm.build_block_sparse_ranges(PATTERN, 32),
                                  jm.build_block_sparse_ranges(PATTERN, 32))
    blocks = jm.build_block_sparse_ranges(PATTERN, 8)
    np.testing.assert_array_equal(
        tm.expand_block_ranges_to_rows(blocks, 8, 37),
        jm.expand_block_ranges_to_rows(blocks, 8, 37))
    np.testing.assert_array_equal(
        tm.expand_block_ranges_to_rows(torch.from_numpy(blocks), 8,
                                       37).numpy(),
        jm.expand_block_ranges_to_rows(blocks, 8, 37))


@pytest.mark.parametrize("causal", [True, False])
def test_segment_ranges_match_jax_numpy_and_tensor(causal):
    ref = np.asarray(jm.build_segment_ranges(jnp.asarray(SEGMENTS), causal))
    np.testing.assert_array_equal(tm.build_segment_ranges(SEGMENTS, causal),
                                  ref)
    dyn = tm.build_segment_ranges(torch.from_numpy(SEGMENTS), causal)
    assert dyn.dtype == torch.int32
    np.testing.assert_array_equal(dyn.numpy(), ref)


@pytest.mark.parametrize("specs", _specs(), ids=SPEC_IDS)
@pytest.mark.parametrize("sq,skv", [(40, 40), (40, 57)])
def test_materialize_mask_matches_jax(specs, sq, skv):
    tspec, jspec, ranges = specs
    ref = np.asarray(jm.materialize_mask(jspec, sq, skv, ranges=ranges))
    out = tm.materialize_mask(tspec, sq, skv, ranges=ranges)
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("specs", _specs(), ids=SPEC_IDS)
def test_row_ranges_and_tile_bounds_match_jax(specs):
    tspec, jspec, ranges = specs
    sq, skv, sq_pad = 40, 57, 64
    ref = jfa.compute_row_ranges(jspec, sq, skv, mask_ranges=ranges,
                                 seq_q_padded=sq_pad)
    rr = tfa.compute_row_ranges(tspec, sq, skv, mask_ranges=ranges,
                                seq_q_padded=sq_pad)
    np.testing.assert_array_equal(rr, ref)
    for want, got in zip(jfa.build_block_bounds(ref, 16, 8),
                         tfa.build_block_bounds(rr, 16, 8)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.stack(build_kv_block_bounds(rr, 16, 8, 8)),
        np.stack(j_build_kv_block_bounds(ref, 16, 8, 8)))
    # The table the kernels read: unpadded, on the requested device.
    table = tfa.row_ranges_tensor(tspec, sq, skv, ranges, torch.device("cpu"))
    np.testing.assert_array_equal(table.numpy(), ref[:sq])


def test_dynamic_row_ranges_match_jax():
    r = np.stack([np.arange(30) - 3, np.arange(30) * 2 - 5], -1).astype(
        np.int32)
    ref = jfa.compute_row_ranges_dynamic(jnp.asarray(r), 30, 40, 32, 40)
    out = tfa.compute_row_ranges_dynamic(torch.from_numpy(r), 30, 40, 32, 40)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    spec = tm.MaskSpec(tm.MaskKind.SPARSE_RANGES)
    table = tfa.row_ranges_tensor(spec, 30, 40, torch.from_numpy(r),
                                  torch.device("cpu"))
    np.testing.assert_array_equal(table.numpy(), np.asarray(ref)[:30])
    with pytest.raises(ValueError):
        tfa.row_ranges_tensor(tm.CAUSAL, 30, 40, torch.from_numpy(r),
                              torch.device("cpu"))


def test_mask_spec_and_block_sizes_checks_match_jax():
    with pytest.raises(ValueError):
        tm.MaskSpec(tm.MaskKind.SLIDING_WINDOW)
    with pytest.raises(ValueError):
        tm.MaskSpec(tm.MaskKind.BLOCK_SPARSE)
    assert tm.sliding_window(4, causal=True).is_causal
    assert not tm.sliding_window(4).is_causal
    for kwargs in ({"block_q": 96}, {"block_kv_major": 640},
                   {"block_q_dq": 100}):
        with pytest.raises(ValueError):
            jfa.BlockSizes(**kwargs)
        with pytest.raises(ValueError):
            tfa.BlockSizes(**kwargs)
    bs = tfa.BlockSizes(block_kv=256, block_kv_major=1024)
    jbs = jfa.BlockSizes(block_kv=256, block_kv_major=1024)
    assert (bs.kv_major, bs.kv_dq_major, bs.q_dkv_major) == (
        jbs.kv_major, jbs.kv_dq_major, jbs.q_dkv_major)

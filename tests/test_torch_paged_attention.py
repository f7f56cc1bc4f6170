"""Port parity: paged decode / chunked prefill attention vs the JAX package.

The same seeded numpy inputs go to the JAX kernels (Pallas in interpret
mode, fp32, HIGHEST matmul precision) and to the port's plain PyTorch
versions, which is what the port's wrappers run for CPU tensors.  Held to
TOLERANCES["fp32"] (max abs error).  The CUDA kernels are held to the
plain versions in tests/test_torch_kernels.py, on the card.  Besides the
two-state pool (K and V halves), MLA's latent pool: one state per token
(S_sub = 1) read as K and, with its rope tail zeroed (``v_tail_zero``), as
V, at a head dim (80) outside the GQA model's and at DeepSeek's absorbed
width (576 = 512 + 64).  The kernels' host-side choices are pure functions
of shapes, checked here too: the decode's split plan (``decode_splits``),
which body each kernel runs (``decode_body``, ``prefill_body``; the card
tests hold the C library to the same answers) and the head dims without a
kernel (past 576).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.serving.paged_attention import (
    paged_decode_attention as jax_decode,
    paged_prefill_attention as jax_prefill,
)
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    check_head_dim,
    decode_body,
    decode_splits,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    prefill_body,
)

HQ, HKV, D, PT, NP, MP = 4, 2, 32, 16, 12, 4


def _pool(rng, dtype=np.float32):
    """Random merged pool [Hkv, NP+1, 2PT, D]; the trash page is random too,
    so a kernel that reads it unmasked shows up."""
    return rng.standard_normal((HKV, NP + 1, 2 * PT, D)).astype(dtype)


def _tables(rng, lengths):
    """Scattered page tables, padded with the trash page (id NP)."""
    perm = rng.permutation(NP)
    table = np.full((len(lengths), MP), NP, np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        pages = -(-n // PT)
        table[i, :pages] = perm[nxt: nxt + pages]
        nxt += pages
    return table


def _decode_inputs(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([1, PT, PT + 1, 3 * PT - 5], np.int32)
    q = rng.standard_normal((len(lengths), HQ, D)).astype(np.float32)
    return q, _pool(rng), _tables(rng, lengths), lengths


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))


def test_decode_plain_matches_jax():
    q, pool, table, lengths = _decode_inputs()
    with jax.default_matmul_precision("highest"):
        ref = jax_decode(jnp.asarray(q), jnp.asarray(pool),
                         jnp.asarray(table), jnp.asarray(lengths),
                         page_tokens=PT, interpret=True)
    out = paged_decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(pool),
        torch.from_numpy(table), torch.from_numpy(lengths), page_tokens=PT,
    )
    assert out.shape == (len(lengths), HQ, D) and out.dtype == torch.float32
    assert _max_err(out.numpy(), ref) <= TOLERANCES["fp32"]


def _prefill_inputs(offset, chunk=8, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((HQ, chunk, D)).astype(np.float32)
    row = _tables(rng, [offset + chunk])[0]
    return q, _pool(rng), row


@pytest.mark.parametrize("offset", [0, PT, PT + 5])
def test_prefill_plain_matches_jax(offset):
    q, pool, row = _prefill_inputs(offset)
    with jax.default_matmul_precision("highest"):
        ref = jax_prefill(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(row),
                          jnp.asarray(offset, jnp.int32), page_tokens=PT,
                          interpret=True)
    out = paged_prefill_attention_plain(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(row),
        offset, page_tokens=PT,
    )
    assert out.shape == q.shape
    assert _max_err(out.numpy(), ref) <= TOLERANCES["fp32"]


def test_cpu_wrappers_take_plain_path_without_launching():
    q, pool, table, lengths = _decode_inputs()
    args = [torch.from_numpy(a) for a in (q, pool, table, lengths)]
    before = (paged_decode_attention.launches,
              paged_prefill_attention.launches)
    out = paged_decode_attention(*args, page_tokens=PT)
    torch.testing.assert_close(
        out, paged_decode_attention_plain(*args, page_tokens=PT),
        rtol=0, atol=0,
    )
    qp, poolp, row = _prefill_inputs(PT)
    out = paged_prefill_attention(torch.from_numpy(qp), torch.from_numpy(poolp),
                                  torch.from_numpy(row), PT, page_tokens=PT)
    assert out.shape == qp.shape
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == before


def test_bad_pool_shape_raises():
    """Page rows must be 1 or 2 · page_tokens (one-state pages, PT rows, are
    MLA's latent layout and valid)."""
    q, pool, table, lengths = _decode_inputs()
    with pytest.raises(ValueError):
        paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(pool[:, :, :PT + 3]),
            torch.from_numpy(table), torch.from_numpy(lengths), page_tokens=PT,
        )


@pytest.mark.parametrize("quantized,d,vtz,hq", [
    (False, 80, 16, 4), (True, 80, 16, 4),
    (False, 576, 64, 16), (True, 576, 64, 16),
], ids=["float", "int8", "float-d576", "int8-d576"])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_latent_pages_with_v_tail_zero_match_jax(kernel, quantized, d, vtz,
                                                 hq):
    """Hq = 4 over Hkv = 1 at D = 80 = d_c 64 + d_r 16, V's last 16 lanes
    zeroed, and DeepSeek's geometry: Hq = 16 over the latent at D = 576 =
    d_c 512 + d_r 64; the int8 pool's one scale per token serves K and
    V."""
    rng = np.random.default_rng(7 + quantized + (d != 80) * 2)
    if quantized:
        pool = rng.integers(-128, 128, (1, NP + 1, PT, d)).astype(np.int8)
        scales = rng.uniform(0.5, 2.0, (1, NP + 1, 1, PT)).astype(
            np.float32) / 127
        kw = dict(k_scales=scales, v_scales=scales)
    else:
        pool = rng.standard_normal((1, NP + 1, PT, d)).astype(np.float32)
        kw = {}
    if kernel == "decode":
        lengths = np.asarray([1, PT + 3, 3 * PT - 5], np.int32)
        args = (rng.standard_normal((3, hq, d)).astype(np.float32), pool,
                _tables(rng, lengths), lengths)
        jfn, tfn = jax_decode, paged_decode_attention_plain
    else:
        offset, chunk = 19, 9
        args = (rng.standard_normal((hq, chunk, d)).astype(np.float32), pool,
                _tables(rng, [offset + chunk])[0], offset)
        jfn, tfn = jax_prefill, paged_prefill_attention_plain
    with jax.default_matmul_precision("highest"):
        ref = jfn(*(jnp.asarray(a) for a in args), page_tokens=PT,
                  v_tail_zero=vtz, interpret=True,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    out = tfn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in args), page_tokens=PT, v_tail_zero=vtz,
              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert out.shape == args[0].shape
    assert _max_err(out.numpy(), ref) <= TOLERANCES["fp32"]


H100_SMS = 132


@pytest.mark.parametrize("batch,kv_heads,group,capacity,splits", [
    (8, 4, 4, 4096, 32),     # the flagship engine's decode
    (8, 1, 16, 4096, 32),    # MLA's latent decode
    (1, 1, 16, 4096, 32),    # one MLA sequence
    (1, 2, 2, 48, 1),        # a one-page cache
    (64, 8, 4, 4096, 2),     # 512 (b, KV head) pairs: 32 tiles a split
    (1, 1, 1, 100000, 782),  # one long sequence: 2 tiles a split
    (8, 4, 4, 4000, 32),     # a capacity that ends mid-tile
])
def test_decode_split_plan(batch, kv_heads, group, capacity, splits):
    got = decode_splits(batch, kv_heads, group, capacity, H100_SMS)
    assert got == splits
    tiles = -(-capacity // 64)
    per = -(-tiles // got)  # tiles a split, as the C launcher derives it
    assert per * got >= tiles and per * (got - 1) < tiles  # none empty
    ctas = batch * kv_heads * -(-group // 16)
    # Two tiles a split, or as few more as keep to 8 CTAs an SM.
    assert per == max(2, -(-tiles * ctas // (8 * H100_SMS))) or got == 1
    assert ctas * got <= 8 * H100_SMS or per > 2


@pytest.mark.parametrize("group", [1, 4, 16, 17, 40])
def test_decode_split_plan_counts_group_slices(group):
    """A group over 16 rows runs in 16-row slices, each a CTA: the plan
    counts them, so a larger group needs no more splits."""
    one = decode_splits(2, 1, 16, 4096, H100_SMS)
    got = decode_splits(2, 1, group, 4096, H100_SMS)
    assert got <= one if group > 16 else got == one


@pytest.mark.parametrize("dtype,d,states,vtz,want", [
    (torch.bfloat16, 64, 2, 0, "tensor_core"),
    (torch.bfloat16, 128, 2, 0, "tensor_core"),
    (torch.bfloat16, 256, 2, 0, "tensor_core"),
    (torch.bfloat16, 80, 1, 16, "tensor_core"),
    (torch.bfloat16, 288, 1, 32, "tensor_core"),   # MLA: 256 kept lanes
    (torch.bfloat16, 288, 1, 16, "fp32_fma"),      # 272 kept lanes
    (torch.bfloat16, 288, 2, 32, "fp32_fma"),      # two-state pages
    (torch.bfloat16, 288, 1, 0, "fp32_fma"),       # the int4 byte at 288
    (torch.bfloat16, 272, 1, 16, "tensor_core"),
    (torch.float32, 64, 2, 0, "fp32_fma"),
    (torch.float32, 288, 1, 32, "fp32_fma"),
    (torch.bfloat16, 576, 1, 64, "tensor_core"),   # DeepSeek: 512 kept
    (torch.bfloat16, 320, 1, 64, "tensor_core"),   # run at 576
    (torch.bfloat16, 576, 1, 0, "fp32_fma"),       # 576 kept lanes
    (torch.bfloat16, 576, 2, 64, "fp32_fma"),      # two-state pages
    (torch.float32, 576, 1, 64, "fp32_fma"),
])
def test_prefill_routing_rule(dtype, d, states, vtz, want):
    assert prefill_body(dtype, d, states, vtz) == want


@pytest.mark.parametrize("d", [592, 1024, 40])
def test_head_dim_without_a_kernel_raises(d):
    """Below 1 no kernel takes the head dim: the routing raises, as the
    CUDA wrappers do before they launch.  Every head dim from 1 has one:
    40 (Stable Diffusion 1.5's first UNet level) takes the tensor-core
    prefill in bf16; past 576 (DeepSeek's absorbed width) both kernels
    take the split-D route in both dtypes."""
    check_head_dim("paged_decode", d)
    if d > 576:
        for dtype in (torch.bfloat16, torch.float32):
            assert prefill_body(dtype, d, 1, 0) == "split_d"
            assert prefill_body(dtype, d, 2, 0) == "split_d"
            assert decode_body(dtype, d) == "split_d"
    else:
        assert prefill_body(torch.bfloat16, d, 1, 0) == "tensor_core"
    for bad in (0, -1):
        with pytest.raises(ValueError, match="has no kernel"):
            check_head_dim("paged_decode", bad)
        with pytest.raises(ValueError, match="has no kernel"):
            prefill_body(torch.bfloat16, bad, 1, 0)
        with pytest.raises(ValueError, match="has no kernel"):
            decode_body(torch.bfloat16, bad)
    for ok in (1, 8, 33, 72, 575, 576, 577, 4096):
        check_head_dim("paged_decode", ok)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "fp32_fma")])
def test_decode_routing_rule(dtype, want):
    for d in (1, 64, 288, 576):
        assert decode_body(dtype, d) == want

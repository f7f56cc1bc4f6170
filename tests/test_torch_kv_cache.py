"""Port parity: paged KV-cache scatter/gather vs the JAX package.

The same seeded numpy K/V are written by both packages' ``write_prompt``
and ``append_tokens``; the written pool tensors themselves must be equal
(the writes are copies, so bit for bit), and ``gather_kv`` must read the
sequence back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.serving import kv_cache as jkv
from metal_flash_attention_plus_tpu_torch.serving import kv_cache as tkv

L, HKV, NP, PT, D, MP = 2, 2, 6, 8, 16, 4


def _caches():
    j = jkv.PagedKVCache.create(L, HKV, NP, PT, D, dtype=jnp.float32)
    t = tkv.PagedKVCache.create(L, HKV, NP, PT, D, dtype=torch.float32,
                                device="cpu")
    return j, t


def _assert_pools_equal(j, t):
    np.testing.assert_array_equal(np.asarray(j.kv_pages), t.kv_pages.numpy())


def test_write_prompt_append_and_gather_match_jax():
    rng = np.random.default_rng(0)
    seq = 19  # three pages, the last partly filled
    k = rng.standard_normal((HKV, seq, D)).astype(np.float32)
    v = rng.standard_normal((HKV, seq, D)).astype(np.float32)
    row = np.asarray([4, 1, 5, NP], np.int32)  # scattered, trash-padded
    j, t = _caches()
    j = jkv.write_prompt(j, 1, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(row))
    t = tkv.write_prompt(t, 1, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(row))
    _assert_pools_equal(j, t)

    # Decode append: sequence 0 writes its token 19, sequence 1 its token 3,
    # slot 2 is padding (length 1, every page on the trash page).
    tables = np.stack([row, [0, NP, NP, NP], [NP] * MP]).astype(np.int32)
    positions = np.asarray([seq, 3, 0], np.int32)
    kn = rng.standard_normal((3, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((3, HKV, D)).astype(np.float32)
    j = jkv.append_tokens(j, 1, jnp.asarray(kn), jnp.asarray(vn),
                          jnp.asarray(positions), jnp.asarray(tables))
    t = tkv.append_tokens(t, 1, torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.from_numpy(positions),
                          torch.from_numpy(tables))
    _assert_pools_equal(j, t)

    jk, jv = jkv.gather_kv(j, 1, jnp.asarray(row), seq + 1)
    tk, tv = tkv.gather_kv(t, 1, torch.from_numpy(row), seq + 1)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(tk.numpy()[:, :seq], k)
    np.testing.assert_array_equal(tk.numpy()[:, seq], kn[0])
    np.testing.assert_array_equal(tv.numpy()[:, seq], vn[0])


def test_chunk_write_at_offset_matches_whole_prompt():
    rng = np.random.default_rng(1)
    k = rng.standard_normal((HKV, 20, D)).astype(np.float32)
    v = rng.standard_normal((HKV, 20, D)).astype(np.float32)
    row = torch.tensor([3, 0, 2, NP], dtype=torch.int32)
    _, whole = _caches()
    _, chunks = _caches()
    tkv.write_prompt(whole, 0, torch.from_numpy(k), torch.from_numpy(v), row)
    for lo, hi in ((0, 12), (12, 20)):
        tkv.write_prompt(chunks, 0, torch.from_numpy(k[:, lo:hi]),
                         torch.from_numpy(v[:, lo:hi]), row, offset=lo)
    torch.testing.assert_close(chunks.kv_pages, whole.kv_pages, rtol=0,
                               atol=0)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_pools_wait_for_their_slice(bits):
    """The quantized pools have come: int8 halves or the int4 byte, with
    fp32 row-vector scales, in the JAX package's shapes."""
    t = tkv.PagedKVCache.create(L, HKV, NP, PT, D, bits=bits, device="cpu")
    j = jkv.PagedKVCache.create(L, HKV, NP, PT, D, quantized=True, bits=bits)
    assert t.quantized and t.kv_pages.dtype == torch.int8
    assert tuple(t.kv_pages.shape) == tuple(j.kv_pages.shape)
    assert tuple(t.k_scales.shape) == tuple(j.k_scales.shape)
    assert t.v_scales.dtype == torch.float32
    with pytest.raises(ValueError):
        tkv.PagedKVCache.create(L, HKV, NP, PT, D, bits=2, device="cpu")


def test_cache_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.PagedKVCache.create(L, HKV, NP, PT, D)

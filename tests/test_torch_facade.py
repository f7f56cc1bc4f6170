"""Port parity: the dispatch facades against the JAX package's.

``AttentionDescriptor`` and ``MultiHeadAttention`` (forward, the
differentiable ``__call__`` and the explicit backward) and the
``QuantizedAttention`` facade's block resolution and benchmark.  The same
seeded numpy inputs go through both packages in fp32; the JAX side runs at
HIGHEST matmul precision, its Pallas kernels in interpret mode; the port's
side runs the plain versions its wrappers take on the CPU.  Tolerance:
TOLERANCES["fp32"] (2e-5) in max abs error over the JAX value's max abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu import attention as ja
from metal_flash_attention_plus_tpu.attention import masking as jm
from metal_flash_attention_plus_tpu_torch import attention as ta
from metal_flash_attention_plus_tpu_torch.attention import masking as tm
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)

TOL = TOLERANCES["fp32"]

# name: (Hq, Hkv, S, D, (torch mask, JAX mask), interleaved)
CASES = {
    "gqa_grouped_causal": (4, 2, 128, 32, (tm.CAUSAL, jm.CAUSAL), False),
    "gqa_interleaved_causal": (4, 2, 128, 32, (tm.CAUSAL, jm.CAUSAL), True),
    "mqa_window": (4, 1, 128, 32,
                   (tm.sliding_window(48), jm.sliding_window(48)), False),
}


def _inputs(name, seed=0):
    hq, hkv, s, d = CASES[name][:4]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((1, hq, s, d), (1, hkv, s, d), (1, hkv, s, d),
                          (1, hq, s, d))]


def _descriptors(name):
    hq, hkv, _, d, (tmask, jmask), inter = CASES[name]
    common = dict(head_dim=d, num_q_heads=hq, num_kv_heads=hkv,
                  interleaved_kv=inter)
    return (ta.AttentionDescriptor(mask=tmask, input_dtype=torch.float32,
                                   **common),
            ja.AttentionDescriptor(mask=jmask, input_dtype=jnp.float32,
                                   **common))


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_descriptor_properties_match_jax():
    for hq, hkv, inter in ((8, None, False), (8, 2, False), (8, 2, True),
                           (8, 1, False)):
        t = ta.AttentionDescriptor(head_dim=64, num_q_heads=hq,
                                   num_kv_heads=hkv, interleaved_kv=inter)
        j = ja.AttentionDescriptor(head_dim=64, num_q_heads=hq,
                                   num_kv_heads=hkv, interleaved_kv=inter)
        assert (t.kv_heads, t.q_per_kv) == (j.kv_heads, j.q_per_kv)
        assert t.broadcast_mode.value == j.broadcast_mode.value
        assert [t.kv_head_for(h) for h in range(hq)] == [
            j.kv_head_for(h) for h in range(hq)]
        assert t.scale_or_default() == j.scale_or_default()
    t = ta.AttentionDescriptor(head_dim=64, softmax_scale=0.5)
    assert t.scale_or_default() == 0.5
    assert t.input_dtype == torch.bfloat16
    assert t.output_dtype == torch.float32
    assert ta.MultiHeadShape(1, 2, 3, 4).as_tuple() == (1, 2, 3, 4)
    assert ({m.value for m in ta.BroadcastMode}
            == {m.value for m in ja.BroadcastMode})
    with pytest.raises(ValueError, match="divisible"):
        ta.AttentionDescriptor(head_dim=64, num_q_heads=6, num_kv_heads=4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_head_forward_matches_jax(name):
    tdesc, jdesc = _descriptors(name)
    q, k, v, _ = _inputs(name)
    with jax.default_matmul_precision("highest"):
        jo, jl = ja.MultiHeadAttention(jdesc).forward(
            *map(jnp.asarray, (q, k, v)), interpret=True)
    to, tl = ta.MultiHeadAttention(tdesc).forward(
        *map(torch.from_numpy, (q, k, v)))
    assert to.dtype == torch.float32 and tl.shape == q.shape[:3]
    assert _rel(to.numpy(), jo) <= TOL
    assert _rel(tl.numpy(), jl) <= TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_head_call_gradients_match_jax(name):
    tdesc, jdesc = _descriptors(name)
    q, k, v, do = _inputs(name, seed=1)
    jmha = ja.MultiHeadAttention(jdesc)

    def jloss(q_, k_, v_):
        return jnp.sum(jmha(q_, k_, v_, interpret=True) * jnp.asarray(do))

    with jax.default_matmul_precision("highest"):
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = ta.MultiHeadAttention(tdesc)(*leaves)
    tgrads = torch.autograd.grad(o, leaves,
                                 grad_outputs=torch.from_numpy(do))
    for got, want in zip(tgrads, jgrads):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_head_backward_matches_jax(name):
    tdesc, jdesc = _descriptors(name)
    q, k, v, do = _inputs(name, seed=2)
    with jax.default_matmul_precision("highest"):
        jmha = ja.MultiHeadAttention(jdesc)
        jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
        jo, jl = jmha.forward(jq, jk, jv, interpret=True)
        jgrads = jmha.backward(jq, jk, jv, jo, jl, jdo, interpret=True)
    tmha = ta.MultiHeadAttention(tdesc)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tl = tmha.forward(tq, tk, tv)
    tgrads = tmha.backward(tq, tk, tv, to, tl, tdo)
    for got, want in zip(tgrads, jgrads):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= TOL


def test_multi_head_validates_as_jax():
    q = torch.zeros(1, 4, 16, 64)
    kv = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="head counts"):
        ta.MultiHeadAttention(ta.AttentionDescriptor(
            head_dim=64, num_q_heads=8, num_kv_heads=2)).forward(q, kv, kv)
    mha = ta.MultiHeadAttention(ta.AttentionDescriptor(
        head_dim=32, num_q_heads=4, num_kv_heads=2))
    with pytest.raises(ValueError, match="head_dim mismatch"):
        mha.forward(q, kv, kv)
    mha = ta.MultiHeadAttention(ta.AttentionDescriptor(
        head_dim=64, num_q_heads=4, num_kv_heads=2))
    with pytest.raises(ValueError, match="k/v/batch mismatch"):
        mha(q, kv, torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError, match="k/v/batch mismatch"):
        mha(q, torch.zeros(2, 2, 16, 64), torch.zeros(2, 2, 16, 64))


@pytest.mark.parametrize("mask", ["full", "causal"])
@pytest.mark.parametrize("seq_len,head_dim,bits", [
    (256, 64, 8), (1024, 128, 8), (4096, 64, 4), (2048, 256, 4),
    (8192, 128, 8)])
def test_quantized_blocks_match_jax(seq_len, head_dim, bits, mask):
    tmask, jmask = ((tm.FULL, jm.FULL) if mask == "full"
                    else (tm.CAUSAL, jm.CAUSAL))
    got = ta.QuantizedAttention(mask=tmask)._blocks(seq_len, head_dim, bits)
    want = ja.QuantizedAttention(mask=jmask)._blocks(seq_len, head_dim, bits)
    assert got.__dict__ == want.__dict__


def test_quantized_facade_int8_p_spans_match_jax():
    # quantize_q with TENSOR scales: P is int8 and rounds over block_kv
    # spans; at d=128 and int8 the table's block_kv is 1024, not
    # BlockSizes()'s 512.  What remains are rounding flips of run-time int8
    # values.
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 1024, 128)).astype(np.float32)
               for _ in range(3))
    cfg = dict(per_tensor=True)
    with jax.default_matmul_precision("highest"):
        jo = ja.QuantizedAttention(config=ja.QuantizedAttentionConfig(
            **cfg))(*map(jnp.asarray, (q, k, v)), quantize_q=True)
    to = ta.QuantizedAttention(config=ta.QuantizedAttentionConfig(**cfg))(
        *map(torch.from_numpy, (q, k, v)), quantize_q=True)
    jo = np.asarray(jo)
    assert np.abs(to.numpy() - jo).max() <= 5e-3 * np.abs(jo).max()


def test_quantized_benchmark_keys():
    res = ta.QuantizedAttention(mask=tm.CAUSAL).benchmark(
        batch=1, num_heads=2, seq_len=64, head_dim=32, iters=1,
        device="cpu")
    assert sorted(res) == ["bf16_tflops", "int4_rel_err", "int4_tflops",
                           "int8_rel_err", "int8_tflops"]
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert res["int8_rel_err"] < res["int4_rel_err"] < 0.5

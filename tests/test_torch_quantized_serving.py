"""Port parity for the quantized serving slice: int8/int4 KV pools, the
paged kernels' quantized modes, W8A8/W4A8 weights and the engine.

A 256-wide model (every contraction a multiple of 256, so W4A8 runs) in
fp32.  The JAX side runs its Pallas kernels in interpret mode at HIGHEST
matmul precision.  Tolerances:

- KV scatters: bytes and scales identical (the same fp32 divisions and
  half-to-even rounding on both sides).
- The paged plain versions over int8/int4 pools vs the JAX kernels:
  TOLERANCES["fp32"] max abs (fp32 sums in another order).
- Logits of ``quantized_forward`` and of the quantized ``prefill_chunk`` /
  ``decode_step``: rel L2 ≤ 1e-3.  The activations are quantized to int8
  at run time, and an activation within an ulp of a rounding boundary may
  round to the neighbouring int8 on one side, which moves an output by
  ~1e-3 relative.  Without such a flip the two agree to ~1e-7, as they do
  at these inputs.  A flip early in the network also moves every later
  activation of its row, whose requantization then flips more of them: on
  other inputs of the W4A8 forward this was measured at up to 1.1e-2.
- The engine with W8A8 and W4A8 weights gives the same greedy tokens as the
  port's uncached ``quantized_forward``; with int8/int4 pools it agrees
  with the float pool on ≥ 80% of tokens, on the JAX package's own
  quantized-cache engine tests' model and prompts (a random model's greedy
  tokens follow near-ties of its logits, so the agreement depends on them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's serving package must be imported before its
# models.cached (see tests/test_torch_serving.py).
import metal_flash_attention_plus_tpu.serving  # noqa: F401
from metal_flash_attention_plus_tpu.models import cached as jcached
from metal_flash_attention_plus_tpu.models import quantized_inference as jqi
from metal_flash_attention_plus_tpu.models import transformer as jtf
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.serving import kv_cache as jkv
from metal_flash_attention_plus_tpu.serving.paged_attention import (
    paged_decode_attention as jax_decode,
    paged_prefill_attention as jax_prefill,
)
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.models import cached as tcached
from metal_flash_attention_plus_tpu_torch.models import (
    quantized_inference as tqi,
)
from metal_flash_attention_plus_tpu_torch.models import transformer as ttf
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.runtime import native_available
from metal_flash_attention_plus_tpu_torch.serving import kv_cache as tkv
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention_plain,
    paged_prefill_attention_plain,
)

DIMS = dict(vocab_size=128, d_model=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=64, d_ff=512, max_seq=256)
JCFG = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, block_sizes=BlockSizes(
    block_q=128, block_kv=128, block_q_dkv=128, block_kv_dkv=128,
    block_q_dq=128, block_kv_dq=128))
TCFG = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
LOGIT_REL_L2 = 1e-3
NP, PT, MP, CHUNK = 16, 8, 6, 16


def _weight_cfgs(bits):
    return (jparams.QuantConfig(bits=bits,
                                granularity=jparams.QuantGranularity.ROW),
            tparams.QuantConfig(bits=bits,
                                granularity=tparams.QuantGranularity.ROW))


@pytest.fixture(scope="module")
def models():
    """{bits: (JAX quantized params, the port's converted copy)} and the
    float params of both packages."""
    jp = jtf.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    quant = {}
    for bits in (8, 4):
        jq = jqi.quantize_weights(jp, _weight_cfgs(bits)[0])
        quant[bits] = (jq, params_from_jax(jax.tree.map(np.asarray, jq),
                                           device="cpu"))
    return jp, tp, quant


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want)
                 / np.linalg.norm(want))


# --------------------------------------------------------------------------
# KV pools and the paged kernels' quantized modes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_kv_scatter_matches_jax(bits):
    rng = np.random.default_rng(bits)
    hkv, d, seq = 2, 32, 19
    k = rng.standard_normal((hkv, seq, d)).astype(np.float32)
    v = rng.standard_normal((hkv, seq, d)).astype(np.float32)
    row = np.asarray([4, 1, 5, NP], np.int32)
    j = jkv.PagedKVCache.create(2, hkv, NP, PT, d, quantized=True, bits=bits)
    t = tkv.PagedKVCache.create(2, hkv, NP, PT, d, quantized=True, bits=bits,
                                device="cpu")
    assert t.quantized and t.bits == bits
    assert tuple(t.kv_pages.shape) == tuple(j.kv_pages.shape)
    j = jkv.write_prompt(j, 1, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(row))
    tkv.write_prompt(t, 1, torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(row))
    tables = np.stack([row, [0, NP, NP, NP]]).astype(np.int32)
    positions = np.asarray([seq, 3], np.int32)
    kn = rng.standard_normal((2, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((2, hkv, d)).astype(np.float32)
    j = jkv.append_tokens(j, 1, jnp.asarray(kn), jnp.asarray(vn),
                          jnp.asarray(positions), jnp.asarray(tables))
    tkv.append_tokens(t, 1, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(positions), torch.from_numpy(tables))
    live = slice(0, NP)  # the trash page takes racing padded writes
    for name in ("kv_pages", "k_scales", "v_scales"):
        want = np.asarray(getattr(j, name))[:, :, live]
        got = getattr(t, name)[:, :, live].numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    jk, jv = jkv.gather_kv(j, 1, jnp.asarray(row), seq + 1)
    tk, tv = tkv.gather_kv(t, 1, torch.from_numpy(row), seq + 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _quantized_pool(rng, bits, hkv, d):
    rows = PT if bits == 4 else 2 * PT
    pool = rng.integers(-128, 128, (hkv, NP + 1, rows, d)).astype(np.int8)
    step = 7.0 if bits == 4 else 127.0
    scales = [(rng.uniform(0.5, 2.0, (hkv, NP + 1, 1, PT)) / step).astype(
        np.float32) for _ in range(2)]
    return pool, scales


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kernel,d", [("decode", 64), ("decode", 128),
                                      ("prefill", 64)])
def test_quantized_paged_plain_matches_jax(kernel, d, bits):
    """D=64 reaches the JAX package's streamed decode kernel, D=128 its
    multi-page wave kernel; both are one CUDA kernel in the port."""
    rng = np.random.default_rng(d + bits)
    hq, hkv = 4, 2
    pool, (ks, vs) = _quantized_pool(rng, bits, hkv, d)
    perm = rng.permutation(NP).astype(np.int32)
    kw = dict(page_tokens=PT, kv_bits=bits)
    if kernel == "decode":
        lengths = np.asarray([1, PT + 3, 3 * PT - 5], np.int32)
        table = np.full((3, MP), NP, np.int32)
        table[0, :1], table[1, :2], table[2, :3] = perm[:1], perm[1:3], perm[
            3:6]
        q = rng.standard_normal((3, hq, d)).astype(np.float32)
        args = (q, pool, table, lengths)
        jfn, tfn = jax_decode, paged_decode_attention_plain
    else:
        offset, chunk = 11, 9
        table = np.full(MP, NP, np.int32)
        table[:3] = perm[:3]
        q = rng.standard_normal((hq, chunk, d)).astype(np.float32)
        args = (q, pool, table, offset)
        jfn, tfn = jax_prefill, paged_prefill_attention_plain
    with jax.default_matmul_precision("highest"):
        want = jfn(*(jnp.asarray(a) for a in args), k_scales=jnp.asarray(ks),
                   v_scales=jnp.asarray(vs), **kw)
    got = tfn(*(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
                else a for a in args),
              k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs),
              **kw)
    err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
    assert err <= TOLERANCES["fp32"], err


def test_paged_mode_rules():
    q = torch.zeros(1, 2, 32)
    pool = torch.zeros(1, 3, 16, 32, dtype=torch.int8)
    table = torch.zeros(1, 1, dtype=torch.int32)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):  # int4 needs scales
        paged_decode_attention_plain(q, pool, table, lengths, kv_bits=4)
    scales = torch.ones(1, 3, 1, 16)
    out = paged_decode_attention_plain(q, pool, table, lengths,
                                       k_scales=scales, v_scales=scales,
                                       kv_bits=4)  # 16 rows: PT = 16
    assert out.shape == (1, 2, 32)
    with pytest.raises(ValueError):  # 16 rows are neither 1 nor 2 · 5
        paged_decode_attention_plain(q, pool, table, lengths, page_tokens=5,
                                     k_scales=scales, v_scales=scales)
    with pytest.raises(ValueError):  # int4 pools take no v_tail_zero
        paged_decode_attention_plain(q, pool, table, lengths,
                                     k_scales=scales, v_scales=scales,
                                     kv_bits=4, v_tail_zero=8)
    # int8 with 16 rows of 16 tokens: one state per token (S_sub = 1), as
    # the JAX package reads it.
    out = paged_decode_attention_plain(q, pool, table, lengths,
                                       page_tokens=16, k_scales=scales,
                                       v_scales=scales)
    assert out.shape == (1, 2, 32)


# --------------------------------------------------------------------------
# Quantized weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_jax_equals_port_quantize_weights(models, bits):
    _, tp, quant = models
    own = tqi.quantize_weights(tp, _weight_cfgs(bits)[1])
    conv = quant[bits][1]
    pairs = [(own["unembed"], conv["unembed"])] + [
        (lo[k], lc[k]) for lo, lc in zip(own["layers"], conv["layers"])
        for k in ("wq", "wk", "wv", "wo", "wg", "wu", "wd")]
    for a, b in pairs:
        assert a.config == b.config and a.shape == b.shape
        for f in ("data", "scale", "zero_point"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f
    np.testing.assert_array_equal(own["embed"].numpy(), tp["embed"].numpy())
    jq = quant[bits][0]
    back = params_to_numpy(own)["layers"][1]["wd"]
    assert sorted(back) == ["data", "scale", "zero_point"]
    assert back["data"].tobytes() == np.asarray(
        jq["layers"][1]["wd"].data).tobytes()
    assert tqi.memory_footprint(own) == jqi.memory_footprint(jq)
    assert tqi.memory_footprint(own)["total_bytes"] < tqi.memory_footprint(
        tp)["total_bytes"]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_forward_matches_jax(models, bits):
    jq, tq = models[2][bits]
    tokens = np.random.default_rng(0).integers(0, 128, (1, 20))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, t: jqi.quantized_forward(p, t, JCFG))(
            jq, jnp.asarray(tokens))
    got = tqi.quantized_forward(tq, torch.from_numpy(tokens), TCFG)
    assert got.shape == (1, 20, 128) and got.dtype == torch.float32
    assert _rel_l2(got, want) <= LOGIT_REL_L2
    # With K/V quantized at run time too (S=20: int8-Q scores over ROW K/V).
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, t: jqi.quantized_forward(
            p, t, JCFG, quantize_kv=True))(jq, jnp.asarray(tokens))
    got = tqi.quantized_forward(tq, torch.from_numpy(tokens), TCFG,
                                quantize_kv=True)
    assert got.shape == (1, 20, 128) and got.dtype == torch.float32
    assert _rel_l2(got, want) <= LOGIT_REL_L2


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_cached_path_matches_jax(models, bits):
    """W8A8 weights over an int8 pool, W4A8 over an int4 pool: two prefill
    chunks of one sequence, then two batched decode steps."""
    jq, tq = models[2][bits]
    rng = np.random.default_rng(10 + bits)
    prompt = rng.integers(0, 128, 27)
    rows = np.full((2, MP), NP, np.int32)  # slot 1 is decode padding
    rows[0, :5] = [7, 2, 11, 4, 9]
    jcache = jcached.init_cache(JCFG, NP, PT, jnp.float32, quantized=bits)
    tcache = tcached.init_cache(TCFG, NP, PT, torch.float32, quantized=bits,
                                device="cpu")
    jprefill = jax.jit(lambda p, t, o, li, c, r: jcached.prefill_chunk(
        p, t, o, li, c, r, JCFG))
    jdecode = jax.jit(lambda p, t, ln, pts, c: jcached.decode_step(
        p, t, ln, pts, c, JCFG))
    with jax.default_matmul_precision("highest"):
        for start in range(0, len(prompt), CHUNK):
            chunk = prompt[start: start + CHUNK]
            padded = np.zeros(CHUNK, np.int32)
            padded[: len(chunk)] = chunk
            jl, jcache = jprefill(jq, jnp.asarray(padded), jnp.int32(start),
                                  jnp.int32(len(chunk) - 1), jcache,
                                  jnp.asarray(rows[0]))
            tl, tcache = tcached.prefill_chunk(
                tq, torch.from_numpy(padded).long(), start, len(chunk) - 1,
                tcache, torch.from_numpy(rows[0]), TCFG)
            assert _rel_l2(tl, jl) <= LOGIT_REL_L2
        lengths = np.asarray([28, 1], np.int32)
        for _ in range(2):
            tokens = rng.integers(0, 128, 2).astype(np.int32)
            jl, jcache = jdecode(jq, jnp.asarray(tokens),
                                 jnp.asarray(lengths), jnp.asarray(rows),
                                 jcache)
            tl, tcache = tcached.decode_step(
                tq, torch.from_numpy(tokens).long(),
                torch.from_numpy(lengths), torch.from_numpy(rows), tcache,
                TCFG)
            assert _rel_l2(tl[0], jl[0]) <= LOGIT_REL_L2
            lengths[0] += 1


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

PROMPTS = {1: [5, 9, 17, 3, 22, 8, 1], 2: [100, 42], 3: [7] * 19}
# The model of the JAX package's tests/test_serving.py (CFG).
SMALL = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=2,
             num_kv_heads=1, head_dim=32, d_ff=128, max_seq=256)


def _engine(params, cfg, prompts, quantized_cache=False):
    if not native_available():
        pytest.skip("native runtime unavailable (needs g++)")
    from metal_flash_attention_plus_tpu_torch.serving.engine import (
        GenerationRequest,
        ServingEngine,
    )

    engine = ServingEngine(
        params, cfg, num_pages=32, page_tokens=16, max_batch=2,
        cache_dtype=torch.float32, chunk_size=16,
        quantized_cache=quantized_cache, device="cpu",
    )
    for rid, p in prompts.items():
        engine.submit(GenerationRequest(rid, p, max_new_tokens=5))
    with torch.inference_mode():
        return engine.run()


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_with_quantized_weights_matches_uncached(models, bits):
    tq = models[2][bits][1]
    out = _engine(tq, TCFG, PROMPTS)
    with torch.inference_mode():
        for rid, prompt in PROMPTS.items():
            seq = list(prompt)
            for _ in range(5):
                logits = tqi.quantized_forward(tq, torch.tensor([seq]), TCFG)
                seq.append(int(torch.argmax(logits[0, -1])))
            assert out[rid] == seq[len(prompt):], rid


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_with_quantized_pool_agrees_with_float_pool(bits):
    jcfg = jtf.TransformerConfig(**SMALL, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0))),
        device="cpu")
    cfg = ttf.TransformerConfig(**SMALL, dtype=torch.float32)
    prompts = {1: PROMPTS[1], 2: PROMPTS[3]}
    ref = _engine(params, cfg, prompts)
    got = _engine(params, cfg, prompts, quantized_cache=bits)
    assert all(len(got[r]) == len(ref[r]) == 5 for r in prompts)
    agree = sum(a == b for r in prompts for a, b in zip(ref[r], got[r]))
    assert agree / (5 * len(prompts)) >= 0.8, (ref, got)


def test_quantized_engine_without_device_needs_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from metal_flash_attention_plus_tpu_torch.serving.engine import (
        ServingEngine,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(models[2][8][1], TCFG, num_pages=8, page_tokens=16,
                      quantized_cache=8)

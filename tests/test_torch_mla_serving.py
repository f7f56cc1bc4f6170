"""Port parity for the MLA serving slice as a whole.

1. ``mla_forward`` logits, and the causality check of the JAX package's
   tests/test_mla_serving.py, at its configuration (2 layers, 2 heads,
   d_c 64 + d_r 16: the flash path at D = 80), against the JAX
   ``mla_forward`` on the same converted parameters.
2. ``mla_prefill_chunk`` (two chunks of one sequence, one of another) and
   batched ``mla_decode_step`` s against the JAX package's, comparing the
   logits at every call and the latent pool at the end: float pool and
   weights, and int8 latent pool with W8A8 weights
   (``quantize_mla_weights``, byte for byte with the JAX one); at d_c 64 +
   d_r 16 and at DeepSeek-V2-Lite's latent widths, 512 + 64 (the paged
   kernels at D = 576).
3. The port's engine with ``mla_executor()`` against the port's own
   uncached greedy decode (the JAX package's engine tests are ``slow``).

fp32 throughout; the JAX side at HIGHEST matmul precision with its Pallas
kernels in interpret mode.  Logits are held to 1e-4 max abs: per-op
differences are at TOLERANCES["fp32"] and add up through two layers.  The
quantized path quantizes activations at run time on both sides; seed 0
puts no value within an ulp of a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's serving package must be imported before its models
# (models.cached_mla -> serving/__init__ -> serving.engine -> models.cached
# is a cycle when entered from the models).
import metal_flash_attention_plus_tpu.serving  # noqa: F401
from metal_flash_attention_plus_tpu.models import cached_mla as jcm
from metal_flash_attention_plus_tpu.models import mla_transformer as jmt
from metal_flash_attention_plus_tpu.models import quantized_inference as jqi
from metal_flash_attention_plus_tpu.ops.flash_attention import (
    BlockSizes as JBlockSizes,
)
from metal_flash_attention_plus_tpu_torch.models import cached_mla as tcm
from metal_flash_attention_plus_tpu_torch.models import mla_transformer as tmt
from metal_flash_attention_plus_tpu_torch.models import (
    quantized_inference as tqi,
)
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from metal_flash_attention_plus_tpu_torch.runtime import native_available

DIMS = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=2,
            head_dim=32, latent_dim=64, rope_dim=16, d_ff=128, max_seq=256)
JBLOCKS = JBlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                      block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)
JCFG = jmt.MLAConfig(**DIMS, dtype=jnp.float32, block_sizes=JBLOCKS)
TCFG = tmt.MLAConfig(**DIMS, dtype=torch.float32)
# DeepSeek-V2-Lite's latent widths (kv_lora_rank 512, qk_rope_head_dim 64
# in huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json:
# the paged kernels at D = 576) at the narrow model above.
DIMS_576 = dict(DIMS, latent_dim=512, rope_dim=64)
CFGS = {
    80: (JCFG, TCFG),
    576: (jmt.MLAConfig(**DIMS_576, dtype=jnp.float32, block_sizes=JBLOCKS),
          tmt.MLAConfig(**DIMS_576, dtype=torch.float32)),
}
LOGIT_TOL = 1e-4
NP, PT, MP, CHUNK = 16, 8, 6, 16


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))


def _params(jcfg=JCFG):
    jparams = jmt.init_mla_params(jcfg, jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def test_mla_forward_matches_jax_and_is_causal():
    jparams, tparams = _params()
    assert tparams["layers"][0]["w_uk"].shape == (2, 32, 64)
    assert tparams["layers"][0]["w_uv"].shape == (2, 64, 32)
    toks = np.random.default_rng(1).integers(0, 128, (1, 48))
    with jax.default_matmul_precision("highest"):
        want = jmt.mla_forward(jparams, jnp.asarray(toks), JCFG)
    got = tmt.mla_forward(tparams, torch.from_numpy(toks), TCFG)
    assert got.shape == (1, 48, 128) and got.dtype == torch.float32
    assert _err(want, got) <= LOGIT_TOL
    dense = tmt.mla_forward(tparams, torch.from_numpy(toks), TCFG,
                            attn_fn=tmt.plain_mla_attention)
    assert (got - dense).abs().max().item() <= LOGIT_TOL
    # Causality: changing a future token must not change earlier logits.
    toks2 = toks.copy()
    toks2[0, 40] = (toks2[0, 40] + 1) % 128
    got2 = tmt.mla_forward(tparams, torch.from_numpy(toks2), TCFG)
    assert (got[:, :40] - got2[:, :40]).abs().max().item() <= 1e-5
    assert (got[:, 40:] - got2[:, 40:]).abs().max().item() > 1e-5
    loss = tmt.mla_loss_fn(tparams, torch.from_numpy(toks), TCFG)
    assert loss.ndim == 0 and torch.isfinite(loss)


def test_mla_loss_matches_jax():
    """``mla_loss_fn`` (``F.embedding``, ``F.cross_entropy``) against the
    JAX loss (indexing, logsumexp − take_along_axis), repeated tokens
    included."""
    jparams, tparams = _params()
    toks = np.random.default_rng(2).integers(0, 128, (2, 33))
    toks[1, 5:9] = toks[1, 4]
    with jax.default_matmul_precision("highest"):
        want = float(jmt.mla_loss_fn(jparams, jnp.asarray(toks), JCFG))
    got = tmt.mla_loss_fn(tparams, torch.from_numpy(toks), TCFG)
    assert got.ndim == 0 and got.dtype == torch.float32
    assert abs(got.item() - want) <= LOGIT_TOL


def test_quantize_mla_weights_matches_jax_byte_for_byte():
    jparams, tparams = _params()
    want = params_to_numpy(params_from_jax(
        jax.tree.map(np.asarray, jqi.quantize_mla_weights(jparams)),
        device="cpu"))
    got = params_to_numpy(tqi.quantize_mla_weights(tparams))
    layer = got["layers"][0]
    assert set(layer["wdkv"]) == {"data", "scale", "zero_point"}
    assert layer["w_uk"].shape == (2, 32, 64)  # the 3-D weights stay float

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    walk(got, want)


@pytest.mark.parametrize("quantized,width", [
    (False, 80), (True, 80), (False, 576), (True, 576),
], ids=["float", "w8a8_int8_latent", "float-d576", "w8a8_int8_latent-d576"])
def test_prefill_chunks_and_decode_steps_match_jax(quantized, width):
    jcfg, tcfg = CFGS[width]
    jparams, tparams = _params(jcfg)
    if quantized:
        jparams = jqi.quantize_mla_weights(jparams)
        tparams = tqi.quantize_mla_weights(tparams)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, 27), rng.integers(0, 128, 10)]
    rows = np.full((3, MP), NP, np.int32)  # slot 2 is decode padding
    rows[0, :5] = [7, 2, 11, 4, 9]
    rows[1, :3] = [0, 13, 5]

    jprefill = jax.jit(lambda p, t, o, li, c, r: jcm.mla_prefill_chunk(
        p, t, o, li, c, r, jcfg))
    jdecode = jax.jit(lambda p, t, ln, pts, c: jcm.mla_decode_step(
        p, t, ln, pts, c, jcfg))
    jcache = jcm.init_mla_cache(jcfg, NP, PT, jnp.float32,
                                quantized=quantized)
    tcache = tcm.init_mla_cache(tcfg, NP, PT, torch.float32,
                                quantized=quantized, device="cpu")
    assert tuple(tcache.kv_pages.shape) == (2, 1, NP + 1, PT, width)

    with jax.default_matmul_precision("highest"):
        for s, prompt in enumerate(prompts):
            for start in range(0, len(prompt), CHUNK):
                chunk = prompt[start: start + CHUNK]
                padded = np.zeros(CHUNK, np.int32)
                padded[: len(chunk)] = chunk
                jl, jcache = jprefill(
                    jparams, jnp.asarray(padded), jnp.int32(start),
                    jnp.int32(len(chunk) - 1), jcache, jnp.asarray(rows[s]))
                tl, tcache = tcm.mla_prefill_chunk(
                    tparams, torch.from_numpy(padded).long(), start,
                    len(chunk) - 1, tcache, torch.from_numpy(rows[s]), tcfg)
                assert tl.shape == (128,)
                assert _err(jl, tl) <= LOGIT_TOL

        lengths = np.asarray([28, 11, 1], np.int32)
        for _ in range(3):
            tokens = rng.integers(0, 128, 3).astype(np.int32)
            jl, jcache = jdecode(jparams, jnp.asarray(tokens),
                                 jnp.asarray(lengths), jnp.asarray(rows),
                                 jcache)
            tl, tcache = tcm.mla_decode_step(
                tparams, torch.from_numpy(tokens).long(),
                torch.from_numpy(lengths), torch.from_numpy(rows), tcache,
                tcfg)
            assert tl.shape == (3, 128)
            # Slot 2 is padding: its logits are discarded by the engine.
            assert _err(jl[:2], tl[:2]) <= LOGIT_TOL
            lengths[:2] += 1
    live = np.asarray(jcache.kv_pages, np.float32)[:, :, :NP]
    np.testing.assert_allclose(tcache.kv_pages[:, :, :NP].float().numpy(),
                               live, rtol=0, atol=1e-5 if not quantized
                               else 1)
    if quantized:
        np.testing.assert_allclose(
            tcache.k_scales[:, :, :NP].numpy(),
            np.asarray(jcache.k_scales)[:, :, :NP], rtol=1e-6, atol=0)


def _uncached_greedy(params, prompt, n):
    seq = list(prompt)
    out = []
    for _ in range(n):
        logits = tmt.mla_forward(params, torch.tensor([seq]), TCFG)
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        seq.append(nxt)
    return out


def test_mla_engine_matches_uncached_greedy():
    if not native_available():
        pytest.skip("native runtime unavailable (needs g++)")
    from metal_flash_attention_plus_tpu_torch.serving.engine import (
        GenerationRequest,
        ServingEngine,
        mla_executor,
    )

    params = tmt.init_mla_params(TCFG, torch.Generator().manual_seed(0),
                                 device="cpu")
    prompts = {
        1: [5, 9, 17, 3, 22, 8, 1],
        2: [100, 42],
        3: [7] * 19,  # > chunk_size=16: a two-chunk prefill
    }
    engine = ServingEngine(
        params, TCFG, num_pages=32, page_tokens=16, max_batch=2,
        cache_dtype=torch.float32, chunk_size=16, executor=mla_executor(),
        device="cpu",
    )
    assert tuple(engine.cache.kv_pages.shape) == (2, 1, 33, 16, 80)
    for rid, p in prompts.items():
        engine.submit(GenerationRequest(rid, p, max_new_tokens=5))
    with torch.inference_mode():
        out = engine.run()
        for rid, p in prompts.items():
            assert out[rid] == _uncached_greedy(params, p, 5), rid
    stats = engine.stats
    assert stats["prefill_calls"] == 4
    assert stats["decode_tokens"] == 3 * 4
    with pytest.raises(ValueError):  # int4 pools take no rope tail
        ServingEngine(params, TCFG, num_pages=8, page_tokens=16,
                      quantized_cache=4, executor=mla_executor(),
                      device="cpu")

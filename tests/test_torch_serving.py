"""Port parity for the serving slice as a whole.

1. The JAX package's ``prefill_chunk`` (two chunks of one sequence, one
   chunk of another) and three batched ``decode_step``s against the port's,
   on the same converted parameters and the same tokens, comparing logits
   at every call.  fp32 throughout; the JAX side at HIGHEST matmul
   precision with its Pallas kernels in interpret mode.  Held to 1e-4 max
   abs error on the logits: per-op differences are at TOLERANCES["fp32"]
   and add up through two layers.
2. The port's ``ServingEngine`` greedy tokens against the port's own
   uncached greedy decode (full ``forward`` over the growing sequence), in
   fp32 on the CPU.  Needs the native runtime (built with g++).
3. Entry points without ``device`` need CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's serving package must be imported before its
# models.cached (models.cached -> serving/__init__ -> serving.engine ->
# models.cached is a cycle when entered from models.cached).
import metal_flash_attention_plus_tpu.serving  # noqa: F401
from metal_flash_attention_plus_tpu.models import cached as jcached
from metal_flash_attention_plus_tpu.models import transformer as jtf
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu_torch.models import cached as tcached
from metal_flash_attention_plus_tpu_torch.models import transformer as ttf
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
)
from metal_flash_attention_plus_tpu_torch.runtime import native_available

DIMS = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, max_seq=256)
JCFG = jtf.TransformerConfig(
    **DIMS, dtype=jnp.float32,
    block_sizes=BlockSizes(
        block_q=128, block_kv=128, block_q_dkv=128, block_kv_dkv=128,
        block_q_dq=128, block_kv_dq=128,
    ),
)
TCFG = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
LOGIT_TOL = 1e-4
NP, PT, MP, CHUNK = 16, 8, 6, 16


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.numpy())))


def test_prefill_chunks_and_decode_steps_match_jax():
    jparams = jtf.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, 27), rng.integers(0, 128, 10)]
    rows = np.full((3, MP), NP, np.int32)  # slot 2 is decode padding
    rows[0, :5] = [7, 2, 11, 4, 9]
    rows[1, :3] = [0, 13, 5]

    jprefill = jax.jit(lambda p, t, o, li, c, r: jcached.prefill_chunk(
        p, t, o, li, c, r, JCFG))
    jdecode = jax.jit(lambda p, t, ln, pts, c: jcached.decode_step(
        p, t, ln, pts, c, JCFG))
    jcache = jcached.init_cache(JCFG, NP, PT, jnp.float32)
    tcache = tcached.init_cache(TCFG, NP, PT, torch.float32, device="cpu")

    with jax.default_matmul_precision("highest"):
        for s, prompt in enumerate(prompts):
            for start in range(0, len(prompt), CHUNK):
                chunk = prompt[start: start + CHUNK]
                padded = np.zeros(CHUNK, np.int32)
                padded[: len(chunk)] = chunk
                jl, jcache = jprefill(
                    jparams, jnp.asarray(padded), jnp.int32(start),
                    jnp.int32(len(chunk) - 1), jcache, jnp.asarray(rows[s]))
                tl, tcache = tcached.prefill_chunk(
                    tparams, torch.from_numpy(padded).long(), start,
                    len(chunk) - 1, tcache, torch.from_numpy(rows[s]), TCFG)
                assert tl.shape == (128,)
                assert _err(jl, tl) <= LOGIT_TOL

        lengths = np.asarray([28, 11, 1], np.int32)
        for _ in range(3):
            tokens = rng.integers(0, 128, 3).astype(np.int32)
            jl, jcache = jdecode(jparams, jnp.asarray(tokens),
                                 jnp.asarray(lengths), jnp.asarray(rows),
                                 jcache)
            tl, tcache = tcached.decode_step(
                tparams, torch.from_numpy(tokens).long(),
                torch.from_numpy(lengths), torch.from_numpy(rows), tcache,
                TCFG)
            assert tl.shape == (3, 128)
            # Slot 2 is padding: its logits are discarded by the engine.
            assert _err(jl[:2], tl[:2]) <= LOGIT_TOL
            lengths[:2] += 1
    live = np.asarray(jcache.kv_pages)[:, :, :NP]
    np.testing.assert_allclose(tcache.kv_pages[:, :, :NP].numpy(), live,
                               rtol=0, atol=1e-5)


def _uncached_greedy(params, prompt, n):
    seq = list(prompt)
    out = []
    for _ in range(n):
        logits = ttf.forward(params, torch.tensor([seq]), TCFG)
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        seq.append(nxt)
    return out


@pytest.mark.parametrize("decode_steps", [1, 2])
def test_engine_matches_uncached_greedy(decode_steps):
    if not native_available():
        pytest.skip("native runtime unavailable (needs g++)")
    from metal_flash_attention_plus_tpu_torch.serving.engine import (
        GenerationRequest,
        ServingEngine,
    )

    params = ttf.init_params(TCFG, torch.Generator().manual_seed(0),
                             device="cpu")
    prompts = {
        1: [5, 9, 17, 3, 22, 8, 1],
        2: [100, 42],
        3: [7] * 19,  # > chunk_size=16: a two-chunk prefill
    }
    engine = ServingEngine(
        params, TCFG, num_pages=32, page_tokens=16, max_batch=2,
        cache_dtype=torch.float32, chunk_size=16, decode_steps=decode_steps,
        device="cpu",
    )
    for rid, p in prompts.items():
        engine.submit(GenerationRequest(rid, p, max_new_tokens=5))
    with torch.inference_mode():
        out = engine.run()
        for rid, p in prompts.items():
            assert out[rid] == _uncached_greedy(params, p, 5), rid
    stats = engine.stats
    assert stats["prefill_calls"] == 4
    assert stats["decode_tokens"] == 3 * 4
    assert stats["decode_calls"] >= 4


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from metal_flash_attention_plus_tpu_torch.serving.engine import (
        ServingEngine,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine({}, TCFG, num_pages=8, page_tokens=16)

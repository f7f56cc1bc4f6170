"""Port parity: the transformer forward vs the JAX package.

The JAX ``init_params`` tree is converted with ``params_from_jax``; the
same seeded tokens then go through both ``forward``s in fp32 (the JAX side
at HIGHEST matmul precision, its flash kernel in interpret mode).  Logits
are held to 1e-4 max abs error: fp32 throughout, and what differs is the
order of sums through two layers (flash online softmax on the JAX side,
dense softmax on the port's), each within TOLERANCES["fp32"] per op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.models import transformer as jtf
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu_torch.models import transformer as ttf
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    CAUSAL,
    FULL,
    reference_attention,
)

DIMS = dict(vocab_size=128, d_model=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, max_seq=128)
JCFG = jtf.TransformerConfig(
    **DIMS, dtype=jnp.float32,
    block_sizes=BlockSizes(
        block_q=128, block_kv=128, block_q_dkv=128, block_kv_dkv=128,
        block_q_dq=128, block_kv_dq=128,
    ),
)
TCFG = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
LOGIT_TOL = 1e-4


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def test_forward_matches_jax():
    params = jtf.init_params(JCFG, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 128, (2, 40))
    with jax.default_matmul_precision("highest"):
        ref = jtf.forward(params, jnp.asarray(tokens, jnp.int32), JCFG)
    tparams = params_from_jax(_numpy_tree(params), device="cpu")
    out = ttf.forward(tparams, torch.from_numpy(tokens), TCFG)
    assert out.shape == (2, 40, 128) and out.dtype == torch.float32
    err = np.max(np.abs(out.numpy() - np.asarray(ref)))
    assert err <= LOGIT_TOL, err


def test_params_from_jax_keeps_bf16_bits():
    cfg = jtf.TransformerConfig(**DIMS, dtype=jnp.bfloat16)
    tree = _numpy_tree(jtf.init_params(cfg, jax.random.PRNGKey(1)))
    tparams = params_from_jax(tree, device="cpu")
    wq = tparams["layers"][1]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(), tree["layers"][1]["wq"].astype(np.float32)
    )
    assert tparams["ln_f"].dtype == torch.float32
    f32 = params_from_jax(tree, device="cpu", dtype=torch.float32)
    assert f32["unembed"].dtype == torch.float32
    assert f32["ln_f"].dtype == torch.float32


@pytest.mark.parametrize("mask", [FULL, CAUSAL], ids=["full", "causal"])
@pytest.mark.parametrize("interleaved", [False, True])
def test_reference_attention_matches_jax(mask, interleaved):
    from metal_flash_attention_plus_tpu.attention import masking
    from metal_flash_attention_plus_tpu.reference.attention import (
        reference_attention as jref,
    )

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 12, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    jmask = masking.CAUSAL if mask == CAUSAL else masking.FULL
    jo, jl = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask,
                  interleaved_kv=interleaved)
    to, tl = reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=mask, interleaved_kv=interleaved,
    )
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=2e-5)


@pytest.mark.parametrize("mask", [FULL, CAUSAL], ids=["full", "causal"])
def test_reference_mha_matches_jax(mask):
    """``reference_mha``: the reference attention's output alone, its
    keyword arguments passed through, as the JAX one."""
    from metal_flash_attention_plus_tpu.attention import masking
    from metal_flash_attention_plus_tpu.reference import (
        reference_mha as jmha,
    )
    from metal_flash_attention_plus_tpu_torch.reference import reference_mha

    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 20, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 20, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 20, 16)).astype(np.float32)
    jmask = masking.CAUSAL if mask == CAUSAL else masking.FULL
    want = np.asarray(jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask=jmask, scale=0.2, interleaved_kv=True))
    got = reference_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), mask=mask, scale=0.2,
                        interleaved_kv=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_init_params_is_seeded_and_shaped():
    a = ttf.init_params(TCFG, torch.Generator().manual_seed(3), device="cpu")
    b = ttf.init_params(TCFG, torch.Generator().manual_seed(3), device="cpu")
    assert a["layers"][0]["wk"].shape == (64, 32)
    assert a["embed"].shape == (128, 64)
    torch.testing.assert_close(a["layers"][1]["wd"], b["layers"][1]["wd"],
                               rtol=0, atol=0)


def test_init_params_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_params(TCFG, torch.Generator().manual_seed(0))

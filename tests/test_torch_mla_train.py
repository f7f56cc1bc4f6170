"""Port parity for MLA training: the gradient of ``mla_loss_fn``.

The JAX package has no MLA train step, only a differentiable
``mla_loss_fn``; the port's gradient of it (autograd through the absorbed
einsums and the differentiable ``flash_attention`` at D = d_c + d_r) is
held to ``jax.grad`` of the JAX ``mla_loss_fn`` on the same converted
parameters and tokens, every parameter, and so is the gradient through
the dense decompress-then-attend oracle (``attn_fn=plain_mla_attention``).

One layer and a short sequence (``jax.grad`` through the interpret-mode
kernels takes ~17 s at two layers); latent 64 + rope 16, so the flash
path runs at D = 80, and DeepSeek-V2-Lite's attention widths (2 heads of
128, latent 512 + rope 64: the flash path at D = 576) at a narrow model.
fp32 throughout, the JAX side at HIGHEST.  Gate: each parameter's max abs
error within 1e-4 of its gradient's max abs (the port measured ~2e-6 at
the serving test's configuration).

On top, a few Adam steps of the MLA loop that ``chip_smoke.py`` phase 15
runs lower the loss, and two runs from one state are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's serving package must be imported before its models
# (see tests/test_torch_mla_serving.py).
import metal_flash_attention_plus_tpu.serving  # noqa: F401
from metal_flash_attention_plus_tpu.models import mla_transformer as jmt
from metal_flash_attention_plus_tpu.ops.flash_attention import (
    BlockSizes as JBlockSizes,
)
from metal_flash_attention_plus_tpu_torch.models import mla_transformer as tmt
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    trainable_parameters,
)
from metal_flash_attention_plus_tpu_torch.utils.profiling import (
    clone_params,
    train_twice,
)

DIMS = dict(vocab_size=96, d_model=64, num_layers=1, num_heads=2,
            head_dim=32, latent_dim=64, rope_dim=16, d_ff=128, max_seq=64)
# DeepSeek-V2-Lite's attention widths (16 heads of 128 cut to 2, the latent
# 512 + rope 64) at DIMS' model width and depth.
V2_LITE_DIMS = dict(DIMS, head_dim=128, latent_dim=512, rope_dim=64)


def _configs(dims):
    return (jmt.MLAConfig(**dims, dtype=jnp.float32, block_sizes=JBlockSizes(
        block_q=128, block_kv=128, block_q_dkv=128, block_kv_dkv=128,
        block_q_dq=128, block_kv_dq=128)),
        tmt.MLAConfig(**dims, dtype=torch.float32))


JCFG, TCFG = _configs(DIMS)
GRAD_REL_TOL = 1e-4


def _setup(jcfg=JCFG):
    jparams = jmt.init_mla_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 25))
    tokens[1, 6:10] = tokens[1, 5]  # repeated tokens: summed gradients
    return jparams, tparams, tokens


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _port_grads(tparams, tokens, attn_fn=None, tcfg=TCFG):
    params = clone_params(tparams)
    trainable_parameters(params)
    loss = tmt.mla_loss_fn(params, torch.from_numpy(tokens), tcfg,
                           attn_fn=attn_fn)
    loss.backward()
    return loss.item(), params_to_numpy(params, grad=True)


@pytest.mark.parametrize("dims", [DIMS, V2_LITE_DIMS],
                         ids=["d80", "v2_lite_d576"])
def test_mla_loss_gradient_matches_jax_grad(dims):
    jcfg, tcfg = _configs(dims)
    assert tcfg.latent_dim + tcfg.rope_dim in (80, 576)
    jparams, tparams, tokens = _setup(jcfg)
    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.value_and_grad(jmt.mla_loss_fn)(
            jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    want = _leaves(jgrads)
    for attn_fn in (None, tmt.plain_mla_attention):
        loss, tgrads = _port_grads(tparams, tokens, attn_fn, tcfg)
        assert abs(loss - float(jloss)) <= 1e-5
        got = _leaves(tgrads)
        assert len(got) == len(want) == 3 + 12  # every parameter
        worst = max(float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
                    for g, w in zip(got, want))
        assert worst <= GRAD_REL_TOL, (attn_fn, worst)


def test_adam_steps_lower_the_mla_loss_and_repeat_bit_for_bit():
    _, tparams, tokens = _setup()
    rows, final = train_twice(TCFG, tparams, torch.from_numpy(tokens), 3,
                              loss=tmt.mla_loss_fn)
    losses = [r["losses"][0] for r in rows]
    assert losses[-1] < losses[0]
    assert all(r["params_differ"] == [] and r["grads_differ"] == []
               and r["losses"][0] == r["losses"][1] for r in rows)
    assert set(final["layers"][0]) == set(tparams["layers"][0])

"""Port parity for the training slice as a whole.

The JAX ``init_params`` tree is converted with ``params_from_jax``; the
same seeded tokens then go through both packages in fp32 (the JAX side at
HIGHEST matmul precision, its flash kernels in interpret mode; the port's
wrappers take their plain versions on the CPU).

- ``loss_fn`` and every gradient vs ``jax.value_and_grad``: 1e-4 max abs
  error — per-op differences are at TOLERANCES["fp32"] and add up through
  two layers, the LM head and the backward.
- Two SGD steps of ``make_train_step`` vs ``optax.sgd``: 1e-5 max abs on
  the parameters (the updates are lr × those gradients).
- ``models/cached.py::prefill`` vs the JAX ``prefill``: 1e-4 on the
  logits, as the serving parity test; 1e-5 on the cached K/V (one layer of
  projections and RoPE).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

# The JAX package's serving package must be imported before its
# models.cached (see tests/test_torch_serving.py).
import metal_flash_attention_plus_tpu.serving  # noqa: F401
from metal_flash_attention_plus_tpu.models import cached as jcached
from metal_flash_attention_plus_tpu.models import transformer as jtf
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu_torch.entry import ENTRY_CONFIG, entry
from metal_flash_attention_plus_tpu_torch.models import cached as tcached
from metal_flash_attention_plus_tpu_torch.models import transformer as ttf
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    flash_dkv,
    flash_dq,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    flash_fwd,
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
GRAD_TOL = 1e-4
SGD_TOL = 1e-5


def _setup(seed=0, batch=2, seq=41):
    jparams = jtf.init_params(JCFG, jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tokens = np.random.default_rng(seed).integers(0, 128, (batch, seq))
    return jparams, tparams, tokens


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _max_err(a_tree, b_tree):
    return max(float(np.max(np.abs(a - b)))
               for a, b in zip(_leaves(a_tree), _leaves(b_tree)))


def test_loss_and_every_gradient_match_jax():
    jparams, tparams, tokens = _setup()
    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.value_and_grad(jtf.loss_fn)(
            jparams, jnp.asarray(tokens, jnp.int32), JCFG)
    ttf.trainable_parameters(tparams)
    loss = ttf.loss_fn(tparams, torch.from_numpy(tokens), TCFG)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GRAD_TOL
    tgrads = params_to_numpy(tparams, grad=True)
    assert jax.tree.structure(tgrads) == jax.tree.structure(
        jax.tree.map(np.asarray, jgrads))
    assert _max_err(tgrads, jgrads) <= GRAD_TOL


def test_loss_over_repeated_tokens_matches_jax():
    """``loss_fn`` (``F.embedding``, ``F.cross_entropy``) against the JAX
    ``loss_fn`` (indexing, ``logsumexp`` − the gathered target) where five
    token ids fill the batch, so each of their embedding rows sums many
    gradients and each target logit many rows: loss and every gradient at
    GRAD_TOL."""
    jparams, tparams, _ = _setup(seed=7)
    tokens = np.random.default_rng(7).choice([3, 17, 64, 90, 127], (2, 33))
    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.value_and_grad(jtf.loss_fn)(
            jparams, jnp.asarray(tokens, jnp.int32), JCFG)
    ttf.trainable_parameters(tparams)
    loss = ttf.loss_fn(tparams, torch.from_numpy(tokens), TCFG)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GRAD_TOL
    tgrads = params_to_numpy(tparams, grad=True)
    assert _max_err(tgrads, jgrads) <= GRAD_TOL
    assert np.count_nonzero(np.abs(tgrads["embed"]).sum(-1)) == 5


def test_train_steps_from_one_state_are_bitwise_equal():
    """Two runs of ``make_train_step`` (bf16, Adam) from one initial state
    give the same parameters and gradients, bit for bit, after each step
    (``utils/profiling.py::train_twice``, which the card runs on the
    flagship)."""
    from metal_flash_attention_plus_tpu_torch.utils.profiling import (
        train_twice,
    )

    cfg = ttf.TransformerConfig(**DIMS, dtype=torch.bfloat16)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(8),
                             device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(8).integers(0, 128, (2, 41)))
    before = [t.clone() for t in ttf.trainable_parameters(params)]
    rows, final = train_twice(cfg, params, tokens, 2)
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert r["losses"][0] == r["losses"][1]
        assert r["params_differ"] == [] and r["grads_differ"] == []
    after = ttf.trainable_parameters(params)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(final["embed"], params["embed"])


def test_two_sgd_steps_match_optax():
    jparams, tparams, tokens = _setup(seed=1)
    opt = optax.sgd(0.5)
    jstep = jtf.make_train_step(JCFG, opt)
    jstate = opt.init(jparams)
    optimizer = torch.optim.SGD(ttf.trainable_parameters(tparams), lr=0.5)
    tstep = ttf.make_train_step(TCFG, optimizer)
    tstate = optimizer.state
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            jparams, jstate, jloss = jstep(jparams, jstate,
                                           jnp.asarray(tokens, jnp.int32))
            tparams, tstate, tloss = tstep(tparams, tstate,
                                           torch.from_numpy(tokens))
            assert abs(tloss.item() - float(jloss)) <= GRAD_TOL
    assert _max_err(params_to_numpy(tparams), jparams) <= SGD_TOL


def test_adam_lowers_the_loss():
    _, tparams, tokens = _setup(seed=2, batch=4, seq=65)
    tokens = torch.from_numpy(tokens)
    optimizer = torch.optim.Adam(ttf.trainable_parameters(tparams), lr=3e-3)
    step = ttf.make_train_step(TCFG, optimizer)
    state = optimizer.state
    with torch.no_grad():
        first = ttf.loss_fn(tparams, tokens, TCFG).item()
    for _ in range(10):
        tparams, state, loss = step(tparams, state, tokens)
    last = loss.item()
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first - 0.1, (first, last)


def test_train_step_rejects_a_foreign_state():
    _, tparams, tokens = _setup(seed=3)
    optimizer = torch.optim.SGD(ttf.trainable_parameters(tparams), lr=0.1)
    step = ttf.make_train_step(TCFG, optimizer)
    with pytest.raises(ValueError):
        step(tparams, {}, torch.from_numpy(tokens))


def test_remat_gives_the_same_gradients():
    _, tparams, tokens = _setup(seed=4)
    grads = []
    for cfg in (TCFG, dataclasses.replace(TCFG, remat=True)):
        params = {k: v for k, v in tparams.items()}
        for t in ttf.trainable_parameters(params):
            t.grad = None
        ttf.loss_fn(params, torch.from_numpy(tokens), cfg).backward()
        grads.append(params_to_numpy(params, grad=True))
    assert _max_err(grads[0], grads[1]) == 0.0


def test_plain_attention_oracle_launches_nothing_and_agrees():
    _, tparams, tokens = _setup(seed=5)
    counts = (flash_fwd.launches, flash_dq.launches, flash_dkv.launches)
    tokens = torch.from_numpy(tokens)
    flash = ttf.forward(tparams, tokens, TCFG)
    oracle = ttf.forward(tparams, tokens, TCFG, attn_fn=ttf.plain_attention)
    assert (flash_fwd.launches, flash_dq.launches,
            flash_dkv.launches) == counts  # CPU: no kernel
    assert float((flash - oracle).abs().max()) <= GRAD_TOL


def test_prefill_matches_jax():
    jparams, tparams, _ = _setup(seed=6)
    prompt = np.random.default_rng(6).integers(0, 128, 29)
    np_, pt, mp = 12, 8, 5
    row = np.full(mp, np_, np.int32)
    row[:4] = [3, 9, 0, 6]
    jcache = jcached.init_cache(JCFG, np_, pt, jnp.float32)
    tcache = tcached.init_cache(TCFG, np_, pt, torch.float32, device="cpu")
    with jax.default_matmul_precision("highest"):
        jl, jcache = jcached.prefill(jparams, jnp.asarray(prompt, jnp.int32),
                                     jcache, jnp.asarray(row), JCFG)
    tl, tcache = tcached.prefill(tparams, torch.from_numpy(prompt), tcache,
                                 torch.from_numpy(row), TCFG)
    assert tl.shape == (128,) and tl.dtype == torch.float32
    assert float(np.max(np.abs(np.asarray(jl) - tl.numpy()))) <= GRAD_TOL
    live = np.asarray(jcache.kv_pages)[:, :, :np_]
    np.testing.assert_allclose(tcache.kv_pages[:, :, :np_].numpy(), live,
                               rtol=0, atol=SGD_TOL)


def test_entry_twin_runs_on_the_cpu():
    fn, (params, tokens) = entry(device="cpu")
    assert tokens.shape == (2, 512) and params["embed"].dtype == torch.bfloat16
    with torch.inference_mode():
        logits = fn(params, tokens)
    assert logits.shape == (2, 512, ENTRY_CONFIG.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()

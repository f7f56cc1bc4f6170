"""Port parity for QAT: ``fake_quantize`` (the clipped straight-through
estimator), the gradients of ``quantized_flash_attention_qat`` against the
JAX package, and the tiny QAT regressor of ``tests/test_qat.py`` on the
port's plain path.

Inputs come from a numpy seed.  ``fake_quantize`` is held bit for bit:
its inputs lie on a 2⁻⁶ grid and its cells hold power-of-two counts, so
the sums behind a CENTERED mean are exact in any order
(``tests/test_torch_quant.py``), the golden quantize/dequantize are
byte-identical, and its gradient is 0 or 1 per element.  The attention
gradients are held as in ``tests/test_torch_quantized_backward.py``: max
abs error over the JAX value's max abs ≤ TOLERANCES["fp32"] (fp32
throughout, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jmask
from metal_flash_attention_plus_tpu.ops import quantized_attention as jqa
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant.ste import fake_quantize as jfq
from metal_flash_attention_plus_tpu_torch.attention import masking as tmask
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops import quantized_attention as tqa
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import fake_quantize
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    _broadcast_cells,
    quantize,
)

CONFIGS = {
    # name: (bits, granularity, strategy, block_size)
    "row8_centered": (8, "row", "centered", 64),
    "tensor8": (8, "tensor", "symmetric", 64),
    "channel8": (8, "channel", "symmetric", 64),
    "row4_asymmetric": (4, "row", "asymmetric", 64),
    "block8_centered": (8, "block", "centered", 16),
}


def _cfgs(name):
    bits, gran, strategy, bs = CONFIGS[name]
    return (jparams.QuantConfig(
                bits=bits, granularity=jparams.QuantGranularity(gran),
                strategy=jparams.QuantStrategy(strategy), block_size=bs),
            tparams.QuantConfig(
                bits=bits, granularity=tparams.QuantGranularity(gran),
                strategy=tparams.QuantStrategy(strategy), block_size=bs))


@pytest.mark.parametrize("shape", [(8, 64), (2, 16, 32), (1, 2, 16, 32)],
                         ids=["rank2", "rank3", "rank4"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fake_quantize_matches_jax(name, shape):
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(len(name) + len(shape))
    x = (rng.integers(-256, 256, shape) / 64).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jy, jvjp = jax.vjp(lambda x_: jfq(x_, jcfg), jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = fake_quantize(tx, tcfg)
    (tg,) = torch.autograd.grad(ty, [tx], grad_outputs=torch.from_numpy(g))
    assert ty.shape == tx.shape and tg.shape == tx.shape
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fake_quantize_rank1_is_the_clipped_ste(name):
    """Rank 1, where the JAX version fails (ROADMAP §3): the values are the
    round trip of x as one [1, N] row and the gradient is the analytic
    clipped STE, 1 where |y − x| ≤ scale/2 (+1e-8), else 0, in x's shape."""
    _, cfg = _cfgs(name)
    x = torch.tensor([0.01, 0.5, 1.0, -0.75, 0.3, -1.2, 2.0, 0.0] * 8)
    tx = x.clone().requires_grad_(True)
    y = fake_quantize(tx, cfg)
    (g,) = torch.autograd.grad(y.sum(), [tx])
    qt = quantize(x, cfg)
    want_y = qt.dequantize().reshape(x.shape)
    scale = _broadcast_cells(qt.scale, qt.config, qt.shape).expand(
        qt.shape).reshape(x.shape)
    want_g = ((want_y - x).abs() <= 0.5 * scale + 1e-8).float()
    assert y.shape == x.shape and g.shape == x.shape
    assert torch.equal(y.detach(), want_y)
    assert torch.equal(g, want_g)


def test_ste_clips_out_of_range_gradients():
    """The JAX package's ``test_qat.py`` case, at rank 1: symmetric absmax
    covers the max, so every gradient passes."""
    x = torch.tensor([0.01, 0.5, 1.0], requires_grad=True)
    (g,) = torch.autograd.grad(fake_quantize(x, tparams.QuantConfig(
        bits=8)).sum(), [x])
    torch.testing.assert_close(g, torch.ones(3), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,mask", [("row8_centered", "causal"),
                                       ("row4_centered", "full")])
def test_qat_gradients_match_jax(name, mask):
    """dq, dk, dv of sum(O·dO) through ``quantized_flash_attention_qat``
    (STE to the float K/V masters) against ``jax.grad``."""
    bits = 4 if name.startswith("row4") else 8
    jcfg = jparams.QuantConfig(bits=bits,
                               granularity=jparams.QuantGranularity.ROW,
                               strategy=jparams.QuantStrategy.CENTERED)
    tcfg = tparams.QuantConfig(bits=bits,
                               granularity=tparams.QuantGranularity.ROW,
                               strategy=tparams.QuantStrategy.CENTERED)
    jm, tm = ((jmask.CAUSAL, tmask.CAUSAL) if mask == "causal"
              else (jmask.FULL, tmask.FULL))
    rng = np.random.default_rng(bits)
    q, do = (rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
            for _ in range(2))

    def jloss(q_, k_, v_):
        return jnp.sum(jqa.quantized_flash_attention_qat(q_, k_, v_, jcfg, jm)
                       * do)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(t) for t in (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = tqa.quantized_flash_attention_qat(*leaves, tcfg, tm)
    got = torch.autograd.grad((o * torch.from_numpy(do)).sum(), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= TOLERANCES["fp32"]


def test_qat_through_quantized_attention_path():
    """``tests/test_qat.py``'s regressor on the port's plain path: a tiny
    attention layer trained with int8 fake-quantized K/V (ROW CENTERED) for
    120 Adam steps lowers its loss below a third, and the trained weights
    deployed through really-quantized attention give the training forward's
    output (same rounding) to 2e-5."""
    d, s, h = 32, 128, 2
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, s, d)).astype(np.float32))
    target = torch.from_numpy(
        rng.standard_normal((1, h, s, d)).astype(np.float32) * 0.3)
    params = {n: torch.from_numpy(
        rng.standard_normal((d, h * d)).astype(np.float32) * d ** -0.5
    ).requires_grad_(True) for n in ("wq", "wkv")}
    cfg = tparams.QuantConfig(bits=8,
                              granularity=tparams.QuantGranularity.ROW,
                              strategy=tparams.QuantStrategy.CENTERED)

    def heads(w):
        return (x @ w).reshape(1, s, h, d).transpose(1, 2)

    def attn_out():
        kv = fake_quantize(heads(params["wkv"]), cfg)
        return flash_attention(heads(params["wq"]), kv, kv,
                               mask=tmask.CAUSAL)

    def loss():
        return ((attn_out() - target) ** 2).mean()

    opt = torch.optim.Adam(params.values(), lr=1e-2)
    with torch.no_grad():
        first = float(loss())
    for _ in range(120):
        opt.zero_grad()
        loss().backward()
        opt.step()
    with torch.no_grad():
        last = float(loss())
        assert last < first / 3, (first, last)
        kv_q = quantize(heads(params["wkv"]), cfg)
        o_deploy = tqa.quantized_flash_attention(heads(params["wq"]), kv_q,
                                                 kv_q, mask=tmask.CAUSAL)
        torch.testing.assert_close(o_deploy, attn_out(), rtol=0, atol=2e-5)

"""Port parity for the quantized-attention slice end to end:
``quantized_forward(..., quantize_kv=True)`` in the packed d=64 layout and
unpacked, and the ``QuantizedAttention`` facade, against the JAX package.

A 1-layer, d=64 model (GQA 4/2) in fp32 at S=128.  The JAX side runs its
Pallas kernels in interpret mode at HIGHEST matmul precision.  Tolerances:

- logits rel L2 ≤ 1e-3.  The two forwards agree to ~1e-7 unless a value
  that is quantized at run time (an activation, Q, K, V, or a P rounded to
  bf16 by the head-pair kernel) lies within the fp32 noise of a rounding
  boundary (RMSNorm, RoPE and sums in another order) and rounds to the
  neighbouring integer on one side.  Each such flip moves the logits by
  1e-4 to 1e-2 here (measured over seeds 6–19; JAX's own eager and jitted
  runs of this forward differ the same way).  Each path is checked at inputs (weights and tokens from
  its seed) where no value lies that close, so the gate holds it to its
  1e-7 agreement with room to spare;
- the facade's O and L at TOLERANCES["fp32"] max abs (runtime quantization
  agrees to the bit on these inputs: the K/V lie on a 2⁻⁶ grid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jmask
from metal_flash_attention_plus_tpu.attention import quantized as jfacade
from metal_flash_attention_plus_tpu.models import quantized_inference as jqi
from metal_flash_attention_plus_tpu.models import transformer as jtf
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu_torch.attention import masking as tmask
from metal_flash_attention_plus_tpu_torch.attention import quantized as tfacade
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.models import (
    quantized_inference as tqi,
)
from metal_flash_attention_plus_tpu_torch.models import transformer as ttf
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    pack_heads,
)
from metal_flash_attention_plus_tpu_torch.quant import params as tparams

DIMS = dict(vocab_size=128, d_model=256, num_layers=1, num_heads=4,
            num_kv_heads=2, head_dim=64, d_ff=512, max_seq=256)
JCFG = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, block_sizes=BlockSizes(
    block_q=128, block_kv=128, block_q_dkv=128, block_kv_dkv=128,
    block_q_dq=128, block_kv_dq=128))
TCFG = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
LOGIT_REL_L2 = 1e-3


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want)
                 / np.linalg.norm(want))


# path: (packed_d64, seed of the weights and tokens)
PATHS = {"packed_auto": (None, 8), "unpacked": (False, 10)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_quantized_forward_with_quantized_kv_matches_jax(path):
    """packed_d64=None: the default, the packed head-pair layout here
    (head_dim 64, even heads, S % 128 == 0); False: int8-Q scores over ROW
    K/V."""
    packed, seed = PATHS[path]
    jq = jqi.quantize_weights(jtf.init_params(JCFG, jax.random.PRNGKey(seed)))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    tokens = np.random.default_rng(seed).integers(0, 128, (1, 128))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, t: jqi.quantized_forward(
            p, t, JCFG, quantize_kv=True, packed_d64=packed))(
                jq, jnp.asarray(tokens))
    got = tqi.quantized_forward(tq, torch.from_numpy(tokens), TCFG,
                                quantize_kv=True, packed_d64=packed)
    assert got.shape == (1, 128, 128) and got.dtype == torch.float32
    assert _rel_l2(got, want) <= LOGIT_REL_L2


def test_packed_heads_round_trip_and_rope():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, 4 * 64)).astype(np.float32))
    packed = ttf._split_heads_packed(x, 4)
    assert packed.shape == (2, 2, 5, 128)
    assert torch.equal(ttf._merge_heads_packed(packed), x)
    natural = ttf._split_heads(x, 4, 64)
    pos = torch.arange(5) + 3
    roped = ttf.rope(natural, pos, 10000.0)
    torch.testing.assert_close(ttf.rope_packed(packed, pos, 10000.0),
                               pack_heads(roped), rtol=0, atol=1e-6)
    want = jtf.rope_packed(jnp.asarray(packed.numpy()), jnp.asarray(
        pos.numpy()), 10000.0)
    np.testing.assert_allclose(ttf.rope_packed(packed, pos, 10000.0).numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)


FACADE = {
    # name: (config kwargs, mask)
    "int8_centered_causal": (dict(), "causal"),
    "int4_hadamard": (dict(key_bits=4, value_bits=4, hadamard=True),
                      "causal"),
    "per_tensor_k4_v8": (dict(key_bits=4, per_tensor=True), "full"),
}


def _facades(name):
    kw, mask = FACADE[name]
    masks = {"causal": (jmask.CAUSAL, tmask.CAUSAL),
             "full": (jmask.FULL, tmask.FULL)}[mask]
    return (jfacade.QuantizedAttention(
                config=jfacade.QuantizedAttentionConfig(**kw), mask=masks[0]),
            tfacade.QuantizedAttention(
                config=tfacade.QuantizedAttentionConfig(**kw), mask=masks[1]))


@pytest.mark.parametrize("name", sorted(FACADE))
def test_facade_matches_jax(name):
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    k, v = ((rng.integers(-256, 256, (1, 2, 128, 64)) / 64).astype(
        np.float32) for _ in range(2))
    jqa, tqa = _facades(name)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    with jax.default_matmul_precision("highest"):
        jo = jqa(*jargs)
        jo2, jl = jqa.forward_with_lse(*jargs)
    to = tqa(*targs)
    kq, vq = tqa.quantize_kv(*targs[1:])
    assert torch.equal(tqa.forward_quantized(targs[0], kq, vq), to)
    to2, tl = tqa.forward_with_lse(*targs)
    for got, want in ((to, jo), (to2, jo2), (tl, jl)):
        got = got.numpy()
        assert got.shape == np.asarray(want).shape
        assert float(np.max(np.abs(got - np.asarray(want)))) <= TOLERANCES[
            "fp32"]
    dense = torch.softmax(
        (targs[0] @ targs[1].repeat_interleave(2, 1).transpose(-1, -2))
        / 8.0 + (torch.triu(torch.full((128, 128), -1e30), 1)
                 if FACADE[name][1] == "causal" else 0), -1
    ) @ targs[2].repeat_interleave(2, 1)
    assert ((to - dense).norm() / dense.norm()).item() < TOLERANCES[
        "int4_rel"]


def test_config_json_round_trip_and_jax_interchange():
    cfg = tfacade.QuantizedAttentionConfig(key_bits=4, value_bits=8,
                                           per_tensor=True, hadamard=True)
    assert tfacade.QuantizedAttentionConfig.from_json(cfg.to_json()) == cfg
    jcfg = jfacade.QuantizedAttentionConfig(key_bits=4, value_bits=8,
                                            per_tensor=True, hadamard=True)
    assert cfg.to_json() == jcfg.to_json()
    assert tfacade.QuantizedAttentionConfig.from_json(jcfg.to_json()) == cfg
    assert cfg.kv_config(4) == tparams.QuantConfig(bits=4)
    assert cfg.hadamard_block(96) == jcfg.hadamard_block(96) == 32
    assert tfacade.QuantizedAttentionConfig().kv_config(8) == \
        tparams.QuantConfig(bits=8, granularity=tparams.QuantGranularity.ROW,
                            strategy=tparams.QuantStrategy.CENTERED)

"""Port parity for the long-context composition: compressed (MLA latent),
sparse (sliding window) and quantized (int8 ROW latent) attention in one
``mla_absorbed_attention`` call.

The mirror of tests/test_long_context.py::test_mla_sparse_quantized_
composition at its shapes (B=1, H=4, S=256, dh=64, d_c=128, a causal
window of 128), against the JAX ``mla_absorbed_attention`` on the same
numpy inputs (the JAX side at HIGHEST, its Pallas kernels in interpret
mode; the latent quantized by each package, byte for byte the same), and
against the dense golden on the dequantized decompressed K/V as the JAX
test holds it.  The real 32K shape runs on the card: ``chip_smoke.py``
phase 17 (a).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metal_flash_attention_plus_tpu.attention.masking import (
    sliding_window as jwindow,
)
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu.ops.mla import (
    mla_absorbed_attention as jmla,
)
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant.tensor import quantize as jquantize
from metal_flash_attention_plus_tpu_torch.attention.masking import (
    sliding_window,
)
from metal_flash_attention_plus_tpu_torch.ops.mla import (
    mla_absorbed_attention,
)
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant.tensor import quantize
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
)

BS128 = BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                   block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)
# The port's quantized forward and the JAX kernel round at the same places
# in fp32 (tests/test_torch_quantized_attention.py holds them at 2e-5);
# the absorbing and projecting einsums add fp32 roundoff of their own.
TOL = 2e-5


def _row8(mod):
    return mod.QuantConfig(bits=8, granularity=mod.QuantGranularity.ROW,
                           strategy=mod.QuantStrategy.CENTERED)


def test_mla_sparse_quantized_composition_matches_jax():
    b, h, s, dh, dc = 1, 4, 256, 64, 128
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    latent = rng.standard_normal((b, s, dc)).astype(np.float32)
    w_uk = (rng.standard_normal((h, dh, dc)) * dc ** -0.5).astype(np.float32)
    w_uv = (rng.standard_normal((h, dc, dh)) * dc ** -0.5).astype(np.float32)

    jc = jquantize(jnp.asarray(latent)[:, None], _row8(jparams))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmla(jnp.asarray(q), jc, jnp.asarray(w_uk),
                               jnp.asarray(w_uv),
                               mask=jwindow(128, causal=True),
                               block_sizes=BS128))
    tc = quantize(torch.from_numpy(latent)[:, None], _row8(tparams))
    np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
    mask = sliding_window(128, causal=True)
    got = mla_absorbed_attention(torch.from_numpy(q), tc,
                                 torch.from_numpy(w_uk),
                                 torch.from_numpy(w_uv), mask=mask)
    assert got.shape == (b, h, s, dh)
    assert float(np.max(np.abs(got.numpy() - want))) <= TOL

    # The JAX test's golden: dense attention on the dequantized,
    # decompressed K/V.
    c = tc.dequantize()[:, 0]
    k = torch.einsum("bsc,hdc->bhsd", c, torch.from_numpy(w_uk))
    v = torch.einsum("bsc,hcd->bhsd", c, torch.from_numpy(w_uv))
    ref, _ = reference_attention(torch.from_numpy(q), k, v, mask=mask,
                                 scale=dh ** -0.5)
    assert float((got - ref).abs().max()) <= 5e-4

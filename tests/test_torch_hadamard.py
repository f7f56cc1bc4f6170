"""Port parity for the Hadamard rotation (``ops/hadamard.py``): the three
fast tests of the JAX package's ``tests/test_hadamard.py`` (matrix,
involution, blocked transform) on the port, and the port against the JAX
package on the same inputs, to the bit (the same fp32 butterfly and
scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import hadamard

from metal_flash_attention_plus_tpu.ops import hadamard as jhad
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu_torch.models.convert import (
    _quantized_from_jax,
)
from metal_flash_attention_plus_tpu_torch.ops import hadamard as thad
from metal_flash_attention_plus_tpu_torch.quant import params as tparams


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_matches_hadamard_matrix():
    n = 64
    x = _normal(0, (8, n))
    got = thad.hadamard_transform(x, n)
    h = torch.from_numpy(hadamard(n).astype(np.float32)) / np.sqrt(n)
    torch.testing.assert_close(got, x @ h, atol=1e-5, rtol=0)


def test_involution():
    x = _normal(1, (4, 256))
    rt = thad.hadamard_transform(thad.hadamard_transform(x))
    torch.testing.assert_close(rt, x, atol=1e-5, rtol=0)


def test_blocked_transform():
    x = _normal(2, (2, 512))
    got = thad.hadamard_transform(x, block_size=128)
    h = torch.from_numpy(hadamard(128).astype(np.float32)) / np.sqrt(128)
    ref = (x.reshape(2, 4, 128) @ h).reshape(2, 512)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [None, 16, 64])
def test_matches_jax_bit_for_bit(block, dtype):
    x = _normal(3, (3, 5, 64))
    jx = jnp.asarray(x.numpy()).astype(dtype)
    want = np.asarray(jhad.hadamard_transform(jx, block).astype(jnp.float32))
    got = thad.hadamard_transform(x.to(getattr(torch, dtype)), block)
    assert str(got.dtype) == f"torch.{dtype}"
    assert got.float().numpy().tobytes() == want.tobytes()


def test_rotate_quantize_round_trip_matches_jax():
    x = _normal(4, (16, 128))
    x[:, 7] *= 50.0  # an outlier channel
    jcfg = jparams.QuantConfig(bits=8)
    tcfg = tparams.QuantConfig(bits=8)
    jt, jbs = jhad.rotate_quantize(jnp.asarray(x.numpy()), jcfg)
    tt, tbs = thad.rotate_quantize(x, tcfg)
    assert tbs == jbs == 128
    conv = _quantized_from_jax(jt, torch.device("cpu"))
    assert torch.equal(tt.data, conv.data)
    assert torch.equal(tt.scale, conv.scale)
    back = thad.dequantize_unrotate(tt, tbs)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jhad.dequantize_unrotate(jt, jbs)))
    plain = (x - thad.dequantize_unrotate(
        thad.rotate_quantize(x, tcfg, 1)[0], 1)).abs().mean()
    assert (back - x).abs().mean() < plain  # the rotation smooths outliers

"""Port parity for ``quant``: ``QuantConfig``, ``quantize``/``dequantize``
and the group-planar int4 packing, against the JAX package.

Payloads, scales, zero points and Σq sums must be IDENTICAL (bytes and
bits) for every granularity × strategy × {8, 4} bits.  The inputs lie on a
2⁻⁶ grid and every reduction covers a power-of-two count, so the sums
behind a CENTERED mean are exact in any order and both packages divide
the same fp32 numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

GRANULARITIES = ["tensor", "row", "channel", "block", "block_2d"]
STRATEGIES = ["symmetric", "centered", "asymmetric"]


def _grid(rng, shape, span=256):
    return (rng.integers(-span, span, shape) / 64).astype(np.float32)


def _configs(gran, strategy, bits):
    kw = dict(bits=bits, compute_sums=True)
    if gran.startswith("block"):
        kw["block_size"] = 32
    if gran == "block_2d":
        kw["block_rows"] = 8
    j = jparams.QuantConfig(granularity=jparams.QuantGranularity(gran),
                            strategy=jparams.QuantStrategy(strategy), **kw)
    t = tparams.QuantConfig(granularity=tparams.QuantGranularity(gran),
                            strategy=tparams.QuantStrategy(strategy), **kw)
    return j, t


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("gran", GRANULARITIES)
def test_quantize_is_byte_identical(gran, strategy, bits):
    x = _grid(np.random.default_rng(len(gran) + bits), (2, 16, 64))
    jcfg, tcfg = _configs(gran, strategy, bits)
    j = jtensor.quantize(jnp.asarray(x), jcfg)
    t = ttensor.quantize(torch.from_numpy(x), tcfg)
    assert t.data.dtype == tcfg.storage_dtype
    for field in ("data", "scale", "zero_point", "sums"):
        _same_bits(getattr(j, field), getattr(t, field).numpy())
    assert t.shape == tuple(j.shape) and t.orig_dtype == torch.float32
    np.testing.assert_array_equal(ttensor.dequantize(t).numpy(),
                                  np.asarray(jtensor.dequantize(j)))


@pytest.mark.parametrize("k", [64, 256, 300, 512])
def test_int4_packing_is_group_planar_like_jax(k):
    q = np.random.default_rng(k).integers(-8, 8, (3, k)).astype(np.int32)
    packed = ttensor.pack_int4(torch.from_numpy(q))
    _same_bits(jtensor.pack_int4(jnp.asarray(q)), packed.numpy())
    np.testing.assert_array_equal(ttensor.unpack_int4(packed).numpy(), q)
    # Element 0 of each 256-column group is a low nibble, element 128 the
    # high nibble of the same byte.
    if k >= 256:
        byte = int(packed[0, 0])
        assert (byte & 0xF) - 8 == q[0, 0] and (byte >> 4) - 8 == q[0, 128]


def test_rank1_input_and_device_copy():
    x = _grid(np.random.default_rng(3), (64,))
    cfg = tparams.INT8_TENSOR
    t = ttensor.quantize(torch.from_numpy(x), cfg)
    j = jtensor.quantize(jnp.asarray(x), jparams.INT8_TENSOR)
    assert t.shape == (1, 64) == tuple(j.shape)
    _same_bits(j.data, t.data.numpy())
    moved = t.to("cpu")
    assert moved.config == cfg and moved.data.device.type == "cpu"
    assert moved.nbytes_payload == 64 and moved.bits == 8


def test_config_rules_and_block_size_choice():
    for jc, tc in ((jparams.INT8_ROW, tparams.INT8_ROW),
                   (jparams.int8_blockwise(), tparams.int8_blockwise())):
        assert (tc.qmax, tc.qmin, tc.block_size) == (jc.qmax, jc.qmin,
                                                     jc.block_size)
    assert tparams.INT4_TENSOR.qmax == 7 and tparams.INT4_TENSOR.qmin == -8
    for k in (64, 96, 100, 384, 1000):
        assert tparams.optimal_block_size(k) == jparams.optimal_block_size(k)
    with pytest.raises(ValueError):
        tparams.QuantConfig(bits=6)
    with pytest.raises(ValueError):
        tparams.QuantConfig(granularity=tparams.QuantGranularity.BLOCK,
                            block_size=12)
    with pytest.raises(ValueError):
        tparams.QuantConfig(granularity=tparams.QuantGranularity.BLOCK_2D,
                            block_size=16)

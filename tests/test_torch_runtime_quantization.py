"""Port parity for runtime quantization (``ops/runtime_quantization.py``)
against the JAX package's ``runtime_quantize``, bit for bit.

The inputs lie on a 2⁻⁶ grid with |x| < 5, so each partial sum behind a
CENTERED mean is exact in any order, and both sides apply the constant
divisors (the count, qmax, qmax − qmin) as multiplies by fp32 reciprocals,
as XLA compiles the JAX kernels (so a scale may differ in the last bit from
``quant.tensor.quantize``'s true division, in both packages): codes,
scales, zero points and Σq agree to the bit.  On other data the mean
depends on the order of its sum; the port fixes the order of its kernels
(``_warp_sum``, ``_block_sum``), and the last test holds the plain
versions to that order, written out element by element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.ops import runtime_quantization as jrq
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu_torch.ops import runtime_quantization as trq
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

STRATEGIES = ["symmetric", "centered", "asymmetric"]


def _grid(rng, shape):
    return (rng.integers(-256, 256, shape) / 64 + 0.75).astype(np.float32)


def _configs(gran, strategy, bits, sums, block_size=None):
    kw = dict(bits=bits, compute_sums=sums, block_size=block_size)
    return (jparams.QuantConfig(granularity=jparams.QuantGranularity(gran),
                                strategy=jparams.QuantStrategy(strategy),
                                **kw),
            tparams.QuantConfig(granularity=tparams.QuantGranularity(gran),
                                strategy=tparams.QuantStrategy(strategy),
                                **kw))


def _same_bits(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype.itemsize == \
        want.dtype.itemsize
    assert got.tobytes() == want.tobytes()


def _assert_identical(t, j):
    assert t.config.granularity.value == j.config.granularity.value
    assert t.shape == tuple(j.shape)
    for field in ("data", "scale", "zero_point"):
        _same_bits(getattr(t, field), getattr(j, field))
    assert (t.sums is None) == (j.sums is None)
    if t.sums is not None:
        _same_bits(t.sums, j.sums)


@pytest.mark.parametrize("sums", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", ["row", "block"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_runtime_quantize_matches_jax_bit_for_bit(strategy, gran, bits,
                                                  sums):
    rng = np.random.default_rng(len(strategy) + bits + 2 * sums)
    x = _grid(rng, (128, 256))
    jcfg, tcfg = _configs(gran, strategy, bits, sums,
                          64 if gran == "block" else None)
    j = jrq.runtime_quantize(jnp.asarray(x), jcfg)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    _assert_identical(t, j)


@pytest.mark.parametrize("gran", ["row", "block"])
def test_counts_that_are_not_powers_of_two(gran):
    """The mean multiplies by the fp32 reciprocal of a count of 96 (a row)
    or 24 x 32 (a block), as XLA compiles the JAX kernels."""
    x = _grid(np.random.default_rng(6), (24, 96))
    jcfg, tcfg = _configs(gran, "centered", 8, True,
                          32 if gran == "block" else None)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    _assert_identical(t, jrq.runtime_quantize(jnp.asarray(x), jcfg))


@pytest.mark.parametrize("case", ["tensor_2d", "row_3d"])
def test_tensor_granularity_and_3d_go_to_quantize(case):
    rng = np.random.default_rng(3)
    shape, gran = ((64, 64), "tensor") if case == "tensor_2d" else (
        (2, 32, 64), "row")
    x = _grid(rng, shape)
    jcfg, tcfg = _configs(gran, "centered", 8, True)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    _assert_identical(t, jrq.runtime_quantize(jnp.asarray(x), jcfg))
    _assert_identical(t, ttensor.quantize(torch.from_numpy(x), tcfg))


def test_bf16_input_quantizes_its_fp32_values():
    x = torch.from_numpy(_grid(np.random.default_rng(4), (64, 128))).to(
        torch.bfloat16)
    for strategy in tparams.QuantStrategy:
        got = trq.rtq_rows(x, strategy, 8, True)
        want = trq.rtq_rows(x.float(), strategy, 8, True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _lane_order_sum(row):
    """The row kernel's order: lane l sums x[l], x[l+32], ... from 0, then
    the xor butterfly over offsets 16, 8, 4, 2, 1."""
    lanes = [np.float32(0.0)] * 32
    for c, x in enumerate(row):
        lanes[c % 32] = np.float32(lanes[c % 32] + x)
    for off in (16, 8, 4, 2, 1):
        lanes = [np.float32(lanes[i] + lanes[i ^ off]) for i in range(32)]
    return lanes[0]


def _thread_order_sum(cell, threads=1024):
    """The block kernel's order: thread t sums elements t, t+1024, ... from
    0, then a[t] += a[t + s] for s = 512 down to 1."""
    acc = [np.float32(0.0)] * threads
    for e, x in enumerate(cell):
        acc[e % threads] = np.float32(acc[e % threads] + x)
    s = threads // 2
    while s:
        acc = [np.float32(acc[t] + acc[t + s]) for t in range(s)]
        s //= 2
    return acc[0]


def test_plain_versions_sum_in_the_kernels_order():
    rng = np.random.default_rng(5)
    rows = (rng.standard_normal((3, 100)) * 3 + 0.7).astype(np.float32)
    got = trq._warp_sum(torch.from_numpy(rows)).numpy()
    want = np.array([_lane_order_sum(r) for r in rows], np.float32)
    assert got.tobytes() == want.tobytes()
    cells = (rng.standard_normal((2, 3000)) * 3 + 0.7).astype(np.float32)
    got = trq._block_sum(torch.from_numpy(cells)).numpy()
    want = np.array([_thread_order_sum(c) for c in cells], np.float32)
    assert got.tobytes() == want.tobytes()
    # The mean a block's codes see is that sum over the count.
    x = torch.from_numpy(cells[0].reshape(30, 100))
    q, scale, zp, _ = trq.rtq_blocks_plain(
        x, 100, tparams.QuantStrategy.CENTERED, 8, False)
    mean = torch.from_numpy(want[:1]) * trq._recip(3000, "cpu")
    assert torch.equal(zp, torch.round(-mean / scale).to(torch.int32))

"""Port parity for the dynamic W8A8 / W4A8 GEMM against the JAX package.

``dynamic_quantized_matmul_plain`` (what the CUDA kernel is held to on the
card) against the JAX ``dynamic_quantized_matmul`` with its Pallas kernel
in interpret mode: bit for bit, for int8 and int4 weights, ROW and TENSOR
scales, SYMMETRIC and CENTERED strategies, ragged M and N, and ``c=``.
Both sides sum the int8 products exactly; the epilogue rounds at the same
places (the JAX kernel, as XLA runs it, fuses the zero-point subtraction
and the C addition into fused multiply-adds, and so does the port).
Weights lie on a 2⁻⁶ grid with power-of-two rows, so that CENTERED means
are exact in any summation order.  Mirrors ``test_dynamic_w8a8_matmul``
and ``test_dynamic_w4a8_matmul``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.ops.quantized_gemm import (
    dynamic_quantized_matmul as jax_dynamic_matmul,
)
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.models.transformer import linear
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm as tq
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

CASES = {
    # name: (bits, granularity, strategy, M, N, K, with c)
    "w8_row_sym": (8, "row", "symmetric", 37, 70, 256, False),
    "w8_row_centered_c": (8, "row", "centered", 37, 70, 256, True),
    "w8_tensor_sym": (8, "tensor", "symmetric", 5, 130, 256, False),
    "w4_row_sym": (4, "row", "symmetric", 37, 70, 512, False),
    "w4_row_centered": (4, "row", "centered", 37, 70, 512, False),
    "w4_tensor_sym_c": (4, "tensor", "symmetric", 9, 70, 256, True),
}


def _case(name):
    bits, gran, strategy, m, n, k, with_c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.integers(-128, 128, (n, k)) / 64).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32) if with_c else None
    jcfg = jparams.QuantConfig(bits=bits,
                               granularity=jparams.QuantGranularity(gran),
                               strategy=jparams.QuantStrategy(strategy))
    tcfg = tparams.QuantConfig(bits=bits,
                               granularity=tparams.QuantGranularity(gran),
                               strategy=tparams.QuantStrategy(strategy))
    return a, w, c, jcfg, tcfg


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_bit_for_bit(name):
    a, w, c, jcfg, tcfg = _case(name)
    want = np.asarray(jax_dynamic_matmul(
        jnp.asarray(a), jtensor.quantize(jnp.asarray(w), jcfg),
        c=None if c is None else jnp.asarray(c)))
    tc = None if c is None else torch.from_numpy(c)
    wq = ttensor.quantize(torch.from_numpy(w), tcfg)
    got = tq.dynamic_quantized_matmul_plain(torch.from_numpy(a), wq, c=tc)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # The public wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(
        tq.dynamic_quantized_matmul(torch.from_numpy(a), wq, c=tc).numpy(),
        want)


@pytest.mark.parametrize("blocks", [(512, 512, 1024), (128, 256, 256)])
def test_takes_the_jax_block_arguments(blocks):
    """``block_m/n/k`` as the JAX signature takes them: TPU tiles, accepted
    and unused, so the result is the JAX one at the same blocks, bit for
    bit."""
    a, w, c, jcfg, tcfg = _case("w8_row_centered_c")
    bm, bn, bk = blocks
    want = np.asarray(jax_dynamic_matmul(
        jnp.asarray(a), jtensor.quantize(jnp.asarray(w), jcfg),
        block_m=bm, block_n=bn, block_k=bk, c=jnp.asarray(c)))
    got = tq.dynamic_quantized_matmul(
        torch.from_numpy(a), ttensor.quantize(torch.from_numpy(w), tcfg),
        block_m=bm, block_n=bn, block_k=bk, c=torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fma32_rounds_once():
    rng = np.random.default_rng(5)
    x, y, z = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
               for _ in range(3))
    exact = x.double() * y.double() + z.double()  # products exact in f64
    got = tq.fma32(x, y, z).double()
    # One rounding: the error is at most half an fp32 ulp of the result.
    ulp = torch.from_numpy(np.spacing(got.float().abs().numpy())).double()
    assert bool(((got - exact).abs() <= ulp / 2).all())


def test_int4_unpack_rule_of_the_kernel():
    """The byte and nibble the CUDA kernel reads for element k."""
    q = np.random.default_rng(2).integers(-8, 8, (4, 512)).astype(np.int32)
    packed = ttensor.pack_int4(torch.from_numpy(q))
    unpacked = ttensor.unpack_int4(packed)
    assert unpacked.dtype == torch.int8
    np.testing.assert_array_equal(unpacked.numpy(), q)
    for k in (0, 127, 128, 255, 256, 300, 511):
        g, j = divmod(k, 256)
        byte = int(packed[1, g * 128 + j % 128])
        nibble = byte & 0xF if j < 128 else byte >> 4
        assert nibble - 8 == q[1, k]


def test_linear_runs_the_dynamic_gemm_on_quantized_weights():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    wq = ttensor.quantize(w.t(), tparams.QuantConfig(
        bits=8, granularity=tparams.QuantGranularity.ROW))
    y = linear(x.to(torch.bfloat16), wq, torch.float32)
    want = tq.dynamic_quantized_matmul_plain(
        x.to(torch.bfloat16).reshape(6, 64), wq).reshape(2, 3, 48)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert linear(x, wq).dtype == torch.float32
    rel = (linear(x, wq) - x @ w).norm() / (x @ w).norm()
    assert rel < 0.02  # int8 quantization error only


def test_rejects_what_it_does_not_take():
    a = torch.ones(4, 256)
    block = ttensor.quantize(torch.ones(8, 256), tparams.QuantConfig(
        bits=8, granularity=tparams.QuantGranularity.BLOCK, block_size=128))
    with pytest.raises(ValueError, match="ROW or TENSOR"):
        tq.dynamic_quantized_matmul(a, block)
    w4 = ttensor.quantize(torch.ones(8, 128), tparams.QuantConfig(
        bits=4, granularity=tparams.QuantGranularity.ROW))
    with pytest.raises(ValueError, match="K % 256"):
        tq.dynamic_quantized_matmul(torch.ones(4, 128), w4)
    w8 = ttensor.quantize(torch.ones(8, 128), tparams.INT8_ROW)
    with pytest.raises(ValueError):
        tq.dynamic_quantized_matmul(a, w8)  # K mismatch


# (M, N, K) → dyn_tile's (tile rows, K splits) on a 132-SM card.
DYN_TILE_PLANS = {
    # the flagship at decode (M = 8): 16-row tiles, K split in clusters of
    # up to 8 where the projection leaves SMs idle (K steps of 128, each
    # range at least two), none over the unembedding's 256 tiles
    (8, 1024, 1024): (16, 4),
    (8, 256, 1024): (16, 4),
    (8, 4096, 1024): (16, 4),
    (8, 1024, 4096): (16, 8),
    (8, 32768, 1024): (16, 1),
    (1, 32768, 1024): (16, 1),
    # a prefill chunk (M = 256): 64-row tiles, K split four ways where
    # N ≤ 1024
    (256, 1024, 1024): (64, 4),
    (256, 4096, 1024): (64, 1),
    (256, 256, 1024): (64, 4),
    # the fully quantized forward (M = 4096): 128-row tiles where they fill
    # the SMs, else 64-row ones
    (4096, 1024, 1024): (128, 1),
    (4096, 32768, 1024): (128, 1),
    (4096, 256, 1024): (64, 1),
    # MLAConfig()'s RoPE projections, gemm_bench's shapes, a ragged K
    (8, 32, 1024): (16, 4),
    (256, 512, 1024): (64, 4),
    (128, 8192, 8192): (64, 1),
    (4096, 8192, 8192): (128, 1),
    (5, 33, 100): (16, 1),
}


@pytest.mark.parametrize("shape", sorted(DYN_TILE_PLANS))
def test_dyn_tile_splits_k_only_where_the_tiles_leave_sms_idle(shape):
    """``dyn_tc_kernel``'s plan: 16-row tiles at decode, 128-row ones
    where they give every SM a CTA, else 64-row ones; K split (≤ 8 ranges
    of ≥ 2 steps, one cluster) up to one CTA for each SM."""
    m, n, k = shape
    bm, splits = tq.dyn_tile(m, n, k, 132)
    assert (bm, splits) == DYN_TILE_PLANS[shape]
    tiles = -(-m // bm) * -(-n // 128)
    assert splits == 1 or (tiles * splits <= 132
                           and 2 * splits <= -(-k // 128))


"""Port parity for the weight-only quantized GEMM against the JAX package.

The same seeded numpy A, weights and C go to the JAX ``quantized_matmul``
(its Pallas kernels in interpret mode, HIGHEST matmul precision) and to
the port's, which on CPU tensors runs the plain versions of the two CUDA
kernels (``wo_folded_gemm_plain``, ``wo_gemm_plain``); the CUDA kernels
are held to those on the card in tests/test_torch_kernels.py.  Both
packages quantize the weights to the same bytes (tests/test_torch_quant.py).
Every arm of the JAX dispatch: folded (SYMMETRIC TENSOR / ROW, a bf16 A)
and dequant-on-load (TENSOR / ROW / BLOCK × SYMMETRIC / ASYMMETRIC /
CENTERED, fp32 and bf16 A), int8 and int4, with and without ``c=``.

Tolerances: an fp32 result within TOLERANCES["fp32"] of the JAX one,
relative to its max abs (the fp32 sums run in another order); a bf16
result within one bf16 ulp of it elementwise (both round an fp32
accumulator that differs in its last bits).  Weights lie on a 2⁻⁶ grid so
that every strategy's scales and zero points are the same on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.ops.quantized_gemm import (
    quantized_matmul as jax_quantized_matmul,
)
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm as tq
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

M, N = 37, 70
GRANS = ("tensor", "row", "block")
STRATEGIES = ("symmetric", "asymmetric", "centered")


def _configs(bits, gran, strategy, block_size=None):
    kw = dict(bits=bits, block_size=block_size if gran == "block" else None)
    return (jparams.QuantConfig(granularity=jparams.QuantGranularity(gran),
                                strategy=jparams.QuantStrategy(strategy),
                                **kw),
            tparams.QuantConfig(granularity=tparams.QuantGranularity(gran),
                                strategy=tparams.QuantStrategy(strategy),
                                **kw))


def _case(seed, bits, gran, strategy, adtype, with_c, k=256, block_size=64):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((M, k)) / 8).astype(np.float32)
    w = (rng.integers(-128, 128, (N, k)) / 64).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32) if with_c else None
    jcfg, tcfg = _configs(bits, gran, strategy, block_size)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if adtype == "bf16"
                else (jnp.float32, torch.float32))
    with jax.default_matmul_precision("highest"):
        want = jax_quantized_matmul(
            jnp.asarray(a).astype(jdt), jtensor.quantize(jnp.asarray(w), jcfg),
            c=None if c is None else jnp.asarray(c), interpret=True)
    wq = ttensor.quantize(torch.from_numpy(w), tcfg)
    got = tq.quantized_matmul(torch.from_numpy(a).to(tdt), wq,
                              c=None if c is None else torch.from_numpy(c))
    return got, torch.from_numpy(np.array(want, np.float32)), wq


def _bf16_ulp(x):
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _assert_close(got, want, adtype):
    assert got.shape == want.shape == (M, N)
    if adtype == "bf16":
        assert got.dtype == torch.bfloat16
        got = got.float()
        assert bool(((got - want).abs()
                     <= _bf16_ulp(torch.maximum(got.abs(), want.abs()))).all())
    else:
        assert got.dtype == torch.float32
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= TOLERANCES["fp32"], err.item()


@pytest.mark.parametrize("with_c", [False, True], ids=["no_c", "c"])
@pytest.mark.parametrize("bits,gran", [(8, "tensor"), (8, "row"),
                                       (4, "tensor"), (4, "row")])
def test_folded_arm_matches_jax(bits, gran, with_c):
    n = (tq.wo_folded_gemm.launches, tq.wo_gemm.launches)
    got, want, _ = _case(bits + len(gran), bits, gran, "symmetric", "bf16",
                         with_c)
    _assert_close(got, want, "bf16")
    # CPU tensors run the plain versions: no launch counted.
    assert (tq.wo_folded_gemm.launches, tq.wo_gemm.launches) == n


@pytest.mark.parametrize("adtype", ["f32", "bf16"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("gran", GRANS)
def test_dequant_arm_matches_jax(gran, strategy, adtype):
    """Every cell except SYMMETRIC TENSOR / ROW with a bf16 A (the folded
    arm) takes the dequant-on-load kernel; int4 and ``c=`` alternate."""
    i = GRANS.index(gran) * 3 + STRATEGIES.index(strategy)
    bits = 4 if i % 2 else 8
    got, want, _ = _case(100 + i, bits, gran, strategy, adtype,
                         with_c=i % 3 == 0, block_size=64 if i % 2 else 128)
    _assert_close(got, want, adtype)


def test_folded_and_dequant_arms_agree_on_symmetric_rows():
    """The same SYMMETRIC ROW weight through both arms (an fp32 A forces
    the dequant one): the folded arm scales once at the store, the other
    per element; both sum exact products, so they agree to fp32."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy((rng.standard_normal((M, 256)) / 8).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.integers(-128, 128, (N, 256)) / 64).astype(
        np.float32))
    wq = ttensor.quantize(w, tparams.QuantConfig(
        granularity=tparams.QuantGranularity.ROW))
    folded = tq.quantized_matmul(a, wq, out_dtype=torch.float32)
    dequant = tq.quantized_matmul(a.float(), wq)
    err = (folded - dequant).abs().max() / dequant.abs().max()
    assert err.item() <= TOLERANCES["fp32"]


def test_what_the_jax_dispatch_rejects_raises():
    a = torch.zeros(4, 200)
    w4 = ttensor.quantize(torch.ones(8, 200), tparams.QuantConfig(bits=4))
    with pytest.raises(ValueError):  # int4 needs K % 256 == 0
        tq.quantized_matmul(a, w4)
    wch = ttensor.quantize(torch.ones(8, 256), tparams.QuantConfig(
        granularity=tparams.QuantGranularity.CHANNEL))
    with pytest.raises(NotImplementedError):
        tq.quantized_matmul(torch.zeros(4, 256), wch)
    with pytest.raises(ValueError):  # K mismatch
        tq.quantized_matmul(torch.zeros(4, 128), wch)
    with pytest.raises(ValueError):  # c of the wrong shape
        tq.quantized_matmul(torch.zeros(4, 256), ttensor.quantize(
            torch.ones(8, 256), tparams.INT8_ROW), c=torch.zeros(4, 7))

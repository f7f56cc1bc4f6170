"""Port parity for the GEMM engine: ``ops.gemm.matmul`` over its four
operand kinds, ``quantized_matmul_qa``, ``compensated_matmul``,
``per_row_block_sums``, the compensation oracles and the strategy
resolution, against the JAX package.

The same seeded numpy inputs are quantized by the JAX package and carried
over by ``models/convert.py``'s converter, so both sides multiply the same
bytes.  The JAX side runs its Pallas kernels in interpret mode (HIGHEST
matmul precision); the port's side runs, on CPU tensors, the plain versions
of its CUDA kernels (held to those kernels on the card in
tests/test_torch_kernels.py and ``chip_smoke.py`` phase 13).  Mirrors
``tests/test_quantized_gemm.py`` (compensated, small blocks, quantized A,
dispatch, block sums, ``c=``), the compensation cases of
``tests/test_quantization.py`` and the ``matmul`` cases of
``tests/test_parity_extras.py``.

Tolerances, in max abs error over the JAX value's max abs:

- the compensated kernel's plain version: bit for bit (exact integer
  compensation, rounded to fp32, accumulated by the fused multiply-add the
  JAX kernel gets from XLA), and the block sums exactly;
- other fp32 results: TOLERANCES["fp32"] (the same fp32 products, summed
  in another order);
- a bf16 compute dtype or result: 2e-3 (an fp32 sum that differs in its
  last bits may round to the neighbouring bf16 value, 2⁻⁸ of itself).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.ops import gemm as jgemm
from metal_flash_attention_plus_tpu.ops import quantized_gemm as jqg
from metal_flash_attention_plus_tpu.quant import capabilities as jcaps
from metal_flash_attention_plus_tpu.quant import compensation as jcomp
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.models.convert import (
    _quantized_from_jax,
)
from metal_flash_attention_plus_tpu_torch.ops import gemm as tgemm
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm as tqg
from metal_flash_attention_plus_tpu_torch.quant import capabilities as tcaps
from metal_flash_attention_plus_tpu_torch.quant import compensation as tcomp
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor
from metal_flash_attention_plus_tpu_torch.utils import roofline

BF16_TOL = 2e-3
CPU = torch.device("cpu")


def _cfg(bits=8, gran="row", strategy="symmetric", bs=None,
         compute_sums=False):
    return jparams.QuantConfig(
        bits=bits, granularity=jparams.QuantGranularity(gran),
        strategy=jparams.QuantStrategy(strategy), block_size=bs,
        compute_sums=compute_sums)


def _quant(x, cfg):
    """(JAX QuantizedTensor of x, the port's over the same bytes)."""
    jq = jtensor.quantize(jnp.asarray(x), cfg)
    return jq, _quantized_from_jax(jq, CPU)


def _port_quant(x, cfg):
    """(JAX QuantizedTensor, the port's) over the same bytes, quantized by
    the port (byte-identical with the JAX golden,
    tests/test_torch_quant.py): no JAX quantize to trace."""
    tq = ttensor.quantize(torch.from_numpy(x), tparams.QuantConfig(
        bits=cfg.bits, granularity=tparams.QuantGranularity(
            cfg.granularity.value),
        strategy=tparams.QuantStrategy(cfg.strategy.value),
        block_size=cfg.block_size))
    jq = jtensor.QuantizedTensor(
        data=jnp.asarray(tq.data.numpy()), scale=jnp.asarray(tq.scale.numpy()),
        zero_point=jnp.asarray(tq.zero_point.numpy()), sums=None, config=cfg,
        shape=tuple(tq.shape))
    return jq, tq


def _data(m=96, k=512, n=64, seed=0, shift_a=0.0, shift_b=0.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) + shift_a).astype(np.float32)
    bt = (rng.standard_normal((n, k)) + shift_b).astype(np.float32)
    return a, bt


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got, want):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _launches():
    return tuple(f.launches for f in (
        tqg.qa_folded_gemm, tqg.qa_gemm, tqg.comp_gemm, tqg.comp_small_gemm,
        tqg.wo_folded_gemm, tqg.wo_gemm))


# ---------------------------------------------------------------------------
# compensated_matmul
# ---------------------------------------------------------------------------

COMP = {
    # name: (block, strategy, with c, A shift, B shift)
    "b128_centered": (128, "centered", False, 0.0, 0.0),
    "b128_asymmetric_c": (128, "asymmetric", True, 0.5, -0.25),
    "b512_asymmetric": (512, "asymmetric", False, 0.3, 0.1),
}


@pytest.mark.parametrize("name", sorted(COMP))
def test_compensated_matmul_matches_jax_bit_for_bit(name):
    bs, strategy, with_c, sa, sb = COMP[name]
    a, bt = _data(seed=bs, shift_a=sa, shift_b=sb)
    cfg = _cfg(gran="block", strategy=strategy, bs=bs)
    (ja, ta), (jb, tb) = _quant(a, cfg), _quant(bt, cfg)
    c = (np.random.default_rng(1).standard_normal((96, 64)).astype(
        np.float32) if with_c else None)
    want = jqg.compensated_matmul(ja, jb, c=None if c is None
                                  else jnp.asarray(c))
    n0 = _launches()
    got = tqg.compensated_matmul(ta, tb, c=None if c is None
                                 else torch.from_numpy(c))
    assert _launches() == n0  # CPU tensors run the plain version
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # ... and the compensation identity: the golden, and the dequantized
    # product, agree with it to fp32 rounding (the JAX test's 1e-3).
    gold = tcomp.compensated_gemm_reference(ta, tb)
    deq = tcomp.dequantized_gemm_reference(ta, tb)
    if c is not None:
        gold, deq = gold + torch.from_numpy(c), deq + torch.from_numpy(c)
    assert (got - gold).abs().max() <= 1e-3
    assert (gold - deq).abs().max() <= 1e-3


@pytest.mark.parametrize("bs,strategy", [(16, "centered"), (64, "centered"),
                                         (32, "asymmetric"),
                                         (48, "asymmetric")])
def test_compensated_small_blocks_match_jax(bs, strategy):
    """Blocks below 128 (the reference's 16–64, and 48, which the JAX arm
    tiles by 384) through the exact fp32 per-element-dequant arm;
    asymmetric: nonzero zero points on both sides."""
    a, bt = _data(k=768 if bs == 48 else 512, seed=bs, shift_a=0.5,
                  shift_b=-0.25)
    cfg = _cfg(gran="block", strategy=strategy, bs=bs)
    (ja, ta), (jb, tb) = _quant(a, cfg), _quant(bt, cfg)
    want = jqg.compensated_matmul(ja, jb)
    got = tqg.compensated_matmul(ta, tb)
    assert _err(got, want) <= TOLERANCES["fp32"]
    deq = tcomp.dequantized_gemm_reference(ta, tb)
    assert (got - deq).abs().max() <= 1e-3


@pytest.mark.parametrize("bs", [8, 16, 24, 32, 48, 64, 80])
def test_comp_small_body_routes_by_block_size(bs):
    """The small-block kernel's route, by configuration: the s8 tensor-core
    tile for a multiple of 16 (m16n8k32 products for 32, 64; m16n8k16 for
    16, 48, 80), the scalar per-element tile for the other multiples of 8;
    both routes take the same argument list from ``comp_arguments``, whose
    block sums (a read of both payloads) the scalar route, which reads
    none, gets as None."""
    want = "tensor_core" if bs % 16 == 0 else "scalar"
    assert tqg.comp_small_body(bs) == want
    a, bt = _data(m=8, k=240 * 4, n=8, seed=bs)
    cfg = tparams.QuantConfig(bits=8, granularity=tparams.QuantGranularity(
        "block"), strategy=tparams.QuantStrategy("centered"), block_size=bs)
    ta, tb = (ttensor.quantize(torch.from_numpy(x), cfg) for x in (a, bt))
    small, args, kw = tqg.comp_arguments(ta, tb)
    assert small and kw["bs"] == bs and len(args) == 8
    sums = args[6:]
    if want == "scalar":
        assert sums == (None, None)
    else:
        assert all(torch.equal(s, tqg.per_row_block_sums(t))
                   for s, t in zip(sums, (ta, tb)))
    assert torch.equal(tqg.comp_small_gemm(*args, **kw),
                       tqg.comp_small_gemm_plain(*args, **kw))
    # 128-row tiles at gemm_bench's M = 4096; 64-row ones, K split in two,
    # at its M = 128 (K = 8192: 64 steps, in units of lcm(bs, 128) k)
    assert tqg.comp_small_tile(4096, 8192, 8192, bs, 132) == (128, 1)
    assert tqg.comp_small_tile(128, 8192, 8192, bs, 132) == (64, 2)


@pytest.mark.parametrize("bs", [16, 32, 48])
def test_comp_arguments_give_the_tensor_core_route_its_operands(bs):
    """``comp_arguments`` hands the small-block tensor-core route
    ``comp_gemm``'s operands: per-block fp32 scales and int32 zero points,
    and the per-row block sums.  On them the plain version (the JAX
    numerics) equals the JAX kernel at TOLERANCES["fp32"], and so does the
    tensor-core route's own arithmetic (``comp_gemm_plain``: the exact
    int32 compensation per block, one fp32 fused multiply-add a block),
    under the cancellation of asymmetric zero points on both sides."""
    k = 768
    a, bt = _data(k=k, seed=bs + 1, shift_a=0.4, shift_b=-0.3)
    cfg = _cfg(gran="block", strategy="asymmetric", bs=bs)
    (ja, ta), (jb, tb) = _quant(a, cfg), _quant(bt, cfg)
    c = np.random.default_rng(bs).standard_normal((96, 64)).astype(
        np.float32)
    small, args, kw = tqg.comp_arguments(ta, tb, c=torch.from_numpy(c))
    assert small and tqg.comp_small_body(bs) == "tensor_core"
    qa, qb, sa, za, sb, zb, sqa, sqb = args
    assert all(t.shape == (k // bs,) for t in (sa, za, sb, zb))
    assert sa.dtype == sb.dtype == torch.float32
    assert za.dtype == zb.dtype == torch.int32 and bool((za != 0).any())
    assert torch.equal(sqa, tqg.per_row_block_sums(ta))
    assert torch.equal(sqb, tqg.per_row_block_sums(tb))
    want = jqg.compensated_matmul(ja, jb, c=jnp.asarray(c))
    assert _err(tqg.comp_small_gemm_plain(*args, **kw), want) <= (
        TOLERANCES["fp32"])
    assert _err(tqg.comp_gemm_plain(*args, **kw), want) <= TOLERANCES["fp32"]


def test_compensated_small_block_tile_and_dequant_form():
    """The small-block arm's K tile is the JAX kernel's, and its dequant is
    one fused multiply-add, ``fma(q, s, −z·s)``: with B the identity the
    product reads A's dequantized values back exactly."""
    assert [tqg.small_block_tile(bs, k) for bs, k in (
        (16, 512), (32, 1024), (64, 256), (48, 512), (80, 4096))] == [
            512, 512, 256, 384, 640]
    cfg = _cfg(gran="block", strategy="asymmetric", bs=32)
    a, _ = _data(k=128, seed=3, shift_a=0.3)
    ja, ta = _port_quant(a * 3.7, cfg)
    eye = jtensor.QuantizedTensor(
        data=jnp.eye(128, dtype=jnp.int8), scale=jnp.ones((1, 4)),
        zero_point=jnp.zeros((1, 4), jnp.int32), sums=None, config=cfg,
        shape=(128, 128))
    want = jqg.compensated_matmul(ja, eye)
    got = tqg.compensated_matmul(ta, _quantized_from_jax(eye, CPU))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_compensated_matmul_rejects_what_jax_asserts():
    a, bt = _data(m=16, k=256, n=16)
    b128, b64 = (_cfg(gran="block", strategy="centered", bs=bs)
                 for bs in (128, 64))
    cases = [(b128, b64),  # block sizes differ
             (b128, _cfg(bits=4, gran="block", bs=128)),  # int4 B
             (b128, _cfg())]  # ROW B
    for ca, cb in cases:
        (ja, ta), (jb, tb) = _port_quant(a, ca), _port_quant(bt, cb)
        with pytest.raises(AssertionError):
            jqg.compensated_matmul(ja, jb)
        with pytest.raises(ValueError):
            tqg.compensated_matmul(ta, tb)


@pytest.mark.parametrize("bits", [8, 4])
def test_per_row_block_sums_match_jax_exactly(bits):
    _, bt = _data()
    cfg = _cfg(bits=bits, gran="block", strategy="centered", bs=128)
    jb, tb = _quant(bt, cfg)
    got = tqg.per_row_block_sums(tb)
    assert got.dtype == torch.int32 and got.shape == (64, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jqg.per_row_block_sums(jb)))
    q = (ttensor.unpack_int4(tb.data) if bits == 4 else tb.data).long()
    assert torch.equal(got.long(), q.reshape(64, 4, 128).sum(-1))


# ---------------------------------------------------------------------------
# quantized_matmul_qa
# ---------------------------------------------------------------------------

QA_CONFIGS = {
    "8b_tensor_sym": _cfg(gran="tensor"),
    "8b_row_sym": _cfg(),
    "8b_row_asym": _cfg(strategy="asymmetric"),
    "8b_block128_centered": _cfg(gran="block", strategy="centered", bs=128),
    "8b_block64_centered": _cfg(gran="block", strategy="centered", bs=64),
    "4b_tensor_sym": _cfg(bits=4, gran="tensor"),
    "4b_row_centered": _cfg(bits=4, strategy="centered"),
}


@pytest.mark.parametrize("bdtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(QA_CONFIGS))
def test_quantized_matmul_qa_matches_jax(name, bdtype):
    """Every config of the JAX test's QA_CONFIGS with an fp32 B (the
    dequant kernel at HIGHEST) and a bf16 B (SYMMETRIC TENSOR / ROW: the
    folded kernel; the others dequantize to bf16; both on the tensor-core
    tile)."""
    cfg = QA_CONFIGS[name]
    a, bt = _data(seed=len(name))
    ja, ta = _quant(a, cfg)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bdtype == "bf16"
                else (jnp.float32, torch.float32))
    b = bt.T.copy()
    with jax.default_matmul_precision("highest"):
        want = jqg.quantized_matmul_qa(ja, jnp.asarray(b).astype(jdt))
    got = tqg.quantized_matmul_qa(ta, torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and got.shape == (96, 64)
    folded, args, _ = tqg.qa_arguments(ta, torch.from_numpy(b).to(tdt))
    assert folded == (bdtype == "bf16" and name in ("8b_tensor_sym",
                                                    "8b_row_sym",
                                                    "4b_tensor_sym"))
    # A bf16 B, folded or dequantizing, runs the tensor-core tile.
    assert tqg.qa_gemm_body(args[1].dtype) == (
        "tensor_core" if bdtype == "bf16" else "fp32_fma")
    assert _err(got, want) <= (BF16_TOL if bdtype == "bf16"
                               else TOLERANCES["fp32"])
    ref = tcomp.dequantize(ta) @ torch.from_numpy(b).to(tdt).float()
    assert (got.float() - ref).abs().max() <= 0.05 * ref.abs().max()


def test_quantized_matmul_qa_folded_rounds_an_fp16_b_to_bf16():
    """The folded kernel casts B to bf16 whatever its float dtype, as the
    JAX call does: an fp16 B is rounded there, and the result is fp16."""
    a, bt = _data(seed=5)
    cfg = _cfg()
    ja, ta = _quant(a, cfg)
    b16 = bt.T.astype(np.float16)
    want = jqg.quantized_matmul_qa(ja, jnp.asarray(b16),
                                   out_dtype=jnp.float32)
    got = tqg.quantized_matmul_qa(ta, torch.from_numpy(b16),
                                  out_dtype=torch.float32)
    via_bf16 = tqg.quantized_matmul_qa(
        ta, torch.from_numpy(b16).to(torch.bfloat16), out_dtype=torch.float32)
    assert torch.equal(got, via_bf16)
    assert _err(got, want) <= TOLERANCES["fp32"]
    assert tqg.quantized_matmul_qa(ta, torch.from_numpy(b16)).dtype == (
        torch.float16)


def test_quantized_matmul_qa_rejects_what_jax_rejects():
    a, bt = _data(m=16, k=200, n=8)
    _, t4 = _port_quant(a, _cfg(bits=4, gran="tensor"))
    with pytest.raises(ValueError):  # int4 needs K % 256 == 0
        tqg.quantized_matmul_qa(t4, torch.from_numpy(bt.T.copy()))
    _, tch = _port_quant(a, _cfg(gran="channel", strategy="centered"))
    with pytest.raises(NotImplementedError):
        tqg.quantized_matmul_qa(tch, torch.from_numpy(bt.T.copy()))
    _, t8 = _port_quant(a, _cfg())
    with pytest.raises(ValueError):  # K mismatch
        tqg.quantized_matmul_qa(t8, torch.zeros(100, 8))


# ---------------------------------------------------------------------------
# ops.gemm.matmul
# ---------------------------------------------------------------------------


def test_matmul_float_float_and_transpose_a():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 32)).astype(np.float32)
    c = rng.standard_normal((64, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jgemm.matmul(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c))
    got = tgemm.matmul(torch.from_numpy(a), torch.from_numpy(b),
                       c=torch.from_numpy(c))
    assert got.dtype == torch.float32
    assert _err(got, want) <= TOLERANCES["fp32"]
    desc = tgemm.GEMMDescriptor(m=64, n=32, k=128, transpose_a=True)
    got_t = tgemm.matmul(torch.from_numpy(a.T.copy()), torch.from_numpy(b),
                         descriptor=desc, c=torch.from_numpy(c))
    assert torch.equal(got_t, got)
    with jax.default_matmul_precision("highest"):
        want16 = jgemm.matmul(jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16))
    got16 = tgemm.matmul(torch.from_numpy(a).bfloat16(),
                         torch.from_numpy(b).bfloat16())
    assert got16.dtype == torch.bfloat16
    assert _err(got16, want16) <= BF16_TOL


def test_matmul_float_quant():
    a, bt = _data(seed=0)
    jb, tb = _quant(bt, _cfg(gran="tensor"))
    with jax.default_matmul_precision("highest"):
        want = jgemm.matmul(jnp.asarray(a), jb)
    got = tgemm.matmul(torch.from_numpy(a), tb)
    assert _err(got, want) <= TOLERANCES["fp32"]


@pytest.mark.parametrize("bdtype", ["f32", "bf16"])
def test_matmul_qa_orientation_with_c(bdtype):
    """QuantizedTensor × float through the qa path; ``c`` is added after
    the kernel in fp32 and rounded to the result's dtype."""
    a, bt = _data(seed=2)
    c = np.random.default_rng(3).standard_normal((96, 64)).astype(
        np.float32)
    ja, ta = _quant(a, _cfg(gran="tensor"))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bdtype == "bf16"
                else (jnp.float32, torch.float32))
    b = bt.T.copy()
    with jax.default_matmul_precision("highest"):
        want = jgemm.matmul(ja, jnp.asarray(b).astype(jdt), c=jnp.asarray(c))
    got = tgemm.matmul(ta, torch.from_numpy(b).to(tdt),
                       c=torch.from_numpy(c))
    assert got.dtype == tdt
    assert _err(got, want) <= (BF16_TOL if bdtype == "bf16"
                               else TOLERANCES["fp32"])
    base = tqg.quantized_matmul_qa(ta, torch.from_numpy(b).to(tdt))
    assert torch.equal(got, (base.float() + torch.from_numpy(c)).to(tdt))


QQ = {
    # name: (A config, B config): the compensated arms, then the degraded
    # ones (A dequantized to bf16, B through quantized_matmul)
    "comp_b128": (_cfg(gran="block", strategy="centered", bs=128),
                  _cfg(gran="block", strategy="centered", bs=128)),
    "comp_small_b64": (_cfg(gran="block", strategy="centered", bs=64),
                       _cfg(gran="block", strategy="centered", bs=64)),
    "degraded_int4_a": (_cfg(bits=4, gran="block", strategy="centered",
                             bs=128),
                        _cfg(gran="block", strategy="centered", bs=128)),
    "degraded_unequal_blocks": (_cfg(gran="block", strategy="centered",
                                     bs=128),
                                _cfg(gran="block", strategy="centered",
                                     bs=64)),
    "degraded_row_b": (_cfg(gran="block", strategy="centered", bs=128),
                       _cfg()),
}


@pytest.mark.parametrize("with_c", [False, True], ids=["no_c", "c"])
@pytest.mark.parametrize("name", sorted(QQ))
def test_matmul_quant_quant_matches_jax(name, with_c):
    ca, cb = QQ[name]
    a, bt = _data(seed=len(name), shift_a=0.25)
    (ja, ta), (jb, tb) = _quant(a, ca), _quant(bt, cb)
    c = (np.random.default_rng(4).standard_normal((96, 64)).astype(
        np.float32) if with_c else None)
    with jax.default_matmul_precision("highest"):
        want = jgemm.matmul(ja, jb, c=None if c is None else jnp.asarray(c))
    got = tgemm.matmul(ta, tb, c=None if c is None else torch.from_numpy(c))
    assert got.dtype == torch.float32
    tol = BF16_TOL if name.startswith("degraded") else TOLERANCES["fp32"]
    assert _err(got, want) <= tol
    ref = tcomp.dequantized_gemm_reference(ta, tb)
    if c is not None:
        ref = ref + torch.from_numpy(c)
    assert (got - ref).norm() / ref.norm() <= (1e-2 if tol == BF16_TOL
                                               else 1e-5)


def _record(monkeypatch):
    """Replace the six GEMM wrappers the dispatch reaches with recorders
    that call through; → the list of wrapper names called."""
    calls = []
    for name in ("qa_folded_gemm", "qa_gemm", "comp_gemm", "comp_small_gemm",
                 "wo_folded_gemm", "wo_gemm"):
        fn = getattr(tqg, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(tqg, name, rec)
    return calls


DISPATCH = {
    # name: (A: float dtype or config, B: float dtype or config, wrapper)
    "qa_folded_row": (_cfg(), "bf16", "qa_folded_gemm"),
    "qa_folded_tensor_int4": (_cfg(bits=4, gran="tensor"), "bf16",
                              "qa_folded_gemm"),
    "qa_dequant_fp32_b": (_cfg(), "f32", "qa_gemm"),
    "qa_dequant_asym_row": (_cfg(strategy="asymmetric"), "bf16", "qa_gemm"),
    "qa_dequant_block": (QQ["comp_b128"][0], "bf16", "qa_gemm"),
    "wo_folded": ("bf16", _cfg(), "wo_folded_gemm"),
    "wo_dequant": ("f32", _cfg(), "wo_gemm"),
    **{f"qq_{k}": (ca, cb, "comp_gemm" if k == "comp_b128" else
                   "comp_small_gemm" if k == "comp_small_b64" else
                   "wo_folded_gemm" if k == "degraded_row_b" else "wo_gemm")
       for k, (ca, cb) in QQ.items()},
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_matmul_launches_exactly_one_expected_wrapper(name, monkeypatch):
    """Each arm of the dispatch calls one of the six GEMM wrappers, once
    (the degraded QT × QT arms take ``quantized_matmul`` with a bf16 A:
    folded over SYMMETRIC ROW weights, else ``wo_gemm``)."""
    a_spec, b_spec, want = DISPATCH[name]
    a, bt = _data(seed=7)

    def operand(x, spec):
        if isinstance(spec, str):
            return torch.from_numpy(x).to(torch.bfloat16 if spec == "bf16"
                                          else torch.float32)
        return _port_quant(x, spec)[1]

    ta = operand(a, a_spec)
    tb = operand(bt if not isinstance(b_spec, str) else bt.T.copy(), b_spec)
    calls = _record(monkeypatch)
    tgemm.matmul(ta, tb)
    assert calls == [want]


def test_matmul_degrades_without_a_fast_int8_path(monkeypatch):
    """``probe_capabilities`` reporting no fast int8 path sends an aligned
    int8 BLOCK pair down the degraded path, in both packages."""
    ca, cb = QQ["comp_b128"]
    a, bt = _data(seed=9)
    (ja, ta), (jb, tb) = _quant(a, ca), _quant(bt, cb)
    slow = dict(device_kind="no-int8", has_int8_mxu=False, bf16_tflops=1.0,
                int8_tops=1.0, hbm_gbps=1.0)
    monkeypatch.setattr(jcaps, "probe_capabilities",
                        lambda: jcaps.DeviceCapabilities(**slow))
    monkeypatch.setattr(tcaps, "probe_capabilities",
                        lambda device=None: tcaps.DeviceCapabilities(**slow))
    calls = _record(monkeypatch)
    with jax.default_matmul_precision("highest"):
        want = jgemm.matmul(ja, jb)
    got = tgemm.matmul(ta, tb)
    assert calls == ["wo_gemm"]
    assert _err(got, want) <= BF16_TOL


def test_matmul_int8_a_over_int4_b_raises_as_in_jax():
    """An int8 BLOCK A over an int4 BLOCK B of one block size is granted
    the compensated path by A's config, which takes int8 × int8 only: both
    packages refuse it."""
    a, bt = _data(m=16, k=256, n=16)
    (ja, ta) = _port_quant(a, _cfg(gran="block", strategy="centered",
                                   bs=128))
    (jb, tb) = _port_quant(bt, _cfg(bits=4, gran="block",
                                    strategy="centered", bs=128))
    with pytest.raises(AssertionError):
        jgemm.matmul(ja, jb)
    with pytest.raises(ValueError):
        tgemm.matmul(ta, tb)


def test_load_previous_c_accumulate():
    """loadPreviousC (the cheap half of the JAX test): each entry point
    with ``c`` equals C + the same product without it, C added in fp32."""
    rng = np.random.default_rng(7)
    m, n, k = 96, 160, 256
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    for bs in (128, 32):
        cfg = tparams.QuantConfig(
            bits=8, granularity=tparams.QuantGranularity.BLOCK,
            block_size=bs, strategy=tparams.QuantStrategy.CENTERED)
        aq, bq = ttensor.quantize(a, cfg), ttensor.quantize(b, cfg)
        base = tqg.compensated_matmul(aq, bq)
        acc = tqg.compensated_matmul(aq, bq, c=c)
        assert torch.allclose(acc, base + c, rtol=1e-5, atol=1e-5)
    bq = ttensor.quantize(b, tparams.INT8_ROW)
    base = tgemm.matmul(a, bq, out_dtype=torch.float32)
    acc = tgemm.matmul(a, bq, out_dtype=torch.float32, c=c)
    assert torch.allclose(acc, base + c, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The compensation oracles (tests/test_quantization.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,strategy,shift", [(8, "centered", 0.7),
                                                 (4, "symmetric", 0.0)])
def test_blockwise_compensation_matches_dequantized_gemm(bits, strategy,
                                                         shift):
    cfg = _cfg(bits=bits, gran="block", strategy=strategy, bs=16,
               compute_sums=True)
    rng = np.random.default_rng(bits)
    (ja, ta) = _quant(rng.standard_normal((24, 64)).astype(np.float32)
                      + shift, cfg)
    (jb, tb) = _quant(rng.standard_normal((40, 64)).astype(np.float32)
                      - shift / 2, cfg)
    ref = tcomp.dequantized_gemm_reference(ta, tb)
    comp = tcomp.compensated_gemm_reference(ta, tb)
    assert torch.allclose(comp, ref, rtol=1e-5, atol=1e-4)
    assert _err(comp, jcomp.compensated_gemm_reference(ja, jb)) <= 1e-6
    with jax.default_matmul_precision("highest"):
        jref = jcomp.dequantized_gemm_reference(ja, jb)
    assert _err(ref, jref) <= TOLERANCES["fp32"]


def test_precomputed_sums_match():
    cfg = _cfg(gran="block", strategy="symmetric", bs=16, compute_sums=True)
    x = np.random.default_rng(5).standard_normal((8, 48)).astype(np.float32)
    jq, tq = _quant(x, cfg)
    assert tq.sums is not None
    q = tq.data.long().reshape(8, 3, 16)
    assert torch.equal(tq.sums.reshape(3).long(), q.sum(dim=(0, 2)))
    np.testing.assert_array_equal(tq.sums.numpy(), np.asarray(jq.sums))


# ---------------------------------------------------------------------------
# Capabilities
# ---------------------------------------------------------------------------

H100 = dict(device_kind="nvidia-h100-sxm", has_int8_mxu=True,
            bf16_tflops=989.0, int8_tops=1979.0, hbm_gbps=3350.0)
NO_INT8 = dict(H100, device_kind="no-int8", has_int8_mxu=False,
               int8_tops=989.0)
RESOLVE = {
    # name: (config, both operands)
    "int8_block128_both": (_cfg(gran="block", bs=128), True),
    "int8_block64_both": (_cfg(gran="block", bs=64), True),
    "int8_block200_both": (_cfg(gran="block", bs=200), True),
    "int8_block128_one": (_cfg(gran="block", bs=128), False),
    "int8_row_both": (_cfg(), True),
    "int4_block128_both": (_cfg(bits=4, gran="block", bs=128), True),
}


@pytest.mark.parametrize("caps", ["h100", "no_int8"])
@pytest.mark.parametrize("name", sorted(RESOLVE))
def test_resolve_strategy_matches_jax(name, caps):
    """The same decision, the same rounded config and as many warnings as
    the JAX package for the same device numbers."""
    cfg, both = RESOLVE[name]
    spec = H100 if caps == "h100" else NO_INT8
    want = jcaps.resolve_strategy(cfg, jcaps.DeviceCapabilities(**spec),
                                  both_operands=both)
    tcfg = tparams.QuantConfig(
        bits=cfg.bits, granularity=tparams.QuantGranularity(
            cfg.granularity.value), block_size=cfg.block_size)
    got = tcaps.resolve_strategy(tcfg, tcaps.DeviceCapabilities(**spec),
                                 both_operands=both)
    assert got.use_compensated_path == want.use_compensated_path
    assert got.config.block_size == want.config.block_size
    assert got.config.bits == want.config.bits
    assert len(got.warnings) == len(want.warnings)
    assert got.config == dataclasses.replace(
        tcfg, block_size=want.config.block_size)


def test_the_port_probes_an_h100_and_reports_it():
    """The port's only spec is the H100's (for every device, as the JAX
    package falls back to a fast-int8 chip on the CPU): both packages
    grant the compensated path here."""
    caps = tcaps.probe_capabilities()
    assert caps == tcaps.DeviceCapabilities(**H100)
    assert caps.supports_compensated_int8
    assert jcaps.probe_capabilities().has_int8_mxu
    assert roofline.detect_chip("cpu") is roofline.H100_SXM
    assert roofline.utilization(989.0, roofline.H100_SXM) == 1.0
    assert roofline.utilization(989.5, roofline.H100_SXM, 8) == 0.5
    report = tcaps.capability_report()
    for line in ("989 TFLOP/s", "1979 TOP/s", "3350 GB/s", "yes (2× bf16)",
                 "block_size % 128 == 0"):
        assert line in report
    slow = tcaps.capability_report(tcaps.DeviceCapabilities(**NO_INT8))
    assert "no (runs at bf16 rate)" in slow and "no-int8" in slow


def test_attention_op_counts_match_jax():
    from metal_flash_attention_plus_tpu.utils import roofline as jroof

    for phase in ("forward", "dq", "dkv", "backward", "fwd_bwd"):
        kw = dict(num_heads=4, batch=2, phase=phase)
        assert roofline.attention_flops(256, 512, 64, **kw) == (
            jroof.attention_flops(256, 512, 64, **kw))


@pytest.mark.parametrize("bdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
@pytest.mark.parametrize("name", ["8b_row_asym", "8b_block128_centered",
                                  "4b_row_centered"])
def test_qa_gemm_body_follows_the_compute_dtype(name, bdtype):
    """The dequant-on-load arm hands ``qa_gemm`` B in the compute dtype
    (fp32 for an fp32 B, else bf16), and ``qa_gemm_body`` sends bf16 to the
    tensor-core tile and fp32 to the fp32-FMA one, as the C interface
    does."""
    a, bt = _data(seed=len(name))
    _, ta = _quant(a, QA_CONFIGS[name])
    folded, args, _ = tqg.qa_arguments(ta, torch.from_numpy(bt.T.copy()).to(
        bdtype))
    assert not folded
    want = "fp32_fma" if bdtype == torch.float32 else "tensor_core"
    assert tqg.qa_gemm_body(args[1].dtype) == want

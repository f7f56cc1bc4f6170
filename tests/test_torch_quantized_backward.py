"""Port parity for the quantized backward: every exact mode of
``flash_attention_backward`` over quantized K/V, the full-integer backward
(levels 1 and 2), the scale and zero-point cotangents and the gradients of
``quantized_flash_attention`` and ``QuantizedAttention``, against the JAX
package.

K/V are quantized once (by the port, byte-identical with the JAX golden)
and handed to both sides, and the backwards start from the same (o, l, dO),
so both differentiate over the same bytes.  The JAX side runs its Pallas
kernels in interpret mode at HIGHEST matmul precision; the port's side
runs the plain PyTorch versions its wrappers take on the CPU.  Tolerances,
in max abs error over the JAX value's max abs:

- an fp32 Q: TOLERANCES["fp32"] — the same fp32 arithmetic, sums in
  another order;
- a bf16 Q (the folded modes, the full-integer backward): 2e-3 — dS, P
  and the dequantized K/V are rounded to bf16 (or dS and P row-quantized
  to int8 at level 2) on both sides from fp32 values that differ in the
  last bits, so an element may land on the neighbouring bf16 (int8) value
  on one side: 2⁻⁸ of one product term (one quantization step, ≤ 1/127 of
  a row's largest term).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jmask
from metal_flash_attention_plus_tpu.attention import quantized as jfacade
from metal_flash_attention_plus_tpu.ops import quantized_attention as jqa
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.attention import masking as tmask
from metal_flash_attention_plus_tpu_torch.attention import (
    quantized as tfacade,
)
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops import flash_attention_bwd as tbwd
from metal_flash_attention_plus_tpu_torch.ops import hadamard as thad
from metal_flash_attention_plus_tpu_torch.ops import quantized_attention as tqa
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

jbwd = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention_bwd")
jfa = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention")

BF16_TOL = 2e-3


def _cfg(bits=8, gran="row", strategy="symmetric", **kw):
    return jparams.QuantConfig(
        bits=bits, granularity=jparams.QuantGranularity(gran),
        strategy=jparams.QuantStrategy(strategy), **kw)


ROW8 = _cfg()
ROW8C = _cfg(strategy="centered")
ROW4C = _cfg(bits=4, strategy="centered")
TEN8 = _cfg(gran="tensor")
CH8 = _cfg(gran="channel")
CH4 = _cfg(bits=4, gran="channel")
B2D = _cfg(gran="block_2d", strategy="centered", block_rows=8, block_size=32)

MASKS = {  # name: (JAX mask, port mask)
    "full": (jmask.FULL, tmask.FULL),
    "causal": (jmask.CAUSAL, tmask.CAUSAL),
    "window": (jmask.sliding_window(48, causal=True),
               tmask.sliding_window(48, causal=True)),
}


def _quantized(x, cfg, hadamard_block=None, float_zp=False):
    """(JAX QuantizedTensor, the port's) over the same bytes."""
    t = torch.from_numpy(x)
    if hadamard_block:
        t = thad.hadamard_transform(t, hadamard_block)
    tq = ttensor.quantize(t, tparams.QuantConfig(
        bits=cfg.bits, granularity=tparams.QuantGranularity(
            cfg.granularity.value),
        strategy=tparams.QuantStrategy(cfg.strategy.value),
        block_size=cfg.block_size, block_rows=cfg.block_rows))
    if float_zp:
        tq = dataclasses.replace(tq, zero_point=tq.zero_point.float())
    jq = jtensor.QuantizedTensor(
        data=jnp.asarray(tq.data.numpy()), scale=jnp.asarray(tq.scale.numpy()),
        zero_point=jnp.asarray(tq.zero_point.numpy()), sums=None, config=cfg,
        shape=tuple(tq.shape))
    return jq, tq


def _dtypes(qdtype):
    return ((jnp.bfloat16, torch.bfloat16) if qdtype == "bf16"
            else (jnp.float32, torch.float32))


def _inputs(seed, b, hq, hkv, sq, skv, d, kcfg, vcfg, qdtype, hb=None,
            float_zp=False):
    """((q, k, v, dO) JAX, the same port) from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    jdt, tdt = _dtypes(qdtype)
    jk, tk = _quantized(k, kcfg, hb, float_zp)
    jv, tv = _quantized(v, vcfg, hb, float_zp)
    return ((jnp.asarray(q).astype(jdt), jk, jv, jnp.asarray(do).astype(jdt)),
            (torch.from_numpy(q).to(tdt), tk, tv, torch.from_numpy(do).to(tdt)))


def _err(got, want):
    """Max abs error over the JAX value's max abs (fp32 views)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tol(qdtype):
    return BF16_TOL if qdtype == "bf16" else TOLERANCES["fp32"]


# ---------------------------------------------------------------------------
# Every exact mode of flash_attention_backward
# ---------------------------------------------------------------------------

EXACT = {
    # name: (b, hq, hkv, sq, skv, d, K, V, Q dtype, mask, options)
    "token_int8": (1, 4, 2, 128, 128, 64, ROW8C, ROW8C, "f32", "causal", {}),
    "token_int4_full": (1, 4, 2, 128, 128, 64, ROW4C, ROW4C, "f32", "full",
                        {}),
    "tensor": (1, 4, 2, 128, 128, 64, TEN8, TEN8, "f32", "causal", {}),
    "block2d": (1, 4, 2, 128, 128, 64, B2D, B2D, "f32", "causal", {}),
    "folded_tensor_k": (1, 4, 2, 128, 128, 64, TEN8, CH8, "bf16", "causal",
                        {}),
    "folded_channel_k": (1, 4, 2, 128, 128, 64, CH8, TEN8, "bf16", "causal",
                         {}),
    "folded_row_interleaved_full": (1, 4, 2, 128, 128, 64, ROW8, ROW8,
                                    "bf16", "full",
                                    dict(interleaved_kv=True)),
    "folded_int4": (1, 4, 2, 128, 128, 64, CH4, CH4, "bf16", "causal", {}),
    "k8_v4_mqa": (2, 4, 1, 128, 128, 32, ROW8C, ROW4C, "f32", "causal", {}),
    "window_interleaved": (1, 4, 2, 128, 128, 64, ROW8C, ROW8C, "f32",
                           "window", dict(interleaved_kv=True)),
    "bias_dbias": (2, 4, 2, 96, 128, 64, ROW8C, ROW8C, "f32", "causal",
                   dict(bias=(1, 4, 96, 128))),
    "ragged": (1, 2, 1, 100, 150, 32, ROW8C, ROW8C, "f32", "causal", {}),
    # Head dims the kernels are not built for (run zero-padded on the card).
    "token_int8_d80": (1, 4, 2, 128, 128, 80, ROW8C, ROW8C, "f32", "causal",
                       {}),
    "token_int4_d96": (1, 4, 2, 128, 128, 96, ROW4C, ROW4C, "f32", "causal",
                       {}),
    "folded_row_d96_bf16": (1, 4, 2, 128, 128, 96, ROW8, ROW8, "bf16",
                            "causal", {}),
    # MLA's width 288 (an int4 row packs as two groups) and 272, which the
    # card runs zero-padded at 288.
    "token_int4_d288": (1, 2, 1, 128, 128, 288, ROW4C, ROW4C, "f32",
                        "causal", {}),
    "folded_row_d288_bf16": (1, 4, 1, 128, 128, 288, ROW8, ROW8, "bf16",
                             "causal", {}),
    "block2d_d288": (1, 2, 1, 128, 128, 288, B2D, B2D, "f32", "causal", {}),
    "folded_channel_int4_d272_bf16": (1, 2, 1, 128, 128, 272, CH4, CH4,
                                      "bf16", "causal", {}),
    # DeepSeek's absorbed width 576 (an int4 row packs as three groups) and
    # the 512 latent, which the card runs zero-padded at 576.
    "token_int8_d576": (1, 2, 1, 128, 128, 576, ROW8C, ROW8C, "f32",
                        "causal", {}),
    "token_int4_d576": (1, 2, 1, 128, 128, 576, ROW4C, ROW4C, "f32",
                        "causal", {}),
    "block2d_d576": (1, 2, 1, 128, 128, 576, B2D, B2D, "f32", "causal", {}),
    "folded_channel_k_d576_bf16": (1, 2, 1, 128, 128, 576, CH8, TEN8,
                                   "bf16", "causal", {}),
    "folded_row_d576_bf16": (1, 2, 1, 128, 128, 576, ROW8, ROW8, "bf16",
                             "causal", {}),
    "token_int8_d576_bf16": (1, 2, 1, 128, 128, 576, ROW8C, ROW8C, "bf16",
                             "causal", {}),
    "token_int8_d512": (1, 2, 1, 128, 128, 512, ROW8C, ROW8C, "f32",
                        "causal", {}),
    "token_int4_d512": (1, 2, 1, 128, 128, 512, ROW4C, ROW4C, "f32",
                        "causal", {}),
    "block2d_d512": (1, 2, 1, 128, 128, 512, B2D, B2D, "f32", "causal", {}),
    "folded_channel_k_d512_bf16": (1, 2, 1, 128, 128, 512, CH8, TEN8,
                                   "bf16", "causal", {}),
    "folded_row_d512_bf16": (1, 2, 1, 128, 128, 512, ROW8, ROW8, "bf16",
                             "causal", {}),
    "token_int8_d512_bf16": (1, 2, 1, 128, 128, 512, ROW8C, ROW8C, "bf16",
                             "causal", {}),
}


def _forward(tq, tk, tv, **kw):
    """(o, l) from the port's forward (held to the JAX package's by
    tests/test_torch_quantized_attention.py), as both packages' arrays."""
    o, lse = tqa.quantized_flash_attention_forward(tq, tk, tv, **kw)
    return (jnp.asarray(o.numpy()), jnp.asarray(lse.numpy())), (o, lse)


def _exact_case(name):
    b, hq, hkv, sq, skv, d, kcfg, vcfg, qdtype, mask, opts = EXACT[name]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        len(name), b, hq, hkv, sq, skv, d, kcfg, vcfg, qdtype)
    jopts, topts = dict(opts), dict(opts)
    if "bias" in opts:
        bias = np.random.default_rng(5).standard_normal(opts["bias"]).astype(
            np.float32)
        jopts["bias"], topts["bias"] = jnp.asarray(bias), torch.from_numpy(
            bias)
        jopts["compute_dbias"] = topts["compute_dbias"] = True
    jm, tm = MASKS[mask]
    fwd = {k_: v_ for k_, v_ in topts.items() if k_ != "compute_dbias"}
    (jo, jl), (to, tl) = _forward(tq, tk, tv, mask=tm, **fwd)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(jq, jk, jv, jo, jl, jdo,
                                             mask=jm, **jopts)
    got = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo, mask=tm,
                                        **topts)
    return got, want, qdtype


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_backward_mode_matches_jax(name):
    got, want, qdtype = _exact_case(name)
    assert (got[3] is None) == (want[3] is None)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float32
            assert _err(g, w) <= _tol(qdtype), name


def test_folded_channel_k_interleaved_matches_dense_vjp():
    """Held to the dense VJP over the dequantized K/V, not to the JAX call:
    the JAX package folds CHANNEL scales into Q and dO by the grouped head
    mapping even when ``interleaved_kv`` (ROADMAP §3).  Tolerance 3e-2
    max abs over the max abs: Q, dO, dS and the dequantized K/V are
    rounded to bf16 here and not in the fp32 dense VJP."""
    _, (tq, tk, tv, tdo) = _inputs(3, 1, 4, 2, 128, 128, 64, CH8, CH8,
                                   "bf16")
    kf, vf = (ttensor.dequantize(t).to(torch.bfloat16) for t in (tk, tv))
    o, lse = tqa.quantized_flash_attention_forward(
        tq, tk, tv, mask=tmask.CAUSAL, interleaved_kv=True)
    got = tbwd.flash_attention_backward(tq, tk, tv, o, lse, tdo,
                                        mask=tmask.CAUSAL,
                                        interleaved_kv=True)
    from metal_flash_attention_plus_tpu_torch.reference.attention import (
        reference_attention_vjp,
    )

    want = reference_attention_vjp(tq, kf, vf, tdo, mask=tmask.CAUSAL,
                                   interleaved_kv=True)
    for g, w in zip(got[:3], want):
        assert (g - w).abs().max() / w.abs().max() <= 3e-2


# ---------------------------------------------------------------------------
# The full-integer backward
# ---------------------------------------------------------------------------

_SYM = dict(row=ROW8, chan=CH8, tens=TEN8)
JBS128 = jfa.BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                        block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)

FULLINT = {
    # name: (K, V, level, 128-wide level-2 tiles, interleaved, head dim)
    "row_chan_l1": ("row", "chan", None, False, False, 128),
    "row_chan_l2": ("row", "chan", "2", False, False, 128),
    "tens_tens_l1": ("tens", "tens", None, False, False, 128),
    "tens_tens_l2_tiles128": ("tens", "tens", "2", True, False, 128),
    "row_chan_l2_tiles128_interleaved": ("row", "chan", "2", True, True,
                                         128),
    # The north-star's head dim, both levels.
    "row_chan_l1_d256": ("row", "chan", None, False, False, 256),
    "row_chan_l2_d256": ("row", "chan", "2", False, False, 256),
    "row_tens_l1": ("row", "tens", None, False, False, 128),
    "row_chan_l1_interleaved": ("row", "chan", None, False, True, 128),
}


@pytest.mark.parametrize("name", sorted(FULLINT))
def test_fullint_backward_matches_jax(name, monkeypatch):
    """At the JAX package's test shapes (B=1, Hq=4, Hkv=2, S=256, D=128,
    bf16, FULL; D=256 too); level 2 with the default 512 blocks (one
    256-wide tile) and with 128-wide tiles, whose row maxima the port takes
    from ``block_sizes`` as the JAX package does."""
    kname, vname, level, tiles128, inter, d = FULLINT[name]
    if level:
        monkeypatch.setenv("MFA_BWD_FULLINT_LEVEL", level)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        21, 1, 4, 2, 256, 256, d, _SYM[kname], _SYM[vname], "bf16")
    jbs = JBS128 if tiles128 else jfa.BlockSizes()
    tbs = tbwd.BlockSizes(**dataclasses.asdict(jbs))
    assert tbwd.fullint_backward_supported(tq, tk, tv, tmask.FULL, None,
                                           None)
    (jo, jl), (to, tl) = _forward(tq, tk, tv, interleaved_kv=inter)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(
            jq, jk, jv, jo, jl, jdo, fullint=True, block_sizes=jbs,
            interleaved_kv=inter)
    got = tbwd.flash_attention_backward(
        tq, tk, tv, to, tl, tdo, fullint=True, block_sizes=tbs,
        interleaved_kv=inter)
    exact = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo,
                                          interleaved_kv=inter)
    assert got[3] is None and want[3] is None
    for g, w, e in zip(got[:3], want[:3], exact[:3]):
        assert _err(g, w) <= BF16_TOL, name
        # ... an approximation of the exact backward: rel L2 < 0.05, the
        # JAX package's gate.
        assert 0 < (g - e).norm() / e.norm() < 0.05


@pytest.mark.parametrize("d", [32, 64, 80, 128, 256, 272, 288])
def test_fullint_body_follows_the_level_2_width(d):
    """The full-integer pair runs on the tensor cores at level 1 and at
    widths of whole s8 k steps (multiples of 32), on the scalar kernels at
    the widths ``fullint_widths`` gives other sequences (S=200: 8, S=336:
    48, S=129: 1), at every head dim up to DeepSeek's 576 (272 runs at
    288), has no kernel for a negative width, and past 576 runs the
    split-D pair at every width."""
    bs = tbwd.BlockSizes()
    for s, want in ((4096, "tensor_core"), (256, "tensor_core"),
                    (160, "tensor_core"), (288, "tensor_core"),
                    (200, "dp4a"), (336, "dp4a"), (129, "dp4a"),
                    (144, "dp4a")):
        widths = tbwd.fullint_widths(bs, s, s)
        assert {tbwd.fullint_body(d, w) for w in widths} == {want}, s
    assert tbwd.fullint_widths(bs, 160, 288) == (96, 32)
    assert tbwd.fullint_body(d, 0) == "tensor_core"
    with pytest.raises(ValueError):
        tbwd.fullint_body(d, -1)
    assert tbwd.fullint_body(d + 580, 0) == tbwd.fullint_body(
        d + 580, 8) == "split_d"
    assert tbwd.fullint_body(304, 0) == "tensor_core"


@pytest.mark.parametrize("d,level", [(288, None), (288, "2"), (272, None)])
def test_fullint_backward_at_mla_widths_matches_jax(d, level, monkeypatch):
    """Levels 1 and 2 at MLA's width 288 and level 1 at 272 (B=1, Hq=2,
    Hkv=1, S=128, bf16, FULL, ROW K / CHANNEL V; level 2 over 128-wide
    tiles)."""
    if level:
        monkeypatch.setenv("MFA_BWD_FULLINT_LEVEL", level)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        d + len(level or ""), 1, 2, 1, 128, 128, d, ROW8, CH8, "bf16")
    tbs = tbwd.BlockSizes(**dataclasses.asdict(JBS128))
    (jo, jl), (to, tl) = _forward(tq, tk, tv)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(jq, jk, jv, jo, jl, jdo,
                                             fullint=True, block_sizes=JBS128)
    got = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo,
                                        fullint=True, block_sizes=tbs)
    for g, w in zip(got[:3], want[:3]):
        assert _err(g, w) <= BF16_TOL


@pytest.mark.parametrize("d", [272, 288, 512, 576])
def test_wide_widths_route_to_the_wide_bodies(d):
    """At 272 and 288 the quantized kernels run at width 288, at 512 and
    576 at width 576: the exact dQ and dK/dV of a bf16 Q on the tensor
    cores (the wide bodies, the latent ones at 576), of an fp32 Q on the
    scalar ones, and the dK/dV's GQA group split over CTAs at the training
    shape (16 q heads over one latent head, 2048 keys, 132 SMs: 16 splits
    of the 64-key tiles at 288, 8 of the 32-key ones at 576); the
    full-integer pair at both levels at the same widths (its dK/dV's group
    split at 576 only: 8 splits there); past 576 the split-D kernels."""
    w = 288 if d <= 288 else 576
    assert tqa.qattn_width(d) == w
    for body in (tbwd.dq_body, tbwd.dkv_body):
        assert body(torch.bfloat16, d) == "tensor_core"
        assert body(torch.float32, d) == "fp32_fma"
    assert tbwd.fullint_body(d, 0) == tbwd.fullint_body(d, 128) == (
        "tensor_core")
    assert tbwd.fullint_body(d, 16) == "dp4a"
    assert tbwd.fullint_dkv_splits(d, 2, 16, 1, 2048, 132) == (
        1 if w == 288 else 8)
    assert tbwd.dkv_splits(torch.bfloat16, d, 2, 16, 1, 2048, 132) == (
        16 if w == 288 else 8)
    assert tbwd.dkv_splits(torch.float32, d, 2, 16, 1, 2048, 132) == 1
    assert tbwd.fullint_body(592, 0) == "split_d"
    assert tqa.qattn_width(592) == 592


@pytest.mark.parametrize("d", [80, 96])
def test_fullint_backward_odd_head_dims_match_jax(d):
    """Level 1 at head dims the kernels run zero-padded (B=1, Hq=4, Hkv=2,
    S=128, bf16, FULL, ROW K / CHANNEL V)."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        d, 1, 4, 2, 128, 128, d, ROW8, CH8, "bf16")
    (jo, jl), (to, tl) = _forward(tq, tk, tv)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(jq, jk, jv, jo, jl, jdo,
                                             fullint=True)
    got = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo,
                                        fullint=True)
    for g, w in zip(got[:3], want[:3]):
        assert _err(g, w) <= BF16_TOL


PADDED = {  # name: (head dim, K, V, Q dtype)
    "token_int8_d80": (80, ROW8C, ROW8C, "f32"),
    "token_int4_d96": (96, ROW4C, ROW4C, "f32"),
    "block2d_d80": (80, _cfg(gran="block_2d", strategy="centered",
                             block_rows=8, block_size=16),
                    _cfg(gran="block_2d", strategy="centered", block_rows=8,
                         block_size=16), "f32"),
    # 48-wide blocks tile D=96 but not its kernel width 128.
    "block2d48_d96": (96, _cfg(gran="block_2d", strategy="centered",
                               block_rows=8, block_size=48),
                      _cfg(gran="block_2d", strategy="centered",
                           block_rows=8, block_size=48), "f32"),
    "folded_channel_d48_bf16": (48, CH8, CH4, "bf16"),
    # 272 at MLA's 288: the int4 row repacked as two groups, BLOCK_2D
    # 16-wide cells, folded ROW (column scales) in bf16.
    "token_int4_d272": (272, ROW4C, ROW4C, "f32"),
    "block2d16_d272": (272, _cfg(gran="block_2d", strategy="centered",
                                 block_rows=8, block_size=16),
                       _cfg(gran="block_2d", strategy="centered",
                            block_rows=8, block_size=16), "f32"),
    "folded_row_d272_bf16": (272, ROW8, ROW8, "bf16"),
    # 512 and 320 at DeepSeek's 576: the int4 row repacked as three groups,
    # BLOCK_2D 16-wide cells, folded ROW in bf16.
    "token_int4_d512": (512, ROW4C, ROW4C, "f32"),
    "block2d16_d320": (320, _cfg(gran="block_2d", strategy="centered",
                                 block_rows=8, block_size=16),
                       _cfg(gran="block_2d", strategy="centered",
                            block_rows=8, block_size=16), "f32"),
    "folded_row_d512_bf16": (512, ROW8, ROW8, "bf16"),
}


@pytest.mark.parametrize("name", sorted(PADDED))
def test_exact_kernel_width_padding_changes_nothing(name):
    """On the card the exact dQ and dK/dV kernels run a head dim outside
    HEAD_DIMS at ``qattn_width``: Q and dO zero-padded, K/V by
    ``pad_qflash_kv``, dQ's store multipliers padded with 1.  The plain
    versions over those, cut back to the head dim, compute what they
    compute over the originals."""
    d, kcfg, vcfg, qdtype = PADDED[name]
    _, (tq, tk, tv, tdo) = _inputs(d, 1, 4, 2, 64, 96, d, kcfg, vcfg, qdtype)
    o, lse = tqa.quantized_flash_attention_forward(tq, tk, tv,
                                                   mask=tmask.CAUSAL)
    di = (tdo.float() * o).sum(-1)
    rr = tbwd.row_ranges_tensor(tmask.CAUSAL, 64, 96, None, "cpu")
    (dq_a, dq_kw), (dkv_a, dkv_kw) = tbwd.qflash_arguments(
        tq, tk, tv, tdo.to(tq.dtype), lse, di, rr, scale=d ** -0.5)
    w = tqa.qattn_width(d)

    def padded(args, mode):
        q, do, kq, vq, kp, vp, *rest = args
        return (*tbwd.pad_lanes(w, q, do),
                *tbwd.pad_qflash_kv(d, kq, vq, kp, vp, mode), *rest)

    dqsc = torch.nn.functional.pad(dq_kw["dqsc"], (0, w - d), value=1.0)
    want = (tbwd.qflash_dq_plain(*dq_a, **dq_kw)[0],
            *tbwd.qflash_dkv_plain(*dkv_a, **dkv_kw))
    got = (tbwd.qflash_dq_plain(*padded(dq_a, dq_kw["mode"]),
                                **{**dq_kw, "dqsc": dqsc})[0],
           *tbwd.qflash_dkv_plain(*padded(dkv_a, dkv_kw["mode"]), **dkv_kw))
    for g, w_ in zip(got, want):
        assert g.shape[-1] == w
        assert (g[..., :d] - w_).abs().max() <= _tol(qdtype) * w_.abs().max()


@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 48, 64, 80, 96, 128, 256])
def test_dkv_kernel_body_follows_the_q_dtype(qdtype, d):
    """The exact dK/dV launch gets Q in its own dtype, in the dequantizing
    and (bf16) folded modes alike, at a kernel width of at most 256: a bf16
    Q takes the tensor-core dK/dV body at every head dim, an fp32 one the
    fp32-FMA body (``dkv_body``, as the C launcher routes)."""
    want = "tensor_core" if qdtype == "bf16" else "fp32_fma"
    for kcfg, vcfg in ((ROW8C, ROW4C), (ROW8, ROW8)):
        _, (tq, tk, tv, tdo) = _inputs(d, 1, 2, 1, 16, 24, d, kcfg, vcfg,
                                       qdtype)
        stats = torch.zeros(1, 2, 16)
        rr = tbwd.row_ranges_tensor(tmask.CAUSAL, 16, 24, None, "cpu")
        _, (dkv_a, dkv_kw) = tbwd.qflash_arguments(
            tq, tk, tv, tdo, stats, stats, rr, scale=d ** -0.5)
        q = dkv_a[0]
        assert q.dtype == tq.dtype and tqa.qattn_width(q.shape[-1]) <= 256
        assert tbwd.dkv_body(q.dtype, q.shape[-1]) == want


@pytest.mark.parametrize("d", [80, 96])
def test_fullint_kernel_width_padding_changes_nothing(d):
    """The full-integer kernels' integer operands zero-padded to
    ``qattn_width``: the plain versions cut back to the head dim compute
    what they compute over the originals."""
    _, (tq, tk, tv, tdo) = _inputs(d, 1, 4, 2, 128, 128, d, ROW8, CH8,
                                   "bf16")
    o, lse = tqa.quantized_flash_attention_forward(tq, tk, tv)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = tbwd.fullint_arguments(
        tq, tk, tv, o, lse, tdo, scale=d ** -0.5)
    w = tqa.qattn_width(d)
    qq, qsc, kq, ks, vq, dov, dovsc, l_, di = dq_a
    pq, pk, pv, pdov = tbwd.pad_lanes(w, qq, kq, vq, dov)
    want = tbwd.fullint_dq_plain(*dq_a, **dq_kw)
    got = tbwd.fullint_dq_plain(pq, qsc, pk, ks, pv, pdov, dovsc, l_, di,
                                **dq_kw)
    assert (got[..., :d] - want).abs().max() <= BF16_TOL * want.abs().max()
    qq, qsc, kq, ks, vq, dor, dorsc, dov, dovsc, l_, di = dkv_a
    pq, pk, pv, pdor, pdov = tbwd.pad_lanes(w, qq, kq, vq, dor, dov)
    want = tbwd.fullint_dkv_plain(*dkv_a, **dkv_kw)
    got = tbwd.fullint_dkv_plain(pq, qsc, pk, ks, pv, pdor, dorsc, pdov,
                                 dovsc, l_, di, **dkv_kw)
    for g, w_ in zip(got, want):
        assert (g[..., :d] - w_).abs().max() <= BF16_TOL * w_.abs().max()


def test_fullint_widths_follow_the_tpu_tiles():
    bs = tbwd.BlockSizes(block_q_dq=1024, block_kv_dq=512,
                         block_q_dkv=1024, block_kv_dkv=512)
    assert tbwd.fullint_widths(bs, 4096, 4096) == (512, 1024)
    assert tbwd.fullint_widths(tbwd.BlockSizes(), 256, 256) == (256, 256)
    assert tbwd.fullint_widths(tbwd.BlockSizes(), 300, 300) == (12, 12)


def test_masked_fullint_equals_exact_bit_for_bit():
    """A mask (or any configuration the full-integer kernels do not take)
    dispatches to the exact kernels: fullint=True gives fullint=False's
    gradients bit for bit."""
    _, (tq, tk, tv, tdo) = _inputs(23, 1, 2, 2, 256, 256, 64, ROW8, ROW8,
                                   "bf16")
    o, lse = tqa.quantized_flash_attention_forward(tq, tk, tv,
                                                   mask=tmask.CAUSAL)
    assert not tbwd.fullint_backward_supported(tq, tk, tv, tmask.CAUSAL,
                                               None, None)
    a = tbwd.flash_attention_backward(tq, tk, tv, o, lse, tdo,
                                      mask=tmask.CAUSAL)
    b = tbwd.flash_attention_backward(tq, tk, tv, o, lse, tdo,
                                      mask=tmask.CAUSAL, fullint=True)
    for ga, gb in zip(a[:3], b[:3]):
        assert torch.equal(ga, gb)


def test_no_bwd_fullint_environment_turns_it_off(monkeypatch):
    _, (tq, tk, tv, _) = _inputs(1, 1, 2, 2, 64, 64, 64, ROW8, CH8, "bf16")
    assert tbwd.fullint_backward_supported(tq, tk, tv, tmask.FULL, None,
                                           None)
    monkeypatch.setenv("MFA_NO_BWD_FULLINT", "1")
    assert not tbwd.fullint_backward_supported(tq, tk, tv, tmask.FULL,
                                               None, None)


# ---------------------------------------------------------------------------
# Scale and zero-point cotangents
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [ROW8C, TEN8, CH8, B2D, ROW4C],
                         ids=["row", "tensor", "channel", "block2d", "row4"])
def test_scale_zp_cotangents_match_jax(cfg):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 2, 64, 64)).astype(np.float32)
    dx = rng.standard_normal(x.shape).astype(np.float32)
    jq, tq = _quantized(x, cfg, float_zp=True)
    want = jqa._scale_zp_cotangents(jnp.asarray(dx), jq)
    got = tqa._scale_zp_cotangents(torch.from_numpy(dx), tq)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert _err(g, w) <= TOLERANCES["fp32"]
    # An integer zero point gets no cotangent.
    _, tq_int = _quantized(x, cfg)
    assert tqa._scale_zp_cotangents(torch.from_numpy(dx), tq_int)[1] is None


# ---------------------------------------------------------------------------
# Gradients through the differentiable entry points
# ---------------------------------------------------------------------------

GRADS = {
    # name: (K, V, Q dtype, mask, float zero points, options)
    "dequant_bias": (ROW8C, ROW8C, "f32", "causal", True,
                     dict(bias=(1, 4, 128, 128))),
    "hadamard": (ROW4C, ROW4C, "f32", "causal", True,
                 dict(hadamard_block=64)),
    "quantize_q_fullint": (ROW8, CH8, "bf16", "full", False,
                           dict(quantize_q=True, bwd_fullint=True)),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_autograd_matches_jax_grad(name):
    """``torch.autograd.grad`` of sum(O·dO) with respect to q, the K/V
    scales, float zero points and the bias, against ``jax.grad``; the
    scales enter through ``dataclasses.replace`` as in bench.py."""
    kcfg, vcfg, qdtype, mask, fzp, opts = GRADS[name]
    hb = opts.get("hadamard_block")
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        len(name) + 30, 1, 4, 2, 128, 128, 64, kcfg, vcfg, qdtype, hb, fzp)
    jopts = {k_: v_ for k_, v_ in opts.items() if k_ != "bias"}
    jleaves = [jq, jk.scale, jv.scale]
    tleaves = [tq, tk.scale, tv.scale]
    if fzp:
        jleaves += [jk.zero_point, jv.zero_point]
        tleaves += [tk.zero_point, tv.zero_point]
    if "bias" in opts:
        bias = np.random.default_rng(2).standard_normal(opts["bias"]).astype(
            np.float32)
        jleaves.append(jnp.asarray(bias))
        tleaves.append(torch.from_numpy(bias))
    jm, tm = MASKS[mask]

    def jloss(q_, ks, vs, *rest):
        kz = rest[0] if fzp else jk.zero_point
        vz = rest[1] if fzp else jv.zero_point
        bias_ = rest[-1] if "bias" in opts else None
        k2 = dataclasses.replace(jk, scale=ks, zero_point=kz)
        v2 = dataclasses.replace(jv, scale=vs, zero_point=vz)
        o = jqa.quantized_flash_attention(q_, k2, v2, bias_, mask=jm,
                                          **jopts)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jloss, argnums=tuple(range(len(jleaves))))(*jleaves)
    leaves = [t.clone().requires_grad_(True) for t in tleaves]
    kz = leaves[3] if fzp else tk.zero_point
    vz = leaves[4] if fzp else tv.zero_point
    k2 = dataclasses.replace(tk, scale=leaves[1], zero_point=kz)
    v2 = dataclasses.replace(tv, scale=leaves[2], zero_point=vz)
    o = tqa.quantized_flash_attention(
        leaves[0], k2, v2, leaves[-1] if "bias" in opts else None, mask=tm,
        **jopts)
    assert o.dtype == tq.dtype
    got = torch.autograd.grad((o.float() * tdo.float()).sum(), leaves)
    for g, w, t in zip(got, want, tleaves):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _err(g, w) <= _tol(qdtype), name


def test_facade_gradient_flows_to_q():
    """``QuantizedAttention`` (int8 CENTERED per token, causal): dq matches
    the JAX facade's ``jax.grad``."""
    rng = np.random.default_rng(8)
    q, k, v, do = (rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
                   for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    jbs = jfa.BlockSizes(block_q=128, block_kv=128)
    jf = jfacade.QuantizedAttention(mask=jmask.CAUSAL, block_sizes=jbs)
    tf = tfacade.QuantizedAttention(mask=tmask.CAUSAL)

    def jloss(q_):
        return jnp.sum(jf(q_, jnp.asarray(k), jnp.asarray(v)) * do)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jloss)(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_(True)
    o = tf(tq, torch.from_numpy(k), torch.from_numpy(v))
    (got,) = torch.autograd.grad((o * torch.from_numpy(do)).sum(), [tq])
    assert _err(got, want) <= TOLERANCES["fp32"]

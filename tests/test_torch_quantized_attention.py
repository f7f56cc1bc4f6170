"""Port parity for the quantized-attention forward: every mode of
``quantized_flash_attention_forward``, the packed head-pair API, their
errors and the differentiable wrapper, against the JAX package.

K/V are quantized once and handed to both sides, so both attend over the
same bytes.  The JAX side runs its Pallas kernels in interpret
mode at HIGHEST matmul precision; at these sizes (S ≤ 150) its grid has one
key tile, a one-pass softmax like the port's plain version.  Tolerances:

- an fp32 Q (dequant-on-load, ``quantize_q``, ``int8_pv``): O and L at
  TOLERANCES["fp32"] max abs (fp32 sums in another order; the int8 P of
  ``int8_pv`` rounds the same fp32 values on both sides);
- a bf16 Q, and the head-pair kernel (which rounds P to bf16 whatever Q's
  dtype): 2e-3 max abs.  P is rounded to bf16 from scores whose fp32 sums
  differ in the last bits, so an element of P may land on the neighbouring
  bf16 value (2⁻⁸ of itself) on one side: O moves by up to 2⁻⁸·p·|v|/l
  per such element, ~1e-4 at these inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jmask
from metal_flash_attention_plus_tpu.ops.flash_attention import (
    BlockSizes as JBlockSizes,
)
from metal_flash_attention_plus_tpu.ops import quantized_attention as jqa
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.attention import masking as tmask
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops import hadamard as thad
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    range_mask,
)
from metal_flash_attention_plus_tpu_torch.ops import quantized_attention as tqa
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
)

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

CASES = {
    # name: (b, hq, hkv, sq, skv, d, K config, V config, Q dtype, mask,
    #        options)
    "row8_full": (1, 4, 2, 128, 128, 64, ROW8C, ROW8C, "f32", "full", {}),
    "row8_causal": (1, 4, 2, 128, 128, 64, ROW8C, ROW8C, "f32", "causal", {}),
    "ten8_full": (1, 4, 2, 128, 128, 64, TEN8, TEN8, "f32", "full", {}),
    "ten8_causal": (1, 4, 2, 128, 128, 64, TEN8, TEN8, "f32", "causal", {}),
    "row4_full": (1, 4, 2, 128, 128, 64, ROW4C, ROW4C, "f32", "full", {}),
    "row4_causal": (1, 4, 2, 128, 128, 64, ROW4C, ROW4C, "f32", "causal",
                    {}),
    "block2d": (1, 4, 2, 128, 128, 64, B2D, B2D, "f32", "causal", {}),
    "quantize_q": (2, 4, 2, 128, 128, 64, ROW8, ROW8C, "f32", "causal",
                   dict(quantize_q=True)),
    "int8_pv_channel": (1, 4, 2, 128, 128, 64, ROW8, CH8, "f32", "causal",
                        dict(quantize_q=True)),
    "int8_pv_tensor_d128": (1, 4, 1, 128, 128, 128, TEN8, TEN8, "f32",
                            "causal", dict(quantize_q=True)),
    "int8_pv_int4_v": (1, 4, 2, 128, 128, 64, ROW8, CH4, "f32", "causal",
                       dict(quantize_q=True)),
    "folded_tensor_bf16": (1, 4, 2, 128, 128, 64, TEN8, CH8, "bf16",
                           "causal", {}),
    "folded_channel_bf16": (1, 4, 2, 128, 128, 64, CH8, TEN8, "bf16",
                            "causal", {}),
    "folded_row_bf16": (1, 4, 2, 128, 128, 64, ROW8, ROW8, "bf16", "full",
                        {}),
    "folded_row_interleaved_bf16": (1, 4, 2, 128, 128, 64, ROW8, ROW8,
                                    "bf16", "causal",
                                    dict(interleaved_kv=True)),
    "int8_pv_interleaved": (1, 4, 2, 128, 128, 64, ROW8, CH8, "f32",
                            "causal", dict(quantize_q=True,
                                           interleaved_kv=True)),
    "mixed_k8v4": (1, 4, 2, 128, 128, 64, ROW8C, ROW4C, "f32", "causal", {}),
    "hadamard": (1, 4, 2, 128, 128, 64, ROW4C, ROW4C, "f32", "causal",
                 dict(hadamard_block=64)),
    "bias": (2, 4, 2, 96, 128, 64, ROW8C, ROW8C, "f32", "causal",
             dict(bias=(1, 4, 96, 128))),
    "window": (1, 4, 2, 128, 128, 64, ROW8C, ROW8C, "f32", "window", {}),
    "gqa_interleaved": (1, 4, 2, 128, 128, 64, ROW8C, ROW8C, "f32", "causal",
                        dict(interleaved_kv=True)),
    "ragged": (1, 2, 1, 100, 150, 32, ROW8C, ROW8C, "f32", "causal", {}),
    # Head dims the kernels are not built for (run zero-padded on the card).
    "quantize_q_d80": (1, 4, 2, 128, 128, 80, ROW8, ROW8, "f32", "causal",
                       dict(quantize_q=True)),
    "quantize_q_d96_bf16": (1, 4, 2, 128, 128, 96, ROW8, ROW8, "bf16",
                            "causal", dict(quantize_q=True)),
    "row4_d96": (1, 4, 2, 128, 128, 96, ROW4C, ROW4C, "f32", "causal", {}),
    # MLA's width 288 (a 256 latent + 32 RoPE lanes: an int4 row packs as
    # two groups) and 272, which the card runs zero-padded at 288.
    "row8_d288": (1, 2, 1, 128, 128, 288, ROW8C, ROW8C, "f32", "causal", {}),
    "row4_d288": (1, 2, 1, 128, 128, 288, ROW4C, ROW4C, "f32", "causal", {}),
    "block2d_d288": (1, 2, 1, 128, 128, 288, B2D, B2D, "f32", "causal", {}),
    "int8_pv_channel_d288": (1, 2, 1, 128, 128, 288, ROW8, CH8, "f32",
                             "causal", dict(quantize_q=True)),
    "folded_row_d288_bf16": (1, 2, 1, 128, 128, 288, ROW8, ROW8, "bf16",
                             "full", {}),
    "row4_d272": (1, 2, 1, 128, 128, 272, ROW4C, ROW4C, "f32", "causal", {}),
    "quantize_q_d272_bf16": (1, 2, 1, 128, 128, 272, ROW8, ROW8, "bf16",
                             "causal", dict(quantize_q=True)),
    # DeepSeek's absorbed width 576 (a 512 latent + 64 RoPE lanes: an int4
    # row packs as three groups, 128 + 128 + 32 bytes) and the 512 latent,
    # which the card runs zero-padded at 576.
    "row8_d576": (1, 2, 1, 128, 128, 576, ROW8C, ROW8C, "f32", "causal", {}),
    "row4_d576": (1, 2, 1, 128, 128, 576, ROW4C, ROW4C, "f32", "causal", {}),
    "block2d_d576": (1, 2, 1, 128, 128, 576, B2D, B2D, "f32", "causal", {}),
    "int8_pv_channel_d576": (1, 2, 1, 128, 128, 576, ROW8, CH8, "f32",
                             "causal", dict(quantize_q=True)),
    "folded_row_d576_bf16": (1, 2, 1, 128, 128, 576, ROW8, ROW8, "bf16",
                             "full", {}),
    "quantize_q_d576_bf16": (1, 2, 1, 128, 128, 576, ROW8, ROW8, "bf16",
                             "causal", dict(quantize_q=True)),
    "row8_d512": (1, 2, 1, 128, 128, 512, ROW8C, ROW8C, "f32", "causal", {}),
    "row4_d512": (1, 2, 1, 128, 128, 512, ROW4C, ROW4C, "f32", "causal", {}),
    "block2d_d512": (1, 2, 1, 128, 128, 512, B2D, B2D, "f32", "causal", {}),
    "int8_pv_channel_d512": (1, 2, 1, 128, 128, 512, ROW8, CH8, "f32",
                             "causal", dict(quantize_q=True)),
    "folded_row_d512_bf16": (1, 2, 1, 128, 128, 512, ROW8, ROW8, "bf16",
                             "full", {}),
    "quantize_q_d512_bf16": (1, 2, 1, 128, 128, 512, ROW8, ROW8, "bf16",
                             "causal", dict(quantize_q=True)),
}


def _quantized(x, cfg, hadamard_block=None):
    """(JAX QuantizedTensor, the port's) over the same bytes: the port
    quantizes (its ``quantize`` is the JAX package's golden, byte for
    byte, ``tests/test_torch_quant.py``) and the JAX side wraps the
    arrays."""
    t = torch.from_numpy(x)
    if hadamard_block:
        t = thad.hadamard_transform(t, hadamard_block)
    tq = ttensor.quantize(t, tparams.QuantConfig(
        bits=cfg.bits, granularity=tparams.QuantGranularity(
            cfg.granularity.value),
        strategy=tparams.QuantStrategy(cfg.strategy.value),
        block_size=cfg.block_size, block_rows=cfg.block_rows))
    jq = jtensor.QuantizedTensor(
        data=jnp.asarray(tq.data.numpy()), scale=jnp.asarray(tq.scale.numpy()),
        zero_point=jnp.asarray(tq.zero_point.numpy()), sums=None, config=cfg,
        shape=tuple(tq.shape))
    return jq, tq


def _inputs(rng, b, hq, hkv, sq, skv, d, kcfg, vcfg, qdtype, hb=None):
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    dt = (jnp.bfloat16, torch.bfloat16) if qdtype == "bf16" else (
        jnp.float32, torch.float32)
    jk, tk = _quantized(k, kcfg, hb)
    jv, tv = _quantized(v, vcfg, hb)
    return ((jnp.asarray(q).astype(dt[0]), jk, jv),
            (torch.from_numpy(q).to(dt[1]), tk, tv))


def _max_err(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    return float(np.max(np.abs(got[fin] - want[fin])))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_mode_matches_jax(name):
    b, hq, hkv, sq, skv, d, kcfg, vcfg, qdtype, mask, opts = CASES[name]
    rng = np.random.default_rng(len(name))
    opts = dict(opts)
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, b, hq, hkv, sq, skv, d, kcfg, vcfg, qdtype,
        opts.get("hadamard_block"))
    jopts, topts = dict(opts), dict(opts)
    if "bias" in opts:
        bias = rng.standard_normal(opts["bias"]).astype(np.float32)
        jopts["bias"], topts["bias"] = jnp.asarray(bias), torch.from_numpy(
            bias)
    with jax.default_matmul_precision("highest"):
        jo, jl = jqa.quantized_flash_attention_forward(
            jq, jk, jv, mask=MASKS[mask][0], **jopts)
    to, tl = tqa.quantized_flash_attention_forward(
        tq, tk, tv, mask=MASKS[mask][1], **topts)
    assert to.dtype == torch.float32 and tl.shape == (b, hq, sq)
    tol = BF16_TOL if qdtype == "bf16" else TOLERANCES["fp32"]
    assert _max_err(to, jo) <= tol
    assert _max_err(tl, jl) <= tol


B2D16 = _cfg(gran="block_2d", strategy="centered", block_rows=8,
             block_size=16)
# 48-wide blocks tile D=96 but not its kernel width 128.
B2D48 = _cfg(gran="block_2d", strategy="centered", block_rows=8,
             block_size=48)
PADDED = {  # name: (head dim, K config, V config, Q dtype, options)
    "quantize_q_d80": (80, ROW8, ROW8, "f32", dict(quantize_q=True)),
    "int8_pv_channel_d96": (96, ROW8, CH8, "f32", dict(quantize_q=True)),
    "int4_token_d80": (80, ROW4C, ROW4C, "f32", {}),
    "block2d_d80": (80, B2D16, B2D16, "f32", {}),
    "block2d48_d96": (96, B2D48, B2D48, "f32", {}),
    "folded_channel_d48_bf16": (48, CH8, TEN8, "bf16", {}),
    # 272 at MLA's 288: the int4 row repacked as two groups (128 + 16
    # bytes), BLOCK_2D 16-wide cells.
    "int4_token_d272": (272, ROW4C, ROW4C, "f32", {}),
    "block2d16_d272": (272, B2D16, B2D16, "f32", {}),
    "int8_pv_channel_d272": (272, ROW8, CH8, "f32", dict(quantize_q=True)),
    # 512 and 320 at DeepSeek's 576: the int4 row repacked from two groups
    # (or one plus a tail) as three, BLOCK_2D 16-wide cells, the int8 P.
    "int4_token_d512": (512, ROW4C, ROW4C, "f32", {}),
    "int4_token_d320": (320, ROW4C, ROW4C, "f32", {}),
    "block2d16_d320": (320, B2D16, B2D16, "f32", {}),
    "int8_pv_channel_d512": (512, ROW8, CH8, "f32", dict(quantize_q=True)),
    "folded_row_d512_bf16": (512, ROW8, ROW8, "bf16", {}),
}


@pytest.mark.parametrize("name", sorted(PADDED))
def test_kernel_width_padding_changes_nothing(name):
    """On the card a head dim outside HEAD_DIMS runs at ``qattn_width``
    over ``pad_qattn_arguments``' tensors.  The plain version over those,
    its O cut back to the head dim, computes what it computes over the
    originals (fp32 sums in another order: the fp32 / bf16 gates).  The
    int4 payload is repacked, not extended, and BLOCK_2D lanes past the
    head dim dequantize to exactly 0."""
    d, kcfg, vcfg, qdtype, opts = PADDED[name]
    _, (tq, tk, tv) = _inputs(np.random.default_rng(d), 1, 4, 2, 64, 96, d,
                              kcfg, vcfg, qdtype)
    args, kw = tqa.qattn_arguments(tq, tk, tv, mask=tmask.CAUSAL, **opts)
    mode, w = kw["mode"], tqa.qattn_width(d)
    q, q_scales, kq, vq, kp, vp, rr = args
    pq, pkq, pvq, pkp, pvp = tqa.pad_qattn_arguments(q, kq, vq, kp, vp, mode)
    assert pq.shape[-1] == w and torch.equal(pq[..., :d], q)
    for orig, padded, bits in ((kq, pkq, mode.bits_k), (vq, pvq, mode.bits_v)):
        ints = ttensor.unpack_int4 if bits == 4 else (lambda t: t)
        assert padded.shape[-1] == (w if bits == 8 else w // 2)
        assert torch.equal(ints(padded)[..., :d], ints(orig))
        assert not ints(padded)[..., d:].any()
    if mode.k_scales == "block2d":
        lanes = tqa._kv_values(pkq, *pkp, "block2d", 8, w, mode.block,
                               torch.float32)
        assert not lanes[..., d:].any()
    o, lse = tqa.qattn_fwd_plain(*args, **kw)
    po, pl = tqa.qattn_fwd_plain(pq, q_scales, pkq, pvq, pkp, pvp, rr, **kw)
    tol = BF16_TOL if qdtype == "bf16" else TOLERANCES["fp32"]
    assert (po[..., :d] - o).abs().max() <= tol * o.abs().max()
    assert (pl - lse).abs().max() <= tol


def test_kernel_width_padding_of_untiled_blocks_and_widths():
    s = torch.full((1, 1, 4, 1), 3.0)
    # A 96-wide block does not tile 128: one cell, cut short, over lanes
    # 96-127, of scale 1 and zero point 0.
    ps, pz = tqa.pad_scales((s, s), "block2d", 96, 128, (8, 96))
    assert torch.equal(ps[..., 1], torch.ones(1, 1, 4))
    assert torch.equal(pz[..., 1], torch.zeros(1, 1, 4))
    assert torch.equal(ps[..., :1], s) and ps.shape[-1] == 2
    # 272 runs at MLA's 288, 304 to 560 at DeepSeek's 576; past 576 the
    # split-D kernels, at the next multiple of 16.
    assert tqa.qattn_width(272) == tqa.qattn_width(288) == 288
    for d in (304, 320, 512, 560, 576):
        assert tqa.qattn_width(d) == 576
    for d, w in ((577, 592), (580, 592), (592, 592), (1024, 1024),
                 (1025, 1040)):
        assert tqa.qattn_width(d) == w
    assert [tqa.qattn_width(d) for d in (16, 48, 64, 80, 96, 144, 256)] == [
        32, 64, 64, 128, 128, 256, 256]
    # Head dims off the multiples of 16 run at the next width too.
    assert [tqa.qattn_width(d) for d in (1, 8, 20, 33, 40, 72, 300)] == [
        32, 32, 32, 64, 64, 128, 576]
    with pytest.raises(ValueError):
        tqa.qattn_width(0)


@pytest.mark.parametrize("d", [64, 256, 272, 288, 320, 512, 576])
@pytest.mark.parametrize("qdtype", ["f32", "bf16", "int8"])
def test_qattn_body_names_the_wide_kernel_at_288(qdtype, d):
    """A bf16 or int8 Q rounding to bf16 takes the 64-key tensor-core
    kernel up to kernel width 256, the wide one (32-key steps) at 288,
    where 272 runs too, and the latent one (O's lanes over two warp groups)
    at 576, where 320 and 512 run too; an fp32 Q takes the scalar body at
    every width; without the head dim the answer names the body alone;
    past 576 every Q takes the split-D kernel."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[qdtype]
    mode = tqa.QAttnMode("token", "token",
                         round_bf16=dtype != torch.float32)
    want = ("fp32_fma" if dtype == torch.float32 else
            "tensor_core_latent" if d > 288 else
            "tensor_core_wide" if d > 256 else "tensor_core")
    assert tqa.qattn_body(dtype, mode, d=d) == want
    assert tqa.qattn_body(dtype, mode) == (
        "fp32_fma" if want == "fp32_fma" else "tensor_core")
    assert tqa.qattn_body(dtype, mode, d=d + 580) == "split_d"


@pytest.mark.parametrize("quantize_q", [False, True])
def test_latent_width_keeps_the_true_head_dims_l_rounded(quantize_q):
    """l sums the rounded P where the TPU kernel's ones-lane rowsum did:
    at a head dim that is not a multiple of 128.  576 and 320 are not, 512
    is; a 512 latent runs at 576 on the card and keeps 512's rule, chosen
    from the true head dim before the padding (bf16 Q; per-token K and V
    dequantized, or an int8 Q over SYMMETRIC ROW K and V)."""
    cfg = ROW8 if quantize_q else ROW8C
    for d, want in ((576, True), (320, True), (512, False), (288, True),
                    (256, False)):
        _, (tq, tk, tv) = _inputs(np.random.default_rng(d), 1, 2, 1, 32, 32,
                                  d, cfg, cfg, "bf16")
        args, kw = tqa.qattn_arguments(tq, tk, tv, mask=tmask.CAUSAL,
                                       quantize_q=quantize_q)
        assert kw["mode"].l_rounded == want, d
        assert tqa.qattn_width(d) in (256, 288, 576)
        pq, pkq, pvq, pkp, pvp = tqa.pad_qattn_arguments(
            args[0], args[2], args[3], args[4], args[5], kw["mode"])
        o, lse = tqa.qattn_fwd_plain(*args, **kw)
        po, pl = tqa.qattn_fwd_plain(pq, args[1], pkq, pvq, pkp, pvp,
                                     args[6], **kw)
        assert (po[..., :d] - o).abs().max() <= BF16_TOL * o.abs().max()
        assert (pl - lse).abs().max() <= BF16_TOL


@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mask", ["full", "causal"])
def test_packed_api_matches_jax(mask, bits, qdtype):
    rng = np.random.default_rng(bits + len(mask) + len(qdtype))
    kcfg = CH8 if bits == 8 else CH4
    vcfg = TEN8 if bits == 8 else _cfg(bits=4, gran="tensor")
    (jq, jk, jv), (tq, tk, tv) = _inputs(rng, 2, 4, 2, 128, 128, 64, kcfg,
                                         vcfg, qdtype)
    with jax.default_matmul_precision("highest"):
        jo, jl = jqa.quantized_flash_attention_forward_packed(
            jqa.pack_heads(jq), jk, jv, mask=MASKS[mask][0])
    tqp = tqa.pack_heads(tq)
    assert torch.equal(tqa.unpack_heads(tqp), tq)
    to, tl = tqa.quantized_flash_attention_forward_packed(
        tqp, tk, tv, mask=MASKS[mask][1])
    assert to.shape == (2, 2, 128, 128) and tl.shape == (2, 4, 128)
    assert _max_err(to, jo) <= BF16_TOL
    assert _max_err(tl, jl) <= BF16_TOL


def test_unpacked_api_takes_the_head_pair_kernel():
    """FULL, d=64, folded TENSOR/CHANNEL scales: both packages route the
    natural-layout call through the head-pair kernel."""
    rng = np.random.default_rng(7)
    (jq, jk, jv), (tq, tk, tv) = _inputs(rng, 1, 4, 2, 128, 256, 64, TEN8,
                                         CH8, "bf16")
    with jax.default_matmul_precision("highest"):
        jo, jl = jqa.quantized_flash_attention_forward(jq, jk, jv)
    to, tl = tqa.quantized_flash_attention_forward(tq, tk, tv)
    po, pl = tqa.quantized_flash_attention_forward_packed(
        tqa.pack_heads(tq), tk, tv)
    assert torch.equal(to, tqa.unpack_heads(po)) and torch.equal(tl, pl)
    assert _max_err(to, jo) <= BF16_TOL
    assert _max_err(tl, jl) <= BF16_TOL


def test_folded_channel_k_with_interleaved_gqa_matches_dense():
    """Held to the dense attention over the dequantized K/V, not to the
    JAX call: the JAX package folds CHANNEL K scales into Q by the grouped
    head mapping even when ``interleaved_kv`` (ROADMAP §3).  Tolerance
    1e-2 max abs: Q·scale·log2e·s_k and P are rounded to bf16 here, not in
    the dense fp32 attention (4e-3 measured)."""
    _, (tq, tk, tv) = _inputs(np.random.default_rng(0), 1, 4, 2, 128, 128,
                              64, CH8, TEN8, "bf16")
    got, _ = tqa.quantized_flash_attention_forward(
        tq, tk, tv, mask=tmask.CAUSAL, interleaved_kv=True)
    want, _ = reference_attention(tq.float(), tk.dequantize(),
                                  tv.dequantize(), mask=tmask.CAUSAL,
                                  interleaved_kv=True)
    assert (got - want).abs().max().item() <= 1e-2


@pytest.mark.parametrize("mask", ["full", "causal"])
def test_int8_p_over_several_key_tiles_matches_jax(mask):
    """Over several key tiles the int8 P of ``int8_pv`` rounds against the
    running row max, in the JAX kernel (its 128-key inner tiles here) and
    in the plain version with ``kv_tile`` (the kernel's tiling, 64 keys,
    on the card); in one pass O lands ~1e-2 away at these sizes.  Seed 0
    has no P within fp32 noise of a half-integer, which would round either
    way and move O by ~4e-4 (two of eight seeds have one)."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _inputs(rng, 1, 2, 2, 384, 384, 64, ROW8,
                                         CH8, "f32")
    with jax.default_matmul_precision("highest"):
        jo, jl = jqa.quantized_flash_attention_forward(
            jq, jk, jv, mask=MASKS[mask][0], quantize_q=True,
            block_sizes=JBlockSizes(block_q=128, block_kv=128))
    args, kw = tqa.qattn_arguments(tq, tk, tv, mask=MASKS[mask][1],
                                   quantize_q=True)
    assert kw["mode"].p_int8
    to, tl = tqa.qattn_fwd_plain(*args, **kw, kv_tile=128)
    one_pass, _ = tqa.qattn_fwd_plain(*args, **kw)
    assert _max_err(to, jo) <= TOLERANCES["fp32"]
    assert _max_err(tl, jl) <= TOLERANCES["fp32"]
    assert _max_err(one_pass, jo) > 10 * TOLERANCES["fp32"]
    assert torch.equal(tqa.qattn_fwd_plain(*args, **kw, kv_tile=384)[0],
                       one_pass)


def _online(args, kw, sq, skv):
    """The kernel's softmax, written as a loop: each block of 64 query rows
    walks 64-key tiles aligned to multiples of 64, from the one holding its
    first live key, P rounded against the running max, earlier tiles
    rescaled."""
    q_in, q_sc, kd, vd, k_par, v_par, rr = args
    mode = kw["mode"]
    s = q_in.float() @ kd.float().transpose(-1, -2)
    if q_sc is not None:
        s = s * q_sc[..., None] * k_par[0][:, :, None, :]
    keep, live = range_mask(rr, skv)
    s = torch.where(keep, s, torch.full_like(s, kw["mask_value"]))
    v = vd.float()
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    lsum = torch.zeros(*s.shape[:-1], 1)
    for r0 in range(0, sq, 64):
        rows = slice(r0, min(r0 + 64, sq))
        starts = [int(a) for a, b in rr[rows].tolist() if b > a]
        m = torch.full((*s.shape[:2], rows.stop - r0, 1), -float("inf"))
        acc, l = torch.zeros_like(o[:, :, rows]), torch.zeros_like(m)
        for t0 in range(min(starts, default=skv) // 64 * 64, skv, 64):
            st = s[:, :, rows, t0:t0 + 64]
            m_next = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.where(torch.isinf(m), torch.zeros_like(m),
                                torch.exp2(m - m_next))
            if mode.p_int8:
                raw = torch.exp2(st + (tqa.LOG2_127 - m_next))
                p = torch.floor(raw + 0.5)
            else:
                raw = torch.exp2(st - m_next)
                p = raw.to(torch.bfloat16).float()
            l = alpha * l + (p if mode.l_rounded else raw).sum(-1, True)
            acc = alpha * acc + p @ v[:, :, t0:t0 + 64]
            m = m_next
        o[:, :, rows], lsum[:, :, rows] = acc / l, l
    if mode.v_scales == "store":
        o = o * v_par[0][:, :, None, :]
    return torch.where(live & (lsum > 0), o, torch.zeros_like(o))


@pytest.mark.parametrize("quantize_q", [True, False],
                         ids=["int8_p", "bf16_p"])
def test_tiled_plain_version_is_the_online_softmax(quantize_q):
    """``kv_tile=KV_TILE`` gives what the kernel's loop gives, under a
    sliding window whose row blocks start at different key tiles; the
    wrapper on CPU tensors takes the kernel's tiles without being told."""
    _, (tq, tk, tv) = _inputs(np.random.default_rng(3), 1, 2, 2, 200, 200,
                              64, ROW8 if quantize_q else TEN8, CH8, "bf16")
    mask = tmask.sliding_window(96, causal=True)
    args, kw = tqa.qattn_arguments(tq, tk, tv, mask=mask,
                                   quantize_q=quantize_q)
    assert kw["mode"].p_int8 == quantize_q and kw["mode"].v_scales == "store"
    got, _ = tqa.qattn_fwd_plain(*args, **kw, kv_tile=tqa.KV_TILE)
    want = _online(args, kw, 200, 200)
    assert (got - want).abs().max().item() <= TOLERANCES["fp32"]
    assert torch.equal(tqa.qattn_fwd(*args, **kw)[0], got)


@pytest.mark.parametrize("block_kv", [128, 256])
@pytest.mark.parametrize("mask", ["full", "causal"])
def test_int8_p_rounds_over_the_tpu_key_tiles(mask, block_kv):
    """The forward resolves ``block_kv`` from ``block_sizes`` as the JAX
    package does and rounds the int8 P over those spans (4 and 2 key tiles
    of 512 keys here), as the JAX kernel does; a one-pass softmax lands
    well away.  Seed 1 has no P within fp32 noise of a half-integer."""
    rng = np.random.default_rng(1)
    (jq, jk, jv), (tq, tk, tv) = _inputs(rng, 1, 2, 2, 256, 512, 64, ROW8,
                                         CH8, "f32")
    with jax.default_matmul_precision("highest"):
        jo, jl = jqa.quantized_flash_attention_forward(
            jq, jk, jv, mask=MASKS[mask][0], quantize_q=True,
            block_sizes=JBlockSizes(block_q=128, block_kv=block_kv))
    to, tl = tqa.quantized_flash_attention_forward(
        tq, tk, tv, mask=MASKS[mask][1], quantize_q=True,
        block_sizes=BlockSizes(block_q=128, block_kv=block_kv))
    assert tqa.int8_p_tile(BlockSizes(block_kv=block_kv), 512) == block_kv
    assert _max_err(to, jo) <= TOLERANCES["fp32"]
    assert _max_err(tl, jl) <= TOLERANCES["fp32"]
    args, kw = tqa.qattn_arguments(tq, tk, tv, mask=MASKS[mask][1],
                                   quantize_q=True)
    one_pass, _ = tqa.qattn_fwd_plain(*args, **kw)
    assert _max_err(one_pass, jo) > 10 * TOLERANCES["fp32"]


ERRORS = {
    # name: (K config, V config, Q dtype, options, error)
    "quantize_q_centered_k": (ROW8C, ROW8, "f32", dict(quantize_q=True),
                              ValueError),
    "channel_v_without_fold": (ROW8, CH8, "f32", {}, ValueError),
    "block2d_k_row_v": (B2D, ROW8, "f32", {}, ValueError),
    "channel_k_dequant": (CH8, ROW8C, "f32", {}, NotImplementedError),
    "quantize_q_block2d_v": (ROW8, B2D, "f32", dict(quantize_q=True),
                             NotImplementedError),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_mode_preconditions_raise_as_in_jax(name):
    kcfg, vcfg, qdtype, opts, err = ERRORS[name]
    (jq, jk, jv), (tq, tk, tv) = _inputs(np.random.default_rng(0), 1, 2, 1,
                                         64, 64, 64, kcfg, vcfg, qdtype)
    with pytest.raises(err):
        jqa.quantized_flash_attention_forward(jq, jk, jv, **opts)
    with pytest.raises(err):
        tqa.quantized_flash_attention_forward(tq, tk, tv, **opts)


@pytest.mark.parametrize("case", ["d32", "window", "row_k"])
def test_packed_api_preconditions_raise(case):
    d = 32 if case == "d32" else 64
    kcfg = ROW8 if case == "row_k" else CH8
    _, (tq, tk, tv) = _inputs(np.random.default_rng(1), 1, 2, 2, 128, 128, d,
                              kcfg, TEN8, "f32")
    mask = MASKS["window" if case == "window" else "causal"][1]
    with pytest.raises(ValueError):
        tqa.quantized_flash_attention_forward_packed(
            tqa.pack_heads(tq), tk, tv, mask=mask)


def test_differentiable_wrapper_forward_and_backward_raise():
    """The differentiable wrapper's forward is the forward's O in q's
    dtype, and its backward (which raised before the quantized backward
    was ported) now gives the JAX package's dq at TOLERANCES["fp32"]
    (max abs over the JAX value's max abs)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(np.random.default_rng(2), 1, 2, 1,
                                         64, 64, 64, ROW8C, ROW8C, "f32")
    tq.requires_grad_(True)
    o = tqa.quantized_flash_attention(tq, tk, tv, mask=tmask.CAUSAL)
    want, _ = tqa.quantized_flash_attention_forward(tq.detach(), tk, tv,
                                                    mask=tmask.CAUSAL)
    assert o.dtype == tq.dtype and torch.equal(o.detach(), want)
    o.sum().backward()
    with jax.default_matmul_precision("highest"):
        jdq = jax.grad(lambda q_: jnp.sum(jqa.quantized_flash_attention(
            q_, jk, jv, mask=jmask.CAUSAL)))(jq)
    jdq = np.asarray(jdq)
    err = np.abs(tq.grad.numpy() - jdq).max() / np.abs(jdq).max()
    assert err <= TOLERANCES["fp32"]


# name: (K config, V config, Q dtype, options, the body qattn_fwd runs).
BODIES = {
    "bf16_dequant_row": (ROW8C, ROW8C, "bf16", {}, "tensor_core"),
    "bf16_folded_tensor": (TEN8, CH8, "bf16", {}, "tensor_core"),
    "bf16_block2d_int4": (B2D, B2D, "bf16", {}, "tensor_core"),
    "int8_q_row": (ROW8, ROW8, "bf16", dict(quantize_q=True), "tensor_core"),
    "int8_q_int8_p": (ROW8, CH8, "bf16", dict(quantize_q=True),
                      "tensor_core"),
    "f32_dequant_row": (ROW8C, ROW8C, "f32", {}, "fp32_fma"),
    "f32_quantize_q": (ROW8, CH4, "f32", dict(quantize_q=True), "fp32_fma"),
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_kernel_body_follows_q_dtype_and_mode(name):
    """``qattn_body`` routes as the C interface does: the tensor-core body
    for a bf16 or int8 Q whose products round to bf16, the fp32-FMA body
    for an fp32 Q (``quantize_q`` makes it int8 but keeps the compute dtype
    fp32, so P stays unrounded).  The head-pair call, whose packed Q is
    bf16 or fp32 and whose mode always rounds to bf16, takes the
    tensor-core body for a bf16 Q and the fp32-FMA body for an fp32 one."""
    kcfg, vcfg, qdtype, opts, want = BODIES[name]
    _, (tq, tk, tv) = _inputs(np.random.default_rng(3), 1, 2, 1, 64, 64, 64,
                              kcfg, vcfg, qdtype)
    args, kw = tqa.qattn_arguments(tq, tk, tv, **opts)
    assert args[0].dtype == (torch.int8 if opts else tq.dtype)
    assert kw["mode"].round_bf16 == (tq.dtype != torch.float32)
    assert tqa.qattn_body(args[0].dtype, kw["mode"]) == want
    assert tqa.qattn_body(tq.dtype, kw["mode"], packed=True) == (
        "tensor_core" if tq.dtype == torch.bfloat16 else "fp32_fma")

"""Port parity of the quantized attention above head dim 576.

On the card every head dim above DeepSeek's absorbed 576 runs the split-D
kernels (``csrc/split_d_quantized.cu``, ``csrc/split_d_quantized_bwd.cu``:
O's, dQ's, dK's and dV's lanes split over CTAs, 256 a CTA) at the next
multiple of 16.  Here, on the CPU, the port's wrappers take their plain
versions; the same seeded numpy inputs go through the JAX package (Pallas
in interpret mode, HIGHEST matmul precision) and the port: the quantized
forward in its modes (int8 and int4 ROW, BLOCK_2D blocks of 80 lanes that
straddle the 256-lane slices, an int8 Q with bf16 and with int8 P over two
128-key spans), ``l_rounded`` true (608, 592: not multiples of 128) and
false (640); the exact backward; the full-integer backward at levels 1 and
2; and ``quantized_forward(..., quantize_kv=True)`` of a 2-layer model at
head dim 640.

Tolerances (max abs error over the JAX value's max abs, as the other
parity files): fp32 at TOLERANCES["fp32"] (2e-5), a bf16 Q (and the
full-integer backward) at 2e-3, as tests/test_torch_quantized_backward.py
states; the model's logits at 1e-3 rel L2 on weights and tokens where no
value quantized at run time lies within fp32 noise of a rounding boundary,
as tests/test_torch_quantized_attention_model.py explains.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jm
from metal_flash_attention_plus_tpu.models import quantized_inference as jqi
from metal_flash_attention_plus_tpu.models import transformer as jtf
from metal_flash_attention_plus_tpu.ops import quantized_attention as jqa
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.attention import masking as tm
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
from metal_flash_attention_plus_tpu_torch.ops import flash_attention_bwd as tbwd
from metal_flash_attention_plus_tpu_torch.ops import quantized_attention as tqa
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

jfa = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention")
tfa = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")
jbwd = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention_bwd")

TOL = TOLERANCES["fp32"]
BF16_TOL = 2e-3
LOGIT_REL_L2 = 1e-3
JBS = jfa.BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                     block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)
TBS = tqa.BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                     block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)


def _rel(got, want):
    """Max abs error over the JAX value's max abs (fp32 views)."""
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfg(bits=8, gran="row", strategy="symmetric", **kw):
    return jparams.QuantConfig(
        bits=bits, granularity=jparams.QuantGranularity(gran),
        strategy=jparams.QuantStrategy(strategy), **kw)


ROW8, ROW8C, ROW4C, CH8 = (_cfg(), _cfg(strategy="centered"),
                           _cfg(bits=4, strategy="centered"),
                           _cfg(gran="channel"))
# 80-lane blocks: at 640 the cells over lanes 240-319 and 480-559 straddle
# the split-D kernels' 256-lane slices.
B2D80 = _cfg(gran="block_2d", strategy="centered", block_rows=8,
             block_size=80)


def _quantized(x, cfg):
    """(JAX QuantizedTensor, the port's) over the same bytes."""
    tq = ttensor.quantize(torch.from_numpy(x), tparams.QuantConfig(
        bits=cfg.bits,
        granularity=tparams.QuantGranularity(cfg.granularity.value),
        strategy=tparams.QuantStrategy(cfg.strategy.value),
        block_size=cfg.block_size, block_rows=cfg.block_rows))
    jq = jtensor.QuantizedTensor(
        data=jnp.asarray(tq.data.numpy()), scale=jnp.asarray(tq.scale.numpy()),
        zero_point=jnp.asarray(tq.zero_point.numpy()), sums=None, config=cfg,
        shape=tuple(tq.shape))
    return jq, tq


def _qinputs(seed, hq, hkv, s, d, kcfg, vcfg, qdtype):
    """((q, K, V, dO) JAX, the same port), B=1."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, hq, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if qdtype == "bf16"
                else (jnp.float32, torch.float32))
    (jk, tk), (jv, tv) = _quantized(k, kcfg), _quantized(v, vcfg)
    return ((jnp.asarray(q).astype(jdt), jk, jv, jnp.asarray(do).astype(jdt)),
            (torch.from_numpy(q).to(tdt), tk, tv,
             torch.from_numpy(do).to(tdt)))


QFWD = {  # name: (head dim, S, K, V, Q dtype, options)
    "int8_row_centered_d608": (608, 96, ROW8C, ROW8C, "bf16", {}),
    "int4_row_f32_d640": (640, 96, ROW4C, ROW4C, "f32", {}),
    "int4_row_d592": (592, 64, ROW4C, ROW4C, "bf16", {}),
    "block2d80_d640": (640, 96, B2D80, B2D80, "bf16", {}),
    "int8_q_f32_d608": (608, 96, ROW8, ROW8, "f32", dict(quantize_q=True)),
    "int8_p_two_spans_d640": (640, 130, ROW8, CH8, "bf16",
                              dict(quantize_q=True)),
}


@pytest.mark.parametrize("name", sorted(QFWD))
def test_quantized_forward_past_576_matches_jax(name):
    """O and L (Hq=2 over one KV head, causal).  ``l_rounded`` comes from
    the true head dim in both packages: true at 592 and 608, false at 640;
    the int8 P rounds over the TPU's 128-key block_kv spans (two at
    S=130)."""
    d, s, kcfg, vcfg, qdtype, opts = QFWD[name]
    (jq, jk, jv, _), (tq, tk, tv, _) = _qinputs(d, 2, 1, s, d, kcfg, vcfg,
                                                 qdtype)
    with jax.default_matmul_precision("highest"):
        jo, jl = jqa.quantized_flash_attention_forward(
            jq, jk, jv, mask=jm.CAUSAL, block_sizes=JBS, interpret=True,
            **opts)
    to, tl = tqa.quantized_flash_attention_forward(
        tq, tk, tv, mask=tm.CAUSAL, block_sizes=TBS, **opts)
    tol = BF16_TOL if qdtype == "bf16" else TOL
    assert _rel(to, jo) <= tol and _rel(tl, jl) <= tol
    args, kw = tqa.qattn_arguments(tq, tk, tv, mask=tm.CAUSAL, **opts)
    mode = kw["mode"]
    assert tqa.qattn_width(d) == d
    assert tqa.qattn_body(args[0].dtype, mode, d=d) == "split_d"
    if mode.v_scales != "p" and not mode.p_int8:
        assert mode.l_rounded == (d % 128 != 0)


# (mode, key span, d, batch, q heads, Sq, Skv) -> runs on 132 SMs
QFWD_SPLIT_PLANS = {
    # QuantizedAttention's default (int8 ROW CENTERED K/V) at Perceiver
    # IO's image cross-attention: 32 CTAs, 8 runs of 98 key tiles.
    "perceiver_facade": (tqa.QAttnMode("token", "token"), 64, 1024, 1, 1,
                         512, 224 * 224, 8),
    "perceiver_folded_store": (tqa.QAttnMode("none", "store"), 64, 1024, 1,
                               1, 512, 224 * 224, 8),
    "perceiver_int8_q_bf16_p": (tqa.QAttnMode("column", "p"), 64, 1024, 1,
                                1, 512, 224 * 224, 8),
    # An int8 P keeps one walk: its integers round against the running max.
    "perceiver_int8_p": (tqa.QAttnMode("column", "store", p_int8=True), 512,
                         1024, 1, 1, 512, 224 * 224, 1),
    "int8_p_64_key_spans": (tqa.QAttnMode("column", "store", p_int8=True),
                            64, 1024, 1, 1, 512, 224 * 224, 1),
    # The trio (B=2, 16 q heads, S=2048) fills the card unsplit.
    "trio_d640": (tqa.QAttnMode("column", "p"), 64, 640, 2, 16, 2048, 2048,
                  1),
    "trio_d1024": (tqa.QAttnMode("token", "token"), 64, 1024, 2, 16, 2048,
                   2048, 1),
    # 576 runs the fixed-width kernels.
    "latent_d576": (tqa.QAttnMode("token", "token"), 64, 576, 1, 1, 512,
                    224 * 224, 1),
}


@pytest.mark.parametrize("name", sorted(QFWD_SPLIT_PLANS))
def test_quantized_forward_split_plan(name):
    """The runs ``qattn_fwd`` splits the KV axis into above 576, from
    shapes alone (``qattn_splits`` over ``split_d_fwd_splits``)."""
    *args, want = QFWD_SPLIT_PLANS[name]
    assert tqa.qattn_splits(*args, 132) == want


@pytest.mark.parametrize("runs", [2, 3, 8])
def test_aligned_runs_deal_each_span_in_whole_tiles(runs):
    """``split_d_fwd_runs`` as the quantized forward walks (each 64-row
    tile's span from the multiple of 64 below its first key): every key
    of a tile's span in exactly one run, the runs consecutive and of whole
    64-key tiles, ``ceil(tiles / runs)`` each, none outside the span; an
    empty row's tile keeps the others' span."""
    sq, skv = 200, 1000
    ranges = np.stack([np.arange(sq) * 3 + 37, np.arange(sq) * 3 + 300],
                      axis=1).astype(np.int32)
    ranges[70] = (5, 5)
    rr = torch.from_numpy(ranges)
    run = tfa.split_d_fwd_runs(rr, skv, runs, aligned=True)
    for t in range(-(-sq // 64)):
        rows = ranges[t * 64:(t + 1) * 64]
        live = rows[rows[:, 1] > rows[:, 0]]
        lo, hi = live[:, 0].min(), live[:, 1].max()
        first = lo // 64 * 64
        per = -(-(-(-(hi - first) // 64)) // runs)
        for r in range(t * 64, min(sq, (t + 1) * 64)):
            row = run[r].numpy()
            walked = np.flatnonzero(row >= 0)
            assert walked.min() == first and walked.max() == hi - 1
            assert np.array_equal(row[walked],
                                  (walked - first) // 64 // per)


def test_padded_head_dim_changes_nothing_past_576():
    """580 runs at 592 on the card: the plain version over the padded
    arguments (Q zero-padded, int4 payloads repacked at 592) equals it at
    580 in the head dim's lanes, ``l_rounded`` chosen from 580."""
    d = 580
    for kcfg, qdtype in ((ROW4C, "bf16"), (ROW8C, "f32")):
        _, (tq, tk, tv, _) = _qinputs(d, 2, 1, 64, d, kcfg, kcfg, qdtype)
        args, kw = tqa.qattn_arguments(tq, tk, tv, mask=tm.CAUSAL)
        assert tqa.qattn_width(d) == 592 and kw["mode"].l_rounded
        q, q_scales, kq, vq, kp, vp, rr = args
        padded = tqa.pad_qattn_arguments(q, kq, vq, kp, vp, kw["mode"])
        assert padded[0].shape[-1] == 592
        po, pl = tqa.qattn_fwd_plain(padded[0], q_scales, *padded[1:], rr,
                                     **kw)
        o, lse = tqa.qattn_fwd_plain(*args, **kw)
        tol = BF16_TOL if qdtype == "bf16" else TOL
        assert (po[..., :d] - o).abs().max() <= tol * o.abs().max()
        assert (pl - lse).abs().max() <= tol


@pytest.mark.parametrize("d,kcfg,vcfg,qdtype", [
    (608, ROW8, ROW4C, "f32"),
    (640, ROW8, ROW8, "bf16"),
])
def test_exact_backward_past_576_matches_jax(d, kcfg, vcfg, qdtype):
    """The exact backward (dq, dK, dV; Hq=2 over one KV head, causal,
    S=96): int8 ROW K and int4 ROW V dequantized under an fp32 Q at 608,
    and the folded ROW mode (column scales on S, dS and dP) under a bf16 Q
    at 640."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qinputs(d + 1, 2, 1, 96, d,
                                                     kcfg, vcfg, qdtype)
    to, tl = tqa.quantized_flash_attention_forward(tq, tk, tv, mask=tm.CAUSAL)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(
            jq, jk, jv, jnp.asarray(to.numpy()), jnp.asarray(tl.numpy()), jdo,
            mask=jm.CAUSAL)
    got = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo,
                                        mask=tm.CAUSAL)
    tol = BF16_TOL if qdtype == "bf16" else TOL
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= tol
    dtype = torch.bfloat16 if qdtype == "bf16" else torch.float32
    assert tbwd.dq_body(dtype, d) == tbwd.dkv_body(dtype, d) == "split_d"


@pytest.mark.parametrize("level", [None, "2"])
def test_fullint_backward_past_576_matches_jax(level, monkeypatch):
    """Levels 1 and 2 at 640 (Hq=2 over one KV head, FULL, S=128, bf16,
    ROW K / CHANNEL V; level 2 over the TPU's 128-wide tiles) against the
    JAX package's full-integer backward."""
    d = 640
    if level:
        monkeypatch.setenv("MFA_BWD_FULLINT_LEVEL", level)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qinputs(
        d + len(level or ""), 2, 1, 128, d, ROW8, CH8, "bf16")
    assert tbwd.fullint_backward_supported(tq, tk, tv, tm.FULL, None, None)
    to, tl = tqa.quantized_flash_attention_forward(tq, tk, tv)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(
            jq, jk, jv, jnp.asarray(to.numpy()), jnp.asarray(tl.numpy()), jdo,
            fullint=True, block_sizes=JBS)
    got = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo,
                                        fullint=True, block_sizes=TBS)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= BF16_TOL
    widths = tbwd.fullint_widths(TBS, 128, 128) if level else (0, 0)
    assert {tbwd.fullint_body(d, w) for w in widths} == {"split_d"}


DIMS = dict(vocab_size=128, d_model=256, num_layers=2, num_heads=2,
            num_kv_heads=1, head_dim=640, d_ff=512, max_seq=256)
# Weights and 32 tokens from this seed put no run-time quantized value
# within fp32 noise of a rounding boundary: the two forwards agree to
# ~1e-7.  At head dim 640 a forward quantizes ten times the values of the
# d=64 model's, so a flip (1e-4 to 1e-2 on the logits) is ten times as
# likely: seeds 0 to 19 at 32 tokens gave eight such inputs, at 128 tokens
# none of 0 to 7 (the same holds at head dims 128 and 576, the kernels'
# built widths).
SEED, TOKENS = 2, 32


def test_quantized_forward_with_quantized_kv_at_head_dim_640_matches_jax():
    """``quantized_forward(..., quantize_kv=True)`` of a 2-layer model of
    two q heads of 640 over one KV head (fp32, S=32): W8A8 projections,
    int8 Q over ROW K/V in the attention, logits ≤ 1e-3 rel L2."""
    jcfg = jtf.TransformerConfig(**DIMS, dtype=jnp.float32,
                                 block_sizes=JBS)
    tcfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    jq = jqi.quantize_weights(jtf.init_params(jcfg,
                                              jax.random.PRNGKey(SEED)))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    tokens = np.random.default_rng(SEED).integers(0, 128, (1, TOKENS))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, t: jqi.quantized_forward(
            p, t, jcfg, quantize_kv=True))(jq, jnp.asarray(tokens))
    got = tqi.quantized_forward(tq, torch.from_numpy(tokens), tcfg,
                                quantize_kv=True)
    assert got.shape == (1, TOKENS, 128) and got.dtype == torch.float32
    want = np.asarray(want, np.float64)
    rel = float(np.linalg.norm(got.double().numpy() - want)
                / np.linalg.norm(want))
    assert rel <= LOGIT_REL_L2

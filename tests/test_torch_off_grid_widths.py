"""Port parity at head dims off the kernels' built widths (1 to 576).

The card runs every head dim from 1 to 576: the flash, quantized and
full-integer kernels at the next built width (``flash_width`` /
``qattn_width``: 8 and 20 at 32, 33 and 40 at 64, 72 at 128, 304 to 560
at 576) over zero-padded lanes, the paged kernels over the pool's own rows
with their staged lanes zeroed up to the next multiple of 16.  Here, on
the CPU, the port's wrappers take their plain versions at the true head
dim; the same seeded numpy inputs go through the JAX package (Pallas in
interpret mode, HIGHEST matmul precision) and the port.  Widths from
public models: Stable Diffusion 1.5's first UNet level (320 channels over
8 heads: 40), DiT-XL/2 and PixArt-alpha (1152 over 16: 72), DeepSeek's
absorbed 576.

Tolerances (max abs error over the JAX value's max abs, as the other
parity files): fp32 outputs at TOLERANCES["fp32"] (2e-5), gradients
against ``jax.grad`` at 1e-4 (fp32 sums in another order through two
products); a bf16 Q (the quantized folded modes and the full-integer
backward) at 2e-3, as tests/test_torch_quantized_backward.py states.  The
paged kernels' outputs at TOLERANCES["fp32"] in max abs error, as
tests/test_torch_paged_attention.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jm
from metal_flash_attention_plus_tpu.ops import quantized_attention as jqa
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu.serving import kv_cache as jkv
from metal_flash_attention_plus_tpu.serving.paged_attention import (
    paged_decode_attention as jax_decode,
    paged_prefill_attention as jax_prefill,
)
from metal_flash_attention_plus_tpu_torch.attention import masking as tm
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops import flash_attention_bwd as tbwd
from metal_flash_attention_plus_tpu_torch.ops import quantized_attention as tqa
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor
from metal_flash_attention_plus_tpu_torch.serving import kv_cache as tkv
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)

tfa = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")
jfa = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention")
jbwd = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention_bwd")

TOL = TOLERANCES["fp32"]
GRAD_TOL = 1e-4
BF16_TOL = 2e-3
JBS = jfa.BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                     block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)


def _rel(got, want):
    """Max abs error over the JAX value's max abs (fp32 views)."""
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [20, 33, 40, 72])
def test_flash_forward_and_gradients_match_jax(d):
    """O, L and the gradients of q, k, v (GQA 4 over 2, causal, S=128):
    the port's autograd through its plain versions against ``jax.grad`` of
    the JAX kernels; the softmax scale is d^-0.5 of the true head dim on
    both sides.  The card's zero-padding to ``flash_width`` leaves O, L and
    the gradients in the head dim's lanes as they are and zeros in the
    rest."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 4, 128, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 128, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, mask=jm.CAUSAL, block_sizes=JBS,
                                interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    with jax.default_matmul_precision("highest"):
        jo, jl = jfa.flash_attention_forward(
            *map(jnp.asarray, (q, k, v)), mask=jm.CAUSAL, block_sizes=JBS,
            interpret=True)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    to, tl = tfa.flash_attention_forward(tq, tk, tv, mask=tm.CAUSAL)
    assert _rel(to, jo) <= TOL and _rel(tl, jl) <= TOL
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = tfa.flash_attention(*leaves, mask=tm.CAUSAL)
    tgrads = torch.autograd.grad(o, leaves, grad_outputs=torch.from_numpy(do))
    for got, want in zip(tgrads, jgrads):
        assert _rel(got, want) <= GRAD_TOL
    # The card's padded call: the same O and L in the head dim's lanes.
    w = tfa.flash_width(d)
    rr = tfa.row_ranges_tensor(tm.CAUSAL, 128, 128, None, "cpu")
    po, pl = tfa.flash_attention_forward_plain(
        *tfa.pad_lanes(w, tq, tk, tv), rr, scale=d ** -0.5)
    assert _rel(po[..., :d], jo) <= TOL and _rel(pl, jl) <= TOL
    assert not po[..., d:].any()


# ---------------------------------------------------------------------------
# Quantized attention: the forward, the exact and the full-integer backward
# ---------------------------------------------------------------------------


def _cfg(bits=8, gran="row", strategy="symmetric"):
    return jparams.QuantConfig(
        bits=bits, granularity=jparams.QuantGranularity(gran),
        strategy=jparams.QuantStrategy(strategy))


ROW8 = _cfg()
ROW4C = _cfg(bits=4, strategy="centered")
CH8 = _cfg(gran="channel")


def _quantized(x, cfg):
    """(JAX QuantizedTensor, the port's) over the same bytes."""
    tq = ttensor.quantize(torch.from_numpy(x), tparams.QuantConfig(
        bits=cfg.bits,
        granularity=tparams.QuantGranularity(cfg.granularity.value),
        strategy=tparams.QuantStrategy(cfg.strategy.value)))
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


QFWD = {  # name: (head dim, K, V, Q dtype, options)
    "int8_row_d40": (40, ROW8, ROW8, "bf16", {}),
    "int8_row_d72": (72, ROW8, ROW8, "bf16", {}),
    "int4_row_d40": (40, ROW4C, ROW4C, "f32", {}),
    "int4_row_d72": (72, ROW4C, ROW4C, "f32", {}),
    "int8_q_d72": (72, ROW8, ROW8, "f32", dict(quantize_q=True)),
}


@pytest.mark.parametrize("name", sorted(QFWD))
def test_quantized_forward_matches_jax(name):
    """O and L (Hq=4 over Hkv=2, causal, S=96).  ``l_rounded`` comes from
    the true head dim (not a multiple of 128 at 40 and 72; at 72 the card
    runs width 128, where the rule would say otherwise), in both packages;
    the card's padded arguments change nothing in the head dim's lanes."""
    d, kcfg, vcfg, qdtype, opts = QFWD[name]
    (jq, jk, jv, _), (tq, tk, tv, _) = _qinputs(d, 4, 2, 96, d, kcfg, vcfg,
                                                 qdtype)
    with jax.default_matmul_precision("highest"):
        jo, jl = jqa.quantized_flash_attention_forward(
            jq, jk, jv, mask=jm.CAUSAL, interpret=True, **opts)
    to, tl = tqa.quantized_flash_attention_forward(tq, tk, tv, mask=tm.CAUSAL,
                                                   **opts)
    tol = BF16_TOL if qdtype == "bf16" else TOL
    assert _rel(to, jo) <= tol and _rel(tl, jl) <= tol
    args, kw = tqa.qattn_arguments(tq, tk, tv, mask=tm.CAUSAL, **opts)
    mode = kw["mode"]
    assert tqa.qattn_width(d) == (64 if d == 40 else 128)
    if mode.v_scales != "p":  # l sums the rounded P: d % 128 != 0
        assert mode.l_rounded
    q, q_scales, kq, vq, kp, vp, rr = args
    padded = tqa.pad_qattn_arguments(q, kq, vq, kp, vp, mode)
    po, pl = tqa.qattn_fwd_plain(padded[0], q_scales, *padded[1:], rr, **kw)
    o, lse = tqa.qattn_fwd_plain(*args, **kw)
    assert (po[..., :d] - o).abs().max() <= tol * o.abs().max()
    assert (pl - lse).abs().max() <= tol


def test_int4_payload_at_an_odd_head_dim_is_refused():
    """An int4 row packs two lanes a byte: an odd head dim has no payload,
    in the port as in the JAX package's ``pack_int4``; the wrappers name
    the rule on a payload of a wrong width."""
    x = np.random.default_rng(0).standard_normal((1, 1, 8, 33)).astype(
        np.float32)
    with pytest.raises(ValueError, match="even"):
        ttensor.pack_int4(torch.zeros(1, 33, dtype=torch.int8))
    with pytest.raises(ValueError):
        jtensor.pack_int4(jnp.zeros((1, 33), jnp.int8))
    with pytest.raises(ValueError, match="even"):
        _quantized(x, ROW4C)
    with pytest.raises(ValueError, match="even head dim"):
        tqa._check_payload("qattn_fwd", torch.zeros(1, 1, 8, 16,
                                                    dtype=torch.uint8),
                           4, 1, 1, 8, 33)
    # int4 at an even off-grid head dim repacks at the kernel width.
    packed = ttensor.pack_int4(torch.arange(40, dtype=torch.int8)[None] % 15
                               - 7)
    wide = tqa.pad_payload(packed, 4, 40, 64)
    assert wide.shape[-1] == 32
    assert torch.equal(ttensor.unpack_int4(wide)[..., :40],
                       ttensor.unpack_int4(packed))
    assert not ttensor.unpack_int4(wide)[..., 40:].any()


def test_exact_backward_at_40_matches_jax():
    """The exact backward (dq, dK, dV; Hq=4 over Hkv=2, causal, S=96) over
    int8 ROW K and int4 ROW V, an fp32 Q."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qinputs(40, 4, 2, 96, 40, ROW8,
                                                     ROW4C, "f32")
    to, tl = tqa.quantized_flash_attention_forward(tq, tk, tv, mask=tm.CAUSAL)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(
            jq, jk, jv, jnp.asarray(to.numpy()), jnp.asarray(tl.numpy()), jdo,
            mask=jm.CAUSAL)
    got = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo,
                                        mask=tm.CAUSAL)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("d,level", [(40, None), (40, "2"), (576, None),
                                     (576, "2")])
def test_fullint_backward_matches_jax(d, level, monkeypatch):
    """Levels 1 and 2 (Hq=2 over one KV head, FULL, S=128, bf16, ROW K /
    CHANNEL V): at 40, which the card runs at 64, and at DeepSeek's 576,
    the full-integer pair's new width.  The card's zero-padded operands
    change nothing in the head dim's lanes (level 1 at 40)."""
    if level:
        monkeypatch.setenv("MFA_BWD_FULLINT_LEVEL", level)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qinputs(
        d + len(level or ""), 2, 1, 128, d, ROW8, CH8, "bf16")
    assert tbwd.fullint_backward_supported(tq, tk, tv, tm.FULL, None, None)
    to, tl = tqa.quantized_flash_attention_forward(tq, tk, tv)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(
            jq, jk, jv, jnp.asarray(to.numpy()), jnp.asarray(tl.numpy()), jdo,
            fullint=True)
    got = tbwd.flash_attention_backward(tq, tk, tv, to, tl, tdo,
                                        fullint=True)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= BF16_TOL
    assert tbwd.fullint_body(d, 0) == "tensor_core"
    if level or d == 576:
        return
    (dq_a, dq_kw), (dkv_a, dkv_kw) = tbwd.fullint_arguments(
        tq, tk, tv, to, tl, tdo, scale=d ** -0.5)
    w = tqa.qattn_width(d)
    qq, qsc, kq, ks, vq, dov, dovsc, l_, di = dq_a
    want_dq = tbwd.fullint_dq_plain(*dq_a, **dq_kw)
    got_dq = tbwd.fullint_dq_plain(*tbwd.pad_lanes(w, qq), qsc,
                                   *tbwd.pad_lanes(w, kq), ks,
                                   *tbwd.pad_lanes(w, vq, dov), dovsc, l_, di,
                                   **dq_kw)
    assert (got_dq[..., :d] - want_dq).abs().max() <= (
        BF16_TOL * want_dq.abs().max())


# ---------------------------------------------------------------------------
# Paged decode and prefill
# ---------------------------------------------------------------------------

HQ, HKV, PT, NP, MP = 4, 2, 16, 12, 4


def _pool(rng, mode, d):
    """(pool [Hkv, NP+1, rows, D], scales or (None, None), kv_bits)."""
    if mode == "float":
        return (rng.standard_normal((HKV, NP + 1, 2 * PT, d)).astype(
            np.float32), (None, None), 8)
    rows = PT if mode == "int4" else 2 * PT
    pool = rng.integers(-128, 128, (HKV, NP + 1, rows, d)).astype(np.int8)
    step = 7.0 if mode == "int4" else 127.0
    scales = tuple((rng.uniform(0.5, 2.0, (HKV, NP + 1, 1, PT)) / step).astype(
        np.float32) for _ in range(2))
    return pool, scales, 4 if mode == "int4" else 8


def _paged_case(d, mode, kernel):
    rng = np.random.default_rng(d * 7 + len(mode) + len(kernel))
    pool, (ks, vs), bits = _pool(rng, mode, d)
    perm = rng.permutation(NP).astype(np.int32)
    if kernel == "decode":
        lengths = np.asarray([1, PT + 3, 3 * PT - 5], np.int32)
        table = np.full((3, MP), NP, np.int32)
        table[0, :1], table[1, :2], table[2, :3] = (perm[:1], perm[1:3],
                                                    perm[3:6])
        q = rng.standard_normal((3, HQ, d)).astype(np.float32)
        args = (q, pool, table, lengths)
    else:
        table = np.full(MP, NP, np.int32)
        table[:3] = perm[:3]
        q = rng.standard_normal((HQ, 9, d)).astype(np.float32)
        args = (q, pool, table, 11)
    return args, ks, vs, bits


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("d,mode", [
    (d, mode) for d in (8, 20, 33, 40, 72) for mode in ("float", "int8",
                                                        "int4")
    if mode != "int4" or d % 2 == 0])  # int4: two lanes a byte
def test_paged_kernels_match_jax(d, mode, kernel):
    """Both paged kernels over float, int8 and int4 pools (int4 at even
    head dims) at head dims off the multiples of 16: the pool keeps the
    JAX layout, [Hkv, NP+1, rows, D], and the call neither copies nor pads
    it."""
    args, ks, vs, bits = _paged_case(d, mode, kernel)
    kw = dict(page_tokens=PT, kv_bits=bits)
    jfn, tfn = ((jax_decode, paged_decode_attention) if kernel == "decode"
                else (jax_prefill, paged_prefill_attention))
    scales = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    with jax.default_matmul_precision("highest"):
        want = jfn(*(jnp.asarray(a) for a in args), interpret=True,
                   **{k: jnp.asarray(s) for k, s in scales.items()}, **kw)
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
             else a for a in args]
    pool = targs[1]
    before = pool.clone()
    got = tfn(*targs, **{k: torch.from_numpy(s) for k, s in scales.items()},
              **kw)
    assert got.shape == args[0].shape
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL
    assert pool.shape[-1] == d and torch.equal(pool, before)


@pytest.mark.parametrize("d", [24, 72])
def test_latent_pages_with_v_tail_zero_at_off_grid_widths(d):
    """One-state pages read as K and, their last 8 lanes zeroed, as V
    (MLA's latent layout) at head dims off the multiples of 16: both
    kernels against the JAX package, V's zeroed lanes zero in O."""
    rng = np.random.default_rng(d)
    pool = rng.standard_normal((1, NP + 1, PT, d)).astype(np.float32)
    table = np.full((2, MP), NP, np.int32)
    table[0, :2], table[1, :3] = [3, 5], [7, 1, 0]
    lengths = np.asarray([PT + 3, 3 * PT - 5], np.int32)
    q = rng.standard_normal((2, 8, d)).astype(np.float32)
    kw = dict(page_tokens=PT, v_tail_zero=8)
    with jax.default_matmul_precision("highest"):
        want = jax_decode(*map(jnp.asarray, (q, pool, table, lengths)),
                          interpret=True, **kw)
        qp = rng.standard_normal((8, 5, d)).astype(np.float32)
        want_p = jax_prefill(*map(jnp.asarray, (qp, pool, table[1])),
                             jnp.asarray(20, jnp.int32), interpret=True, **kw)
    got = paged_decode_attention(*map(torch.from_numpy,
                                      (q, pool, table, lengths)), **kw)
    got_p = paged_prefill_attention(*map(torch.from_numpy,
                                         (qp, pool, table[1])), 20, **kw)
    for g, w in ((got, want), (got_p, want_p)):
        assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) <= TOL
        assert not g[..., d - 8:].any()


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_pool_keeps_the_jax_layout_at_an_off_grid_head_dim(bits):
    """``PagedKVCache.create`` at D=40: the JAX package's shapes, dtypes and
    byte counts, nothing padded to a kernel width."""
    t = tkv.PagedKVCache.create(2, 2, 6, 16, 40, dtype=torch.bfloat16,
                                bits=bits, device="cpu")
    j = jkv.PagedKVCache.create(2, 2, 6, 16, 40, dtype=jnp.bfloat16,
                                bits=bits)
    assert tuple(t.kv_pages.shape) == j.kv_pages.shape
    assert t.kv_pages.shape[-1] == 40
    assert (t.kv_pages.numel() * t.kv_pages.element_size()
            == j.kv_pages.size * j.kv_pages.dtype.itemsize)
    if bits != 16:
        assert tuple(t.k_scales.shape) == j.k_scales.shape

"""Port parity at head dims above 576, where the card runs the split-D kernels.

On the card every head dim above DeepSeek's absorbed width 576 runs on
``csrc/split_d_attention.cu``: the flash forward, dQ and dK/dV and the
paged decode and prefill, each CTA owning 256 lanes of the output and
summing the scores over the whole head dim.  Here, on the CPU, the port's
entry points take their plain versions at the true head dim; the same
seeded numpy inputs go through the JAX package (Pallas in interpret mode,
HIGHEST matmul precision) and the port.  The routing that the card's
wrappers read (``flash_width``, the ``*_body`` functions, ``dkv_splits``)
is checked at the new widths, and so is the quantized path's routing
there: the quantized forward, the exact quantized backward and the
full-integer pair take the split-D kernels too (their parity against the
JAX package: tests/test_torch_quantized_past_576.py).

Tolerances (as tests/test_torch_off_grid_widths.py): the flash outputs at
TOLERANCES["fp32"] (2e-5) in max abs error over the JAX value's max abs,
the gradients against ``jax.grad`` at 1e-4 (fp32 sums in another order
through two products); the paged outputs at TOLERANCES["fp32"] in max abs
error.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jm
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
from metal_flash_attention_plus_tpu_torch.serving import paged_attention as tpa

tfa = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")
jfa = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention")

TOL = TOLERANCES["fp32"]
GRAD_TOL = 1e-4
JBS = jfa.BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                     block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)
WIDE = (600, 1024)


def _rel(got, want):
    """Max abs error over the JAX value's max abs (fp32 views)."""
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_bias", [False, True], ids=["causal", "bias"])
@pytest.mark.parametrize("d", WIDE)
def test_flash_forward_and_gradients_match_jax(d, with_bias):
    """O, L and the gradients of q, k, v (and the bias) at B=1, Hq=2 over
    Hkv=1, S=64, causal: the port's autograd through its plain versions
    against ``jax.grad`` of the JAX kernels, the softmax scale d^-0.5 of
    the true head dim on both sides.  The card's zero-padding to
    ``flash_width`` (600 runs at 608) leaves O and L in the head dim's
    lanes as they are and zeros in the rest."""
    rng = np.random.default_rng(d + with_bias)
    q = rng.standard_normal((1, 2, 64, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, 64, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    bias = (rng.standard_normal((1, 2, 64, 64)).astype(np.float32)
            if with_bias else None)

    def jloss(q_, k_, v_, b_):
        o = jfa.flash_attention(q_, k_, v_, b_, mask=jm.CAUSAL,
                                block_sizes=JBS, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    jargs = [jnp.asarray(x) for x in (q, k, v)] + [
        None if bias is None else jnp.asarray(bias)]
    with jax.default_matmul_precision("highest"):
        jo, jl = jfa.flash_attention_forward(
            *jargs[:3], mask=jm.CAUSAL, bias=jargs[3], block_sizes=JBS,
            interpret=True)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2) + ((3,) if with_bias
                                                        else ()))(*jargs)
    targs = [torch.from_numpy(x) for x in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)
    to, tl = tfa.flash_attention_forward(*targs, mask=tm.CAUSAL, bias=tb)
    assert _rel(to, jo) <= TOL and _rel(tl, jl) <= TOL
    leaves = [t.clone().requires_grad_(True) for t in targs]
    if tb is not None:
        leaves.append(tb.clone().requires_grad_(True))
    o = tfa.flash_attention(*leaves[:3], *leaves[3:], mask=tm.CAUSAL)
    tgrads = torch.autograd.grad(o, leaves, grad_outputs=torch.from_numpy(do))
    assert len(tgrads) == len(jgrads)
    for got, want in zip(tgrads, jgrads):
        assert _rel(got, want) <= GRAD_TOL
    w = tfa.flash_width(d)
    rr = tfa.row_ranges_tensor(tm.CAUSAL, 64, 64, None, "cpu")
    po, pl = tfa.flash_attention_forward_plain(
        *tfa.pad_lanes(w, *targs), rr, bias=tb, scale=d ** -0.5)
    assert _rel(po[..., :d], jo) <= TOL and _rel(pl, jl) <= TOL
    assert not po[..., d:].any()


def _gap_ranges(sq, skv, width=40):
    """Sparse rows: the first half of each 64-row tile attends to the
    first ``width`` keys, the second half to the last ``width``, so the
    runs between hold no live key."""
    first = np.arange(sq) % 64 < 32
    return np.stack([np.where(first, 0, skv - width),
                     np.where(first, width, skv)], axis=1).astype(np.int32)


# name: (mask, sparse gap rows, bias, runs) at D = 640, Sq = 96 over
# Skv = 448 (7 key tiles) or 320.
SPLIT_FWD = {
    "causal_3_runs": (jm.CAUSAL, tm.CAUSAL, False, False, 3, 448),
    "window_5_runs": (jm.sliding_window(96, causal=True),
                      tm.sliding_window(96, causal=True), False, False, 5,
                      448),
    "sparse_gap_4_runs": (jm.MaskSpec(jm.MaskKind.SPARSE_RANGES),
                          tm.MaskSpec(tm.MaskKind.SPARSE_RANGES), True, False,
                          4, 448),
    "bias_full_2_runs": (jm.FULL, tm.FULL, False, True, 2, 320),
}


@pytest.mark.parametrize("name", sorted(SPLIT_FWD))
def test_split_forward_merge_matches_unsplit_and_jax(name):
    """The plain version of the split-D forward with its KV axis split
    (``flash_attention_forward_plain(..., splits=n)``: each 64-row tile's
    key span dealt into n runs of whole 64-key tiles, a partial each,
    merged by ``merge_fwd_splits_plain``, the plain version of
    split_d_fwd_merge_kernel) against the unsplit plain version and the
    JAX forward (interpret mode), O and L at D = 640 within
    TOLERANCES["fp32"]; a run with no live key (the sparse gap) weighs
    nothing, and one with no key (the window's short spans: the later
    runs) adds nothing."""
    jmask, tmask, gap, with_bias, runs, skv = SPLIT_FWD[name]
    d, sq = 640, 96
    rng = np.random.default_rng(skv + runs)
    q = rng.standard_normal((1, 2, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, skv, d)).astype(np.float32)
            for _ in range(2))
    bias = (rng.standard_normal((1, 2, sq, skv)).astype(np.float32)
            if with_bias else None)
    ranges = _gap_ranges(sq, skv) if gap else None
    with jax.default_matmul_precision("highest"):
        jo, jl = jfa.flash_attention_forward(
            *(jnp.asarray(x) for x in (q, k, v)), mask=jmask,
            mask_ranges=None if ranges is None else jnp.asarray(ranges),
            bias=None if bias is None else jnp.asarray(bias),
            block_sizes=JBS, interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    rr = tfa.row_ranges_tensor(tmask, sq, skv, ranges, "cpu")
    run = tfa.split_d_fwd_runs(rr, skv, runs, aligned=False)
    assert int(run.max()) >= 1  # at least two runs walk keys
    kw = dict(bias=tb, scale=d ** -0.5)
    o1, l1 = tfa.flash_attention_forward_plain(tq, tk, tv, rr, **kw)
    on, ln = tfa.flash_attention_forward_plain(tq, tk, tv, rr, **kw,
                                               splits=runs)
    assert (on - o1).abs().max() <= TOL * o1.abs().max()
    live = torch.isfinite(l1)
    assert torch.equal(torch.isfinite(ln), live)
    assert (ln[live] - l1[live]).abs().max() <= TOL * l1[live].abs().max()
    assert _rel(on, jo) <= TOL and _rel(ln, jl) <= TOL


# (d, batch, q heads, Sq, Skv, SMs, one walk) -> runs
FWD_SPLIT_PLANS = [
    # Perceiver IO's image cross-attention: 8 row tiles x 4 lane slices =
    # 32 CTAs on 132 SMs, 784 key tiles: 8 runs (256 CTAs, two an SM).
    ((1024, 1, 1, 512, 224 * 224, 132, False), 8),
    # The trio (B=2, 16 q heads, S=2048): 4,096 / 3,072 CTAs, one walk.
    ((1024, 2, 16, 2048, 2048, 132, False), 1),
    ((640, 2, 16, 2048, 2048, 132, False), 1),
    # An int8 P keeps one walk wherever the grid is.
    ((1024, 1, 1, 512, 224 * 224, 132, True), 1),
    # Few CTAs but a short key axis: runs of at least 16 tiles.
    ((640, 1, 1, 128, 2048, 132, False), 2),
    ((640, 1, 1, 128, 960, 132, False), 1),
    # Up to 576 there is no split-D forward.
    ((576, 1, 1, 512, 224 * 224, 132, False), 1),
    # At most 64 runs.
    ((1024, 1, 1, 64, 1 << 20, 132, False), 64),
]


@pytest.mark.parametrize("shape,want", FWD_SPLIT_PLANS)
def test_split_d_forward_split_plan(shape, want):
    """split_d_fwd_splits from shapes alone: 1 unless the grid leaves SMs
    idle, then as many runs as fill two CTAs an SM, each at least 16 key
    tiles, at most 64; 1 for an int8 P and at or below 576."""
    *dims, one_walk = shape
    assert tfa.split_d_fwd_splits(*dims, one_walk=one_walk) == want


# ---------------------------------------------------------------------------
# Paged decode and prefill
# ---------------------------------------------------------------------------

HQ, HKV, PT, NP, MP = 4, 2, 16, 8, 3
PAGED_WIDE = (608, 1024)


def _pool(rng, mode, d, hkv=HKV, states=2):
    """(pool [Hkv, NP+1, rows, D], scales or (None, None), kv_bits)."""
    if mode == "float":
        return (rng.standard_normal((hkv, NP + 1, states * PT, d)).astype(
            np.float32), (None, None), 8)
    rows = PT if mode == "int4" else states * PT
    pool = rng.integers(-128, 128, (hkv, NP + 1, rows, d)).astype(np.int8)
    step = 7.0 if mode == "int4" else 127.0
    scales = tuple((rng.uniform(0.5, 2.0, (hkv, NP + 1, 1, PT)) / step).astype(
        np.float32) for _ in range(2))
    return pool, scales, 4 if mode == "int4" else 8


def _against_jax(kernel, args, kw, scales):
    """(port, JAX) outputs of one paged call on numpy arguments."""
    jfn, tfn = ((jax_decode, tpa.paged_decode_attention) if kernel == "decode"
                else (jax_prefill, tpa.paged_prefill_attention))
    with jax.default_matmul_precision("highest"):
        want = jfn(*(jnp.asarray(a) for a in args), interpret=True,
                   **{k: jnp.asarray(s) for k, s in scales.items()}, **kw)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got = tfn(*targs, **{k: torch.from_numpy(s) for k, s in scales.items()},
              **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("mode", ["float", "int8", "int4"])
@pytest.mark.parametrize("d", PAGED_WIDE)
def test_paged_kernels_match_jax(d, mode, kernel):
    """Both paged kernels over float and int8 two-state pools and the int4
    byte (Hq=4 over Hkv=2) above 576: the same output as the JAX package,
    the pool unchanged at its own head dim."""
    rng = np.random.default_rng(d + len(mode) * 3 + len(kernel))
    pool, (ks, vs), bits = _pool(rng, mode, d)
    perm = rng.permutation(NP).astype(np.int32)
    if kernel == "decode":
        lengths = np.asarray([1, PT + 3, 3 * PT - 5], np.int32)
        table = np.full((3, MP), NP, np.int32)
        table[0, :1], table[1, :2], table[2, :3] = (perm[:1], perm[1:3],
                                                    perm[3:6])
        args = (rng.standard_normal((3, HQ, d)).astype(np.float32), pool,
                table, lengths)
    else:
        table = np.full(MP, NP, np.int32)
        table[:3] = perm[:3]
        args = (rng.standard_normal((HQ, 9, d)).astype(np.float32), pool,
                table, np.int32(11))
    scales = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    before = pool.copy()
    got, want = _against_jax(kernel, args, dict(page_tokens=PT,
                                                 kv_bits=bits), scales)
    assert got.shape == args[0].shape
    assert float(np.max(np.abs(got.numpy() - want))) <= TOL
    assert np.array_equal(pool, before) and pool.shape[-1] == d


@pytest.mark.parametrize("d,vtz", [(608, 64), (1024, 64), (1030, 6)])
def test_latent_pages_with_v_tail_zero_match_jax(d, vtz):
    """One-state pages read as K and, their last ``vtz`` lanes zeroed, as V
    (MLA's latent layout; 1030 off the multiples of 16) at Hq=8 over one
    head: both kernels against the JAX package, V's zeroed lanes zero in
    O."""
    rng = np.random.default_rng(d + vtz)
    pool = rng.standard_normal((1, NP + 1, PT, d)).astype(np.float32)
    table = np.full((2, MP), NP, np.int32)
    table[0, :2], table[1, :3] = [3, 5], [7, 1, 0]
    lengths = np.asarray([PT + 3, 3 * PT - 5], np.int32)
    kw = dict(page_tokens=PT, v_tail_zero=vtz)
    got, want = _against_jax(
        "decode", (rng.standard_normal((2, 8, d)).astype(np.float32), pool,
                   table, lengths), kw, {})
    got_p, want_p = _against_jax(
        "prefill", (rng.standard_normal((8, 5, d)).astype(np.float32), pool,
                    table[1], np.int32(20)), kw, {})
    for g, w in ((got, want), (got_p, want_p)):
        assert float(np.max(np.abs(g.numpy() - w))) <= TOL
        assert not g[..., d - vtz:].any()


# ---------------------------------------------------------------------------
# Routing and the split plans at the new widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [577, 580, 600, 608, 640, 1024, 1088, 1152,
                               2048])
def test_every_width_above_576_takes_the_split_d_route(d, dtype):
    """flash_width pads to the next multiple of 16; the forward, dQ, dK/dV,
    decode and prefill all name the split-D route in both dtypes, for
    every pool layout; the lane slices are ceil(width / 256)."""
    w = tfa.flash_width(d)
    assert w % 16 == 0 and d <= w < d + 16
    assert tfa.split_d_slices(d) == -(-w // 256)
    assert tfa.SPLIT_D_SLICE == 256
    assert (tfa.fwd_body(dtype, d) == tbwd.dq_body(dtype, d)
            == tbwd.dkv_body(dtype, d) == "split_d")
    assert tpa.decode_body(dtype, d) == "split_d"
    for states, vtz in ((1, 0), (1, 64), (2, 0)):
        assert tpa.prefill_body(dtype, d, states, vtz) == "split_d"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_576_and_below_keep_their_fixed_width_routes(dtype):
    """At 576 and below nothing moves to the split-D kernels."""
    want = "tensor_core" if dtype == torch.bfloat16 else "fp32_fma"
    for d in (1, 64, 288, 576):
        assert tfa.fwd_body(dtype, d) == tbwd.dkv_body(dtype, d) == want
        assert tpa.decode_body(dtype, d) == want
        assert tfa.split_d_slices(d) == 1
    assert tfa.flash_width(576) == 576 and tfa.flash_width(577) == 592


# (dtype, d, batch, q heads, kv heads, kv length, SMs) -> splits
SPLIT_D_PLANS = [
    # The trio's timing shape on an H100 (B=2, 16 q heads over one, 2048
    # keys: 32 key tiles a batch row, times 3 or 4 lane slices).
    ((torch.bfloat16, 640, 2, 16, 1, 2048, 132), 4),
    ((torch.bfloat16, 1024, 2, 16, 1, 2048, 132), 4),
    ((torch.float32, 1024, 2, 16, 1, 2048, 132), 4),
    # 8 lane slices at 2048: 512 CTAs unsplit, 2 splits.
    ((torch.bfloat16, 2048, 2, 16, 1, 2048, 132), 2),
    # A short sequence: every head its own CTA.
    ((torch.float32, 640, 1, 16, 1, 256, 132), 16),
    # No group to split.
    ((torch.bfloat16, 1024, 2, 8, 8, 2048, 132), 1),
    # A group of 3 dealt as 2 + 1.
    ((torch.bfloat16, 608, 1, 6, 2, 128, 132), 2),
]


@pytest.mark.parametrize("shape,want", SPLIT_D_PLANS)
def test_split_d_dkv_split_plan(shape, want):
    """dkv_splits over the split-D dK/dV (64-key tiles, both dtypes): the
    grid's lane slices count as CTAs, the split doubles while within the
    group and eight CTAs an SM."""
    assert tbwd._DKV_SPLIT_TILE["split_d"] == 64
    assert tbwd.dkv_splits(*shape) == want


def test_quantized_paths_still_stop_at_576():
    """The quantized forward, the exact quantized backward and the
    full-integer pair keep their width tables up to 576 and past it take
    the split-D kernels: ``qattn_width`` pads to the next multiple of 16,
    ``qattn_body`` (every Q), ``dq_body`` / ``dkv_body`` and
    ``fullint_body`` (every level-2 width) answer "split_d", and the
    full-integer dK/dV splits its group as the float split-D dK/dV does."""
    assert tqa.HEAD_DIMS[-1] == 576 and tqa.qattn_width(576) == 576
    for d, w in ((577, 592), (592, 592), (600, 608), (1024, 1024)):
        assert tqa.qattn_width(d) == w
        for qd in (torch.float32, torch.bfloat16, torch.int8):
            mode = tqa.QAttnMode("token", "token",
                                 round_bf16=qd != torch.float32)
            assert tqa.qattn_body(qd, mode, d=d) == "split_d"
        assert tbwd.fullint_body(d, 0) == tbwd.fullint_body(d, 592) == (
            "split_d")
        assert tbwd.dq_body(torch.bfloat16, d) == "split_d"
        assert tbwd.fullint_dkv_splits(d, 2, 16, 1, 2048, 132) == (
            tbwd.dkv_splits(torch.bfloat16, d, 2, 16, 1, 2048, 132))
    with pytest.raises(ValueError, match="has no"):
        tbwd.fullint_body(592, -1)

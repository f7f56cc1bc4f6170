"""Port parity: the reference and the flash path vs the JAX package.

The same seeded numpy inputs go through both packages in fp32.  The JAX
side runs at HIGHEST matmul precision, its Pallas kernels in interpret
mode with 128-tiles; the port's side runs the plain PyTorch versions its
wrappers take on the CPU.  Tolerance: TOLERANCES["fp32"] (2e-5) in max
abs error over the JAX value's max abs — both sides compute the same
fp32 arithmetic and differ only in the order of sums.

The port's flash path is held to the JAX FLASH path, not to the dense
reference: on a row with no live key the flash kernels give O = 0 and
L = -inf where the reference gives the mean of V.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jm
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu.reference import attention as jref
from metal_flash_attention_plus_tpu_torch.attention import masking as tm
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    flash_attention_bwd as fbwd,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_backward,
)
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor
from metal_flash_attention_plus_tpu_torch.reference import (
    attention as tref,
)

# The port's ops/__init__ re-exports a function of the same name too.
tfa = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")

# The JAX package's ops/__init__ re-exports functions of these names.
jfa = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention")
jbwd = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention_bwd")

TOL = TOLERANCES["fp32"]
JBS = jfa.BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                     block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(out), finite)
    assert np.array_equal(out[~finite], ref[~finite])
    return np.abs(out[finite] - ref[finite]).max() / max(
        np.abs(ref[finite]).max(), 1e-30)


def _segments_with_empty_row(s):
    r = jm.build_segment_ranges(np.repeat(np.arange(4), -(-s // 4))[:s])
    r = r.copy()
    r[s // 3] = (5, 5)
    return r


# name: (B, Hq, Hkv, Sq, Skv, D, (torch spec, JAX spec, ranges), interleaved,
#        bias shape)
CASES = {
    "full": (1, 2, 2, 128, 128, 64, (tm.FULL, jm.FULL, None), False, None),
    "causal_gqa": (2, 4, 2, 128, 128, 16, (tm.CAUSAL, jm.CAUSAL, None),
                   False, None),
    "causal_interleaved": (1, 4, 2, 200, 200, 16,
                           (tm.CAUSAL, jm.CAUSAL, None), True, None),
    "window_mqa": (1, 4, 1, 256, 256, 16,
                   (tm.sliding_window(64), jm.sliding_window(64), None),
                   False, None),
    "window_causal_rect": (1, 2, 1, 96, 160, 64,
                           (tm.sliding_window(40, causal=True),
                            jm.sliding_window(40, causal=True), None),
                           False, None),
    "segments_empty_row": (
        1, 2, 2, 150, 150, 16,
        (tm.MaskSpec(tm.MaskKind.SPARSE_RANGES),
         jm.MaskSpec(jm.MaskKind.SPARSE_RANGES), _segments_with_empty_row(150)),
        False, None),
    "block_sparse": (
        1, 2, 1, 256, 256, 16,
        (tm.MaskSpec(tm.MaskKind.BLOCK_SPARSE, block_size=64),
         jm.MaskSpec(jm.MaskKind.BLOCK_SPARSE, block_size=64),
         jm.build_block_sparse_ranges(
             np.tril(np.ones((4, 4), bool)) & ~np.eye(4, k=-2, dtype=bool),
             64)),
        False, None),
    "bias_causal_bcast": (2, 4, 2, 100, 100, 16, (tm.CAUSAL, jm.CAUSAL, None),
                          False, (1, 4, 100, 100)),
    "ragged_rect_bias": (1, 2, 2, 70, 190, 16, (tm.CAUSAL, jm.CAUSAL, None),
                         False, (1, 1, 70, 190)),
    # MLA's latent attention: one KV head, D = d_c + d_r = 64 + 16.
    "mla_latent_d80": (1, 4, 1, 96, 96, 80, (tm.CAUSAL, jm.CAUSAL, None),
                       False, None),
}
BWD_CASES = ["causal_gqa", "causal_interleaved", "window_causal_rect",
             "segments_empty_row", "bias_causal_bcast", "ragged_rect_bias",
             "mla_latent_d80"]


def _inputs(name, seed=0):
    b, hq, hkv, sq, skv, d, _, _, bias_shape = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    bias = (None if bias_shape is None
            else rng.standard_normal(bias_shape).astype(np.float32))
    return q, k, v, do, bias


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_matches_jax(name):
    (tspec, jspec, ranges), interleaved = CASES[name][6], CASES[name][7]
    q, k, v, _, bias = _inputs(name)
    with jax.default_matmul_precision("highest"):
        jo, jl = jfa.flash_attention_forward(
            *_jax(q, k, v), mask=jspec, mask_ranges=ranges,
            bias=_jax(bias)[0], block_sizes=JBS, interleaved_kv=interleaved,
            interpret=True)
    to, tl = tfa.flash_attention_forward(
        *_torch(q, k, v), mask=tspec, mask_ranges=ranges,
        bias=_torch(bias)[0], interleaved_kv=interleaved)
    assert to.dtype == torch.float32 and tl.shape == q.shape[:3]
    assert _rel(to.numpy(), jo) <= TOL
    assert _rel(tl.numpy(), jl) <= TOL


@pytest.mark.parametrize("name", BWD_CASES)
def test_flash_backward_matches_jax(name):
    (tspec, jspec, ranges), interleaved = CASES[name][6], CASES[name][7]
    q, k, v, do, bias = _inputs(name, seed=1)
    kw_j = dict(mask=jspec, mask_ranges=ranges, block_sizes=JBS,
                interleaved_kv=interleaved, interpret=True)
    with jax.default_matmul_precision("highest"):
        jo, jl = jfa.flash_attention_forward(*_jax(q, k, v),
                                             bias=_jax(bias)[0], **kw_j)
        jgrads = jbwd.flash_attention_backward(
            *_jax(q, k, v), jo, jl, jnp.asarray(do), bias=_jax(bias)[0],
            compute_dbias=bias is not None, **kw_j)
    o, lse = np.array(jo), np.array(jl)  # writable copies for torch
    tgrads = flash_attention_backward(
        *_torch(q, k, v, o, lse, do), mask=tspec, mask_ranges=ranges,
        bias=_torch(bias)[0], interleaved_kv=interleaved,
        compute_dbias=bias is not None)
    for got, want, what in zip(tgrads, jgrads, ("dq", "dk", "dv", "dbias")):
        if want is None:
            assert got is None
            continue
        assert got.shape == want.shape, what
        assert _rel(got.numpy(), want) <= TOL, what


@pytest.mark.parametrize("name", ["causal_gqa", "bias_causal_bcast"])
def test_autograd_matches_jax_grad(name):
    tspec, jspec, _ = CASES[name][6]
    q, k, v, do, bias = _inputs(name, seed=2)

    def jloss(q_, k_, v_, bias_):
        o = jfa.flash_attention(q_, k_, v_, bias_, mask=jspec,
                                block_sizes=JBS, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    with jax.default_matmul_precision("highest"):
        jgrads = jax.grad(jloss, argnums=argnums)(*_jax(q, k, v, bias))
    leaves = [t.requires_grad_(True) for t in _torch(q, k, v, bias)
              if t is not None]
    o = tfa.flash_attention(*leaves[:3], leaves[3] if bias is not None
                            else None, mask=tspec)
    tgrads = torch.autograd.grad(o, leaves, grad_outputs=torch.from_numpy(do))
    for got, want in zip(tgrads, jgrads):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("name", ["causal_interleaved", "window_causal_rect",
                                  "segments_empty_row", "bias_causal_bcast"])
def test_reference_matches_jax(name):
    (tspec, jspec, ranges), interleaved = CASES[name][6], CASES[name][7]
    q, k, v, do, bias = _inputs(name, seed=3)
    kw_j = dict(mask=jspec, mask_ranges=ranges, bias=_jax(bias)[0],
                interleaved_kv=interleaved)
    kw_t = dict(mask=tspec, mask_ranges=ranges, bias=_torch(bias)[0],
                interleaved_kv=interleaved)
    jo, jl = jref.reference_attention(*_jax(q, k, v), **kw_j)
    to, tl = tref.reference_attention(*_torch(q, k, v), **kw_t)
    assert _rel(to.numpy(), jo) <= TOL and _rel(tl.numpy(), jl) <= TOL
    jb = jref.reference_attention_bwd(*_jax(q, k, v), jo, jl, jnp.asarray(do),
                                      **kw_j)
    tb = tref.reference_attention_bwd(*_torch(q, k, v), to, tl,
                                      torch.from_numpy(do), **kw_t)
    for got, want in zip(tb, jb):
        assert _rel(got.numpy(), want) <= TOL
    if name == "segments_empty_row":
        return  # the analytic backward's L is the sentinel on an empty row
    # The autograd golden model agrees with the analytic one.
    tv = tref.reference_attention_vjp(*_torch(q, k, v, do), **kw_t)
    for got, want in zip(tv, tb[:3]):
        assert _rel(got.numpy(), want.numpy()) <= 10 * TOL


def test_flash_matches_reference_where_every_row_is_live():
    q, k, v, _, bias = _inputs("bias_causal_bcast", seed=4)
    o, lse = tfa.flash_attention_forward(*_torch(q, k, v), mask=tm.CAUSAL,
                                         bias=torch.from_numpy(bias))
    ro, rl = tref.reference_attention(*_torch(q, k, v), mask=tm.CAUSAL,
                                      bias=torch.from_numpy(bias))
    assert _rel(o.numpy(), ro.numpy()) <= TOL
    assert _rel(lse.numpy(), rl.numpy()) <= TOL


def test_tensor_ranges_match_numpy_ranges():
    tspec, _, ranges = CASES["segments_empty_row"][6]
    q, k, v, do, _ = _inputs("segments_empty_row", seed=5)
    args = _torch(q, k, v)
    o_np, l_np = tfa.flash_attention_forward(*args, mask=tspec,
                                             mask_ranges=ranges)
    o_t, l_t = tfa.flash_attention_forward(
        *args, mask=tspec, mask_ranges=torch.from_numpy(ranges))
    torch.testing.assert_close(o_t, o_np, rtol=0, atol=0)
    torch.testing.assert_close(l_t, l_np, rtol=0, atol=0)
    assert torch.isneginf(l_t[..., q.shape[2] // 3]).all()
    assert (o_t[..., q.shape[2] // 3, :] == 0).all()


def test_lse_output_has_no_gradient_and_out_dtype():
    q, k, v, _, _ = _inputs("causal_gqa", seed=6)
    leaves = [t.requires_grad_(True) for t in _torch(q, k, v)]
    o, lse = tfa.flash_attention_with_lse(*leaves, mask=tm.CAUSAL,
                                          out_dtype=torch.bfloat16)
    assert o.dtype == torch.bfloat16 and o.requires_grad
    assert lse.dtype == torch.float32 and not lse.requires_grad


def test_unported_options_raise():
    """``row_max`` is not ported; ``fullint=True`` over float K/V takes the
    exact kernels (the full-integer backward needs quantized K/V), giving
    ``fullint=False``'s gradients bit for bit, as in the JAX package; and
    quantized K/V run, matching the JAX package's backward over them."""
    q, k, v, do, _ = _inputs("causal_gqa", seed=7)
    tq, tk, tv, tdo = _torch(q, k, v, do)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_forward(tq, tk, tv, row_max="estimate")
    o, lse = tfa.flash_attention_forward(tq, tk, tv)
    exact = flash_attention_backward(tq, tk, tv, o, lse, tdo)
    for a, b in zip(exact[:3], flash_attention_backward(
            tq, tk, tv, o, lse, tdo, fullint=True)[:3]):
        assert torch.equal(a, b)
    tcfg = tparams.QuantConfig(bits=8)
    kq, vq = ttensor.quantize(tk, tcfg), ttensor.quantize(tv, tcfg)

    def to_jax(t):
        return jtensor.QuantizedTensor(
            data=jnp.asarray(t.data.numpy()),
            scale=jnp.asarray(t.scale.numpy()),
            zero_point=jnp.asarray(t.zero_point.numpy()), sums=None,
            config=jparams.QuantConfig(bits=8), shape=t.shape)

    got = flash_attention_backward(tq, kq, vq, o, lse, tdo, fullint=True)
    with jax.default_matmul_precision("highest"):
        want = jbwd.flash_attention_backward(
            jnp.asarray(q), to_jax(kq), to_jax(vq), jnp.asarray(o.numpy()),
            jnp.asarray(lse.numpy()), jnp.asarray(do), block_sizes=JBS,
            fullint=True)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g.numpy(), w) <= TOL


def test_kernel_widths_and_zero_padded_lanes():
    """On the card a head dim runs at the next width the kernels are built
    for, its Q/K/V/dO lanes zero-padded: the padded call gives the same O,
    L and gradients in the head dim's lanes, and zeros in the rest."""
    assert [tfa.flash_width(d) for d in (16, 48, 64, 80, 96, 272, 288)] == [
        32, 64, 64, 128, 128, 288, 288]
    for d in (40, 304):
        with pytest.raises(ValueError):
            tfa.flash_width(d)
    q, k, v, do, _ = _inputs("window_causal_rect", seed=2)
    q, k, v, do = _torch(q, k, v, do)
    rr = tfa.row_ranges_tensor(tm.sliding_window(40, causal=True), 96, 160,
                               None, "cpu")
    kw = dict(scale=64 ** -0.5)
    o, lse = tfa.flash_attention_forward_plain(q, k, v, rr, **kw)
    po, plse = tfa.flash_attention_forward_plain(*tfa.pad_lanes(80, q, k, v),
                                                 rr, **kw)
    assert _rel(po[..., :64].numpy(), o.numpy()) <= TOL
    assert _rel(plse.numpy(), lse.numpy()) <= TOL
    assert not po[..., 64:].any()
    di = (do * o).sum(-1)
    grads = (fbwd.flash_attention_dq_plain(q, k, v, do, lse, di, rr, **kw)[0],
             *fbwd.flash_attention_dkv_plain(q, k, v, do, lse, di, rr, **kw))
    padded = tfa.pad_lanes(80, q, k, v, do)
    pgrads = (fbwd.flash_attention_dq_plain(*padded, lse, di, rr, **kw)[0],
              *fbwd.flash_attention_dkv_plain(*padded, lse, di, rr, **kw))
    for got, want in zip(pgrads, grads):
        assert _rel(got[..., :64].numpy(), want.numpy()) <= TOL
        assert not got[..., 64:].any()

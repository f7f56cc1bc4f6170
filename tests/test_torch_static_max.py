"""Port parity: the flash forward's static-max mode (``row_max``).

The same seeded numpy inputs go through both packages in fp32.  The JAX
side runs at HIGHEST matmul precision, its Pallas kernel in interpret mode
with 128-tiles; the port's side runs the plain version its wrapper takes
on the CPU.  Tolerances: ``estimate_row_max_scaled`` within 1e-5 relative
(the same fp32 norms and sampled products, summed in another order); O
against the JAX static-max kernel at TOLERANCES["fp32"] and L at 1e-4 (max
abs over the JAX value's max abs: L adds ln l to M·ln2, whose rounding
the fp32 sums of both sides see); against the
port's own running-max forward at the JAX package's own static-max
tolerances (O 1e-5, L 1e-3 max abs), since a shift of the softmax only
moves where exp2 rounds.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jm
from metal_flash_attention_plus_tpu_torch.attention import masking as tm
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)

tfa = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")
jfa = importlib.import_module(
    "metal_flash_attention_plus_tpu.ops.flash_attention")

L_TOL = 1e-4
JBS = jfa.BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                     block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)


def _segments(s):
    r = jm.build_segment_ranges(np.repeat(np.arange(3), -(-s // 3))[:s])
    r = r.copy()
    r[s // 3] = (5, 5)  # an empty row
    return r


# name: (B, Hq, Hkv, Sq, Skv, D, (torch spec, JAX spec, ranges), interleaved)
CASES = {
    "full": (1, 4, 2, 256, 320, 64, (tm.FULL, jm.FULL, None), False),
    "causal": (2, 2, 1, 256, 320, 64, (tm.CAUSAL, jm.CAUSAL, None), False),
    "window": (1, 4, 2, 256, 256, 32,
               (tm.sliding_window(128), jm.sliding_window(128), None), False),
    "window_causal_interleaved": (
        1, 4, 2, 200, 200, 32,
        (tm.sliding_window(64, causal=True),
         jm.sliding_window(64, causal=True), None), True),
    "segments_mqa": (
        1, 2, 1, 150, 150, 16,
        (tm.MaskSpec(tm.MaskKind.SPARSE_RANGES),
         jm.MaskSpec(jm.MaskKind.SPARSE_RANGES), _segments(150)), False),
    # MLA's latent attention: 16 query heads over one KV head at D = 288.
    "mla_d288": (1, 16, 1, 128, 128, 288, (tm.CAUSAL, jm.CAUSAL, None),
                 False),
    # DeepSeek-V2's absorbed width 512 + 64.
    "mla_d576": (1, 16, 1, 128, 128, 576, (tm.CAUSAL, jm.CAUSAL, None),
                 False),
}


def _inputs(name, seed=0):
    b, hq, hkv, sq, skv, d = CASES[name][:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(out), finite)
    assert np.array_equal(out[~finite], ref[~finite])
    return np.abs(out[finite] - ref[finite]).max() / max(
        np.abs(ref[finite]).max(), 1e-30)


def _abs(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(out), finite)
    return np.abs(out[finite] - ref[finite]).max()


def _true_row_max(q, k, hq, hkv, interleaved):
    """The natural-unit row max scale·q·k over every key, + 5."""
    d = q.shape[-1]
    heads = [(h % hkv) if interleaved else h // (hq // hkv)
             for h in range(hq)]
    s = np.einsum("bhrd,bhcd->bhrc", q.astype(np.float64),
                  k[:, heads].astype(np.float64)) / np.sqrt(d)
    return (s.max(-1) + 5.0).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_estimate_row_max_matches_jax(name):
    b, hq, hkv, sq, skv, d, (tspec, jspec, ranges), inter = CASES[name]
    q, k, _ = _inputs(name)
    scale = d ** -0.5
    qs = (q * np.float32(scale * tfa.LOG2E)).astype(np.float32)
    group = hq // hkv

    def head(h):
        return h % hkv if inter else h // group

    jr = (None if ranges is None else
          jfa.compute_row_ranges(jspec, sq, skv, mask_ranges=ranges))
    with jax.default_matmul_precision("highest"):
        want = jfa.estimate_row_max_scaled(
            jnp.asarray(qs), jnp.asarray(k), jspec, row_ranges=jr,
            kv_head_of=head, seq_q=sq, seq_kv=skv)
    tr = (None if ranges is None else
          tfa.row_ranges_tensor(tspec, sq, skv, ranges, torch.device("cpu")))
    got = tfa.estimate_row_max_scaled(
        torch.from_numpy(qs), torch.from_numpy(k), tspec, row_ranges=tr,
        kv_head_of=head, seq_q=sq, seq_kv=skv)
    assert got.shape == (b, hq, sq) and got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["estimate", "caller"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_static_max_matches_jax_kernel(name, mode):
    b, hq, hkv, sq, skv, d, (tspec, jspec, ranges), inter = CASES[name]
    q, k, v = _inputs(name, seed=1)
    rm = ("estimate" if mode == "estimate"
          else _true_row_max(q, k, hq, hkv, inter))
    with jax.default_matmul_precision("highest"):
        jo, jl = jfa.flash_attention_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jspec,
            mask_ranges=ranges, block_sizes=JBS, interleaved_kv=inter,
            row_max=rm if mode == "estimate" else jnp.asarray(rm),
            interpret=True)
    to, tl = tfa.flash_attention_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), mask=tspec,
        mask_ranges=ranges, interleaved_kv=inter,
        row_max=rm if mode == "estimate" else torch.from_numpy(rm))
    assert _rel(to.numpy(), jo) <= TOLERANCES["fp32"]
    assert _rel(tl.numpy(), jl) <= L_TOL


@pytest.mark.parametrize("mode", ["estimate", "caller"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_static_max_matches_running_max(name, mode):
    b, hq, hkv, sq, skv, d, (tspec, _, ranges), inter = CASES[name]
    q, k, v = (torch.from_numpy(x) for x in _inputs(name, seed=2))
    rm = ("estimate" if mode == "estimate" else torch.from_numpy(
        _true_row_max(q.numpy(), k.numpy(), hq, hkv, inter)))
    kw = dict(mask=tspec, mask_ranges=ranges, interleaved_kv=inter)
    o0, l0 = tfa.flash_attention_forward(q, k, v, **kw)
    o1, l1 = tfa.flash_attention_forward(q, k, v, row_max=rm, **kw)
    assert _abs(o1.numpy(), o0.numpy()) <= 1e-5
    assert _abs(l1.numpy(), l0.numpy()) <= 1e-3


def test_row_max_errors():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention_forward(q, q, q, bias=torch.zeros(1, 1, 8, 8),
                                    row_max="estimate")
    with pytest.raises(ValueError, match="row_max"):
        tfa.flash_attention_forward(q, q, q, row_max="exact")

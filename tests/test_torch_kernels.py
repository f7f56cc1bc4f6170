"""The port's CUDA kernels held to their plain PyTorch versions, on the card.

Every test here needs an NVIDIA CUDA device and skips without one.  The
file imports nothing of JAX, so on a machine with the card and no JAX it
runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: fp32 inputs are held to TOLERANCES["fp32"]; bf16 inputs to
2e-2 — the kernel and the plain version round the same values to bf16 at
the same places (q after scaling, P before P·V, dS before dS·K), so what
is left is the order of fp32 accumulation and, in the forwards, the
one-pass vs online softmax rescaling of P before its bf16 rounding.  The
paged kernels are held in max abs error, the flash kernels in max abs
error over the plain version's max abs (their gradients reach ~10).  The
paged kernels' int8/int4 pool modes take the same tolerances.  The
dynamic W8A8/W4A8 GEMM is held bit for bit: both sides sum the int8
products exactly and round the epilogue at the same places.  The quantized
attention kernels are held as the flash kernels: fp32 where nothing is
rounded (an fp32 Q with dequantized or integer K/V), 2e-2 (L 7e-3) where P
is rounded (a bf16 Q, the int8 P of ``int8_pv``, the head-pair kernel's
bf16 P); the plain version takes the kernel's key spans (``kv_tile``).
The runtime quantization kernels are held bit for bit.  The weight-only
and quantized-A GEMM kernels sum exact products (bf16 × int8, bf16 × bf16)
or fp32 ones in another order than the plain versions: an fp32 result
within TOLERANCES["fp32"] of its max abs, a bf16 one within one bf16 ulp
(the weight-only ones: their bf16 / fp16 results equal their fp32 ones
rounded, bit for bit);
so does the small-block compensated kernel, while the compensated kernel
is held bit for bit (exact integer compensation, the same fused
multiply-add per block).  The quantized attention kernels at head dims
outside their built widths (80, 96) run zero-padded and take the same
tolerances.  MLA's
modes of the paged kernels (one-state latent pages, ``v_tail_zero``,
D = 80, 288, DeepSeek's 576 and 320 (run at 576), Hq = 16 over Hkv = 1)
and of the flash kernels (D = 80, 288, DeepSeek's 576 and 320, run at 576)
take their kernels' tolerances; so do the paged and flash kernels' scalar
instances above 288; above 576 the paged and flash wrappers run the
split-D kernels (O's lanes split over CTAs, 580 to 2048 here), which take
the same tolerances and repeat bit for bit.  The
paged decode splits the KV axis across CTAs and merges the splits in a fixed order, so two calls on the
same inputs are held equal bit for bit (at 576 the prefill too); so are
the bf16 forward, dQ and
dK/dV at D = 288 and 576 (``flash_fwd_wide_kernel`` and
``flash_fwd_latent_kernel`` in both of their modes, the wide and the
latent bodies; the dK/dV's GQA group split over CTAs and merged in split
order, the merge kernel bit for bit with its plain version), which take
the flash kernels' bf16 tolerances, and the quantized kernels at MLA's
width (the wide forward, the exact dQ and dK/dV and the full-integer pair
at 272 / 288) and at DeepSeek's (the latent forward, the exact dQ and
dK/dV and their fp32 instances at 320 / 512 / 576), which take the
quantized ones'; past 576 the quantized forward, the exact dQ and dK/dV
and the full-integer pair run the split-D kernels (O's, dQ's, dK's and
dV's lanes split over CTAs), which take the same tolerances.  The flash
forward's static-max mode (``row_max``) takes the flash forward's
tolerances, the kernel and the plain version given the same subtrahends;
the dynamic GEMM under a stored plan stays bit for bit, and the
weight-only GEMM under one takes its tolerance.  ``MultiHeadAttention``
launches exactly the flash kernels its entry points name and equals the
direct calls bit for bit.
"""

import ctypes
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention import masking
from metal_flash_attention_plus_tpu_torch.attention import tuning
from metal_flash_attention_plus_tpu_torch.attention.descriptor import (
    AttentionDescriptor,
)
from metal_flash_attention_plus_tpu_torch.attention.multi_head import (
    MultiHeadAttention,
)
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    LOG2E,
    SPLIT_D_SLICE,
    BlockSizes,
    DTYPE_CODES,
    estimate_row_max_scaled,
    flash_attention,
    flash_attention_forward,
    flash_attention_forward_plain,
    flash_fwd,
    fwd_body,
    row_ranges_tensor,
    split_d_slices,
)
from metal_flash_attention_plus_tpu_torch.ops import flash_attention_bwd as fbwd
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_dkv,
    flash_dq,
)
from metal_flash_attention_plus_tpu_torch.ops import quantized_attention as qa
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm as qg
from metal_flash_attention_plus_tpu_torch.ops import runtime_quantization as rq
from metal_flash_attention_plus_tpu_torch.ops.hadamard import (
    hadamard_transform,
)
from metal_flash_attention_plus_tpu_torch.quant import params as qparams
from metal_flash_attention_plus_tpu_torch.quant.tensor import quantize
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)

BF16_TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return torch.device("cuda")


def _tol(dtype):
    return TOLERANCES["fp32"] if dtype == torch.float32 else BF16_TOL


def _inputs(rng, hkv, num_pages, pt, d, lengths, max_pages):
    pool = rng.standard_normal((hkv, num_pages + 1, 2 * pt, d))
    perm = rng.permutation(num_pages)
    table = np.full((len(lengths), max_pages), num_pages, np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        pages = -(-n // pt)
        table[i, :pages] = perm[nxt: nxt + pages]
        nxt += pages
    return pool.astype(np.float32), table


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "hq,hkv,d,pt",
    [(4, 2, 32, 16), (16, 4, 64, 256), (8, 2, 128, 64), (2, 2, 64, 48),
     # Head dims off the multiples of 16: rows of 8, 4 or 2 bytes' copies.
     (4, 2, 8, 16), (4, 2, 20, 16), (8, 2, 24, 64), (4, 2, 33, 16),
     (8, 1, 40, 64), (16, 1, 72, 256), (4, 2, 300, 16)],
)
def test_decode_kernel_matches_plain(cuda_device, dtype, hq, hkv, d, pt):
    rng = np.random.default_rng(0)
    lengths = np.asarray([1, pt, pt + 1, 3 * pt - 5, 1], np.int32)
    max_pages = 4
    pool, table = _inputs(rng, hkv, 16, pt, d, lengths, max_pages)
    q = rng.standard_normal((len(lengths), hq, d)).astype(np.float32)
    args = [torch.from_numpy(q).to(cuda_device, dtype),
            torch.from_numpy(pool).to(cuda_device, dtype),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device)]
    n = paged_decode_attention.launches
    out = paged_decode_attention(*args, page_tokens=pt)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n + 1
    ref = paged_decode_attention_plain(*args, page_tokens=pt)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "hq,hkv,d,pt,chunk,offset",
    [
        (4, 2, 32, 16, 8, 0),
        (4, 2, 32, 16, 8, 16),
        (4, 2, 32, 16, 8, 21),
        (16, 4, 64, 256, 256, 0),
        (16, 4, 64, 256, 256, 512),
        (16, 4, 64, 256, 256, 300),
        (8, 2, 128, 64, 48, 70),
        (2, 2, 64, 48, 40, 100),  # group 1, pages not a multiple of 64
        # Head dims off the multiples of 16.
        (4, 2, 8, 16, 8, 21),
        (4, 2, 20, 16, 8, 16),
        (8, 2, 24, 64, 48, 70),
        (4, 2, 33, 16, 8, 21),
        (8, 1, 40, 256, 256, 300),
        (16, 1, 72, 256, 256, 512),
    ],
)
def test_prefill_kernel_matches_plain(cuda_device, dtype, hq, hkv, d, pt,
                                      chunk, offset):
    rng = np.random.default_rng(1)
    max_pages = -(-(offset + chunk) // pt) + 1
    pool, table = _inputs(rng, hkv, max_pages + 2, pt, d, [offset + chunk],
                          max_pages)
    q = rng.standard_normal((hq, chunk, d)).astype(np.float32)
    args = [torch.from_numpy(q).to(cuda_device, dtype),
            torch.from_numpy(pool).to(cuda_device, dtype),
            torch.from_numpy(table[0]).to(cuda_device)]
    n = paged_prefill_attention.launches
    out = paged_prefill_attention(*args, offset, page_tokens=pt)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n + 1
    ref = paged_prefill_attention_plain(*args, offset, page_tokens=pt)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim(cuda_device):
    """40 (not a multiple of 16) runs: one launch, the plain version's
    output, the pool untouched; a head dim of 0 has no kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(40)
    q = torch.randn(1, 2, 40, device=cuda_device, generator=g)
    pool = torch.randn(1, 2, 32, 40, device=cuda_device, generator=g)
    table = torch.zeros(1, 1, dtype=torch.int32, device=cuda_device)
    lengths = torch.full((1,), 16, dtype=torch.int32, device=cuda_device)
    before = pool.clone()
    n = paged_decode_attention.launches
    out = paged_decode_attention(q, pool, table, lengths)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n + 1
    ref = paged_decode_attention_plain(q, pool, table, lengths)
    assert out.shape == (1, 2, 40) and torch.equal(pool, before)
    assert (out - ref).abs().max().item() <= _tol(torch.float32)
    with pytest.raises(ValueError):
        paged_decode_attention(q[..., :0], pool[..., :0], table, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_reject_head_dims_past_576(cuda_device, dtype):
    """592 is past DeepSeek's absorbed width: both wrappers no longer raise
    there but launch the split-D kernels, once each, with the plain
    versions' results and V's zeroed tail zero in O."""
    from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
        decode_body,
        prefill_body,
    )

    d, pt, vtz = 592, 16, 64
    assert decode_body(dtype, d) == prefill_body(dtype, d, 1, vtz) == (
        "split_d")
    g = torch.Generator(device=cuda_device).manual_seed(592)
    pool = torch.randn(1, 3, pt, d, generator=g, device=cuda_device).to(dtype)
    table = torch.tensor([[1, 0]], dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([20], dtype=torch.int32, device=cuda_device)
    q = torch.randn(1, 16, d, generator=g, device=cuda_device).to(dtype)
    qp = torch.randn(16, 8, d, generator=g, device=cuda_device).to(dtype)
    kw = dict(v_tail_zero=vtz)
    n = (paged_decode_attention.launches, paged_prefill_attention.launches)
    out = paged_decode_attention(q, pool, table, lengths, **kw)
    pf = paged_prefill_attention(qp, pool, table[0], 12, **kw)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == (n[0] + 1, n[1] + 1)
    for got, want in (
            (out, paged_decode_attention_plain(q, pool, table, lengths, **kw)),
            (pf, paged_prefill_attention_plain(qp, pool, table[0], 12, **kw))):
        assert got.shape == want.shape
        assert (got.float() - want.float()).abs().max().item() <= _tol(dtype)
        assert not got[..., d - vtz:].float().abs().max().item()


# --------------------------------------------------------------------------
# Flash attention: forward, dQ, dK/dV
# --------------------------------------------------------------------------


def _rel(out, ref):
    ref = ref.float()
    scale = ref[torch.isfinite(ref)].abs().max().clamp_min(1e-30)
    both_inf = torch.isinf(ref) & (out.float() == ref)
    diff = torch.where(both_inf, torch.zeros_like(ref), out.float() - ref)
    return (diff.abs().max() / scale).item()


def _flash_case(device, dtype, b, hq, hkv, sq, skv, d, mask, ranges=None,
                bias_shape=None, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    q, k, v = t(b, hq, sq, d), t(b, hkv, skv, d), t(b, hkv, skv, d)
    do = t(b, hq, sq, d)
    bias = None if bias_shape is None else t(*bias_shape)
    rr = row_ranges_tensor(mask, sq, skv, ranges, device)
    return ([x.to(dtype) for x in (q, k, v)], do.to(dtype), bias, rr)


def _segments_with_empty_row():
    ranges = masking.build_segment_ranges(np.repeat(np.arange(5), 26))
    ranges[7] = (40, 40)
    return ranges


FLASH_CASES = {
    # name: (b, hq, hkv, sq, skv, d, mask, ranges, bias shape)
    "causal_gqa4": (2, 8, 2, 160, 160, 64, masking.CAUSAL, None, None),
    "full_group1": (1, 2, 2, 96, 130, 32, masking.FULL, None, None),
    "window_causal": (1, 4, 1, 200, 200, 128, masking.sliding_window(
        48, causal=True), None, None),
    "segments_empty_row": (
        1, 4, 2, 130, 130, 64, masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
        _segments_with_empty_row(), None),
    "block_sparse": (1, 4, 4, 128, 128, 64, masking.MaskSpec(
        masking.MaskKind.BLOCK_SPARSE, block_size=32), masking.
        build_block_sparse_ranges(np.eye(4, dtype=bool) | np.eye(
            4, k=-1, dtype=bool), 32), None),
    "bias_bcast": (2, 4, 2, 70, 90, 64, masking.CAUSAL, None, (1, 4, 70, 90)),
    "ragged_rect": (1, 4, 4, 1000 // 8, 1000, 256, masking.CAUSAL, None,
                    None),
    # Where the tensor-core dK/dV body's tiling is at risk: a key tile's
    # query span starting mid-tile (Sq < Skv, ends aligned), causal rows
    # with no live key (Sq > Skv), a group of 4 at D=256, bias at D=128.
    "rect_span_mid_tile": (1, 4, 2, 150, 250, 64, masking.CAUSAL, None,
                           None),
    "rect_empty_rows_d128": (1, 4, 2, 250, 150, 128, masking.CAUSAL, None,
                             None),
    "gqa4_d256": (1, 8, 2, 200, 200, 256, masking.CAUSAL, None, None),
    "bias_d128": (2, 4, 2, 100, 130, 128, masking.CAUSAL, None,
                  (2, 1, 100, 130)),
    # Where the tensor-core forward's walk is at risk (64-key tiles aligned
    # from key 0): window rows starting mid-tile, so a row's first tiles
    # are fully masked and alpha must wipe the mask_value transient; Sq
    # not a multiple of 64 with empty rows (Sq > Skv, causal); a group of 4
    # at D=256 with ragged Sq (both GQA layouts: every case runs
    # interleaved too); bias at D=32 over an odd Skv (unaligned float2
    # pairs).
    "window_mid_tile": (1, 4, 2, 300, 300, 64, masking.sliding_window(
        100, causal=True), None, None),
    "ragged_sq_empty_rows": (1, 4, 2, 190, 120, 64, masking.CAUSAL, None,
                             None),
    "gqa4_d256_ragged": (1, 8, 2, 130, 200, 256, masking.CAUSAL, None,
                         None),
    "bias_d32": (2, 4, 2, 100, 131, 32, masking.CAUSAL, None,
                 (2, 4, 100, 131)),
    # DeepSeek's absorbed width 576 (the latent bf16 bodies, the fp32
    # kernels' 32-row tiles) and 320 run at 576: window rows starting
    # mid-tile, bias over an odd Skv, sparse rows with an empty row, causal
    # rows with no live key (Sq > Skv).
    "window_mid_tile_d576": (1, 4, 2, 300, 300, 576, masking.sliding_window(
        100, causal=True), None, None),
    "bias_d576": (2, 4, 2, 100, 131, 576, masking.CAUSAL, None,
                  (2, 1, 100, 131)),
    "segments_empty_row_d320": (
        1, 4, 2, 130, 130, 320, masking.MaskSpec(
            masking.MaskKind.SPARSE_RANGES), _segments_with_empty_row(),
        None),
    "rect_empty_rows_d576": (1, 4, 2, 250, 150, 576, masking.CAUSAL, None,
                             None),
    # Above 576 the split-D kernels (O's lanes over CTAs, the scores over
    # the whole head dim in 32-lane chunks): window rows starting mid-tile,
    # bias over an odd Skv, sparse rows with an empty row, causal rows with
    # no live key, a group of 16 over one head off the multiples of 16.
    "window_mid_tile_d640": (1, 4, 2, 300, 300, 640, masking.sliding_window(
        100, causal=True), None, None),
    "bias_d608": (2, 4, 2, 100, 131, 608, masking.CAUSAL, None,
                  (2, 1, 100, 131)),
    "segments_empty_row_d1152": (
        1, 4, 2, 130, 130, 1152, masking.MaskSpec(
            masking.MaskKind.SPARSE_RANGES), _segments_with_empty_row(),
        None),
    "rect_empty_rows_d1024": (1, 4, 2, 250, 150, 1024, masking.CAUSAL, None,
                              None),
    "gqa16_d580": (1, 16, 1, 130, 130, 580, masking.CAUSAL, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda_device, dtype, interleaved, name):
    (q, k, v), do, bias, rr = _flash_case(cuda_device, dtype,
                                          *FLASH_CASES[name])
    scale = q.shape[-1] ** -0.5
    kw = dict(bias=bias, scale=scale, interleaved_kv=interleaved)
    n = (flash_fwd.launches, flash_dq.launches, flash_dkv.launches)
    o, lse = flash_fwd(q, k, v, rr, **kw)
    torch.cuda.synchronize()
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    tol = _tol(dtype)
    assert _rel(o, o_ref) <= tol
    assert _rel(lse, l_ref) <= (TOLERANCES["fp32"] if dtype == torch.float32
                                else TOLERANCES["lse"])
    di = (do.float() * o_ref).sum(-1)
    dq, dbias = flash_dq(q, k, v, do, l_ref, di, rr, want_dbias=bias
                         is not None, **kw)
    dk, dv = flash_dkv(q, k, v, do, l_ref, di, rr, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_dq.launches, flash_dkv.launches) == (
        n[0] + 1, n[1] + 1, n[2] + 1)
    dq_ref, dbias_ref = flash_attention_dq_plain(
        q, k, v, do, l_ref, di, rr, want_dbias=bias is not None, **kw)
    dk_ref, dv_ref = flash_attention_dkv_plain(q, k, v, do, l_ref, di, rr,
                                               **kw)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= tol
    if bias is not None:
        assert _rel(dbias, dbias_ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 48, 64, 80, 128, 256, 288, 320, 576,
                               8, 20, 24, 33, 40, 72, 300,
                               580, 608, 640, 1024, 1152, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_every_head_dim(cuda_device, d, dtype):
    """Each built width, 48 (run at 64, zero-padded) and 320 (at 576); the
    head dims off the multiples of 16 (8 and 20 at 32, 33 and 40 at 64, 72
    at 128, 300 at 576); above 576 the split-D kernels (580 run at 592)."""
    (q, k, v), do, _, rr = _flash_case(cuda_device, dtype, 1, 4, 1, 150, 150,
                                       d, masking.CAUSAL, seed=d)
    kw = dict(scale=d ** -0.5)
    o, lse = flash_fwd(q, k, v, rr, **kw)
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    di = (do.float() * o_ref).sum(-1)
    dq, _ = flash_dq(q, k, v, do, l_ref, di, rr, **kw)
    dk, dv = flash_dkv(q, k, v, do, l_ref, di, rr, **kw)
    torch.cuda.synchronize()
    dq_ref, _ = flash_attention_dq_plain(q, k, v, do, l_ref, di, rr, **kw)
    dk_ref, dv_ref = flash_attention_dkv_plain(q, k, v, do, l_ref, di, rr,
                                               **kw)
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert _rel(got, want) <= _tol(dtype)


# The tensor-core dQ body (bf16 up to D = 256) at each built width, where
# its tiling is at risk: a causal group of 4, a window over interleaved GQA
# (rows whose first tiles are fully masked), sparse ranges with an empty
# row, bias with dbias over an odd Skv, Skv < 64 < Sq (causal rows with no
# live key, Sq not a multiple of 64) and a full mask over Skv > Sq.
# name: (b, hq, hkv, sq, skv, mask, ranges, bias shape, interleaved)
DQ_TC_CASES = {
    "causal_gqa4": (2, 8, 2, 160, 160, masking.CAUSAL, None, None, False),
    "window_interleaved": (1, 8, 2, 200, 200, masking.sliding_window(
        48, causal=True), None, None, True),
    "segments_empty_row": (
        1, 4, 2, 130, 130, masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
        _segments_with_empty_row(), None, False),
    "bias_dbias": (2, 4, 2, 100, 131, masking.CAUSAL, None, (2, 1, 100, 131),
                   False),
    "short_kv_empty_rows": (1, 4, 2, 190, 40, masking.CAUSAL, None, None,
                            False),
    "full_rect": (1, 4, 4, 70, 300, masking.FULL, None, None, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("name", sorted(DQ_TC_CASES))
def test_flash_dq_tensor_core_body_matches_plain(cuda_device, name, d):
    """The bf16 dQ (and dbias) on the tensor-core body against the plain
    version, one launch a call, max abs over the plain's max abs at the
    bf16 gate."""
    b, hq, hkv, sq, skv, mask, ranges, bias_shape, inter = DQ_TC_CASES[name]
    (q, k, v), do, bias, rr = _flash_case(
        cuda_device, torch.bfloat16, b, hq, hkv, sq, skv, d, mask, ranges,
        bias_shape, seed=d)
    assert fbwd.dq_body(q.dtype, d) == "tensor_core"
    kw = dict(bias=bias, scale=d ** -0.5, interleaved_kv=inter)
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    di = (do.float() * o_ref).sum(-1)
    n = flash_dq.launches
    dq, dbias = flash_dq(q, k, v, do, l_ref, di, rr,
                         want_dbias=bias is not None, **kw)
    torch.cuda.synchronize()
    assert flash_dq.launches == n + 1
    dq_ref, dbias_ref = flash_attention_dq_plain(
        q, k, v, do, l_ref, di, rr, want_dbias=bias is not None, **kw)
    assert dq.dtype == torch.float32 and dq.shape == dq_ref.shape
    assert torch.isfinite(dq).all()
    assert _rel(dq, dq_ref) <= BF16_TOL, name
    if bias is not None:
        assert _rel(dbias, dbias_ref) <= BF16_TOL, name


# The tensor-core dQ and dK/dV at MLA's width 288 (the wide bodies: the
# dK/dV in 48-row query steps with the GQA group split over CTAs and merged,
# the dQ in 32-key tiles), where their tiling is at risk: MLA's 16 q heads
# over one latent head (16 splits of one head; 8 of two at B=4, S=2048), 4
# over 2 interleaved (2 splits), a group of 3 (runs of 2 and 1), a causal
# mask over a ragged S = 300, a sliding window, sparse rows with an empty
# row, bias with dbias over an odd Skv, Sq < Skv and Sq > Skv (causal rows
# with no live key), and D = 272 (run at 288).  The same cases at
# DeepSeek's absorbed width 576 (the latent bodies: the dK/dV in 32-key
# CTAs and 32-row query steps, the dQ over single-buffered 32-key tiles),
# D = 320 (run at 576) and V2-Lite's training shape (B=2, S=2048: 8 splits
# of 2 heads).
# name: (b, hq, hkv, sq, skv, d, mask, ranges, bias shape, interleaved)
WIDE_CASES = {
    "mla_causal_s300": (2, 16, 1, 300, 300, 288, masking.CAUSAL, None, None,
                        False),
    "gqa_interleaved_s300": (1, 4, 2, 300, 300, 288, masking.CAUSAL, None,
                             None, True),
    "mla_window": (1, 16, 1, 300, 300, 288, masking.sliding_window(
        100, causal=True), None, None, False),
    "segments_empty_row": (
        1, 4, 2, 130, 130, 288, masking.MaskSpec(
            masking.MaskKind.SPARSE_RANGES), _segments_with_empty_row(), None,
        True),
    "mla_segments_empty_row": (
        1, 16, 1, 130, 130, 288, masking.MaskSpec(
            masking.MaskKind.SPARSE_RANGES), _segments_with_empty_row(), None,
        False),
    "bias_dbias": (2, 4, 2, 100, 131, 288, masking.CAUSAL, None,
                   (2, 1, 100, 131), False),
    "mla_bias_dbias": (1, 16, 1, 100, 131, 288, masking.CAUSAL, None,
                       (1, 16, 100, 131), False),
    "mla_sq_lt_skv": (1, 16, 1, 150, 300, 288, masking.CAUSAL, None, None,
                      False),
    "gqa_sq_gt_skv": (1, 4, 2, 300, 150, 288, masking.CAUSAL, None, None,
                      True),
    "mla_d272": (1, 16, 1, 300, 300, 272, masking.CAUSAL, None, None, False),
    "group3_uneven_runs": (1, 3, 1, 300, 300, 288, masking.CAUSAL, None, None,
                           False),
    "mla_b4_s2048_runs_of_2": (4, 16, 1, 2048, 2048, 288, masking.CAUSAL,
                               None, None, False),
    "d576_mla_causal_s300": (2, 16, 1, 300, 300, 576, masking.CAUSAL, None,
                             None, False),
    "d576_gqa_interleaved_s300": (1, 4, 2, 300, 300, 576, masking.CAUSAL,
                                  None, None, True),
    "d576_mla_window": (1, 16, 1, 300, 300, 576, masking.sliding_window(
        100, causal=True), None, None, False),
    "d576_segments_empty_row": (
        1, 4, 2, 130, 130, 576, masking.MaskSpec(
            masking.MaskKind.SPARSE_RANGES), _segments_with_empty_row(), None,
        True),
    "d576_mla_bias_dbias": (1, 16, 1, 100, 131, 576, masking.CAUSAL, None,
                            (1, 16, 100, 131), False),
    "d576_mla_sq_lt_skv": (1, 16, 1, 150, 300, 576, masking.CAUSAL, None,
                           None, False),
    "d576_gqa_sq_gt_skv": (1, 4, 2, 300, 150, 576, masking.CAUSAL, None,
                           None, True),
    "d576_group3_uneven_runs": (1, 3, 1, 300, 300, 576, masking.CAUSAL, None,
                                None, False),
    "d320_mla": (1, 16, 1, 300, 300, 320, masking.CAUSAL, None, None, False),
    "d576_v2_lite_b2_s2048": (2, 16, 1, 2048, 2048, 576, masking.CAUSAL,
                              None, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_flash_wide_bodies_match_plain(cuda_device, name):
    """The bf16 dQ (and dbias) and dK/dV at D = 288 and 576 on the
    tensor-core wide and latent bodies against their plain versions, max
    abs over the plain's max abs at the bf16 gate; one dQ and one dK/dV
    launch a call, plus one merge where the dK/dV splits; two calls equal
    bit for bit."""
    b, hq, hkv, sq, skv, d, mask, ranges, bias_shape, inter = WIDE_CASES[
        name]
    (q, k, v), do, bias, rr = _flash_case(
        cuda_device, torch.bfloat16, b, hq, hkv, sq, skv, d, mask, ranges,
        bias_shape, seed=len(name))
    assert fbwd.dq_body(q.dtype, d) == fbwd.dkv_body(q.dtype, d) == (
        "tensor_core")
    splits = fbwd.dkv_splits(q.dtype, d, b, hq, hkv, skv,
                             torch.cuda.get_device_properties(
                                 cuda_device).multi_processor_count)
    want_dbias = bias is not None
    kw = dict(bias=bias, scale=d ** -0.5, interleaved_kv=inter)
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    di = (do.float() * o_ref).sum(-1)
    runs = []
    for _ in range(2):
        n = (flash_dq.launches, flash_dkv.launches,
             fbwd.merge_dkv_splits.launches)
        dq, dbias = flash_dq(q, k, v, do, l_ref, di, rr,
                             want_dbias=want_dbias, **kw)
        dk, dv = flash_dkv(q, k, v, do, l_ref, di, rr, **kw)
        torch.cuda.synchronize()
        assert (flash_dq.launches - n[0], flash_dkv.launches - n[1],
                fbwd.merge_dkv_splits.launches - n[2]) == (
                    1, 1, int(splits > 1)), name
        runs.append((dq, dbias, dk, dv))
    dq_ref, dbias_ref = flash_attention_dq_plain(
        q, k, v, do, l_ref, di, rr, want_dbias=want_dbias, **kw)
    dk_ref, dv_ref = flash_attention_dkv_plain(q, k, v, do, l_ref, di, rr,
                                               **kw)
    dq, dbias, dk, dv = runs[0]
    for got, want, what in ((dq, dq_ref, "dq"), (dk, dk_ref, "dk"),
                            (dv, dv_ref, "dv"), (dbias, dbias_ref, "dbias")):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.float32 and got.shape == want.shape, what
        assert torch.isfinite(got).all(), what
        assert _rel(got, want) <= BF16_TOL, (name, what)
    for first, second in zip(*runs):
        assert (first is None and second is None) or torch.equal(
            first, second), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["running_max", "row_max"])
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_flash_wide_forward_matches_plain(cuda_device, name, mode):
    """The bf16 forward at D = 288 (272 runs at 288) and 576 (320 runs at
    576) on the tensor cores (``flash_fwd_wide_kernel``,
    ``flash_fwd_latent_kernel``) against its plain version over the wide
    and latent bodies' cases, with the running max and with a caller's
    ``row_max`` (the true row max + 5; that mode takes no bias, so the
    bias cases run there without theirs): O's max abs over the plain's at
    the bf16 gate, L at the lse gate, -inf exactly where the plain has it;
    one launch a call; two calls equal bit for bit."""
    b, hq, hkv, sq, skv, d, mask, ranges, bias_shape, inter = WIDE_CASES[
        name]
    static = mode == "row_max"
    (q, k, v), _, bias, rr = _flash_case(
        cuda_device, torch.bfloat16, b, hq, hkv, sq, skv, d, mask, ranges,
        None if static else bias_shape, seed=len(name))
    assert fwd_body(q.dtype, d) == "tensor_core"
    scale = d ** -0.5
    kw = dict(bias=bias, scale=scale, interleaved_kv=inter)
    if static:
        kw["row_max"] = _static_row_max(q, k, mask, rr, "caller", scale, hq,
                                        hkv, interleaved=inter)
    runs = []
    for _ in range(2):
        n = flash_fwd.launches
        runs.append(flash_fwd(q, k, v, rr, **kw))
        torch.cuda.synchronize()
        assert flash_fwd.launches == n + 1, name
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    o, lse = runs[0]
    assert o.dtype == torch.float32 and o.shape == o_ref.shape == q.shape
    assert lse.shape == l_ref.shape == q.shape[:3]
    assert torch.isfinite(o).all(), name
    assert _rel(o, o_ref) <= BF16_TOL, name
    assert _rel(lse, l_ref) <= TOLERANCES["lse"], name
    assert all(torch.equal(x, y) for x, y in zip(*runs)), name


@pytest.mark.cuda
@pytest.mark.parametrize("splits,shape", [(8, (2, 1, 2048, 288)),
                                          (3, (1, 2, 131, 288)),
                                          (1, (1, 1, 64, 288))])
def test_dkv_merge_kernel_matches_plain_bit_for_bit(cuda_device, splits,
                                                    shape):
    """``flash_dkv_merge_kernel`` sums the splits in the plain version's
    order: equal bit for bit, one launch a call."""
    g = torch.Generator(device=cuda_device).manual_seed(splits)
    ws = torch.randn((splits, 2) + shape, generator=g, device=cuda_device)
    dk = torch.empty(shape, device=cuda_device)
    dv = torch.empty_like(dk)
    n = fbwd.merge_dkv_splits.launches
    fbwd.merge_dkv_splits(ws, dk, dv)
    torch.cuda.synchronize()
    assert fbwd.merge_dkv_splits.launches == n + 1
    want_k, want_v = fbwd.merge_dkv_splits_plain(ws)
    assert torch.equal(dk, want_k) and torch.equal(dv, want_v)


@pytest.mark.cuda
def test_backward_kernels_route_as_the_python_bodies_say(cuda_device):
    """The C launchers' routing (fwd_tc, mfa::dq_tc, dkv_tc, as the
    library reports it) agrees with fwd_body / dq_body / dkv_body at every
    built width: the bf16 forward, dQ and dK/dV at every width on the
    tensor cores (288 on flash_fwd_wide_kernel and the wide bodies, 576 on
    flash_fwd_latent_kernel and the latent bodies), fp32 on the scalar
    bodies; above 576 every multiple of 16 on the split-D kernels (bits 3,
    4 and 5) in both dtypes."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build
    from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
        DTYPE_CODES,
        fwd_body,
    )

    bodies = _build.kernel_function("mfa_flash_tc_bodies",
                                    [ctypes.c_int, ctypes.c_int])
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128, 256, 288, 576):
            bits = bodies(DTYPE_CODES[dtype], d)
            want = [f(dtype, d) == "tensor_core" for f in (
                fwd_body, fbwd.dq_body, fbwd.dkv_body)]
            assert [bool(bits >> i & 1) for i in range(3)] == want, (dtype, d)
            bf16 = dtype == torch.bfloat16
            assert want == [bf16, bf16, bf16]
        for d in (592, 640, 1024, 2048):
            want = [f(dtype, d) == "split_d" for f in (
                fwd_body, fbwd.dq_body, fbwd.dkv_body)]
            assert want == [True] * 3
            assert bodies(DTYPE_CODES[dtype], d) == 8 | 16 | 32, (dtype, d)
    assert bodies(DTYPE_CODES[torch.bfloat16], 48) == -1
    assert bodies(DTYPE_CODES[torch.bfloat16], 600) == -1  # not padded
    split = _build.kernel_function("mfa_split_d_slice", [])
    assert split() == SPLIT_D_SLICE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_reject_head_dims_past_576(cuda_device, dtype):
    """592 is past DeepSeek's absorbed width: the forward, dQ and dK/dV
    wrappers no longer raise there but launch the split-D kernels, once
    each, with the plain versions' results."""
    (q, k, v), do, _, rr = _flash_case(cuda_device, dtype, 1, 4, 1, 64, 64,
                                       592, masking.CAUSAL)
    assert fwd_body(dtype, 592) == "split_d"
    kw = dict(scale=592 ** -0.5)
    n = (flash_fwd.launches, flash_dq.launches, flash_dkv.launches)
    o, lse = flash_fwd(q, k, v, rr, **kw)
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    di = (do.float() * o_ref).sum(-1)
    dq, _ = flash_dq(q, k, v, do, l_ref, di, rr, **kw)
    dk, dv = flash_dkv(q, k, v, do, l_ref, di, rr, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_dq.launches, flash_dkv.launches) == (
        n[0] + 1, n[1] + 1, n[2] + 1)
    dq_ref, _ = flash_attention_dq_plain(q, k, v, do, l_ref, di, rr, **kw)
    dk_ref, dv_ref = flash_attention_dkv_plain(q, k, v, do, l_ref, di, rr,
                                               **kw)
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.shape == want.shape and _rel(got, want) <= _tol(dtype)


@pytest.mark.cuda
def test_flagship_training_is_deterministic(cuda_device):
    """The bf16 flagship trained twice from one initial state (Adam, the
    train phase's 4 x 2049 seeded tokens): every parameter and gradient
    equal bit for bit after each of 8 steps."""
    from metal_flash_attention_plus_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from metal_flash_attention_plus_tpu_torch.utils.profiling import (
        train_tokens,
        train_twice,
    )

    cfg = TransformerConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=cuda_device)
    rows, _ = train_twice(cfg, params, train_tokens(cfg, 0, cuda_device), 8)
    assert len(rows) == 8
    for row in rows:
        assert row["losses"][0] == row["losses"][1], row
        assert not row["params_differ"] and not row["grads_differ"], row
    assert rows[-1]["losses"][0] < rows[0]["losses"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_strided_views_match_contiguous(cuda_device, dtype):
    """Permuted and sliced Q/K views through ``flash_attention`` on the
    card: each direction launches its kernel once, and O and the gradients
    equal the contiguous call's bit for bit (the CPU mirror is
    tests/test_torch_parity_extras.py)."""
    from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(1, 4, 128, 64, generator=g).to(
        cuda_device, dtype) for _ in range(4))
    q_view = q.permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
    k_view = torch.cat([k, torch.ones_like(k[:, :, :32])], dim=2)[:, :, :128]
    assert not q_view.is_contiguous() and not k_view.is_contiguous()

    def run(q_, k_, v_):
        leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
        n = (flash_fwd.launches, flash_dq.launches, flash_dkv.launches)
        o = flash_attention(*leaves, mask=masking.CAUSAL)
        out = (o, *torch.autograd.grad(o, leaves, do))
        torch.cuda.synchronize()
        assert (flash_fwd.launches, flash_dq.launches,
                flash_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
        return out

    for a, b in zip(run(q, k, v), run(q_view, k_view, v)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    (q, k, v), do, _, rr = _flash_case(cuda_device, torch.float32, 1, 2, 1,
                                       64, 64, 64, masking.CAUSAL)
    with pytest.raises(TypeError):
        flash_fwd(q.half(), k.half(), v.half(), rr, scale=0.125)
    with pytest.raises(ValueError):  # head dim 0 has no kernel
        flash_fwd(q[..., :0].contiguous(), k[..., :0].contiguous(),
                  v[..., :0].contiguous(), rr, scale=0.125)
    with pytest.raises(ValueError):  # not contiguous
        flash_fwd(q.transpose(1, 2), k, v, rr, scale=0.125)
    lse = torch.zeros(1, 2, 64, device=cuda_device)
    with pytest.raises(ValueError):  # L must be fp32 [B, Hq, Sq]
        flash_dq(q, k, v, do, lse[..., :10], lse, rr, scale=0.125)


# --------------------------------------------------------------------------
# The paged kernels' int8 / int4 pool modes
# --------------------------------------------------------------------------


def _quantized_pool(rng, bits, hkv, num_pages, pt, d, device):
    rows = pt if bits == 4 else 2 * pt
    pool = rng.integers(-128, 128, (hkv, num_pages + 1, rows, d))
    scales = [torch.from_numpy(rng.uniform(
        0.5, 2.0, (hkv, num_pages + 1, 1, pt)).astype(np.float32)).to(
            device) / (7.0 if bits == 4 else 127.0) for _ in range(2)]
    return torch.from_numpy(pool.astype(np.int8)).to(device), scales


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,pt", [(4, 2, 32, 16), (16, 4, 64, 256),
                                         (8, 2, 128, 64),
                                         # off the multiples of 16
                                         (4, 2, 8, 16), (4, 2, 20, 16),
                                         (8, 1, 40, 64), (16, 1, 72, 256)])
def test_decode_kernel_quantized_modes_match_plain(cuda_device, bits, dtype,
                                                   hq, hkv, d, pt):
    rng = np.random.default_rng(bits)
    lengths = np.asarray([1, pt, pt + 1, 3 * pt - 5], np.int32)
    _, table = _inputs(rng, 1, 16, pt, 16, lengths, 4)
    pool, (ks, vs) = _quantized_pool(rng, bits, hkv, 16, pt, d, cuda_device)
    q = torch.from_numpy(rng.standard_normal((4, hq, d)).astype(
        np.float32)).to(cuda_device, dtype)
    args = (q, pool, torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device))
    kw = dict(page_tokens=pt, k_scales=ks, v_scales=vs, kv_bits=bits)
    n = paged_decode_attention.launches
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n + 1
    ref = paged_decode_attention_plain(*args, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,pt,chunk,offset", [
    (4, 2, 32, 16, 8, 21),
    (16, 4, 64, 256, 256, 0),
    (16, 4, 64, 256, 256, 300),
    (8, 2, 128, 64, 48, 70),
])
def test_prefill_kernel_quantized_modes_match_plain(
        cuda_device, bits, dtype, hq, hkv, d, pt, chunk, offset):
    rng = np.random.default_rng(bits + 1)
    max_pages = -(-(offset + chunk) // pt) + 1
    _, table = _inputs(rng, 1, max_pages + 2, pt, 16, [offset + chunk],
                       max_pages)
    pool, (ks, vs) = _quantized_pool(rng, bits, hkv, max_pages + 2, pt, d,
                                     cuda_device)
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d)).astype(
        np.float32)).to(cuda_device, dtype)
    args = (q, pool, torch.from_numpy(table[0]).to(cuda_device), offset)
    kw = dict(page_tokens=pt, k_scales=ks, v_scales=vs, kv_bits=bits)
    n = paged_prefill_attention.launches
    out = paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n + 1
    ref = paged_prefill_attention_plain(*args, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype)


@pytest.mark.cuda
def test_paged_kernels_reject_bad_quantized_pools(cuda_device):
    q = torch.zeros(1, 2, 64, device=cuda_device)
    table = torch.zeros(1, 1, dtype=torch.int32, device=cuda_device)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda_device)
    scales = torch.ones(1, 2, 1, 16, device=cuda_device)
    float_pool = torch.zeros(1, 2, 32, 64, device=cuda_device)
    with pytest.raises(TypeError):  # scales with a float pool
        paged_decode_attention(q, float_pool, table, lengths,
                               k_scales=scales, v_scales=scales)
    pool = float_pool.to(torch.int8)
    with pytest.raises(TypeError):  # scales of the wrong shape
        paged_decode_attention(q, pool, table, lengths,
                               k_scales=scales[..., :8],
                               v_scales=scales[..., :8])
    with pytest.raises(ValueError):  # int4 without scales
        paged_decode_attention(q, pool, table, lengths, kv_bits=4)


# --------------------------------------------------------------------------
# The dynamic W8A8 / W4A8 GEMM
# --------------------------------------------------------------------------

GEMM_CASES = {
    # name: (bits, granularity, strategy, M, N, K, with c)
    "w8_row_decode": (8, "row", "symmetric", 8, 1024, 1024, False),
    "w8_row_ragged": (8, "row", "symmetric", 37, 70, 384, False),
    "w8_row_ragged_k": (8, "row", "symmetric", 5, 33, 100, False),
    "w8_row_centered_c": (8, "row", "centered", 256, 130, 1024, True),
    "w8_tensor": (8, "tensor", "symmetric", 1, 257, 512, False),
    "w4_row": (4, "row", "symmetric", 8, 256, 1024, False),
    "w4_row_centered_ragged": (4, "row", "centered", 37, 70, 512, False),
    "w4_tensor_c": (4, "tensor", "symmetric", 256, 1024, 4096, True),
    # dyn_tile's plans: decode with K split over a cluster (int8 and int4),
    # M = 1 over the unembedding's 256 column tiles, a prefill chunk with
    # K split and c=, and the 128-row tiles of the fully quantized forward.
    "w8_split_k_decode": (8, "row", "symmetric", 8, 256, 4096, False),
    "w4_split_k_decode": (4, "row", "symmetric", 8, 256, 4096, False),
    "w8_m1_unembed": (8, "row", "symmetric", 1, 32768, 1024, False),
    "w8_split_k_prefill_c": (8, "row", "symmetric", 256, 256, 1024, True),
    "w8_tile128": (8, "row", "symmetric", 4096, 1024, 1024, False),
    "w4_tile128_centered": (4, "row", "centered", 4096, 1024, 1024, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GEMM_CASES))
def test_dyn_gemm_matches_plain_bit_for_bit(cuda_device, name):
    bits, gran, strategy, m, n, k, with_c = GEMM_CASES[name]
    rng = np.random.default_rng(m + n + k)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device)

    wq = quantize(t(n, k), qparams.QuantConfig(
        bits=bits, granularity=qparams.QuantGranularity(gran),
        strategy=qparams.QuantStrategy(strategy)))
    qa, sa, rs = qg.quantize_rows(t(m, k).to(torch.bfloat16))
    sb, zb = qg.weight_scales(wq)
    c = t(m, n) if with_c else None
    launches = qg.dyn_gemm.launches
    out = qg.dyn_gemm(qa, wq.data, sa, rs, sb, zb, bits=bits, c=c)
    torch.cuda.synchronize()
    assert qg.dyn_gemm.launches == launches + 1
    ref = qg.dyn_gemm_plain(qa, wq.data, sa, rs, sb, zb, bits=bits, c=c)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_dyn_gemm_rejects_what_it_does_not_take(cuda_device):
    a = torch.ones(4, 256, device=cuda_device)
    block = quantize(torch.ones(8, 256, device=cuda_device),
                     qparams.QuantConfig(
                         bits=8, granularity=qparams.QuantGranularity.BLOCK,
                         block_size=128))
    with pytest.raises(ValueError, match="ROW or TENSOR"):
        qg.dynamic_quantized_matmul(a, block)
    w4 = quantize(torch.ones(8, 128, device=cuda_device),
                  qparams.QuantConfig(
                      bits=4, granularity=qparams.QuantGranularity.ROW))
    with pytest.raises(ValueError, match="K % 256"):
        qg.dynamic_quantized_matmul(a[:, :128], w4)
    w8 = quantize(torch.ones(8, 256, device=cuda_device), qparams.INT8_ROW)
    qa, sa, rs = qg.quantize_rows(a)
    sb, zb = qg.weight_scales(w8)
    with pytest.raises(TypeError):  # float activations
        qg.dyn_gemm(a, w8.data, sa, rs, sb, zb, bits=8)
    with pytest.raises(TypeError):  # int8 payload declared int4
        qg.dyn_gemm(qa, w8.data, sa, rs, sb, zb, bits=4)
    with pytest.raises(TypeError):  # fp64 scales
        qg.dyn_gemm(qa, w8.data, sa.double(), rs, sb, zb, bits=8)


# --------------------------------------------------------------------------
# The quantized attention kernels
# --------------------------------------------------------------------------


def _qcfg(bits=8, gran="row", strategy="symmetric", **kw):
    return qparams.QuantConfig(
        bits=bits, granularity=qparams.QuantGranularity(gran),
        strategy=qparams.QuantStrategy(strategy), **kw)


ROW8, ROW8C, ROW4, ROW4C = (_qcfg(), _qcfg(strategy="centered"),
                            _qcfg(bits=4), _qcfg(bits=4, strategy="centered"))
TEN8, CH8, CH4 = _qcfg(gran="tensor"), _qcfg(gran="channel"), _qcfg(
    bits=4, gran="channel")
B2D = _qcfg(gran="block_2d", strategy="centered", block_rows=8,
            block_size=32)
B2D16 = _qcfg(gran="block_2d", strategy="centered", block_rows=8,
              block_size=16)
# 48-wide blocks tile D=96 but not its kernel width 128.
B2D48 = _qcfg(gran="block_2d", strategy="centered", block_rows=8,
              block_size=48)
# 80-wide blocks: cells straddling the 256-lane slices of D = 640.
B2D80 = _qcfg(gran="block_2d", strategy="centered", block_rows=8,
              block_size=80)
TEN4 = _qcfg(bits=4, gran="tensor")
ROW4A, ROW8A = (_qcfg(bits=b, strategy="asymmetric") for b in (4, 8))
B2D4 = _qcfg(bits=4, gran="block_2d", strategy="centered", block_rows=8,
             block_size=32)
BF16, F32 = torch.bfloat16, torch.float32
QQ = dict(quantize_q=True)

QATTN_CASES = {
    # name: (b, hq, hkv, sq, skv, d, K config, V config, Q dtype, mask,
    #        options)
    "dequant_row8c": (2, 8, 2, 200, 200, 64, ROW8C, ROW8C, BF16,
                      masking.CAUSAL, {}),
    "dequant_row4c_f32": (1, 4, 2, 130, 130, 64, ROW4C, ROW4C, F32,
                          masking.CAUSAL, {}),
    "dequant_tensor_f32_full": (1, 4, 2, 90, 170, 64, TEN8, TEN8, F32,
                                masking.FULL, {}),
    "quantize_q_row": (2, 8, 2, 200, 200, 64, ROW8, ROW8, BF16,
                       masking.CAUSAL, QQ),
    "quantize_q_int4_k_d128_f32": (1, 4, 1, 100, 150, 128, ROW4, ROW8C, F32,
                                   masking.CAUSAL, QQ),
    "int8_pv_channel": (1, 4, 2, 160, 160, 64, ROW8, CH8, BF16,
                        masking.CAUSAL, QQ),
    "int8_pv_tensor_d256": (1, 2, 1, 96, 96, 256, TEN8, TEN8, F32,
                            masking.FULL, QQ),
    "int8_pv_int4_v": (1, 4, 2, 160, 160, 64, ROW8, CH4, BF16,
                       masking.CAUSAL, QQ),
    # The north-star fwd+bwd's forward: int8 Q and P, ROW K / CHANNEL V.
    "int8_pv_channel_d256_full": (1, 2, 2, 128, 128, 256, ROW8, CH8, BF16,
                                  masking.FULL, QQ),
    "folded_tensor": (2, 8, 2, 200, 200, 64, TEN8, CH8, BF16, masking.CAUSAL,
                      {}),
    "folded_channel_interleaved": (1, 8, 2, 128, 128, 64, CH8, TEN8, BF16,
                                   masking.CAUSAL, dict(interleaved_kv=True)),
    "folded_row_window": (1, 4, 2, 300, 300, 64, ROW8, ROW8, BF16,
                          masking.sliding_window(96, causal=True), {}),
    "block2d_f32": (1, 4, 2, 128, 128, 64, B2D, B2D, F32, masking.CAUSAL,
                    {}),
    "block2d_bf16": (1, 4, 2, 128, 128, 64, B2D, B2D, BF16, masking.CAUSAL,
                     {}),
    "bias": (2, 8, 2, 200, 200, 64, ROW8C, ROW8C, BF16, masking.CAUSAL,
             dict(bias=(1, 8, 200, 200))),
    "d32_full_f32": (1, 4, 4, 70, 90, 32, ROW8C, ROW8C, F32, masking.FULL,
                     {}),
    "ragged_rect": (1, 4, 2, 70, 300, 64, ROW8C, ROW8C, BF16, masking.CAUSAL,
                    {}),
    # Head dims outside HEAD_DIMS, zero-padded to the next built width.
    "quantize_q_d80": (1, 4, 2, 128, 128, 80, ROW8, ROW8, BF16,
                       masking.CAUSAL, QQ),
    "folded_row_d40": (1, 8, 1, 150, 150, 40, ROW8, ROW8, BF16,
                       masking.CAUSAL, {}),
    "dequant_row4c_d72": (1, 4, 2, 130, 130, 72, ROW4C, ROW4C, BF16,
                          masking.CAUSAL, {}),
    "quantize_q_d33": (1, 4, 2, 128, 128, 33, ROW8, ROW8, BF16,
                       masking.CAUSAL, QQ),
    "dequant_row8c_d20_f32": (1, 4, 2, 100, 100, 20, ROW8C, ROW8C, F32,
                              masking.CAUSAL, {}),
    "int8_pv_channel_d96": (1, 4, 2, 160, 160, 96, ROW8, CH8, BF16,
                            masking.CAUSAL, QQ),
    "dequant_row4c_d96_f32": (1, 4, 2, 130, 130, 96, ROW4C, ROW4C, F32,
                              masking.CAUSAL, {}),
    "block2d_d80_f32": (1, 4, 2, 128, 128, 80, B2D16, B2D16, F32,
                        masking.CAUSAL, {}),
    "block2d48_d96_f32": (1, 4, 2, 128, 128, 96, B2D48, B2D48, F32,
                          masking.CAUSAL, {}),
    # The tensor-core body (a bf16 or int8 Q) at its ragged edges: Skv
    # under one 64-key tile, int4 K/V, BLOCK_2D, bias, windows, interleaved
    # GQA, every built width and the padded ones.
    "tc_short_kv": (1, 4, 2, 100, 40, 64, ROW8C, ROW8C, BF16, masking.FULL,
                    {}),
    "tc_quantize_q_short_kv": (1, 4, 2, 50, 37, 128, ROW8, CH8, BF16,
                               masking.FULL, QQ),
    "tc_dequant_row4c": (1, 4, 2, 130, 130, 64, ROW4C, ROW4C, BF16,
                         masking.CAUSAL, {}),
    "tc_quantize_q_int4_k": (1, 4, 2, 130, 130, 64, ROW4, ROW8, BF16,
                             masking.CAUSAL, QQ),
    "tc_block2d_d128": (1, 4, 2, 96, 160, 128, B2D, B2D, BF16,
                        masking.CAUSAL, {}),
    "tc_quantize_q_bias": (1, 4, 2, 100, 100, 64, ROW8, ROW8, BF16,
                           masking.CAUSAL, dict(quantize_q=True,
                                                bias=(1, 4, 100, 100))),
    "tc_int8_pv_window": (1, 4, 2, 300, 300, 64, ROW8, CH8, BF16,
                          masking.sliding_window(96, causal=True), QQ),
    "tc_int8_pv_interleaved": (1, 8, 2, 128, 128, 64, ROW8, CH8, BF16,
                               masking.CAUSAL,
                               dict(quantize_q=True, interleaved_kv=True)),
    "tc_dequant_d32": (1, 4, 4, 70, 90, 32, ROW8C, ROW8C, BF16, masking.FULL,
                       {}),
    "tc_int8_pv_d32": (1, 4, 2, 70, 90, 32, ROW8, CH8, BF16, masking.FULL,
                       QQ),
    "tc_dequant_d128": (1, 4, 2, 150, 150, 128, ROW8C, ROW8C, BF16,
                        masking.CAUSAL, {}),
    "tc_dequant_d256": (1, 2, 1, 100, 130, 256, ROW8C, ROW8C, BF16,
                        masking.CAUSAL, {}),
    "tc_quantize_q_row_d256": (1, 2, 1, 100, 130, 256, ROW8, ROW8, BF16,
                               masking.CAUSAL, QQ),
    "tc_int8_pv_int4_v_d256": (1, 2, 1, 100, 200, 256, ROW8, CH4, BF16,
                               masking.FULL, QQ),
    "tc_folded_row_d96": (1, 4, 2, 130, 130, 96, ROW8, ROW8, BF16,
                          masking.CAUSAL, {}),
    # The head-pair call's own mode, unpacked (hpack_fwd runs this body
    # through the packed strides for a bf16 Q): CHANNEL K folded into Q
    # (K_NONE), CHANNEL V at the store (V_STORE), P rounded to bf16, l
    # summing it unrounded.
    "tc_head_pair_mode": (1, 4, 2, 130, 130, 64, CH8, CH8, BF16,
                          masking.CAUSAL, dict(head_pair_mode=True)),
    # MLA's width 288 (qattn_fwd_wide_kernel for a bf16 or int8 Q, the
    # scalar body for fp32; 272 runs at 288): int8 and int4 (two packing
    # groups a row), ROW / TENSOR / CHANNEL / BLOCK_2D, int8 Q with bf16 and
    # int8 P, bias, causal and sliding-window masks, interleaved GQA.
    "wide_dequant_row8c_d288": (1, 4, 1, 200, 200, 288, ROW8C, ROW8C, BF16,
                                masking.CAUSAL, {}),
    "wide_dequant_row4c_d288": (1, 4, 2, 130, 130, 288, ROW4C, ROW4C, BF16,
                                masking.CAUSAL, {}),
    "wide_dequant_k8_v4_f32_d288": (1, 2, 1, 100, 130, 288, ROW8C, ROW4C,
                                    F32, masking.CAUSAL, {}),
    "wide_block2d_d288": (1, 4, 2, 128, 160, 288, B2D, B2D, BF16,
                          masking.CAUSAL, {}),
    "wide_block2d16_d272": (1, 4, 2, 128, 128, 272, B2D16, B2D16, BF16,
                            masking.CAUSAL, {}),
    "wide_quantize_q_row_d288": (1, 4, 1, 150, 150, 288, ROW8, ROW8, BF16,
                                 masking.CAUSAL, QQ),
    "wide_quantize_q_int4_k_d272": (1, 4, 2, 130, 130, 272, ROW4, ROW8,
                                    BF16, masking.CAUSAL, QQ),
    "wide_int8_pv_channel_d288": (1, 4, 1, 300, 300, 288, ROW8, CH8, BF16,
                                  masking.CAUSAL, QQ),
    "wide_int8_pv_int4_v_d288": (1, 2, 1, 200, 200, 288, ROW8, CH4, BF16,
                                 masking.FULL, QQ),
    "wide_int8_pv_tensor_f32_d288": (1, 2, 1, 96, 96, 288, TEN8, TEN8, F32,
                                     masking.FULL, QQ),
    "wide_folded_row_window_d288": (1, 4, 1, 300, 300, 288, ROW8, ROW8,
                                    BF16,
                                    masking.sliding_window(96, causal=True),
                                    {}),
    "wide_folded_tensor_bias_d272": (1, 4, 2, 130, 130, 272, TEN8, CH8, BF16,
                                     masking.CAUSAL,
                                     dict(bias=(1, 4, 130, 130))),
    "wide_folded_channel_interleaved_d288": (1, 8, 2, 128, 128, 288, CH8,
                                             TEN8, BF16, masking.CAUSAL,
                                             dict(interleaved_kv=True)),
    "wide_short_kv_d288": (1, 4, 2, 100, 40, 288, ROW8C, ROW4C, BF16,
                           masking.FULL, {}),
    # DeepSeek's absorbed width 576 (qattn_fwd_latent_kernel for a bf16 or
    # int8 Q, the scalar body in 32-row tiles for an fp32 Q and for an fp32
    # Q quantized to int8; 320 and 512 run at 576): int8 and int4 (three
    # packing groups a row), ROW / TENSOR / CHANNEL / BLOCK_2D, int8 Q with
    # bf16 and int8 P, bias, causal and sliding-window masks, interleaved
    # GQA, Hq = 16 over one latent head.
    "latent_dequant_row8c_d576": (1, 16, 1, 300, 300, 576, ROW8C, ROW8C,
                                  BF16, masking.CAUSAL, {}),
    "latent_dequant_row4c_d576": (1, 4, 2, 130, 130, 576, ROW4C, ROW4C,
                                  BF16, masking.CAUSAL, {}),
    "latent_dequant_k8_v4_f32_d576": (1, 2, 1, 100, 130, 576, ROW8C, ROW4C,
                                      F32, masking.CAUSAL, {}),
    "latent_block2d_d576": (1, 4, 2, 128, 160, 576, B2D, B2D, BF16,
                            masking.CAUSAL, {}),
    "latent_quantize_q_row_d512": (1, 16, 1, 150, 150, 512, ROW8, ROW8,
                                   BF16, masking.CAUSAL, QQ),
    "latent_quantize_q_int4_k_d320": (1, 4, 2, 130, 130, 320, ROW4, ROW8,
                                      BF16, masking.CAUSAL, QQ),
    "latent_quantize_q_f32_d576": (1, 2, 1, 100, 100, 576, ROW8, ROW4, F32,
                                   masking.CAUSAL, QQ),
    "latent_int8_pv_channel_d576": (1, 16, 1, 300, 300, 576, ROW8, CH8,
                                    BF16, masking.CAUSAL, QQ),
    "latent_int8_pv_int4_v_d512": (1, 2, 1, 200, 200, 512, ROW8, CH4, BF16,
                                   masking.FULL, QQ),
    "latent_int8_pv_tensor_f32_d576": (1, 2, 1, 96, 96, 576, TEN8, TEN8,
                                       F32, masking.FULL, QQ),
    "latent_folded_row_window_d576": (1, 4, 1, 300, 300, 576, ROW8, ROW8,
                                      BF16,
                                      masking.sliding_window(96, causal=True),
                                      {}),
    "latent_folded_tensor_bias_d320": (1, 4, 2, 130, 130, 320, TEN8, CH8,
                                       BF16, masking.CAUSAL,
                                       dict(bias=(1, 4, 130, 130))),
    "latent_folded_channel_interleaved_d576": (1, 8, 2, 128, 128, 576, CH8,
                                               TEN8, BF16, masking.CAUSAL,
                                               dict(interleaved_kv=True)),
    "latent_short_kv_d576": (1, 4, 2, 100, 40, 576, ROW8C, ROW4C, BF16,
                             masking.FULL, {}),
    # Above 576 (split_d_qattn_kernel: O's lanes over CTAs, 256 a CTA; 580
    # runs at 592): int8 and int4 (a 256-value packing group a slice, the
    # last group split at its own midpoint), folded ROW / TENSOR / CHANNEL,
    # BLOCK_2D blocks of 80 lanes straddling the slices, an int8 Q with bf16
    # and int8 P (two 512-key spans), fp32 Q (also quantized to int8),
    # bias, windows, interleaved GQA, Hq = 16 over one head.
    "split_d_dequant_row8c_gqa16_d640": (1, 16, 1, 200, 200, 640, ROW8C,
                                         ROW8C, BF16, masking.CAUSAL, {}),
    "split_d_dequant_row4c_d592": (1, 4, 2, 130, 130, 592, ROW4C, ROW4C,
                                   BF16, masking.CAUSAL, {}),
    "split_d_dequant_row4c_d580": (1, 4, 1, 100, 100, 580, ROW4C, ROW4C,
                                   BF16, masking.CAUSAL, {}),
    "split_d_folded_row_d1024": (1, 4, 1, 150, 150, 1024, ROW8, ROW8, BF16,
                                 masking.CAUSAL, {}),
    "split_d_folded_tensor_bias_d592": (1, 4, 2, 130, 130, 592, TEN8, CH8,
                                        BF16, masking.CAUSAL,
                                        dict(bias=(1, 4, 130, 130))),
    "split_d_folded_channel4_interleaved_d640": (
        1, 8, 2, 128, 128, 640, CH4, TEN8, BF16, masking.CAUSAL,
        dict(interleaved_kv=True)),
    "split_d_block2d80_d640": (1, 4, 2, 128, 160, 640, B2D80, B2D80, BF16,
                               masking.CAUSAL, {}),
    "split_d_quantize_q_row_d640": (1, 16, 1, 150, 150, 640, ROW8, ROW8,
                                    BF16, masking.CAUSAL, QQ),
    "split_d_quantize_q_int4_k_d592": (1, 4, 2, 130, 130, 592, ROW4, ROW8,
                                       BF16, masking.CAUSAL, QQ),
    "split_d_int8_pv_two_spans_d1024": (1, 4, 1, 128, 700, 1024, ROW8, CH8,
                                        BF16, masking.FULL, QQ),
    "split_d_int8_pv_tensor_f32_d640": (1, 2, 1, 96, 96, 640, TEN8, TEN8,
                                        F32, masking.FULL, QQ),
    "split_d_dequant_k8_v4_f32_d592": (1, 2, 1, 100, 130, 592, ROW8C, ROW4C,
                                       F32, masking.CAUSAL, {}),
    "split_d_quantize_q_f32_d640": (1, 2, 1, 100, 100, 640, ROW8, ROW4, F32,
                                    masking.CAUSAL, QQ),
    "split_d_folded_row_window_d1024": (1, 4, 1, 300, 300, 1024, ROW8, ROW8,
                                        BF16,
                                        masking.sliding_window(96,
                                                               causal=True),
                                        {}),
}


def _qattn_inputs(device, b, hq, hkv, sq, skv, d, kcfg, vcfg, dtype,
                  hadamard_block=None, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    q, k, v = t(b, hq, sq, d).to(dtype), t(b, hkv, skv, d), t(b, hkv, skv, d)
    if hadamard_block:
        k, v = (hadamard_transform(x, hadamard_block) for x in (k, v))
    return q, quantize(k, kcfg), quantize(v, vcfg)


def _qattn_tols(dtype, p_int8=False):
    if dtype == torch.float32 and not p_int8:
        return TOLERANCES["fp32"], TOLERANCES["fp32"]
    return BF16_TOL, TOLERANCES["lse"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(QATTN_CASES))
def test_qattn_kernel_matches_plain(cuda_device, name):
    b, hq, hkv, sq, skv, d, kcfg, vcfg, dtype, mask, opts = QATTN_CASES[name]
    q, kq, vq = _qattn_inputs(cuda_device, b, hq, hkv, sq, skv, d, kcfg,
                              vcfg, dtype)
    opts = dict(opts)
    head_pair = opts.pop("head_pair_mode", False)
    if "bias" in opts:
        opts["bias"] = torch.randn(opts["bias"], device=cuda_device)
    args, kw = qa.qattn_arguments(q, kq, vq, mask=mask, **opts)
    if head_pair:  # hpack_fwd's mode: l sums the unrounded P
        kw["mode"] = dataclasses.replace(kw["mode"], l_rounded=False)
        assert kw["mode"] == qa.QAttnMode(k_scales="none", v_scales="store")
        assert qa.qattn_body(args[0].dtype, kw["mode"]) == "tensor_core"
    # The public forward's spans: the TPU's block_kv for an int8 P.
    tile = (qa.int8_p_tile(BlockSizes(), skv) if kw["mode"].p_int8
            else None)
    n = qa.qattn_fwd.launches
    o, lse = qa.qattn_fwd(*args, **kw, kv_tile=tile)
    torch.cuda.synchronize()
    assert qa.qattn_fwd.launches == n + 1
    o_ref, l_ref = qa.qattn_fwd_plain(*args, **kw,
                                      kv_tile=tile or qa.KV_TILE)
    tol_o, tol_l = _qattn_tols(dtype, kw["mode"].p_int8)
    assert o.dtype == torch.float32 and o.shape == o_ref.shape
    assert _rel(o, o_ref) <= tol_o
    assert _rel(lse, l_ref) <= tol_l
    if not head_pair:  # the public forward runs the mode it was given
        fwd, _ = qa.quantized_flash_attention_forward(q, kq, vq, mask=mask,
                                                      **opts)
        assert torch.equal(fwd, o)


@pytest.mark.cuda
def test_qattn_hadamard_through_the_kernel(cuda_device):
    q, kq, vq = _qattn_inputs(cuda_device, 1, 4, 2, 128, 128, 64, ROW4C,
                              ROW4C, torch.float32, hadamard_block=64)
    kw = dict(mask=masking.CAUSAL, hadamard_block=64)
    o, lse = qa.quantized_flash_attention_forward(q, kq, vq, **kw)
    cpu = (q.cpu(), kq.to("cpu"), vq.to("cpu"))
    o_ref, l_ref = qa.quantized_flash_attention_forward(*cpu, **kw)
    assert _rel(o.cpu(), o_ref) <= TOLERANCES["fp32"]
    assert _rel(lse.cpu(), l_ref) <= TOLERANCES["fp32"]


HPACK_CASES = {
    # name: (b, hq, hkv, sq, skv, options); ragged: Sq not a multiple of
    # 64 (the odd head's last rows past Sq).
    "rect": (2, 8, 2, 256, 320, {}),
    "ragged_sq": (1, 8, 2, 200, 200, {}),
    "interleaved": (1, 8, 2, 256, 256, dict(interleaved_kv=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mask", [masking.FULL, masking.CAUSAL],
                         ids=["full", "causal"])
@pytest.mark.parametrize("case", sorted(HPACK_CASES))
def test_hpack_kernel_matches_plain(cuda_device, case, mask, bits, dtype):
    """The head-pair call (a bf16 Q: the tensor-core body; fp32: the
    scalar one) against its plain version."""
    b, hq, hkv, sq, skv, opts = HPACK_CASES[case]
    kcfg, vcfg = (CH8, TEN8) if bits == 8 else (CH4, _qcfg(bits=4,
                                                          gran="tensor"))
    q, kq, vq = _qattn_inputs(cuda_device, b, hq, hkv, sq, skv, 64, kcfg,
                              vcfg, dtype, seed=bits)
    args, kw = qa.hpack_arguments(qa.pack_heads(q), kq, vq, mask=mask,
                                  **opts)
    n = qa.hpack_fwd.launches
    o, lse = qa.hpack_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert qa.hpack_fwd.launches == n + 1
    o_ref, l_ref = qa.hpack_fwd_plain(*args, **kw)
    assert o.shape == (b, hq // 2, sq, 128) and lse.shape == (b, hq, sq)
    assert _rel(o, o_ref) <= BF16_TOL
    assert _rel(lse, l_ref) <= TOLERANCES["lse"]


@pytest.mark.cuda
def test_quantized_attention_kernels_reject_what_they_do_not_take(
        cuda_device):
    q, kq, vq = _qattn_inputs(cuda_device, 1, 2, 1, 64, 64, 64, ROW8C,
                              ROW8C, torch.float32)
    args, kw = qa.qattn_arguments(q, kq, vq)
    qin, qs, kd, vd, kp, vp, rr = args
    with pytest.raises(TypeError):  # a float payload
        qa.qattn_fwd(qin, qs, kd.float(), vd, kp, vp, rr, **kw)
    with pytest.raises(TypeError):  # per-token scales of the wrong shape
        qa.qattn_fwd(qin, qs, kd, vd, (kp[0][..., :8], kp[1]), vp, rr, **kw)
    with pytest.raises(TypeError):  # an int8 Q without its scales
        qa.qattn_fwd(qin.to(torch.int8), None, kd, vd, kp, vp, rr, **kw)
    with pytest.raises(TypeError):  # a bf16 Q whose products stay fp32
        qa.qattn_fwd(qin.to(torch.bfloat16), qs, kd, vd, kp, vp, rr, **kw)
    with pytest.raises(ValueError):  # q on the CPU, payloads on the card
        qa.check_qattn_inputs("qattn_fwd", qin.cpu(), qs, kd, vd, kp, vp,
                              rr, None, kw["mode"])
    with pytest.raises(ValueError):  # not the packed d=64 layout
        qa.hpack_fwd(q, kd, vd, vp[0], rr, bits_k=8, bits_v=8)


# --------------------------------------------------------------------------
# The quantized backward kernels
# --------------------------------------------------------------------------

QBWD_CASES = {
    # name: (b, hq, hkv, sq, skv, d, K config, V config, Q dtype, mask,
    #        options)
    "dequant_row8c": (2, 8, 2, 200, 200, 64, ROW8C, ROW8C, BF16,
                      masking.CAUSAL, {}),
    "dequant_row4c_f32": (1, 4, 2, 130, 130, 64, ROW4C, ROW4C, F32,
                          masking.CAUSAL, {}),
    "dequant_tensor_f32_full": (1, 4, 2, 90, 170, 64, TEN8, TEN8, F32,
                                masking.FULL, {}),
    "dequant_k8_v4_f32": (1, 4, 1, 128, 128, 64, ROW8C, ROW4C, F32,
                          masking.CAUSAL, {}),
    "folded_tensor": (2, 8, 2, 200, 200, 64, TEN8, CH8, BF16, masking.CAUSAL,
                      {}),
    "folded_channel_interleaved": (1, 8, 2, 128, 128, 64, CH8, TEN8, BF16,
                                   masking.CAUSAL, dict(interleaved_kv=True)),
    "folded_row_window": (1, 4, 2, 300, 300, 64, ROW8, ROW8, BF16,
                          masking.sliding_window(96, causal=True), {}),
    "folded_int4_k": (1, 4, 2, 160, 160, 64, CH4, CH8, BF16, masking.CAUSAL,
                      {}),
    "block2d_f32": (1, 4, 2, 128, 128, 64, B2D, B2D, F32, masking.CAUSAL,
                    {}),
    "block2d_bf16": (1, 4, 2, 128, 128, 64, B2D, B2D, BF16, masking.CAUSAL,
                     {}),
    "bias_dbias": (2, 8, 2, 200, 200, 64, ROW8C, ROW8C, BF16, masking.CAUSAL,
                   dict(bias=(1, 8, 200, 200))),
    "d32_full_f32": (1, 4, 4, 70, 90, 32, ROW8C, ROW8C, F32, masking.FULL,
                     {}),
    "d128_folded_row": (1, 4, 2, 160, 160, 128, ROW8, ROW8, BF16,
                        masking.CAUSAL, {}),
    "d256_f32_full": (1, 2, 1, 96, 96, 256, ROW8C, ROW8C, F32, masking.FULL,
                      {}),
    # The north-star's exact arm: folded ROW K / CHANNEL V at D=256.
    "d256_folded_row_k_channel_v_full": (1, 2, 2, 128, 128, 256, ROW8, CH8,
                                         BF16, masking.FULL, {}),
    "ragged_rect": (1, 4, 2, 70, 300, 64, ROW8C, ROW8C, BF16, masking.CAUSAL,
                    {}),
    # Head dims outside HEAD_DIMS, zero-padded to the next built width.
    "d80_dequant_row8c_f32": (1, 4, 2, 128, 128, 80, ROW8C, ROW8C, F32,
                              masking.CAUSAL, {}),
    "d40_folded_row": (1, 8, 1, 150, 150, 40, ROW8, ROW8, BF16,
                       masking.CAUSAL, {}),
    "d72_dequant_row4c": (1, 4, 2, 130, 130, 72, ROW4C, ROW4C, BF16,
                          masking.CAUSAL, {}),
    "d33_dequant_row8c_f32": (1, 4, 2, 100, 100, 33, ROW8C, ROW8C, F32,
                              masking.CAUSAL, {}),
    "d96_dequant_row4c": (1, 4, 2, 130, 130, 96, ROW4C, ROW4C, BF16,
                          masking.CAUSAL, {}),
    "d96_folded_channel": (1, 4, 2, 128, 128, 96, CH8, CH4, BF16,
                           masking.CAUSAL, {}),
    "d80_block2d_f32": (1, 4, 2, 128, 128, 80, B2D16, B2D16, F32,
                        masking.CAUSAL, {}),
    "d96_block2d48_f32": (1, 4, 2, 128, 128, 96, B2D48, B2D48, F32,
                          masking.CAUSAL, {}),
    # The tensor-core dK/dV body's risky tilings (bf16): a query span
    # starting mid-tile, causal rows with no live key, an interleaved group
    # of 4 at D=256, bias at D=128, BLOCK_2D rows and D=32.
    "tc_rect_span_mid_tile": (1, 4, 2, 150, 250, 64, ROW8C, ROW8C, BF16,
                              masking.CAUSAL, {}),
    "tc_rect_empty_rows_d128": (1, 4, 2, 250, 150, 128, ROW4C, ROW8C, BF16,
                                masking.CAUSAL, {}),
    "tc_d256_gqa4_interleaved": (1, 8, 2, 130, 130, 256, ROW8, CH8, BF16,
                                 masking.CAUSAL, dict(interleaved_kv=True)),
    "tc_bias_d128": (1, 4, 2, 100, 130, 128, ROW8C, ROW8C, BF16,
                     masking.CAUSAL, dict(bias=(1, 4, 100, 130))),
    "tc_block2d_d128_rect": (1, 4, 2, 96, 160, 128, B2D, B2D, BF16,
                             masking.CAUSAL, {}),
    "tc_d32_full": (1, 4, 4, 70, 90, 32, ROW8C, ROW4C, BF16, masking.FULL,
                    {}),
    # The tensor-core dQ body (bf16) in the modes qflash_arguments builds,
    # int8 and int4: folded ROW / TENSOR / CHANNEL (the integers, column
    # scales on S, dS and dP), dequant per token (ASYMMETRIC, CENTERED) and
    # BLOCK_2D, dbias; D = 80 / 96 zero-padded to 128; Skv < 64 < Sq with
    # causal rows that see no key.
    "dq_tc_folded_row4": (1, 4, 2, 150, 150, 64, ROW4, ROW4, BF16,
                          masking.CAUSAL, {}),
    "dq_tc_folded_tensor_int4_v_d128": (1, 4, 2, 130, 200, 128, TEN8, TEN4,
                                        BF16, masking.FULL, {}),
    "dq_tc_folded_channel4_d256": (1, 4, 2, 130, 130, 256, CH4, CH4, BF16,
                                   masking.CAUSAL, {}),
    "dq_tc_token_asym4_d256": (1, 2, 1, 100, 160, 256, ROW4A, ROW8A, BF16,
                               masking.CAUSAL, {}),
    "dq_tc_block2d_int4_d128": (1, 4, 2, 128, 192, 128, B2D4, B2D4, BF16,
                                masking.CAUSAL, {}),
    "dq_tc_dbias_folded_row_d32": (1, 4, 2, 100, 131, 32, ROW8, ROW8, BF16,
                                   masking.CAUSAL,
                                   dict(bias=(1, 4, 100, 131))),
    "dq_tc_d80_folded_row_dbias": (1, 4, 2, 128, 128, 80, ROW8, CH8, BF16,
                                   masking.CAUSAL,
                                   dict(bias=(1, 4, 128, 128))),
    "dq_tc_d96_block2d48": (1, 4, 2, 128, 128, 96, B2D48, B2D48, BF16,
                            masking.CAUSAL, {}),
    "dq_tc_short_kv_empty_rows": (1, 4, 2, 100, 40, 64, ROW8C, ROW4C, BF16,
                                  masking.CAUSAL, {}),
    # MLA's width 288 (qflash_dq_wide_kernel, qflash_dkv_wide_kernel and
    # the merge of its group split for bf16; the scalar bodies for fp32;
    # 272 runs at 288): per-token int8 / int4, folded ROW (column scales),
    # CHANNEL int4 (store multipliers), BLOCK_2D, bias with dbias, windows,
    # interleaved GQA and a group of 8 split over CTAs.
    "wide_dequant_row8c_d288": (1, 4, 1, 200, 200, 288, ROW8C, ROW8C, BF16,
                                masking.CAUSAL, {}),
    "wide_dequant_row4c_d288": (1, 4, 2, 130, 130, 288, ROW4C, ROW4C, BF16,
                                masking.CAUSAL, {}),
    "wide_folded_row_gqa8_d288": (1, 8, 1, 160, 160, 288, ROW8, ROW8, BF16,
                                  masking.CAUSAL, {}),
    "wide_folded_channel4_d288": (1, 4, 2, 130, 130, 288, CH4, CH4, BF16,
                                  masking.CAUSAL, {}),
    "wide_block2d_d288": (1, 4, 2, 128, 160, 288, B2D, B2D, BF16,
                          masking.CAUSAL, {}),
    "wide_bias_dbias_d272": (1, 4, 2, 100, 130, 272, ROW8C, ROW8C, BF16,
                             masking.CAUSAL, dict(bias=(1, 4, 100, 130))),
    "wide_window_interleaved_d288": (1, 8, 2, 300, 300, 288, ROW8C, ROW4C,
                                     BF16,
                                     masking.sliding_window(96, causal=True),
                                     dict(interleaved_kv=True)),
    "wide_f32_d288": (1, 2, 1, 96, 130, 288, ROW8C, ROW4C, F32,
                      masking.CAUSAL, {}),
    "wide_tensor_f32_full_d272": (1, 2, 1, 96, 96, 272, TEN8, TEN8, F32,
                                  masking.FULL, {}),
    # DeepSeek's absorbed width 576 (qflash_dq_latent_kernel,
    # qflash_dkv_latent_kernel and the merge of its group split for bf16;
    # the scalar bodies in 32-row tiles for fp32; 320 and 512 run at 576):
    # the same modes over 16 q heads of one latent head.
    "latent_dequant_row8c_d576": (1, 16, 1, 200, 200, 576, ROW8C, ROW8C,
                                  BF16, masking.CAUSAL, {}),
    "latent_dequant_row4c_d512": (1, 4, 2, 130, 130, 512, ROW4C, ROW4C,
                                  BF16, masking.CAUSAL, {}),
    "latent_folded_row_gqa16_d576": (1, 16, 1, 160, 160, 576, ROW8, ROW8,
                                     BF16, masking.CAUSAL, {}),
    "latent_folded_channel4_d576": (1, 4, 2, 130, 130, 576, CH4, CH4, BF16,
                                    masking.CAUSAL, {}),
    "latent_block2d_d576": (1, 4, 2, 128, 160, 576, B2D, B2D, BF16,
                            masking.CAUSAL, {}),
    "latent_bias_dbias_d320": (1, 4, 2, 100, 130, 320, ROW8C, ROW8C, BF16,
                               masking.CAUSAL, dict(bias=(1, 4, 100, 130))),
    "latent_window_interleaved_d576": (1, 8, 2, 300, 300, 576, ROW8C,
                                       ROW4C, BF16,
                                       masking.sliding_window(96,
                                                              causal=True),
                                       dict(interleaved_kv=True)),
    "latent_f32_d576": (1, 2, 1, 96, 130, 576, ROW8C, ROW4C, F32,
                        masking.CAUSAL, {}),
    "latent_tensor_f32_full_d320": (1, 2, 1, 96, 96, 320, TEN8, TEN8, F32,
                                    masking.FULL, {}),
    # Above 576 (split_d_qdq_kernel and split_d_qdkv_kernel over the
    # payloads, the dK/dV's group split and merge; 580 runs at 592): the
    # same modes, BLOCK_2D cells straddling the slices.
    "split_d_dequant_row8c_gqa16_d640": (1, 16, 1, 200, 200, 640, ROW8C,
                                         ROW8C, BF16, masking.CAUSAL, {}),
    "split_d_dequant_row4c_d592": (1, 4, 2, 130, 130, 592, ROW4C, ROW4C,
                                   BF16, masking.CAUSAL, {}),
    "split_d_folded_row_gqa16_d1024": (1, 16, 1, 160, 160, 1024, ROW8, ROW8,
                                       BF16, masking.CAUSAL, {}),
    "split_d_folded_channel4_d640": (1, 4, 2, 130, 130, 640, CH4, CH4, BF16,
                                     masking.CAUSAL, {}),
    "split_d_block2d80_d640": (1, 4, 2, 128, 160, 640, B2D80, B2D80, BF16,
                               masking.CAUSAL, {}),
    "split_d_bias_dbias_d580": (1, 4, 2, 100, 130, 580, ROW8C, ROW8C, BF16,
                                masking.CAUSAL, dict(bias=(1, 4, 100, 130))),
    "split_d_window_interleaved_d1024": (1, 8, 2, 300, 300, 1024, ROW8C,
                                         ROW4C, BF16,
                                         masking.sliding_window(
                                             96, causal=True),
                                         dict(interleaved_kv=True)),
    "split_d_f32_d640": (1, 2, 1, 96, 130, 640, ROW8C, ROW4C, F32,
                         masking.CAUSAL, {}),
    "split_d_tensor_f32_full_d1024": (1, 2, 1, 96, 96, 1024, TEN8, TEN8,
                                      F32, masking.FULL, {}),
}


def _bwd_inputs(device, q, kq, vq, mask, seed, **opts):
    """(dO, L, D) of a quantized forward on the card."""
    o, lse = qa.quantized_flash_attention_forward(q, kq, vq, mask=mask,
                                                  **opts)
    gen = torch.Generator(device=device).manual_seed(seed)
    do = torch.randn(q.shape, generator=gen, device=device).to(q.dtype)
    return do, lse, (do.float() * o).sum(dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(QBWD_CASES))
def test_qflash_kernels_match_plain(cuda_device, name):
    """The exact quantized dQ and dK/dV kernels (dbias too) against their
    plain versions, tolerances as the flash kernels'."""
    b, hq, hkv, sq, skv, d, kcfg, vcfg, dtype, mask, opts = QBWD_CASES[name]
    q, kq, vq = _qattn_inputs(cuda_device, b, hq, hkv, sq, skv, d, kcfg,
                              vcfg, dtype)
    opts = dict(opts)
    bias = None
    if "bias" in opts:
        bias = torch.randn(opts.pop("bias"), device=cuda_device)
    do, lse, di = _bwd_inputs(cuda_device, q, kq, vq, mask, 1, bias=bias,
                              **opts)
    rr = row_ranges_tensor(mask, sq, skv, None, cuda_device)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, bias, scale=d ** -0.5,
        want_dbias=bias is not None, **opts)
    assert fbwd.dq_body(dtype, d) == (
        "split_d" if d > 576 else "tensor_core" if dtype == BF16
        else "fp32_fma")
    n = (fbwd.qflash_dq.launches, fbwd.qflash_dkv.launches)
    dq, dbias = fbwd.qflash_dq(*dq_a, **dq_kw)
    dk, dv = fbwd.qflash_dkv(*dkv_a, **dkv_kw)
    torch.cuda.synchronize()
    assert (fbwd.qflash_dq.launches, fbwd.qflash_dkv.launches) == (
        n[0] + 1, n[1] + 1)
    dq_ref, dbias_ref = fbwd.qflash_dq_plain(*dq_a, **dq_kw)
    dk_ref, dv_ref = fbwd.qflash_dkv_plain(*dkv_a, **dkv_kw)
    tol = _tol(dtype)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref),
                      (dbias, dbias_ref)):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= tol, name


FULLINT_CASES = {
    # name: (b, hq, hkv, s or (sq, skv), d, K config, V config, level 2
    #        blocks or None, interleaved)
    "row_chan_l1": (1, 4, 2, 256, 128, ROW8, CH8, None, False),
    "row_chan_l2_w128": (1, 4, 2, 256, 128, ROW8, CH8, 128, False),
    "tens_tens_l1": (2, 4, 4, 192, 64, TEN8, TEN8, None, False),
    "tens_tens_l2_w64": (2, 4, 4, 192, 64, TEN8, TEN8, 512, False),
    "ragged_l2_w8": (1, 4, 2, 200, 64, ROW8, TEN8, 512, False),
    "d256_l1": (1, 2, 2, 128, 256, ROW8, CH8, None, False),
    "d32_interleaved_l2": (1, 8, 2, 256, 32, ROW8, CH8, 128, True),
    # Head dims outside HEAD_DIMS, zero-padded to the next built width.
    "d80_l1": (1, 4, 2, 256, 80, ROW8, CH8, None, False),
    "d96_l2_w128": (1, 4, 2, 256, 96, TEN8, TEN8, 128, False),
    # The north-star's spans: 512 keys (dQ) and queries (dK/dV), eight
    # 64-wide tiles each, at its head dim.
    "d256_l2_w512": (1, 2, 2, 1024, 256, ROW8, CH8, 512, False),
    # Widths of whole k steps that are not whole tiles: two 32-wide spans
    # a tile (S=160), 96-wide spans across tiles (S=288).
    "w32_l2": (1, 4, 2, 160, 128, ROW8, CH8, 512, False),
    "w96_l2": (1, 4, 2, 288, 64, ROW8, TEN8, 512, False),
    # Widths below one k step, on the scalar kernels (fullint_body).
    "w16_l2": (1, 4, 2, 144, 64, ROW8, CH8, 512, False),
    "w1_l2": (1, 4, 2, 129, 128, TEN8, CH8, 512, False),
    "gqa8_interleaved_l1": (1, 16, 2, 256, 128, ROW8, CH8, None, True),
    "sq_ne_skv": (1, 4, 2, (192, 320), 128, ROW8, CH8, 128, False),
    # MLA's width 288 (two warp groups; the level-1 dK/dV in 32-query
    # steps; S's int32 sums from 0), both levels, 272 at 288; a level-2
    # width below one k step on the scalar pair.
    "d288_l1": (1, 4, 2, 256, 288, ROW8, CH8, None, False),
    "d288_l2_w128": (1, 4, 2, 256, 288, ROW8, CH8, 128, False),
    "d288_l2_w96": (1, 4, 2, 288, 288, ROW8, TEN8, 512, False),
    "d272_l2_w256": (1, 2, 1, 256, 272, TEN8, TEN8, 512, False),
    "d288_gqa8_interleaved_l1": (1, 16, 2, 192, 288, ROW8, TEN8, None,
                                 True),
    "d288_l1_sq_ne_skv": (1, 4, 2, (100, 200), 288, ROW8, CH8, None, False),
    "d288_w16_l2": (1, 4, 2, 144, 288, ROW8, CH8, 512, False),
    # Head dims off the multiples of 16, at 64 and 128.
    "d40_l1": (1, 8, 1, 192, 40, ROW8, CH8, None, False),
    "d40_l2_w64": (1, 8, 1, 192, 40, ROW8, CH8, 512, False),
    "d72_l1": (1, 4, 2, 256, 72, TEN8, TEN8, None, False),
    "d72_l2_w128": (1, 4, 2, 256, 72, ROW8, CH8, 128, False),
    # DeepSeek's absorbed 576 (32-row tiles, four warp groups), both
    # levels; the level-2 spans of one 32-key step, of two tiles and below
    # one k step (the 32-row __dp4a pair); 16 q heads over one latent head
    # (the dK/dV's group split and merge); 560 at 576.
    "d576_l1": (1, 4, 1, 256, 576, ROW8, CH8, None, False),
    "d576_l2_w128": (1, 4, 1, 256, 576, ROW8, CH8, 128, False),
    "d576_l2_w32": (1, 4, 2, 160, 576, ROW8, TEN8, 512, False),
    "d576_w16_l2": (1, 4, 1, 144, 576, ROW8, CH8, 512, False),
    "d576_gqa16_l1": (2, 16, 1, 256, 576, ROW8, CH8, None, False),
    "d576_gqa16_l2_w128": (2, 16, 1, 256, 576, ROW8, CH8, 128, False),
    "d576_gqa16_w8_l2": (1, 16, 1, 200, 576, TEN8, CH8, 512, True),
    "d576_l1_sq_ne_skv": (1, 4, 2, (100, 200), 576, ROW8, CH8, None, False),
    "d560_l1": (1, 4, 1, 128, 560, ROW8, CH8, None, False),
    # Above 576 (split_d_fullint_dq_kernel, split_d_fullint_dkv_kernel:
    # 256 lanes a CTA), both levels; level-2 spans of two tiles, of one
    # 32-wide piece of a tile, across tiles (96) and below one k step (16);
    # 16 q heads over one (the dK/dV's group split and merge); 580 at 592.
    "split_d_d592_l1": (1, 4, 2, 256, 592, ROW8, CH8, None, False),
    "split_d_d640_l2_w128": (1, 4, 1, 256, 640, ROW8, CH8, 128, False),
    "split_d_d1024_l1": (1, 4, 1, 192, 1024, TEN8, TEN8, None, False),
    "split_d_d1024_l2_w32": (1, 4, 2, 160, 1024, ROW8, TEN8, 512, False),
    "split_d_d640_l2_w96": (1, 4, 2, 288, 640, ROW8, TEN8, 512, False),
    "split_d_d640_w16_l2": (1, 4, 1, 144, 640, ROW8, CH8, 512, False),
    "split_d_d640_gqa16_l1": (2, 16, 1, 256, 640, ROW8, CH8, None, False),
    "split_d_d640_gqa16_l2_w128": (2, 16, 1, 256, 640, ROW8, CH8, 128,
                                   False),
    "split_d_d592_gqa8_interleaved_l1": (1, 16, 2, 192, 592, ROW8, TEN8,
                                         None, True),
    "split_d_d580_l1_sq_ne_skv": (1, 4, 2, (100, 200), 580, ROW8, CH8, None,
                                  False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FULLINT_CASES))
def test_fullint_kernels_match_plain(cuda_device, name):
    """The full-integer dQ and dK/dV kernels against their plain versions
    (bf16 tolerance: dS and P rounded to bf16, or row-quantized to int8
    over the resolved widths, from fp32 values summed in another order),
    on the kernels ``fullint_body`` names for the resolved widths."""
    b, hq, hkv, s, d, kcfg, vcfg, blocks, inter = FULLINT_CASES[name]
    sq, skv = s if isinstance(s, tuple) else (s, s)
    q, kq, vq = _qattn_inputs(cuda_device, b, hq, hkv, sq, skv, d, kcfg,
                              vcfg, BF16)
    assert fbwd.fullint_backward_supported(q, kq, vq, masking.FULL, None,
                                           None)
    opts = dict(interleaved_kv=inter)
    do, lse, di = _bwd_inputs(cuda_device, q, kq, vq, masking.FULL, 2,
                              quantize_q=True, **opts)
    bs = fbwd.BlockSizes(**({} if blocks is None else dict(
        block_kv_dq=blocks, block_q_dkv=blocks)))
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.fullint_arguments(
        q, kq, vq, None, lse, do, scale=d ** -0.5, block_sizes=bs, di=di,
        int8_grads=blocks is not None, **opts)
    if blocks is not None:
        assert (dq_kw["width"], dkv_kw["width"]) == fbwd.fullint_widths(
            bs, sq, skv)
    n = (fbwd.fullint_dq.launches, fbwd.fullint_dkv.launches)
    dq = fbwd.fullint_dq(*dq_a, **dq_kw)
    dk, dv = fbwd.fullint_dkv(*dkv_a, **dkv_kw)
    torch.cuda.synchronize()
    assert (fbwd.fullint_dq.launches, fbwd.fullint_dkv.launches) == (
        n[0] + 1, n[1] + 1)
    dk_ref, dv_ref = fbwd.fullint_dkv_plain(*dkv_a, **dkv_kw)
    for got, want in ((dq, fbwd.fullint_dq_plain(*dq_a, **dq_kw)),
                      (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= BF16_TOL, name


@pytest.mark.cuda
def test_fullint_kernels_route_as_the_python_bodies_say(cuda_device):
    """The C launcher's routing of the full-integer pair (as the library
    reports it) agrees with fullint_body at every built width, level 1 and
    every level-2 width up to 4096: whole s8 k steps on the tensor cores,
    the rest on the scalar kernels."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build

    body = _build.kernel_function("mfa_fullint_tc_body",
                                  [ctypes.c_int, ctypes.c_int])
    for d in (32, 64, 128, 256, 288, 576, 8, 40, 72, 300):
        for width in range(4097):
            want = fbwd.fullint_body(d, width) == "tensor_core"
            assert body(d, width) == int(want), (d, width)
            assert want == (width % 32 == 0)
    # Above 576 the split-D pair at both levels and every width (the C
    # interface takes the padded width, a multiple of 16).
    for d in (592, 640, 1024, 2048):
        for width in (0, 1, 16, 96, 128, 512):
            assert fbwd.fullint_body(d, width) == "split_d"
            assert body(d, width) == 2, (d, width)
    assert body(0, 0) == -1 and body(64, -1) == -1
    assert body(600, 0) == -1 and body(640, -1) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("block_kv", [128, 256])
@pytest.mark.parametrize("d", [272, 288])
def test_qattn_wide_int8_p_over_block_kv_spans(cuda_device, d, block_kv):
    """The wide forward's int8 P (an int8 Q, SYMMETRIC CHANNEL V) over the
    TPU's block_kv spans of 128 and 256 keys, each walked in 32-key steps
    twice (the span's row max, then P): held to the plain version over the
    same spans, and through the public forward's ``block_sizes``."""
    q, kq, vq = _qattn_inputs(cuda_device, 1, 4, 1, 300, 520, d, ROW8, CH8,
                              BF16, seed=d)
    args, kw = qa.qattn_arguments(q, kq, vq, mask=masking.CAUSAL,
                                  quantize_q=True)
    assert kw["mode"].p_int8
    assert qa.qattn_body(args[0].dtype, kw["mode"], d=d) == "tensor_core_wide"
    o, lse = qa.qattn_fwd(*args, **kw, kv_tile=block_kv)
    o_ref, l_ref = qa.qattn_fwd_plain(*args, **kw, kv_tile=block_kv)
    assert _rel(o, o_ref) <= BF16_TOL
    assert _rel(lse, l_ref) <= TOLERANCES["lse"]
    fwd, _ = qa.quantized_flash_attention_forward(
        q, kq, vq, mask=masking.CAUSAL, quantize_q=True,
        block_sizes=BlockSizes(block_kv=block_kv))
    assert torch.equal(fwd, o)


def _wide_calls(device, d):
    """Each wide quantized kernel's launch at head dim ``d``, as a list of
    (name, thunk returning its outputs): the forward (bf16 dequant, int8 P),
    the exact dQ and dK/dV (a group of 8 split over CTAs and merged), and
    the full-integer pair at levels 1 and 2."""
    calls = []
    for name, kcfg, vcfg, opts in (("fwd_dequant", ROW4C, ROW8C, {}),
                                   ("fwd_int8_p", ROW8, CH8, QQ)):
        q, kq, vq = _qattn_inputs(device, 1, 4, 1, 200, 200, d, kcfg, vcfg,
                                  BF16)
        args, kw = qa.qattn_arguments(q, kq, vq, mask=masking.CAUSAL, **opts)
        tile = 128 if kw["mode"].p_int8 else None
        calls.append((name, lambda a=args, k=kw, t=tile: qa.qattn_fwd(
            *a, **k, kv_tile=t)))
    q, kq, vq = _qattn_inputs(device, 1, 8, 1, 160, 160, d, ROW8, ROW4C, BF16)
    do, lse, di = _bwd_inputs(device, q, kq, vq, masking.CAUSAL, 3)
    rr = row_ranges_tensor(masking.CAUSAL, 160, 160, None, device)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, scale=d ** -0.5)
    assert fbwd.dkv_splits(BF16, d, 1, 8, 1, 160,
                           fbwd._sm_count(device)) > 1
    calls += [("qflash_dq", lambda: fbwd.qflash_dq(*dq_a, **dq_kw)[0]),
              ("qflash_dkv", lambda: fbwd.qflash_dkv(*dkv_a, **dkv_kw))]
    q, kq, vq = _qattn_inputs(device, 1, 4, 2, 256, 256, d, ROW8, CH8, BF16)
    do, lse, di = _bwd_inputs(device, q, kq, vq, masking.FULL, 4)
    for level2 in (False, True):
        (fa, fkw), (ka, kkw) = fbwd.fullint_arguments(
            q, kq, vq, None, lse, do, scale=d ** -0.5, di=di,
            block_sizes=BlockSizes(block_kv_dq=128, block_q_dkv=128),
            int8_grads=level2)
        tag = "l2" if level2 else "l1"
        calls += [(f"fullint_dq_{tag}",
                   lambda a=fa, k=fkw: fbwd.fullint_dq(*a, **k)),
                  (f"fullint_dkv_{tag}",
                   lambda a=ka, k=kkw: fbwd.fullint_dkv(*a, **k))]
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("d", [272, 288])
def test_wide_quantized_kernels_repeat_bit_for_bit(cuda_device, d):
    """Two calls of each wide quantized kernel on the same inputs give the
    same bits: no floating-point atomics, the dK/dV's group split merged in
    split order."""
    for name, call in _wide_calls(cuda_device, d):
        first, second = call(), call()
        torch.cuda.synchronize()
        for x, y in zip(first if isinstance(first, tuple) else (first,),
                        second if isinstance(second, tuple) else (second,)):
            assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("block_kv", [128, 256])
@pytest.mark.parametrize("d", [320, 576])
def test_qattn_latent_int8_p_over_block_kv_spans(cuda_device, d, block_kv):
    """The latent forward's int8 P (an int8 Q, SYMMETRIC CHANNEL V) over
    the TPU's block_kv spans of 128 and 256 keys, each walked in 32-key
    steps twice (both warps' halves of the span's row max, then P): held
    to the plain version over the same spans, and through the public
    forward's ``block_sizes``."""
    q, kq, vq = _qattn_inputs(cuda_device, 1, 16, 1, 300, 520, d, ROW8, CH8,
                              BF16, seed=d)
    args, kw = qa.qattn_arguments(q, kq, vq, mask=masking.CAUSAL,
                                  quantize_q=True)
    assert kw["mode"].p_int8
    assert qa.qattn_body(args[0].dtype, kw["mode"],
                         d=d) == "tensor_core_latent"
    o, lse = qa.qattn_fwd(*args, **kw, kv_tile=block_kv)
    o_ref, l_ref = qa.qattn_fwd_plain(*args, **kw, kv_tile=block_kv)
    assert _rel(o, o_ref) <= BF16_TOL
    assert _rel(lse, l_ref) <= TOLERANCES["lse"]
    fwd, _ = qa.quantized_flash_attention_forward(
        q, kq, vq, mask=masking.CAUSAL, quantize_q=True,
        block_sizes=BlockSizes(block_kv=block_kv))
    assert torch.equal(fwd, o)


def _latent_calls(device, d):
    """Each quantized kernel's launch at head dim ``d`` above 288, as a
    list of (name, thunk returning its outputs): the forward (bf16 and int4
    dequant, int8 P, an fp32 Q), the exact dQ and dK/dV of a bf16 Q (16 q
    heads over one latent head: the group split over CTAs and merged) and
    of an fp32 Q."""
    calls = []
    for name, kcfg, vcfg, dtype, opts in (
            ("fwd_dequant", ROW4C, ROW8C, BF16, {}),
            ("fwd_int8_p", ROW8, CH8, BF16, QQ),
            ("fwd_f32", ROW8C, ROW4C, F32, {})):
        q, kq, vq = _qattn_inputs(device, 1, 16, 1, 300, 300, d, kcfg, vcfg,
                                  dtype)
        args, kw = qa.qattn_arguments(q, kq, vq, mask=masking.CAUSAL, **opts)
        tile = 128 if kw["mode"].p_int8 else None
        calls.append((name, lambda a=args, k=kw, t=tile: qa.qattn_fwd(
            *a, **k, kv_tile=t)))
    for tag, dtype, kcfg in (("", BF16, ROW8), ("_f32", F32, ROW8C)):
        q, kq, vq = _qattn_inputs(device, 1, 16, 1, 300, 300, d, kcfg, ROW4C,
                                  dtype)
        do, lse, di = _bwd_inputs(device, q, kq, vq, masking.CAUSAL, 3)
        rr = row_ranges_tensor(masking.CAUSAL, 300, 300, None, device)
        (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.qflash_arguments(
            q, kq, vq, do, lse, di, rr, scale=d ** -0.5)
        calls += [(f"qflash_dq{tag}",
                   lambda a=dq_a, k=dq_kw: fbwd.qflash_dq(*a, **k)[0]),
                  (f"qflash_dkv{tag}",
                   lambda a=dkv_a, k=dkv_kw: fbwd.qflash_dkv(*a, **k))]
    assert fbwd.dkv_splits(BF16, d, 1, 16, 1, 300,
                           fbwd._sm_count(device)) > 1
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 512, 576])
def test_latent_quantized_kernels_repeat_bit_for_bit(cuda_device, d):
    """Two calls of each quantized kernel above 288 on the same inputs give
    the same bits: no floating-point atomics, the dK/dV's group split
    merged in split order."""
    for name, call in _latent_calls(cuda_device, d):
        first, second = call(), call()
        torch.cuda.synchronize()
        for x, y in zip(first if isinstance(first, tuple) else (first,),
                        second if isinstance(second, tuple) else (second,)):
            assert torch.equal(x, y), name


@pytest.mark.cuda
def test_quantized_kernels_past_576_launch_split_d_and_fullint_at_576(
        cuda_device):
    """At 640 the public quantized forward and backward (exact, and
    full-integer at both levels) launch the split-D kernels and no
    fixed-width one: the C routing names them for the padded width (the
    routers send every D above 576 to the split-D launchers), each
    wrapper counts one launch a call; each result is the CPU's (the plain
    versions) and repeats bit for bit.  (No profiler here: a trace in
    this file's run left the later GEMM tests' traces empty.)  The
    full-integer pair runs at 576 too (where it raised before its 576
    instances): one dQ, one dK/dV launch, the plain versions' results."""
    q, kq, vq = _qattn_inputs(cuda_device, 1, 4, 1, 96, 96, 640, ROW8, CH8,
                              BF16)
    assert qa.qattn_body(BF16, qa.QAttnMode("none", "store"),
                         d=640) == "split_d"
    assert {fbwd.dq_body(BF16, 640), fbwd.dkv_body(BF16, 640),
            fbwd.fullint_body(640, 0), fbwd.fullint_body(640, 96)} == {
                "split_d"}
    qbody = _build.kernel_function("mfa_qattn_body", [ctypes.c_int] * 3)
    fbody = _build.kernel_function("mfa_fullint_tc_body", [ctypes.c_int] * 2)
    assert qbody(1, 640, 1) == 4 and fbody(640, 0) == fbody(640, 96) == 2
    cpu = (q.cpu(), kq.to("cpu"), vq.to("cpu"))
    n = qa.qattn_fwd.launches
    o, lse = qa.quantized_flash_attention_forward(q, kq, vq)
    assert qa.qattn_fwd.launches == n + 1
    o_ref, l_ref = qa.quantized_flash_attention_forward(*cpu)
    assert _rel(o.cpu(), o_ref) <= BF16_TOL
    assert _rel(lse.cpu(), l_ref) <= TOLERANCES["lse"]
    do = torch.randn(q.shape, device=cuda_device).to(BF16)
    counted = (fbwd.qflash_dq, fbwd.qflash_dkv, fbwd.fullint_dq,
               fbwd.fullint_dkv)
    for fullint, level in ((False, None), (True, "1"), (True, "2")):
        kw = dict(fullint=fullint, block_sizes=fbwd.BlockSizes(
            block_kv_dq=128, block_q_dkv=128))
        old = os.environ.get("MFA_BWD_FULLINT_LEVEL")
        if level:
            os.environ["MFA_BWD_FULLINT_LEVEL"] = level
        try:
            n = [f.launches for f in counted]
            got = fbwd.flash_attention_backward(q, kq, vq, o, lse, do, **kw)
            torch.cuda.synchronize()
            grew = [f.launches - c for f, c in zip(counted, n)]
            assert grew == ([0, 0, 1, 1] if fullint else [1, 1, 0, 0])
            again = fbwd.flash_attention_backward(q, kq, vq, o, lse, do,
                                                  **kw)
            want = fbwd.flash_attention_backward(
                *cpu, o.cpu(), lse.cpu(), do.cpu(), **kw)
        finally:
            if old is None:
                os.environ.pop("MFA_BWD_FULLINT_LEVEL", None)
            else:
                os.environ["MFA_BWD_FULLINT_LEVEL"] = old
        assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
        for g, w in zip(got[:3], want[:3]):
            assert _rel(g.cpu(), w) <= BF16_TOL, (fullint, level)
    q, kq, vq = _qattn_inputs(cuda_device, 1, 4, 1, 64, 64, 576, ROW8, CH8,
                              BF16)
    assert fbwd.fullint_backward_supported(q, kq, vq, masking.FULL, None,
                                           None)
    o, lse = qa.quantized_flash_attention_forward(q, kq, vq)
    (fa, fkw), (ka, kkw) = fbwd.fullint_arguments(q, kq, vq, o, lse,
                                                  torch.ones_like(q),
                                                  scale=576 ** -0.5)
    n = (fbwd.fullint_dq.launches, fbwd.fullint_dkv.launches)
    dq = fbwd.fullint_dq(*fa, **fkw)
    dk, dv = fbwd.fullint_dkv(*ka, **kkw)
    torch.cuda.synchronize()
    assert (fbwd.fullint_dq.launches, fbwd.fullint_dkv.launches) == (
        n[0] + 1, n[1] + 1)
    dk_ref, dv_ref = fbwd.fullint_dkv_plain(*ka, **kkw)
    for got, want in ((dq, fbwd.fullint_dq_plain(*fa, **fkw)), (dk, dk_ref),
                      (dv, dv_ref)):
        assert _rel(got, want) <= BF16_TOL


@pytest.mark.cuda
def test_split_d_qattn_fp32_q_rounding_to_bf16(cuda_device):
    """An fp32 Q in a mode that rounds to bf16 (``qattn_fwd`` takes it; the
    public forward gives an fp32 Q the fp32 mode): at 640 the split-D
    kernel's fp32 instance rounds the dequantized K/V and P to bf16 where
    the plain version does."""
    q, kq, vq = _qattn_inputs(cuda_device, 1, 4, 1, 100, 100, 640, ROW8C,
                              ROW8C, F32)
    args, kw = qa.qattn_arguments(q, kq, vq, mask=masking.CAUSAL)
    kw["mode"] = dataclasses.replace(kw["mode"], round_bf16=True)
    assert qa.qattn_body(F32, kw["mode"], d=640) == "split_d"
    o, lse = qa.qattn_fwd(*args, **kw)
    o_ref, l_ref = qa.qattn_fwd_plain(*args, **kw, kv_tile=qa.KV_TILE)
    assert _rel(o, o_ref) <= BF16_TOL
    assert _rel(lse, l_ref) <= TOLERANCES["lse"]


@pytest.mark.cuda
def test_qattn_kernels_route_as_qattn_body_says(cuda_device):
    """The C interface's choice of forward kernel (as the library reports
    it) agrees with ``qattn_body`` at every built width: the latent kernel
    at 576 and the wide one at 288 for a bf16 or int8 Q rounding to bf16,
    the 64-key one below, the scalar body for fp32 and for an int8 Q
    without the rounding; above 576 the split-D kernel for every Q."""
    body = _build.kernel_function("mfa_qattn_body", [ctypes.c_int] * 3)
    names = {"fp32_fma": 0, "tensor_core": 1, "tensor_core_wide": 2,
             "tensor_core_latent": 3, "split_d": 4}
    for d in qa.HEAD_DIMS + (592, 640, 1024, 2048):
        for dtype, code in qa.Q_TYPES.items():
            for rb in (False, True):
                if dtype == BF16 and not rb:
                    assert body(code, d, 0) == -1
                    continue
                mode = qa.QAttnMode("token", "token", round_bf16=rb)
                want = names[qa.qattn_body(dtype, mode, d=d)]
                assert body(code, d, int(rb)) == want, (d, dtype, rb)
    assert body(1, 304, 1) == -1 and body(1, 272, 1) == -1
    assert body(1, 600, 1) == -1  # above 576 the multiples of 16


@pytest.mark.cuda
@pytest.mark.parametrize("fullint", [False, True])
def test_quantized_autograd_on_the_card(cuda_device, fullint):
    """``quantized_flash_attention``'s gradients (q, K/V scales) on the card
    against the same call on the CPU (the plain versions)."""
    q, kq, vq = _qattn_inputs(cuda_device, 1, 4, 2, 256, 256, 64, ROW8, CH8,
                              BF16)
    do = torch.randn(q.shape, device=cuda_device).to(BF16)

    def grads(q_, kq_, vq_, do_):
        leaves = [t.clone().requires_grad_(True)
                  for t in (q_, kq_.scale, vq_.scale)]
        k2 = dataclasses.replace(kq_, scale=leaves[1])
        v2 = dataclasses.replace(vq_, scale=leaves[2])
        o = qa.quantized_flash_attention(leaves[0], k2, v2,
                                         quantize_q=fullint,
                                         bwd_fullint=fullint)
        return torch.autograd.grad((o.float() * do_.float()).sum(), leaves)

    n = (fbwd.fullint_dq.launches, fbwd.qflash_dq.launches)
    got = grads(q, kq, vq, do)
    torch.cuda.synchronize()
    assert (fbwd.fullint_dq.launches - n[0],
            fbwd.qflash_dq.launches - n[1]) == ((1, 0) if fullint else (0, 1))
    want = grads(q.cpu(), kq.to("cpu"), vq.to("cpu"), do.cpu())
    for g, w in zip(got, want):
        assert _rel(g.float().cpu(), w.float()) <= BF16_TOL


@pytest.mark.cuda
def test_quantized_backward_kernels_reject_what_they_do_not_take(
        cuda_device):
    q, kq, vq = _qattn_inputs(cuda_device, 1, 2, 1, 64, 64, 64, ROW8, CH8,
                              BF16)
    do, lse, di = _bwd_inputs(cuda_device, q, kq, vq, masking.FULL, 3)
    rr = row_ranges_tensor(masking.FULL, 64, 64, None, cuda_device)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, scale=0.125)
    with pytest.raises(TypeError):  # a float payload
        fbwd.qflash_dq(*dq_a[:2], dq_a[2].float(), *dq_a[3:], **dq_kw)
    with pytest.raises(ValueError):  # dO on the CPU
        fbwd.qflash_dkv(dkv_a[0], dkv_a[1].cpu(), *dkv_a[2:], **dkv_kw)
    with pytest.raises(TypeError):  # store multipliers of the wrong shape
        fbwd.qflash_dq(*dq_a, **{**dq_kw, "dqsc": dq_kw["dqsc"][..., :8]})
    (fq_a, fq_kw), _ = fbwd.fullint_arguments(q, kq, vq, None, lse, do,
                                               scale=0.125, di=di)
    with pytest.raises(TypeError):  # a bf16 Q where int8 is taken
        fbwd.fullint_dq(q, *fq_a[1:], **fq_kw)
    with pytest.raises(ValueError):  # a negative width
        fbwd.fullint_dq(*fq_a, **{**fq_kw, "width": -1})


# --------------------------------------------------------------------------
# Runtime quantization
# --------------------------------------------------------------------------


def _rtq_input(device, shape, dtype, offset):
    """x [R, K] of ``dtype``; ``offset`` elements into its storage, so a
    nonzero offset leaves the base off 16-byte alignment (the kernels'
    scalar loads)."""
    n = shape[0] * shape[1]
    flat = torch.randn(n + offset, device=device) * 3 + 0.7
    return flat.to(dtype)[offset:].view(shape)


def _same_twice(call, want):
    """Two calls of ``call`` give the same bits, and those of ``want``."""
    first = call()
    torch.cuda.synchronize()
    second = call()
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("strategy", list(qparams.QuantStrategy),
                         ids=lambda s: s.value)
@pytest.mark.parametrize("shape,offset", [
    ((1000, 64), 0), ((37, 200), 0),
    ((16384, 64), 0),  # the facade's K/V rows
    ((50, 37), 0),     # rows not a multiple of 16 bytes, a ragged chunk
    ((64, 96), 0), ((33, 100), 0), ((5, 1), 0),
    ((300, 64), 1),    # a base off 16-byte alignment
    ((9, 2000), 0),    # past four chunks a lane: re-read from L1
], ids=["1000x64", "37x200", "16384x64", "50x37", "64x96", "33x100", "5x1",
        "300x64-unaligned", "9x2000"])
def test_row_kernel_matches_plain_bit_for_bit(cuda_device, shape, offset,
                                              strategy, bits, dtype):
    x = _rtq_input(cuda_device, shape, dtype, offset)
    n = rq.rtq_rows.launches
    want = rq.rtq_rows_plain(x, strategy, bits, True)
    _same_twice(lambda: rq.rtq_rows(x, strategy, bits, True), want)
    assert rq.rtq_rows.launches == n + 2
    got = rq.rtq_rows(x, strategy, bits, False)
    assert got[3] is None and all(torch.equal(a, b)
                                  for a, b in zip(got[:3], want[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("strategy", list(qparams.QuantStrategy),
                         ids=lambda s: s.value)
@pytest.mark.parametrize("shape,bs,offset", [
    ((512, 256), 64, 0),
    ((300, 384), 128, 0),   # 3 blocks x 16 CTAs: R not a multiple of C
    ((4096, 1024), 64, 0), ((4096, 1024), 128, 0),  # the main path's
    ((300, 256), 32, 0), ((200, 1024), 256, 0),
    ((5, 256), 64, 0),      # R < C: empty bands
    ((40, 300), 100, 0),    # bs not a multiple of 8
    ((64, 512), 64, 1),     # a base off 16-byte alignment
    ((20000, 64), 64, 0),   # a band past the held chunks: re-read from L2
], ids=["512x256-64", "300x384-128", "4096x1024-64", "4096x1024-128",
        "300x256-32", "200x1024-256", "5x256-64", "40x300-100",
        "64x512-64-unaligned", "20000x64-64"])
def test_block_kernel_matches_plain_bit_for_bit(cuda_device, shape, bs,
                                                offset, strategy, bits,
                                                dtype):
    x = _rtq_input(cuda_device, shape, dtype, offset)
    n = rq.rtq_blocks.launches
    want = rq.rtq_blocks_plain(x, bs, strategy, bits, True)
    _same_twice(lambda: rq.rtq_blocks(x, bs, strategy, bits, True), want)
    assert rq.rtq_blocks.launches == n + 2
    got = rq.rtq_blocks(x, bs, strategy, bits, False)
    assert got[3] is None and all(torch.equal(a, b)
                                  for a, b in zip(got[:3], want[:3]))


@pytest.mark.cuda
def test_row_group_matches_the_kernel(cuda_device):
    """The C library's lanes a row (mfa_rtq_row_group) are the plain
    version's (``row_group``)."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build

    group = _build.kernel_function("mfa_rtq_row_group", [ctypes.c_int])
    for k in (1, 7, 8, 9, 37, 64, 96, 100, 200, 256, 257, 2000, 4096):
        assert group(k) == rq.row_group(k), k


@pytest.mark.cuda
def test_block_clusters_fit_on_the_card(cuda_device):
    """Every cluster size block_cluster plans launches: the card holds at
    least one cluster of it at once (mfa_rtq_max_clusters)."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build

    active = _build.kernel_function("mfa_rtq_max_clusters", [ctypes.c_int])
    for cluster in (1, 2, 4, 8, 16):
        assert active(cluster) >= 1, cluster
    assert active(17) < 0  # past MAX_CLUSTER


@pytest.mark.cuda
def test_runtime_quantize_through_the_kernels(cuda_device):
    x = torch.randn(256, 512, device=cuda_device)
    for cfg in (qparams.int8_blockwise(64), _qcfg(bits=4, strategy="centered",
                                                  compute_sums=True)):
        got = rq.runtime_quantize(x, cfg)
        want = rq.runtime_quantize(x.cpu(), cfg)
        for field in ("data", "scale", "zero_point", "sums"):
            assert torch.equal(getattr(got, field).cpu(),
                               getattr(want, field))
    with pytest.raises(TypeError):  # fp16 has no kernel
        rq.rtq_rows(x.half(), qparams.QuantStrategy.SYMMETRIC, 8)


# --------------------------------------------------------------------------
# MLA's modes of the paged kernels: one-state latent pages, v_tail_zero
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("pool_kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("d,vtz", [(288, 32), (80, 16), (576, 64),
                                   (320, 64), (24, 8), (72, 8), (33, 1),
                                   (640, 64), (1088, 64), (1030, 6)])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_latent_paged_kernels_match_plain(cuda_device, kernel, d, vtz,
                                          pool_kind):
    """Hq = 16 over Hkv = 1: the decode splits the group over CTAs at
    D = 288 and DeepSeek's 576; D = 80 runs the kernels' run-time head dim,
    320 the 576 instances' (the prefill on paged_prefill_wide_kernel);
    640, 1088 and 1030 (pool rows off the 4-lane vectors) the split-D
    kernels."""
    rng = np.random.default_rng(d + vtz)
    hq, pt, num_pages = 16, 64, 12
    dtype = torch.float32 if pool_kind == "f32" else torch.bfloat16
    if pool_kind == "int8":
        pool = torch.from_numpy(rng.integers(-128, 128, (
            1, num_pages + 1, pt, d)).astype(np.int8)).to(cuda_device)
        sc = torch.from_numpy(rng.uniform(0.5, 2.0, (
            1, num_pages + 1, 1, pt)).astype(np.float32)).to(cuda_device) / 127
        kw = dict(k_scales=sc, v_scales=sc)
    else:
        pool = torch.from_numpy(rng.standard_normal((
            1, num_pages + 1, pt, d)).astype(np.float32)).to(cuda_device,
                                                             dtype)
        kw = {}
    kw.update(page_tokens=pt, v_tail_zero=vtz, scale=0.1)
    if kernel == "decode":
        lengths = np.asarray([1, pt + 3, 3 * pt - 5, 4 * pt], np.int32)
        _, table = _inputs(rng, 1, num_pages, pt, 16, lengths, 4)
        args = (torch.from_numpy(rng.standard_normal((4, hq, d)).astype(
            np.float32)).to(cuda_device, dtype), pool,
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device))
        fn, plain = paged_decode_attention, paged_decode_attention_plain
    else:
        offset, chunk = 70, 100
        _, table = _inputs(rng, 1, num_pages, pt, 16, [offset + chunk], 4)
        args = (torch.from_numpy(rng.standard_normal((hq, chunk, d)).astype(
            np.float32)).to(cuda_device, dtype), pool,
            torch.from_numpy(table[0]).to(cuda_device), offset)
        fn, plain = paged_prefill_attention, paged_prefill_attention_plain
    n = fn.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    ref = plain(*args, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype)
    # V's rope tail is zero, so the output's is too.
    assert not out[..., d - vtz:].float().abs().max().item()


# --------------------------------------------------------------------------
# The paged kernels' redesign: split-KV decode, tensor-core prefill
# --------------------------------------------------------------------------


def _paged_pool(device, kind, hkv, num_pages, pt, d, states, seed):
    """A pool of ``kind`` (bf16 / f32 floats, int8 halves or one state,
    the int4 byte) from a generator on the card, and its kwargs."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = pt if kind == "int4" else states * pt
    shape = (hkv, num_pages + 1, rows, d)
    if kind in ("bf16", "f32"):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        return torch.randn(shape, generator=g, device=device).to(dtype), {}
    pool = torch.randint(-128, 128, shape, generator=g, device=device)
    step = 7.0 if kind == "int4" else 127.0
    ks, vs = ((torch.rand((hkv, num_pages + 1, 1, pt), generator=g,
                          device=device) * 1.5 + 0.5) / step
              for _ in range(2))
    return pool.to(torch.int8), dict(k_scales=ks, v_scales=vs,
                                     kv_bits=4 if kind == "int4" else 8)


def _page_table(rng, lengths, pt, num_pages, max_pages, device):
    perm = rng.permutation(num_pages)
    table = np.full((len(lengths), max_pages), num_pages, np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        pages = -(-int(n) // pt)
        table[i, :pages] = perm[nxt: nxt + pages]
        nxt += pages
    return torch.from_numpy(table).to(device)


# (head dim, page states, v_tail_zero): the flagship's two-state pages at
# D = 64 and 128, MLA's one-state latent pages at D = 288 with V's rope
# tail of 32 zeroed and at DeepSeek's 576 with 64, two-state pages at 576
# (the int4 byte: one state, no tail).
SPLIT_LAYOUTS = [(64, 2, 0), (128, 2, 0), (288, 1, 32), (576, 1, 64),
                 (576, 2, 0), (608, 2, 0), (1024, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("pool_kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,states,vtz", SPLIT_LAYOUTS)
@pytest.mark.parametrize("group", [1, 4, 16])
@pytest.mark.parametrize("pt", [16, 48, 256])
def test_decode_kernel_many_splits_match_plain(cuda_device, pt, group, d,
                                               states, vtz, dtype,
                                               pool_kind):
    """Lengths 1, PT, PT + 1 and 4000 in one batch over a 4000-token
    table: every split count from the plan (up to 63 at PT = 16), splits
    past a sequence's end, page sizes that are not multiples of 64."""
    from metal_flash_attention_plus_tpu_torch.serving import (
        paged_attention as pa,
    )

    if pool_kind == "int4":
        states, vtz = 1, 0
    hq = max(group, 2)
    hkv = hq // group
    lengths = np.asarray([1, pt, pt + 1, 4000], np.int32)
    max_pages = -(-4000 // pt)
    num_pages = int(sum(-(-n // pt) for n in lengths)) + 3
    rng = np.random.default_rng(pt + group + d)
    kind = pool_kind if pool_kind != "float" else (
        "bf16" if dtype == torch.bfloat16 else "f32")
    pool, kw = _paged_pool(cuda_device, kind, hkv, num_pages, pt, d, states,
                           seed=pt * group + d)
    kw.update(page_tokens=pt, v_tail_zero=vtz, scale=0.1)
    table = _page_table(rng, lengths, pt, num_pages, max_pages, cuda_device)
    q = torch.from_numpy(rng.standard_normal((len(lengths), hq, d)).astype(
        np.float32)).to(cuda_device, dtype)
    ln = torch.from_numpy(lengths).to(cuda_device)
    splits = pa.decode_splits(len(lengths), hkv, group, max_pages * pt,
                              torch.cuda.get_device_properties(
                                  cuda_device).multi_processor_count)
    assert splits > 1
    n = paged_decode_attention.launches
    out = paged_decode_attention(q, pool, table, ln, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n + 1
    ref = paged_decode_attention_plain(q, pool, table, ln, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype)
    if vtz:
        assert not out[..., d - vtz:].float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_kind", ["float", "int8"])
def test_decode_kernel_is_deterministic(cuda_device, pool_kind, dtype):
    """Two calls on the same inputs give the same bits: the splits merge
    in a fixed order, with no atomics."""
    d, pt, hq, hkv = 64, 256, 16, 4
    lengths = np.asarray([1, 300, 1800, 4000, 77, 2500, 1024, 3999],
                         np.int32)
    rng = np.random.default_rng(11)
    kind = pool_kind if pool_kind != "float" else (
        "bf16" if dtype == torch.bfloat16 else "f32")
    pool, kw = _paged_pool(cuda_device, kind, hkv, 80, pt, d, 2, seed=3)
    table = _page_table(rng, lengths, pt, 80, 16, cuda_device)
    q = torch.from_numpy(rng.standard_normal((8, hq, d)).astype(
        np.float32)).to(cuda_device, dtype)
    ln = torch.from_numpy(lengths).to(cuda_device)
    outs = [paged_decode_attention(q, pool, table, ln, page_tokens=pt, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def _prefill_tc_cases():
    cases = []
    for d, states, vtz, hq, hkv in [(64, 2, 0, 16, 4), (128, 2, 0, 8, 2),
                                    (288, 1, 32, 16, 1), (576, 1, 64, 16, 1),
                                    (320, 1, 0, 8, 2)]:
        for kind in ("bf16", "int8", "int4"):
            if kind == "int4" and d in (288, 576):
                continue  # the int4 byte keeps every lane: scalar
            for pt, chunk, offset in [(16, 100, 70), (48, 256, 300),
                                      (256, 256, 512), (256, 64, 0)]:
                cases.append((d, states, vtz, hq, hkv, kind, pt, chunk,
                              offset))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("d,states,vtz,hq,hkv,kind,pt,chunk,offset",
                         _prefill_tc_cases())
def test_prefill_tensor_core_instances_match_plain(cuda_device, d, states,
                                                   vtz, hq, hkv, kind, pt,
                                                   chunk, offset):
    """paged_prefill_tc_kernel at D = 64, 128 and MLA's 288 / 32,
    paged_prefill_wide_kernel at DeepSeek's 576 / 64 and at 320 (run at
    576, two KV heads), over float, int8 and int4 pools, chunks that end
    mid-tile and offsets that split a row tile's visible range."""
    from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
        prefill_body,
    )

    if kind == "int4":
        states = 1
    assert prefill_body(torch.bfloat16, d, states, vtz) == "tensor_core"
    rng = np.random.default_rng(d + pt + offset)
    max_pages = -(-(offset + chunk) // pt) + 1
    pool, kw = _paged_pool(cuda_device, kind, hkv, max_pages + 2, pt, d,
                           states, seed=d * pt + offset)
    kw.update(page_tokens=pt, v_tail_zero=vtz, scale=d ** -0.5)
    row = _page_table(rng, [offset + chunk], pt, max_pages + 2, max_pages,
                      cuda_device)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    n = paged_prefill_attention.launches
    out = paged_prefill_attention(q, pool, row, offset, **kw)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n + 1
    ref = paged_prefill_attention_plain(q, pool, row, offset, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    if vtz:
        assert not out[..., d - vtz:].float().abs().max().item()


@pytest.mark.cuda
def test_paged_kernels_route_as_the_python_bodies_say(cuda_device):
    """The C library's routing (mfa_paged_bodies: bit 0 the decode, bit 1
    the prefill on the tensor cores; above 576 bit 2 the decode, bit 3 the
    prefill on the split-D kernels) agrees with decode_body and
    prefill_body."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build
    from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
        _DTYPE_CODES,
        decode_body,
        prefill_body,
    )

    bodies = _build.kernel_function("mfa_paged_bodies", [ctypes.c_int] * 4)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 80, 128, 256, 272, 288, 304, 320, 512, 528, 576,
                  8, 20, 33, 40, 72, 300, 520, 577, 592, 640, 1024, 1088):
            for states in (1, 2):
                for vtz in (0, 16, 32, 64):
                    if vtz >= d:
                        continue  # no lane of V is kept: no layout
                    bits = bodies(_DTYPE_CODES[dtype], d, states, vtz)
                    dec = decode_body(dtype, d)
                    pre = prefill_body(dtype, d, states, vtz)
                    want = ((dec == "tensor_core") | (pre == "tensor_core") << 1
                            | (dec == "split_d") << 2
                            | (pre == "split_d") << 3)
                    assert bits == want, (dtype, d, states, vtz)
    assert bodies(_DTYPE_CODES[torch.bfloat16], 0, 2, 0) == -1
    assert bodies(_DTYPE_CODES[torch.bfloat16], 592, 1, 64) == 4 | 8


@pytest.mark.cuda
@pytest.mark.parametrize("d,kind,states,vtz,dtype", [
    (576, "f32", 1, 64, torch.float32),    # MLA's fp32 latent pages
    (576, "f32", 2, 0, torch.float32),
    (576, "bf16", 2, 64, torch.bfloat16),  # two-state pages: scalar
    (576, "bf16", 1, 0, torch.bfloat16),   # 576 kept lanes: scalar
    (576, "int8", 2, 0, torch.bfloat16),
    (576, "int8", 1, 64, torch.float32),
    (576, "int4", 1, 0, torch.bfloat16),
    (576, "int4", 1, 0, torch.float32),
    (336, "f32", 1, 64, torch.float32),
    (336, "bf16", 2, 0, torch.bfloat16),
    (336, "int8", 2, 64, torch.bfloat16),
    (336, "int4", 1, 0, torch.float32),
])
def test_prefill_scalar_instances_past_288_match_plain(cuda_device, d, kind,
                                                       states, vtz, dtype):
    """paged_prefill_kernel above 288 (32-row CTAs, 32-token tiles): fp32,
    and the bf16 shapes the tensor cores leave; 336 is not a multiple of
    the tile's 32 lane threads."""
    from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
        prefill_body,
    )

    assert prefill_body(dtype, d, states, vtz) == "fp32_fma"
    pt, chunk, offset, hq, hkv = 48, 100, 70, 8, 2
    rng = np.random.default_rng(d + states + vtz)
    max_pages = -(-(offset + chunk) // pt) + 1
    pool, kw = _paged_pool(cuda_device, kind, hkv, max_pages + 2, pt, d,
                           states, seed=d + vtz)
    kw.update(page_tokens=pt, v_tail_zero=vtz, scale=d ** -0.5)
    row = _page_table(rng, [offset + chunk], pt, max_pages + 2, max_pages,
                      cuda_device)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d)).astype(
        np.float32)).to(cuda_device, dtype)
    n = paged_prefill_attention.launches
    out = paged_prefill_attention(q, pool, row, offset, **kw)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n + 1
    ref = paged_prefill_attention_plain(q, pool, row, offset, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype)
    if vtz:
        assert not out[..., d - vtz:].float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_kind", ["float", "int8"])
def test_paged_kernels_at_576_are_deterministic(cuda_device, pool_kind,
                                                dtype):
    """DeepSeek's geometry (Hq = 16 over the latent, D = 576, one-state
    pages, 64 zeroed V lanes): two decode calls and two prefill calls on
    the same inputs give the same bits."""
    d, vtz, pt, hq = 576, 64, 256, 16
    lengths = np.asarray([1, 300, 1800, 4000, 77, 2500, 1024, 3999],
                         np.int32)
    rng = np.random.default_rng(23)
    kind = pool_kind if pool_kind != "float" else (
        "bf16" if dtype == torch.bfloat16 else "f32")
    pool, kw = _paged_pool(cuda_device, kind, 1, 80, pt, d, 1, seed=5)
    kw.update(page_tokens=pt, v_tail_zero=vtz, scale=0.06)
    table = _page_table(rng, lengths, pt, 80, 16, cuda_device)
    q = torch.from_numpy(rng.standard_normal((8, hq, d)).astype(
        np.float32)).to(cuda_device, dtype)
    ln = torch.from_numpy(lengths).to(cuda_device)
    outs = [paged_decode_attention(q, pool, table, ln, **kw)
            for _ in range(2)]
    qp = torch.from_numpy(rng.standard_normal((hq, 256, d)).astype(
        np.float32)).to(cuda_device, dtype)
    pfs = [paged_prefill_attention(qp, pool, table[3], 512, **kw)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(pfs[0], pfs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [640, 1088])
def test_split_d_kernels_repeat_bit_for_bit(cuda_device, forced_splits, d,
                                            dtype):
    """Above 576, each split-D kernel called twice on the same inputs gives
    the same bits: the flash forward (also with its KV axis split in 3 runs
    and merged), dQ (with dbias) and dK/dV over 16 q heads on one (the
    dK/dV's group split over CTAs and merged), causal, and the paged decode
    (its KV axis split) and prefill over one-state latent pages with 64
    zeroed V lanes; each against its plain version."""
    (q, k, v), do, bias, rr = _flash_case(cuda_device, dtype, 2, 16, 1, 256,
                                          256, d, masking.CAUSAL,
                                          bias_shape=(2, 1, 256, 256), seed=d)
    assert fbwd.dkv_splits(dtype, d, 2, 16, 1, 256, 132) > 1
    kw = dict(scale=d ** -0.5)

    def fwd_split():
        forced_splits(3)
        try:
            return flash_fwd(q, k, v, rr, **kw)
        finally:
            forced_splits(None)

    calls = {
        "fwd": lambda: flash_fwd(q, k, v, rr, **kw),
        "fwd_split": fwd_split,
        "dq": lambda: flash_dq(q, k, v, do, lse, di, rr, bias=bias,
                               want_dbias=True, **kw),
        "dkv": lambda: flash_dkv(q, k, v, do, lse, di, rr, **kw)}
    o, lse = calls["fwd"]()
    di = (do.float() * o).sum(-1)
    for name, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert torch.equal(x, y), name
    dq, dbias = calls["dq"]()
    dq_ref, dbias_ref = flash_attention_dq_plain(
        q, k, v, do, lse, di, rr, bias=bias, want_dbias=True, **kw)
    assert _rel(dq, dq_ref) <= _tol(dtype)
    assert _rel(dbias, dbias_ref) <= _tol(dtype)
    vtz, pt, hq = 64, 64, 16
    lengths = np.asarray([1, 300, 1800, 77], np.int32)
    rng = np.random.default_rng(d)
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    pool, pkw = _paged_pool(cuda_device, kind, 1, 40, pt, d, 1, seed=d)
    pkw.update(page_tokens=pt, v_tail_zero=vtz, scale=d ** -0.5)
    table = _page_table(rng, lengths, pt, 40, 32, cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    qd = torch.from_numpy(rng.standard_normal((4, hq, d)).astype(
        np.float32)).to(cuda_device, dtype)
    qp = torch.from_numpy(rng.standard_normal((hq, 256, d)).astype(
        np.float32)).to(cuda_device, dtype)
    for fn, plain, args in (
            (paged_decode_attention, paged_decode_attention_plain,
             (qd, pool, table, ln)),
            (paged_prefill_attention, paged_prefill_attention_plain,
             (qp, pool, table[2], 512))):
        first, second = fn(*args, **pkw), fn(*args, **pkw)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        ref = plain(*args, **pkw)
        assert (first.float() - ref.float()).abs().max().item() <= _tol(
            dtype)


# --------------------------------------------------------------------------
# The split-D forward's KV split (split_d_fwd_splits, then the merge)
# --------------------------------------------------------------------------

FLASH_FWD_MODULE = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")


@pytest.fixture
def forced_splits(monkeypatch):
    """force(n): the split-D forwards plan n runs of the KV axis (1 where
    the call keeps one walk); force(None): the planner's own plan."""
    planner = FLASH_FWD_MODULE.split_d_fwd_splits

    def force(n):
        def plan(d, *shape, one_walk=False):
            if n is None:
                return planner(d, *shape, one_walk=one_walk)
            return 1 if one_walk or split_d_slices(d) == 1 else n
        monkeypatch.setattr(FLASH_FWD_MODULE, "split_d_fwd_splits", plan)
        monkeypatch.setattr(qa, "split_d_fwd_splits", plan)
    return force


def _gap_ranges(sq, skv):
    """Sparse rows whose tile span has runs with no live key: the first
    half of each 64-row tile attends to [0, 200), the second to the last
    200 keys."""
    r = np.arange(sq) % 64 < 32
    return np.stack([np.where(r, 0, skv - 200), np.where(r, 200, skv)],
                    axis=1).astype(np.int32)


SPARSE = masking.MaskSpec(masking.MaskKind.SPARSE_RANGES)
WINDOW_128 = masking.sliding_window(128, causal=True)

SPLIT_FWD_FLASH_CASES = {
    # name: (b, hq, hkv, sq, skv, d, mask, sparse gap rows, bias shape,
    # static max, forced runs or None for the plan's): few row tiles over
    # a long key axis.
    "full_planned_d1024": (1, 1, 1, 128, 4096, 1024, masking.FULL, False,
                           None, False, None),
    "causal_gqa4_d640": (1, 4, 1, 100, 1300, 640, masking.CAUSAL, False,
                         None, False, 3),
    "window_d1024": (1, 4, 2, 128, 1500, 1024, WINDOW_128, False, None,
                     False, 5),
    "sparse_gap_d640": (1, 2, 2, 128, 1600, 640, SPARSE, True, None, False,
                        4),
    "bias_d640": (1, 2, 1, 100, 1100, 640, masking.FULL, False,
                  (1, 2, 100, 1100), False, 3),
    "static_max_causal_d1024": (1, 2, 1, 128, 2048, 1024, masking.CAUSAL,
                                False, None, True, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SPLIT_FWD_FLASH_CASES))
def test_split_d_flash_forward_split_matches_plain(cuda_device,
                                                   forced_splits, name,
                                                   dtype):
    """split_d_fwd_kernel with its KV axis split, then
    split_d_fwd_merge_kernel: O and L against the unsplit plain version at
    the flash gates, two calls equal bit for bit, the launches counted
    (one kernel and one merge a call), and the same with one run (no
    merge)."""
    b, hq, hkv, sq, skv, d, mask, gap, bias_shape, static, n = \
        SPLIT_FWD_FLASH_CASES[name]
    (q, k, v), _, bias, rr = _flash_case(
        cuda_device, dtype, b, hq, hkv, sq, skv, d, mask,
        ranges=_gap_ranges(sq, skv) if gap else None, bias_shape=bias_shape,
        seed=d + sq)
    kw = dict(scale=d ** -0.5, bias=bias)
    if static:
        kw["row_max"] = _static_row_max(q, k, mask, rr, "caller",
                                        kw["scale"], hq, hkv)
    splits = n or FLASH_FWD_MODULE.split_d_fwd_splits(
        d, b, hq, sq, skv, torch.cuda.get_device_properties(
            cuda_device).multi_processor_count)
    assert splits > 1
    ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    forced_splits(n)
    for runs in (splits, 1):
        if runs == 1:
            forced_splits(1)
        counts = (flash_fwd.launches,
                  FLASH_FWD_MODULE.merge_fwd_splits.launches)
        first, second = (flash_fwd(q, k, v, rr, **kw) for _ in range(2))
        torch.cuda.synchronize()
        assert (flash_fwd.launches - counts[0],
                FLASH_FWD_MODULE.merge_fwd_splits.launches - counts[1]) == (
                    2, 2 if runs > 1 else 0)
        for x, y in zip(first, second):
            assert torch.equal(x, y)
        assert _rel(first[0], ref[0]) <= _tol(dtype)
        assert _rel(first[1], ref[1]) <= (
            TOLERANCES["fp32"] if dtype == torch.float32
            else TOLERANCES["lse"])


SPLIT_FWD_QCASES = {
    # name: (b, hq, hkv, sq, skv, d, K config, V config, Q dtype, mask,
    # options, forced runs or None for the plan's): every Q type, int8 and
    # int4 payloads (whole rows through the raw ring; D = 656's int4 rows
    # of 328 bytes staged synchronously), TOKEN / BLOCK_2D dequantization,
    # folded CHANNEL / TENSOR K, V_P (ROW V), V_STORE (CHANNEL / TENSOR
    # V), an int8 Q with a bf16 P (split) and with an int8 P (one walk),
    # causal, window, sparse rows with a gap and bias masks.
    "row8c_full_planned_d1024": (1, 1, 1, 128, 4096, 1024, ROW8C, ROW8C,
                                 BF16, masking.FULL, {}, None),
    "row4c_causal_gqa_d640": (1, 2, 1, 128, 2048, 640, ROW4C, ROW4C, BF16,
                              masking.CAUSAL, {}, None),
    "row4c_unaligned_d656": (1, 2, 1, 100, 1200, 656, ROW4C, ROW4C, BF16,
                             masking.FULL, {}, 3),
    "k8_v4_unaligned_d656": (1, 2, 1, 100, 1200, 656, ROW8C, ROW4C, BF16,
                             masking.CAUSAL, {}, 3),
    "block2d80_d640": (1, 2, 2, 64, 1600, 640, B2D80, B2D80, BF16,
                       masking.CAUSAL, {}, 4),
    "folded_channel_tensor_bias_d640": (1, 2, 1, 100, 1100, 640, CH8, TEN8,
                                        BF16, masking.FULL,
                                        dict(bias=(1, 2, 100, 1100)), 3),
    "folded_row_vp_window_d1024": (1, 2, 1, 128, 1500, 1024, ROW8, ROW8,
                                   BF16, WINDOW_128, {}, 5),
    "folded_tensor_store_sparse_gap_d640": (1, 2, 2, 128, 1600, 640, TEN8,
                                            CH8, BF16, SPARSE,
                                            dict(gap=True), 4),
    "folded_int4_channel_d1024": (1, 2, 1, 64, 1500, 1024, CH4, CH4, BF16,
                                  masking.CAUSAL, {}, 3),
    "int8_q_row_d640": (1, 4, 1, 100, 1300, 640, ROW8, ROW8, BF16,
                        masking.CAUSAL, QQ, 3),
    "int8_q_int4_k_d1024": (1, 2, 1, 64, 1500, 1024, ROW4, ROW8, BF16,
                            masking.FULL, QQ, 3),
    "int8_pv_one_walk_d1024": (1, 2, 1, 128, 1500, 1024, ROW8, CH8, BF16,
                               masking.FULL, QQ, 3),
    "f32_q_d640": (1, 2, 1, 64, 1100, 640, ROW8C, ROW4C, F32,
                   masking.CAUSAL, {}, 3),
    "f32_q_int8_d640": (1, 2, 1, 64, 1100, 640, ROW8, ROW4, F32,
                        masking.CAUSAL, QQ, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPLIT_FWD_QCASES))
def test_split_d_qattn_split_matches_plain(cuda_device, forced_splits,
                                           name):
    """split_d_qattn_kernel on a long key axis over few row tiles, its KV
    axis split (but with an int8 P) and merged: O and L against the plain
    version at the gates of test_qattn_kernel_matches_plain, two calls
    equal bit for bit, the kernel and merge launches counted; then one
    run against the same plain version."""
    b, hq, hkv, sq, skv, d, kcfg, vcfg, dtype, mask, opts, n = \
        SPLIT_FWD_QCASES[name]
    q, kq, vq = _qattn_inputs(cuda_device, b, hq, hkv, sq, skv, d, kcfg,
                              vcfg, dtype, seed=d + skv)
    opts = dict(opts)
    if opts.pop("gap", False):
        opts["mask_ranges"] = _gap_ranges(sq, skv)
    if "bias" in opts:
        opts["bias"] = torch.randn(opts["bias"], device=cuda_device)
    args, kw = qa.qattn_arguments(q, kq, vq, mask=mask, **opts)
    mode = kw["mode"]
    tile = qa.int8_p_tile(BlockSizes(), skv) if mode.p_int8 else None
    assert qa.qattn_body(args[0].dtype, mode, d=d) == "split_d"
    splits = 1 if mode.p_int8 else (n or FLASH_FWD_MODULE.split_d_fwd_splits(
        d, b, hq, sq, skv, torch.cuda.get_device_properties(
            cuda_device).multi_processor_count))
    assert (splits > 1) == (not mode.p_int8)
    o_ref, l_ref = qa.qattn_fwd_plain(*args, **kw, kv_tile=tile or qa.KV_TILE)
    tol_o, tol_l = _qattn_tols(dtype, mode.p_int8)
    forced_splits(n)
    for runs in (splits, 1):
        if runs == 1:
            forced_splits(1)
        counts = (qa.qattn_fwd.launches,
                  FLASH_FWD_MODULE.merge_fwd_splits.launches)
        first, second = (qa.qattn_fwd(*args, **kw, kv_tile=tile)
                         for _ in range(2))
        torch.cuda.synchronize()
        assert (qa.qattn_fwd.launches - counts[0],
                FLASH_FWD_MODULE.merge_fwd_splits.launches - counts[1]) == (
                    2, 2 if runs > 1 else 0)
        for x, y in zip(first, second):
            assert torch.equal(x, y)
        assert _rel(first[0], o_ref) <= tol_o
        assert _rel(first[1], l_ref) <= tol_l


# --------------------------------------------------------------------------
# The quantized forward's int8 P over the TPU's key spans
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("block_kv", [128, 512])
@pytest.mark.parametrize("mask", [masking.FULL, masking.CAUSAL],
                         ids=["full", "causal"])
def test_qattn_int8_p_over_key_spans_matches_plain(cuda_device, mask,
                                                   block_kv):
    q, kq, vq = _qattn_inputs(cuda_device, 1, 4, 2, 256, 1024, 256, ROW8,
                              CH8, torch.bfloat16, seed=block_kv)
    args, kw = qa.qattn_arguments(q, kq, vq, mask=mask, quantize_q=True)
    assert kw["mode"].p_int8
    tile = qa.int8_p_tile(BlockSizes(block_kv=block_kv), 1024)
    o, lse = qa.qattn_fwd(*args, **kw, kv_tile=tile)
    torch.cuda.synchronize()
    o_ref, l_ref = qa.qattn_fwd_plain(*args, **kw, kv_tile=tile)
    assert _rel(o, o_ref) <= BF16_TOL
    assert _rel(lse, l_ref) <= TOLERANCES["lse"]
    fwd, _ = qa.quantized_flash_attention_forward(
        q, kq, vq, mask=mask, quantize_q=True,
        block_sizes=BlockSizes(block_kv=block_kv))
    assert torch.equal(fwd, o)
    with pytest.raises(ValueError):  # spans are whole 64-key tiles
        qa.qattn_fwd(*args, **kw, kv_tile=96)
    f_args, f_kw = qa.qattn_arguments(q, kq, vq, mask=mask)
    with pytest.raises(ValueError):  # only an int8 Q walks key spans
        qa.qattn_fwd(*f_args, **f_kw, kv_tile=tile)


# --------------------------------------------------------------------------
# The weight-only GEMMs
# --------------------------------------------------------------------------

WO_CASES = {
    # name: (bits, granularity, strategy, block, A dtype, M, N, K, with c,
    # out dtype or None for A's): SYMMETRIC TENSOR / ROW with a bf16 A take
    # the folded kernel.
    "folded_row8": (8, "row", "symmetric", None, BF16, 300, 200, 256, False,
                    None),
    "folded_row8_c": (8, "row", "symmetric", None, BF16, 300, 200, 256, True,
                      None),
    "folded_row4": (4, "row", "symmetric", None, BF16, 70, 130, 512, False,
                    None),
    "folded_tensor8_c": (8, "tensor", "symmetric", None, BF16, 37, 70, 96,
                         True, None),
    "wo_block128": (8, "block", "centered", 128, BF16, 300, 200, 256, False,
                    None),
    "wo_block64_int4_c": (4, "block", "centered", 64, BF16, 37, 70, 256,
                          True, None),
    "wo_asym_row": (8, "row", "asymmetric", None, BF16, 300, 200, 256, False,
                    None),
    "wo_asym_row_c": (8, "row", "asymmetric", None, BF16, 37, 70, 100, True,
                      None),
    "wo_f32_row": (8, "row", "symmetric", None, F32, 300, 200, 256, False,
                   None),
    "wo_f32_tensor_int4_c": (4, "tensor", "centered", None, F32, 37, 70, 256,
                             True, None),
    # The tensor-core tile at gemm_bench's depth (K = 8192, the fp32 gate
    # over 256 tensor-core sums), gemm_bench's int4 BLOCK 256, M and N off
    # the 128 / 64 tiles with both tile shapes (128-row tiles at M = 1100,
    # N = 4100: two CTAs for each SM), K % 32 and N % 2 not 0, and out
    # dtypes other than A's (an fp32 A stored in bf16 by the scalar tile).
    "folded_row8_k8192": (8, "row", "symmetric", None, BF16, 256, 384, 8192,
                          False, None),
    "wo_block256_k8192_c": (8, "block", "symmetric", 256, BF16, 130, 200,
                            8192, True, None),
    "wo_block256_int4": (4, "block", "symmetric", 256, BF16, 200, 130, 1024,
                         False, None),
    "folded_row8_wide_ragged_c": (8, "row", "symmetric", None, BF16, 1100,
                                  4100, 528, True, None),
    "wo_row4_asym_wide_ragged": (4, "row", "asymmetric", None, BF16, 1100,
                                 4100, 512, False, None),
    "wo_tensor8_odd_n_k200": (8, "tensor", "centered", None, BF16, 65, 99,
                              200, True, None),
    "folded_row8_f32_out": (8, "row", "symmetric", None, BF16, 300, 200, 256,
                            False, F32),
    "folded_tensor4_f16_out_c": (4, "tensor", "symmetric", None, BF16, 37, 70,
                                 256, True, torch.float16),
    "wo_block128_f16_out": (8, "block", "centered", 128, BF16, 130, 99, 256,
                            False, torch.float16),
    "wo_f32_row_bf16_out_c": (8, "row", "asymmetric", None, F32, 300, 200,
                              256, True, BF16),
    # Split K (wo_tile): M = 1 over 8 splits; an odd N over 16, fp16 out.
    # (folded_row8_k8192 and wo_block256_k8192_c split 16 ways, and
    # wo_block256_int4 4 ways, too.)
    "wo_m1_split_c": (8, "row", "asymmetric", None, BF16, 1, 1000, 2048,
                      True, None),
    "folded_row4_split_odd_n": (4, "row", "symmetric", None, BF16, 64, 257,
                                4096, False, torch.float16),
}


def _bf16_close(out, ref):
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
        out.abs(), ref.abs()).clamp_min(2.0 ** -126))) - 7)
    return bool(((out - ref).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WO_CASES))
def test_weight_only_gemm_kernels_match_plain(cuda_device, name):
    """The weight-only kernel of each arm (the body ``wo_gemm_body`` names)
    in fp32 against its plain version on the same arguments, on the card
    and on the CPU, at the fp32 gate (TOLERANCES["fp32"] of its max abs:
    the kernels sum exact products in another order); then
    ``quantized_matmul`` on the card, one more launch, returning exactly
    that fp32 result rounded to the out dtype (the kernels round it once at
    the store)."""
    bits, gran, strategy, bs, adtype, m, n, k, with_c, out = WO_CASES[name]
    rng = np.random.default_rng(m + n + k + bits)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device)

    wq = quantize(t(n, k), _qcfg(bits=bits, gran=gran, strategy=strategy,
                                 block_size=bs))
    a = t(m, k).to(adtype)
    c = t(m, n) if with_c else None
    folded, args, kw = qg.wo_arguments(a, wq, c)
    assert folded == name.startswith("folded")
    assert qg.wo_gemm_body(args[0].dtype) == (
        "fp32_fma" if adtype == F32 else "tensor_core")
    kernel, plain = ((qg.wo_folded_gemm, qg.wo_folded_gemm_plain) if folded
                     else (qg.wo_gemm, qg.wo_gemm_plain))
    n0 = (qg.wo_folded_gemm.launches, qg.wo_gemm.launches)
    got32 = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert got32.dtype == F32 and got32.shape == (m, n)
    assert _rel(got32, plain(*args, **kw)) <= TOLERANCES["fp32"]
    ref = qg.quantized_matmul(a.cpu(), wq.to("cpu"),
                              c=None if c is None else c.cpu(),
                              out_dtype=F32)
    assert _rel(got32.cpu(), ref) <= TOLERANCES["fp32"]
    got = qg.quantized_matmul(a, wq, c=c, out_dtype=out)
    torch.cuda.synchronize()
    assert (qg.wo_folded_gemm.launches, qg.wo_gemm.launches) == (
        n0[0] + 2 * folded, n0[1] + 2 * (not folded))
    assert got.dtype == (out or adtype)
    assert torch.equal(got, got32.to(got.dtype))


@pytest.mark.cuda
def test_weight_only_gemm_routes_as_wo_gemm_body_says(cuda_device):
    """The C interface's routing (``mfa_wo_tc_body``) agrees with
    ``wo_gemm_body``: a bf16 A on the tensor-core tile, an fp32 A on the
    scalar one, nothing else."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build

    body = _build.kernel_function("mfa_wo_tc_body", [ctypes.c_int])
    for atype, dtype in ((0, F32), (1, BF16)):
        assert body(atype) == int(qg.wo_gemm_body(dtype) == "tensor_core")
    assert body(2) == -1 and body(-1) == -1


@pytest.mark.cuda
def test_weight_only_gemm_kernels_reject_what_they_do_not_take(cuda_device):
    a = torch.ones(4, 256, device=cuda_device, dtype=BF16)
    w8 = quantize(torch.ones(8, 256, device=cuda_device), ROW8)
    scale = w8.scale.reshape(-1).float()
    with pytest.raises(TypeError):  # the folded kernel takes a bf16 A
        qg.wo_folded_gemm(a.float(), w8.data, scale, bits=8)
    with pytest.raises(TypeError):  # an int8 payload declared int4
        qg.wo_folded_gemm(a, w8.data, scale, bits=4)
    with pytest.raises(TypeError):  # ROW scales of the wrong length
        qg.wo_gemm(a, w8.data, scale[:4], scale[:4], bits=8, scales=1)
    with pytest.raises(ValueError):  # not a scale kind of the kernel
        qg.wo_gemm(a, w8.data, scale, scale, bits=8, scales=3)
    with pytest.raises(ValueError):  # CPU tensors for the kernel
        qg.wo_gemm(a, w8.data.cpu(), scale, scale, bits=8, scales=1)
    with pytest.raises(TypeError):  # not a dtype the kernels store
        qg.wo_folded_gemm(a, w8.data, scale, bits=8, out_dtype=torch.float64)
    with pytest.raises(TypeError):
        qg.wo_gemm(a, w8.data, scale, scale, bits=8, scales=1,
                   out_dtype=torch.int32)


# --------------------------------------------------------------------------
# The quantized-A and compensated GEMMs
# --------------------------------------------------------------------------

QA_GEMM_CASES = {
    # name: (bits, granularity, strategy, block, B dtype, M, N, K): SYMMETRIC
    # TENSOR / ROW with a non-fp32 B take the folded kernel.
    "folded_row8": (8, "row", "symmetric", None, BF16, 300, 200, 256),
    "folded_row4": (4, "row", "symmetric", None, BF16, 70, 130, 512),
    "folded_tensor8_fp16_b": (8, "tensor", "symmetric", None, torch.float16,
                              37, 70, 96),
    "qa_row8_asym": (8, "row", "asymmetric", None, BF16, 300, 200, 256),
    "qa_block128": (8, "block", "centered", 128, BF16, 130, 70, 512),
    "qa_block64_int4_f32": (4, "block", "centered", 64, F32, 37, 70, 256),
    "qa_row8_f32": (8, "row", "symmetric", None, F32, 300, 200, 256),
    "qa_tensor4_centered_f32": (4, "tensor", "centered", None, F32, 37, 70,
                                256),
}

# The tensor-core tile (bf16 B) at its ragged edges: M = 1 and 128, K not a
# multiple of 32 (and of 16: element loads), N not a multiple of 8 (element
# loads, odd N), int4 A with BLOCK cells, and both of its tile shapes
# (64 x 128 for the small ones; 128 x 128 at M = 1100, N = 4104, two CTAs
# for each SM).  Same fields as QA_GEMM_CASES.
QA_TC_CASES = {
    "m1": (8, "row", "asymmetric", None, BF16, 1, 200, 256),
    "m128_block128": (8, "block", "centered", 128, BF16, 128, 1000, 1024),
    "k200": (8, "row", "asymmetric", None, BF16, 300, 200, 200),
    "k272_tensor": (8, "tensor", "centered", None, BF16, 130, 136, 272),
    "odd_n": (8, "row", "asymmetric", None, BF16, 70, 99, 96),
    "int4_block64": (4, "block", "centered", 64, BF16, 130, 70, 512),
    "wide_k528": (8, "row", "asymmetric", None, BF16, 1100, 4104, 528),
    "wide_int4_n4100": (4, "row", "asymmetric", None, BF16, 600, 4100,
                        512),
    # The folded GEMM (SYMMETRIC TENSOR / ROW A) on the same tile: ragged
    # M, N and K (K % 16 and N % 8 not 0), M = 128, both tile shapes, int4.
    "folded_row8_ragged": (8, "row", "symmetric", None, BF16, 300, 99, 200),
    "folded_row8_m128": (8, "row", "symmetric", None, BF16, 128, 1000, 1024),
    "folded_row8_wide_k528": (8, "row", "symmetric", None, BF16, 1100, 4100,
                              528),
    "folded_row4_ragged_n": (4, "row", "symmetric", None, BF16, 130, 70,
                             512),
    "folded_row4_wide": (4, "row", "symmetric", None, BF16, 600, 4104, 512),
    "folded_tensor8_ragged": (8, "tensor", "symmetric", None, BF16, 37, 70,
                              104),
    "folded_tensor8_m128_k200": (8, "tensor", "symmetric", None, BF16, 128,
                                 136, 200),
}


def _t(rng, device, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(QA_GEMM_CASES))
def test_qa_gemm_kernels_match_plain(cuda_device, name):
    """The quantized-A kernels against their plain versions on the same
    arguments: an fp32 result within TOLERANCES["fp32"] of its max abs,
    through ``quantized_matmul_qa`` (which rounds to B's dtype) one bf16
    or fp16 ulp."""
    bits, gran, strategy, bs, bdtype, m, n, k = QA_GEMM_CASES[name]
    rng = np.random.default_rng(m + n + k + bits)
    aq = quantize(_t(rng, cuda_device, m, k), _qcfg(
        bits=bits, gran=gran, strategy=strategy, block_size=bs))
    b = _t(rng, cuda_device, k, n).to(bdtype)
    folded, args, kw = qg.qa_arguments(aq, b)
    assert folded == name.startswith("folded")
    kernel, plain = ((qg.qa_folded_gemm, qg.qa_folded_gemm_plain) if folded
                     else (qg.qa_gemm, qg.qa_gemm_plain))
    n0 = (qg.qa_folded_gemm.launches, qg.qa_gemm.launches)
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert (qg.qa_folded_gemm.launches, qg.qa_gemm.launches) == (
        n0[0] + folded, n0[1] + (not folded))
    ref = plain(*args, **kw)
    assert out.dtype == F32 and out.shape == (m, n)
    assert _rel(out, ref) <= TOLERANCES["fp32"]
    got = qg.quantized_matmul_qa(aq, b)
    want = qg.quantized_matmul_qa(aq.to("cpu"), b.cpu())
    assert got.dtype == bdtype
    if bdtype == F32:
        assert _rel(got.cpu(), want) <= TOLERANCES["fp32"]
    else:
        assert _bf16_close(got.cpu().float(), want.float())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(QA_TC_CASES))
def test_qa_tensor_core_tile_ragged_edges_match_plain(cuda_device, name):
    """``qa_tc_kernel`` (dequant-on-load, or folded) against the plain
    version on the same arguments at the fp32 gate (TOLERANCES["fp32"] of
    its max abs), one launch a call, and ``quantized_matmul_qa`` on the
    card returning exactly that result rounded to B's dtype.  (The kernel
    sums k on the tensor cores, in another order than the CPU's plain
    version, so a result near 0 can round to another bf16 value than the
    CPU's: the one-ulp comparison of test_qa_gemm_kernels_match_plain holds
    only by chance there.)"""
    bits, gran, strategy, bs, bdtype, m, n, k = QA_TC_CASES[name]
    rng = np.random.default_rng(m + n + k + bits)
    aq = quantize(_t(rng, cuda_device, m, k), _qcfg(
        bits=bits, gran=gran, strategy=strategy, block_size=bs))
    b = _t(rng, cuda_device, k, n).to(bdtype)
    folded, args, kw = qg.qa_arguments(aq, b)
    assert folded == name.startswith("folded")
    assert qg.qa_gemm_body(args[1].dtype) == "tensor_core"
    kernel, plain = ((qg.qa_folded_gemm, qg.qa_folded_gemm_plain) if folded
                     else (qg.qa_gemm, qg.qa_gemm_plain))
    n0 = kernel.launches
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref = plain(*args, **kw)
    assert out.dtype == F32 and out.shape == (m, n)
    assert _rel(out, ref) <= TOLERANCES["fp32"]
    got = qg.quantized_matmul_qa(aq, b)
    assert got.dtype == bdtype and torch.equal(got, out.to(bdtype))


COMP_GEMM_CASES = {
    # name: (block, strategy, M, N, K, with c)
    "b128_asym": (128, "asymmetric", 300, 200, 512, False),
    "b128_centered_c": (128, "centered", 70, 130, 256, True),
    "b512_asym_c": (512, "asymmetric", 130, 70, 1024, True),
    # The s8 tensor-core tile: K one 128-block with ragged M and N; M = 1;
    # 128-row tiles (at least two CTAs for each SM) over an odd N with c=.
    "b128_one_block_ragged": (128, "asymmetric", 37, 70, 128, False),
    "b384_m1_c": (384, "centered", 1, 130, 768, True),
    "b128_wide_odd_n_c": (128, "asymmetric", 2200, 2001, 256, True),
    "small_b32": (32, "centered", 300, 200, 256, False),
    "small_b64_asym_c": (64, "asymmetric", 70, 130, 512, True),
    "small_b16_ragged_k": (16, "centered", 37, 70, 208, False),
    # comp_tc_kernel's m16n8k16 blocks (48, 80) unsplit, the scalar tile's
    # blocks (8, 24) and gemm_bench's M = 128 at K = 8192 (64-row tiles, K
    # split in two).
    "small_b48_k16": (48, "centered", 300, 200, 480, False),
    "small_b80_k16_asym_c": (80, "asymmetric", 70, 130, 640, True),
    # K split where a unit of lcm(bs, 128) k spans several steps of 128
    # (48: 3, 80: 5, 96: 3), so ranges start mid-K on a block's start and
    # end on a block's end: 10 units in 5 ranges, 6 in 3, and 11 in 5
    # (ranges of 2 and 3 units).
    "small_b48_split_asym_c": (48, "asymmetric", 64, 256, 3840, True),
    "small_b80_split_asym_c": (80, "asymmetric", 64, 256, 3840, True),
    "small_b96_split_uneven": (96, "centered", 64, 256, 4224, False),
    "small_b8_scalar": (8, "centered", 37, 70, 136, False),
    "small_b24_scalar_asym_c": (24, "asymmetric", 70, 130, 240, True),
    "small_b64_m128_k8192": (64, "centered", 128, 1024, 8192, False),
}


def _kernels_run(fn):
    """(fn's result, the names of the CUDA kernels it launched)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(COMP_GEMM_CASES))
def test_comp_gemm_kernels_match_plain(cuda_device, name):
    """The compensated kernel bit for bit (exact integer compensation, the
    same fused multiply-add per block), the small-block one within
    TOLERANCES["fp32"] (fp32 products summed in another order)."""
    bs, strategy, m, n, k, with_c = COMP_GEMM_CASES[name]
    rng = np.random.default_rng(m + n + k + bs)
    cfg = _qcfg(gran="block", strategy=strategy, block_size=bs)
    aq = quantize(_t(rng, cuda_device, m, k) + 0.3, cfg)
    bq = quantize(_t(rng, cuda_device, n, k) - 0.2, cfg)
    c = _t(rng, cuda_device, m, n) if with_c else None
    small, args, kw = qg.comp_arguments(aq, bq, c)
    assert small == name.startswith("small")
    if "split" in name:
        sms = torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        assert qg.comp_small_tile(m, n, k, bs, sms)[1] > 1
    kernel, plain = ((qg.comp_small_gemm, qg.comp_small_gemm_plain) if small
                     else (qg.comp_gemm, qg.comp_gemm_plain))
    n0 = (qg.comp_gemm.launches, qg.comp_small_gemm.launches)
    out, ran = _kernels_run(lambda: kernel(*args, **kw))
    assert (qg.comp_gemm.launches, qg.comp_small_gemm.launches) == (
        n0[0] + (not small), n0[1] + small)
    # the route comp_small_body names (comp_gemm: the s8 tile), and nothing
    # else
    tc = not small or qg.comp_small_body(bs) == "tensor_core"
    assert tc == (bs % 16 == 0)
    assert [any(k in name for name in ran) for k in (
        "comp_tc_kernel<", "comp_small_kernel(")] == [tc, not tc]
    ref = plain(*args, **kw)
    assert out.dtype == F32 and out.shape == (m, n)
    if small:
        assert _rel(out, ref) <= TOLERANCES["fp32"]
    else:
        assert torch.equal(out, ref)
    cpu = qg.compensated_matmul(aq.to("cpu"), bq.to("cpu"),
                                c=None if c is None else c.cpu())
    assert _rel(qg.compensated_matmul(aq, bq, c=c).cpu(), cpu) <= (
        TOLERANCES["fp32"])


@pytest.mark.cuda
def test_comp_small_gemm_routes_as_comp_small_body_says(cuda_device):
    """The C interface's routing (``mfa_comp_small_body``: the k of the s8
    products, 0 for the scalar tile) agrees with ``comp_small_body``."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build

    body = _build.kernel_function("mfa_comp_small_body", [ctypes.c_int])
    for bs in (8, 16, 24, 32, 40, 48, 64, 80, 96, 192):
        tc = qg.comp_small_body(bs) == "tensor_core"
        assert body(bs) == (0 if not tc else (32 if bs % 32 == 0 else 16))


@pytest.mark.cuda
def test_dyn_gemm_launches_the_s8_tile_once(cuda_device):
    """One launch of ``dyn_tc_kernel`` per call, split K included (the
    cluster sums the splits: no second kernel)."""
    w = quantize(torch.randn(256, 4096, device=cuda_device), qparams.INT8_ROW)
    qa, sa, rs = qg.quantize_rows(torch.randn(8, 4096, device=cuda_device))
    sb, zb = qg.weight_scales(w)
    assert qg.dyn_tile(8, 256, 4096, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)[1] > 1
    _, ran = _kernels_run(
        lambda: qg.dyn_gemm(qa, w.data, sa, rs, sb, zb, bits=8))
    assert len(ran) == 1 and "dyn_tc_kernel<" in ran.pop()


@pytest.mark.cuda
def test_qa_and_comp_kernels_reject_what_they_do_not_take(cuda_device):
    aq = quantize(torch.ones(8, 256, device=cuda_device), ROW8)
    b = torch.ones(256, 16, device=cuda_device, dtype=BF16)
    scale = aq.scale.reshape(-1).float()
    with pytest.raises(TypeError):  # the folded kernel takes a bf16 B
        qg.qa_folded_gemm(aq.data, b.float(), scale, bits=8)
    with pytest.raises(TypeError):  # an int8 payload declared int4
        qg.qa_folded_gemm(aq.data, b, scale, bits=4)
    with pytest.raises(TypeError):  # ROW scales of the wrong length
        qg.qa_gemm(aq.data, b, scale[:4], scale[:4], bits=8, scales=1)
    with pytest.raises(ValueError):  # not a scale kind of the kernel
        qg.qa_gemm(aq.data, b, scale, scale, bits=8, scales=3)
    with pytest.raises(ValueError):  # a CPU B for the kernel
        qg.qa_gemm(aq.data, b.cpu(), scale, scale, bits=8, scales=1)
    cfg = _qcfg(gran="block", strategy="centered", block_size=128)
    a8, b8 = (quantize(torch.randn(r, 256, device=cuda_device), cfg)
              for r in (8, 16))
    _, args, kw = qg.comp_arguments(a8, b8)
    with pytest.raises(ValueError):  # blocks of 64 are the small kernel's
        qg.comp_gemm(*args, bs=64)
    with pytest.raises(TypeError):  # float zero points
        qg.comp_gemm(*args[:3], args[3].float(), *args[4:], **kw)
    buf = torch.zeros(8 * 256 + 8, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):  # a payload 8 bytes off 16
        qg.comp_gemm(buf[8:].view(8, 256), *args[1:], **kw)


# --------------------------------------------------------------------------
# The dispatch layer: the static-max forward, stored GEMM plans,
# MultiHeadAttention
# --------------------------------------------------------------------------

STATIC_MASKS = {
    "full": (masking.FULL, None),
    "causal": (masking.CAUSAL, None),
    "window": (masking.sliding_window(48), None),
    "segments": (masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
                 "segments"),
}


def _static_row_max(q, k, mask, rr, mode, scale, hq, hkv,
                    interleaved=False):
    """The base-2 subtrahends flash_attention_forward hands the kernel:
    "estimate"'s, or a caller's bound (the true row max + 5, natural
    units) times log2(e); q head h reads kv head h // (hq // hkv), or
    h % hkv where ``interleaved``."""
    group = hq // hkv
    heads = [h % hkv if interleaved else h // group for h in range(hq)]
    if mode == "estimate":
        sparse = mask.kind == masking.MaskKind.SPARSE_RANGES
        return estimate_row_max_scaled(
            (q.float() * (scale * LOG2E)).to(q.dtype), k, mask,
            row_ranges=rr if sparse else None,
            kv_head_of=lambda h: heads[h], seq_q=q.shape[2],
            seq_kv=k.shape[2]).contiguous()
    kx = k.float()[:, heads]
    s = scale * (q.float() @ kx.transpose(-1, -2))
    return ((s.amax(-1) + 5.0) * LOG2E).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["estimate", "caller"])
@pytest.mark.parametrize("mask_name", sorted(STATIC_MASKS))
@pytest.mark.parametrize("d", [32, 64, 128, 256, 288, 640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_max_kernel_matches_plain(cuda_device, dtype, d, mask_name,
                                         mode):
    mask, ranges = STATIC_MASKS[mask_name]
    ranges = _segments_with_empty_row() if ranges == "segments" else None
    (q, k, v), _, _, rr = _flash_case(cuda_device, dtype, 1, 4, 2, 130, 130,
                                      d, mask, ranges, seed=d)
    scale = d ** -0.5
    mx = _static_row_max(q, k, mask, rr, mode, scale, 4, 2)
    n = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, rr, scale=scale, row_max=mx)
    torch.cuda.synchronize()
    assert flash_fwd.launches == n + 1
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, scale=scale,
                                                 row_max=mx)
    assert _rel(o, o_ref) <= _tol(dtype)
    assert _rel(lse, l_ref) <= (TOLERANCES["fp32"] if dtype == torch.float32
                                else TOLERANCES["lse"])
    o_run, l_run = flash_fwd(q, k, v, rr, scale=scale)
    assert _rel(o, o_run) <= _tol(dtype)
    assert _rel(lse, l_run) <= (TOLERANCES["fp32"] if dtype == torch.float32
                                else TOLERANCES["lse"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_max_entry_point_launches_the_kernel(cuda_device, dtype):
    (q, k, v), _, _, rr = _flash_case(cuda_device, dtype, 2, 8, 2, 200, 200,
                                      64, masking.CAUSAL)
    mx = _static_row_max(q, k, masking.CAUSAL, rr, "estimate", 0.125, 8, 2)
    n = flash_fwd.launches
    o, lse = flash_attention_forward(q, k, v, mask=masking.CAUSAL,
                                     row_max="estimate")
    torch.cuda.synchronize()
    assert flash_fwd.launches == n + 1
    o2, l2 = flash_fwd(q, k, v, rr, scale=0.125, row_max=mx)
    assert torch.equal(o, o2) and torch.equal(lse, l2)
    bound = _static_row_max(q, k, masking.CAUSAL, rr, "caller", 0.125, 8,
                            2) / LOG2E
    o3, _ = flash_attention_forward(q, k, v, mask=masking.CAUSAL,
                                    row_max=bound)
    assert _rel(o3, flash_attention_forward_plain(
        q, k, v, rr, scale=0.125, row_max=bound * LOG2E)[0]) <= _tol(dtype)
    with pytest.raises(ValueError, match="bias"):
        flash_fwd(q, k, v, rr, scale=0.125, row_max=mx,
                  bias=torch.zeros(1, 1, 200, 200, device=cuda_device))
    with pytest.raises(ValueError):  # M must be fp32 [B, Hq, Sq]
        flash_fwd(q, k, v, rr, scale=0.125, row_max=mx[..., :10])


@pytest.mark.cuda
def test_static_max_body_is_the_forward_body(cuda_device):
    fn = _build.kernel_function("mfa_flash_static_max_body",
                                [ctypes.c_int] * 2)
    for dtype, code in DTYPE_CODES.items():
        for d in (32, 64, 128, 256, 288, 640, 1024):
            assert fn(code, d) == {"tensor_core": 1, "split_d": 2}.get(
                fwd_body(dtype, d), 0)
    assert fn(DTYPE_CODES[torch.bfloat16], 288) == 1  # flash_fwd_wide_kernel
    assert fn(DTYPE_CODES[torch.float32], 288) == 0
    assert fn(DTYPE_CODES[torch.float32], 640) == 2  # split_d_fwd_kernel
    assert fn(1, 40) == -1


@pytest.fixture
def stored_plans(tmp_path, monkeypatch):
    """A shared tuner over an empty store in ``tmp_path``."""
    tuner = tuning.AttentionTuner(
        store=tuning.CalibrationStore(str(tmp_path)))
    monkeypatch.setattr(tuning.AttentionTuner, "_instance", tuner)
    return tuner


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,n,k,plan", [
    (8, 1024, 4096, (16, 128, 1024)), (8, 256, 1024, (16, 128, 128)),
    (256, 1024, 1024, (64, 128, 256)), (300, 4096, 1024, (128, 128, 1024)),
])
def test_dyn_gemm_under_a_stored_plan_is_bit_for_bit(cuda_device,
                                                     stored_plans, m, n, k,
                                                     plan, bits):
    tuner = stored_plans
    tuner._store_entry(tuner._gemm_key(m, n, k, bits, "dynamic"),
                       {"gemm_blocks": list(plan), "tflops": 1.0})
    assert tuner.recommend_gemm(m, n, k, bits) == plan
    tile = tuning.tile_of(plan, k, "dynamic")
    assert qg.dyn_tile(m, n, k, 132, bits) == tile
    cfg = _qcfg(bits=bits, gran="row")
    w = quantize(torch.randn(n, k, device=cuda_device), cfg)
    a = torch.randn(m, k, device=cuda_device).to(BF16)
    qa_, sa, rs = qg.quantize_rows(a)
    sb, zb = qg.weight_scales(w)
    launches = qg.dyn_gemm.launches
    out = qg.dynamic_quantized_matmul(a, w)
    torch.cuda.synchronize()
    assert qg.dyn_gemm.launches == launches + 1
    ref = qg.dyn_gemm_plain(qa_, w.data, sa, rs, sb, zb, bits=bits)
    assert torch.equal(out, ref)
    shape_tile = qg.dyn_shape_tile(m, n, k, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    assert torch.equal(qg.dyn_gemm(qa_, w.data, sa, rs, sb, zb, bits=bits,
                                   tile=shape_tile), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("gran", ["row", "block"])
@pytest.mark.parametrize("m,n,k,plan", [
    (128, 1024, 2048, (64, 128, 256)), (128, 1024, 2048, (128, 128, 1024)),
    (4, 384, 8192, (64, 128, 512)),
])
def test_weight_only_gemm_under_a_stored_plan_matches_plain(
        cuda_device, stored_plans, m, n, k, plan, gran):
    tuner = stored_plans
    tuner._store_entry(tuner._gemm_key(m, n, k, 8, "weight_only"),
                       {"gemm_blocks": list(plan), "tflops": 1.0})
    tile = tuning.tile_of(plan, k, "weight_only")
    assert qg.wo_tile(m, n, k, 132, 8) == tile
    cfg = (_qcfg(gran="row") if gran == "row" else
           _qcfg(gran="block", block_size=256))
    w = quantize(torch.randn(n, k, device=cuda_device), cfg)
    a = torch.randn(m, k, device=cuda_device).to(BF16)
    folded, args, kw = qg.wo_arguments(a, w)
    gemm, plain = ((qg.wo_folded_gemm, qg.wo_folded_gemm_plain) if folded
                   else (qg.wo_gemm, qg.wo_gemm_plain))
    launches = gemm.launches
    out = qg.quantized_matmul(a, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert gemm.launches == launches + 1
    ref = plain(*args, **kw)
    assert _rel(out, ref) <= TOLERANCES["fp32"]


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,interleaved,mask", [
    (8, 2, False, masking.CAUSAL), (8, 2, True, masking.CAUSAL),
    (8, 1, False, masking.sliding_window(64)), (4, 4, False, masking.FULL),
])
def test_multi_head_attention_launches_and_equals_direct_calls(
        cuda_device, hq, hkv, interleaved, mask):
    (q, k, v), do, _, _ = _flash_case(cuda_device, BF16, 2, hq, hkv, 200,
                                      200, 64, mask)
    mha = MultiHeadAttention(AttentionDescriptor(
        head_dim=64, num_q_heads=hq, num_kv_heads=hkv, mask=mask,
        interleaved_kv=interleaved))
    kw = dict(mask=mask, interleaved_kv=interleaved)

    def counts():
        return (flash_fwd.launches, flash_dq.launches, flash_dkv.launches)

    n = counts()
    o, lse = mha.forward(q, k, v)
    torch.cuda.synchronize()
    assert counts() == (n[0] + 1, n[1], n[2])
    o2, l2 = flash_attention_forward(q, k, v, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, l2)

    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    n = counts()
    grads = torch.autograd.grad(mha(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert counts() == (n[0] + 1, n[1] + 1, n[2] + 1)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))

    n = counts()
    got = mha.backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert counts() == (n[0], n[1] + 1, n[2] + 1)
    want = fbwd.flash_attention_backward(q, k, v, o, lse, do, **kw)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_measure_held_leaves_out_the_host_launches(cuda_device):
    from metal_flash_attention_plus_tpu_torch.utils import profiling

    x = torch.randn(1024, device=cuda_device)
    held = profiling.measure_held(torch.add, x, x, iters=50)
    fenced = profiling.measure(torch.add, x, x, iters=50)
    assert 0 < held < fenced


@pytest.mark.cuda
def test_measure_held_raises_where_the_call_waits_for_the_card(cuda_device):
    from metal_flash_attention_plus_tpu_torch.utils import profiling

    x = torch.randn(1024, device=cuda_device)
    with pytest.raises(RuntimeError, match="did not enqueue"):
        profiling.measure_held(lambda t: t.sum().item(), x, iters=4,
                               spin_cycles=1000, tries=2)


@pytest.mark.cuda
def test_measure_device_without_profiled_kernels_uses_held_events(
        cuda_device, monkeypatch):
    from metal_flash_attention_plus_tpu_torch.utils import profiling

    a = torch.randn(2048, 2048, device=cuda_device).to(BF16)
    monkeypatch.setattr(profiling, "kernel_table", lambda prof: (0.0, 0, []))
    sec = profiling.measure_device(torch.matmul, a, a, iters=10)
    held = profiling.measure_held(torch.matmul, a, a, iters=10)
    assert 0 < sec and 0.5 < sec / held < 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,m,n,k", [
    ("dynamic", 8, 1024, 4096), ("dynamic", 256, 1024, 1024),
    ("weight_only", 128, 1024, 2048),
])
def test_calibrate_gemm_stores_a_swept_plan(cuda_device, stored_plans, mode,
                                           m, n, k):
    tuner = stored_plans
    plan = tuner.calibrate_gemm(m, n, k, mode=mode, iters=5)
    assert plan in tuning._default_candidates(m, n, k, mode)
    assert tuner.recommend_gemm(m, n, k, mode=mode) == plan
    entry = tuner._store.load(tuning.device_kind())[
        tuner._gemm_key(m, n, k, 8, mode)]
    assert entry["gemm_blocks"] == list(plan) and entry["tflops"] > 0

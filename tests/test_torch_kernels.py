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
D = 80 and 288, Hq = 16 over Hkv = 1) and of the flash kernels (D = 80 and
288) take their kernels' tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu_torch.attention import masking
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
    flash_attention_forward_plain,
    flash_fwd,
    row_ranges_tensor,
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
    [(4, 2, 32, 16), (16, 4, 64, 256), (8, 2, 128, 64), (2, 2, 64, 48)],
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
    q = torch.zeros(1, 2, 40, device=cuda_device)  # not a multiple of 16
    pool = torch.zeros(1, 2, 32, 40, device=cuda_device)
    table = torch.zeros(1, 1, dtype=torch.int32, device=cuda_device)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, table, lengths)


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
@pytest.mark.parametrize("d", [32, 48, 64, 80, 128, 256, 288])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_every_head_dim(cuda_device, d, dtype):
    """Each built width, and 48 (run at 64, zero-padded)."""
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


@pytest.mark.cuda
def test_backward_kernels_route_as_the_python_bodies_say(cuda_device):
    """The C launchers' routing (mfa::fwd_tc, dq_tc, dkv_tc, as the
    library reports it) agrees with fwd_body / dq_body / dkv_body at every
    built width: bf16 up to 256 on the tensor cores, fp32 and D = 288 on
    the scalar bodies."""
    import ctypes

    from metal_flash_attention_plus_tpu_torch import _build
    from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
        DTYPE_CODES,
        fwd_body,
    )

    bodies = _build.kernel_function("mfa_flash_tc_bodies",
                                    [ctypes.c_int, ctypes.c_int])
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128, 256, 288):
            bits = bodies(DTYPE_CODES[dtype], d)
            want = [f(dtype, d) == "tensor_core" for f in (
                fwd_body, fbwd.dq_body, fbwd.dkv_body)]
            assert [bool(bits >> i & 1) for i in range(3)] == want, (dtype, d)
            assert want == [dtype == torch.bfloat16 and d <= 256] * 3
    assert bodies(DTYPE_CODES[torch.bfloat16], 48) == -1


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
def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    (q, k, v), do, _, rr = _flash_case(cuda_device, torch.float32, 1, 2, 1,
                                       64, 64, 64, masking.CAUSAL)
    with pytest.raises(TypeError):
        flash_fwd(q.half(), k.half(), v.half(), rr, scale=0.125)
    with pytest.raises(ValueError):  # head dim 40 has no kernel
        flash_fwd(q[..., :40].contiguous(), k[..., :40].contiguous(),
                  v[..., :40].contiguous(), rr, scale=0.125)
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
                                         (8, 2, 128, 64)])
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
        "tensor_core" if dtype == BF16 else "fp32_fma")
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
    for d in (32, 64, 128, 256):
        for width in range(4097):
            want = fbwd.fullint_body(d, width) == "tensor_core"
            assert body(d, width) == int(want), (d, width)
            assert want == (width % 32 == 0)
    assert body(48, 0) == -1 and body(64, -1) == -1


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("strategy", list(qparams.QuantStrategy),
                         ids=lambda s: s.value)
@pytest.mark.parametrize("shape", [(1000, 64), (37, 200)],
                         ids=["1000x64", "37x200"])
def test_row_kernel_matches_plain_bit_for_bit(cuda_device, shape, strategy,
                                              bits, dtype):
    x = (torch.randn(shape, device=cuda_device) * 3 + 0.7).to(dtype)
    n = rq.rtq_rows.launches
    got = rq.rtq_rows(x, strategy, bits, True)
    torch.cuda.synchronize()
    assert rq.rtq_rows.launches == n + 1
    want = rq.rtq_rows_plain(x, strategy, bits, True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("strategy", list(qparams.QuantStrategy),
                         ids=lambda s: s.value)
@pytest.mark.parametrize("shape,bs", [((512, 256), 64), ((300, 384), 128)],
                         ids=["512x256-64", "300x384-128"])
def test_block_kernel_matches_plain_bit_for_bit(cuda_device, shape, bs,
                                                strategy, bits, dtype):
    x = (torch.randn(shape, device=cuda_device) * 3 + 0.7).to(dtype)
    n = rq.rtq_blocks.launches
    got = rq.rtq_blocks(x, bs, strategy, bits, True)
    torch.cuda.synchronize()
    assert rq.rtq_blocks.launches == n + 1
    want = rq.rtq_blocks_plain(x, bs, strategy, bits, True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


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
@pytest.mark.parametrize("d,vtz", [(288, 32), (80, 16)])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_latent_paged_kernels_match_plain(cuda_device, kernel, d, vtz,
                                          pool_kind):
    """Hq = 16 over Hkv = 1: the decode splits the group over CTAs at
    D = 288; D = 80 runs the kernels' run-time head dim."""
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
}


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
    kernel, plain = ((qg.comp_small_gemm, qg.comp_small_gemm_plain) if small
                     else (qg.comp_gemm, qg.comp_gemm_plain))
    n0 = (qg.comp_gemm.launches, qg.comp_small_gemm.launches)
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert (qg.comp_gemm.launches, qg.comp_small_gemm.launches) == (
        n0[0] + (not small), n0[1] + small)
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

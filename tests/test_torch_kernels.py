"""The port's CUDA kernels held to their plain PyTorch versions, on the card.

Every test here needs an NVIDIA CUDA device and skips without one.  The
file imports nothing of JAX, so on a machine with the card and no JAX it
runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: fp32 inputs are held to TOLERANCES["fp32"]; bf16 inputs to
2e-2 max abs error — the kernel and the plain version round the same
values to bf16 at the same places (q after scaling, P before P·V), so
what is left is the order of fp32 accumulation and the one-pass vs online
softmax rescaling of P before its bf16 rounding.
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
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
    q = torch.zeros(1, 2, 48, device=cuda_device)
    pool = torch.zeros(1, 2, 32, 48, device=cuda_device)
    table = torch.zeros(1, 1, dtype=torch.int32, device=cuda_device)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, table, lengths)

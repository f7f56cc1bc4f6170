"""Blockwise zero-point compensation: the golden math.

The twin of the JAX package's ``quant/compensation.py``; the reference's
compensation formula for a blockwise-quantized GEMM
(``BlockwiseCompensationTest.swift:10-17``):

    acc[m,n] = Σ_b s_a[b]·s_b[b]·( Sqq[b,m,n]
                                   − z_b[b]·SqA[b,m]
                                   − z_a[b]·SqB[b,n]
                                   + cnt[b]·z_a[b]·z_b[b] )

b ranges over K blocks, Sqq is the block's integer product, SqA / SqB the
per-block row sums of the payloads, cnt the block size: the expansion of
Σ (qa − z_a)(qb − z_b)·s_a·s_b.  These are the tests' oracles; the
compensated kernel (``ops/quantized_gemm.py::comp_gemm``) is held to them.
"""

from __future__ import annotations

import torch

from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    exact_fp32,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    dequantize,
    unpack_int4,
)


def _payload_int64(t: QuantizedTensor) -> torch.Tensor:
    q = unpack_int4(t.data) if t.bits == 4 else t.data
    return q.reshape(t.shape).long()


def compensated_gemm_reference(a: QuantizedTensor,
                               b_t: QuantizedTensor) -> torch.Tensor:
    """Golden blockwise-compensated GEMM: A [M, K] × Bᵀ [N, K] → fp32
    [M, N], both BLOCK-quantized along K with one block size; int8 or
    int4.  The integer terms are exact (int64 on the CPU, float64 on a
    card, exact below 2⁵³) and the sum over blocks runs in float64,
    rounded to fp32 once."""
    qa, qb = _payload_int64(a), _payload_int64(b_t)
    m, k = qa.shape
    n, k2 = qb.shape
    bs = a.config.block_size
    if k != k2 or bs != b_t.config.block_size:
        raise ValueError("operands must share K and the block size")
    nb = k // bs
    sa = a.scale.reshape(nb).double()
    sb = b_t.scale.reshape(nb).double()
    za = a.zero_point.reshape(nb).long()
    zb = b_t.zero_point.reshape(nb).long()
    qa_b, qb_b = qa.reshape(m, nb, bs), qb.reshape(n, nb, bs)
    if qa.device.type == "cpu":
        sqq = torch.einsum("mbk,nbk->bmn", qa_b, qb_b)
    else:  # no integer matmul on CUDA
        sqq = torch.einsum("mbk,nbk->bmn", qa_b.double(),
                           qb_b.double()).long()
    sq_a, sq_b = qa_b.sum(-1), qb_b.sum(-1)  # [M, nb], [N, nb]
    comp = (sqq - zb[:, None, None] * sq_a.t()[:, :, None]
            - za[:, None, None] * sq_b.t()[:, None, :]
            + (bs * za * zb)[:, None, None])
    return torch.einsum("b,bmn->mn", sa * sb, comp.double()).float()


def dequantized_gemm_reference(a: QuantizedTensor,
                               b_t: QuantizedTensor) -> torch.Tensor:
    """Dequantize, then an exact fp32 product (TF32 off): agrees with the
    compensated path to fp32 rounding."""
    with exact_fp32():
        return dequantize(a) @ dequantize(b_t).t()

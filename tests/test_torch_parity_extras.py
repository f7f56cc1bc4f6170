"""Strided views: the mirror of tests/test_parity_extras.py::
TestStridedViews.

Permuted and sliced (non-contiguous) Q/K/V views give the port's
``flash_attention`` exactly what the contiguous call gives (the entry
points make their operands contiguous before any kernel or plain
version sees them), forward and gradients, and the flash path on a view
agrees with the dense reference as the JAX test holds it.  The card's
twin is ``tests/test_torch_kernels.py::test_flash_strided_views_match_
contiguous``.
"""

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
)


def _qkv(seed, h, s):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, s, 64)).astype(
        np.float32)) for _ in range(3)]


def test_transposed_and_sliced_inputs_match_contiguous():
    q, k, v = _qkv(0, 4, 128)
    # Views: Q permuted out of an [S, B, H, D] parent, K sliced out of an
    # over-allocated one.
    q_view = q.permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
    k_view = torch.cat([k, torch.ones(1, 4, 32, 64)], dim=2)[:, :, :128]
    assert not q_view.is_contiguous() and not k_view.is_contiguous()
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        q.shape).astype(np.float32))

    def run(q_, k_, v_):
        leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
        o = flash_attention(*leaves, mask=CAUSAL)
        return (o, *torch.autograd.grad(o, leaves, do))

    for a, b in zip(run(q, k, v), run(q_view, k_view, v)):
        assert torch.equal(a, b)


def test_reference_on_views():
    q, k, v = _qkv(1, 2, 96)
    o, _ = reference_attention(q, k, v, mask=CAUSAL)
    o2 = flash_attention(q.transpose(1, 2).transpose(1, 2), k, v,
                         mask=CAUSAL)
    assert float((o2 - o).abs().max()) <= 2e-5

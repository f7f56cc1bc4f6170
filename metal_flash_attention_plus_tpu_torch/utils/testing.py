"""Test utilities: the tolerance ladder and deterministic data generators.

The port of the JAX package's ``utils/testing.py``:

  FP32 pipeline      max abs err 2e-5   (O, L, D, dQ, dK, dV)
  mixed bf16         max abs err 5e-2   (O/dV/dK/dQ), L 7e-3, D 1e-1
  quantized          relative err: FP16 < 0.05, INT8 < 0.25

:func:`random_qkv` draws from a ``torch.Generator``, so its numbers differ
from the JAX package's ``jax.random`` draws; to feed both packages the
same inputs, draw with numpy (:func:`lcg_data`, or ``np.random``) and
convert.  :func:`lcg_data` gives the JAX package's bits exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)

TOL_FP32 = 2e-5
TOL_MIXED = 5e-2
TOL_MIXED_L = 7e-3
TOL_MIXED_D = 1e-1
RELTOL_FP16 = 0.05
RELTOL_INT8 = 0.25


def random_qkv(generator: torch.Generator, batch, num_q_heads, num_kv_heads,
               seq_q, seq_kv, head_dim, dtype=torch.float32,
               device: DeviceLike = None):
    """Standard-normal Q [B, Hq, Sq, D] and K, V [B, Hkv, Skv, D], drawn in
    fp32 from ``generator`` (a CPU generator) in that order, then cast to
    ``dtype`` on ``device`` (``None``: the card)."""
    dev = resolve_device(device)

    def draw(h, s):
        x = torch.randn((batch, h, s, head_dim), generator=generator,
                        dtype=torch.float32)
        return x.to(device=dev, dtype=dtype)

    return (draw(num_q_heads, seq_q), draw(num_kv_heads, seq_kv),
            draw(num_kv_heads, seq_kv))


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def max_abs_err(a, b) -> float:
    """Max |a − b| in fp32 (tensors or arrays)."""
    return float((_f32(a) - _f32(b)).abs().max())


def rel_err(a, b) -> float:
    """‖a − b‖₂ / (‖b‖₂ + 1e-12) in fp32."""
    a, b = _f32(a), _f32(b)
    return float(torch.linalg.norm((a - b).ravel())
                 / (torch.linalg.norm(b.ravel()) + 1e-12))


def assert_close(actual, expected, tol, what=""):
    err = max_abs_err(actual, expected)
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.1e}"


def assert_rel_close(actual, expected, tol, what=""):
    err = rel_err(actual, expected)
    assert err <= tol, f"{what}: rel err {err:.3e} > {tol:.2f}"


def lcg_data(shape, seed=42, lo=-1.0, hi=1.0):
    """Deterministic LCG data (the JAX package's generator, bit for bit):
    float32 numpy."""
    n = int(np.prod(shape))
    state = np.uint64(seed)
    out = np.empty(n, dtype=np.float64)
    a = np.uint64(6364136223846793005)
    c = np.uint64(1442695040888963407)
    with np.errstate(over="ignore"):  # the LCG wraps modulo 2**64
        for i in range(n):
            state = a * state + c
            out[i] = (state >> np.uint64(33)) / float(1 << 31)
    return (lo + (hi - lo) * out).reshape(shape).astype(np.float32)

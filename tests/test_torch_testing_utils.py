"""Port parity for ``utils/testing.py``.

``lcg_data`` gives the JAX package's bits exactly; the tolerance ladder is
the same numbers; ``max_abs_err``, ``rel_err`` and the two asserts agree
with the JAX helpers on the same arrays (tensors on the port's side);
``random_qkv`` draws from an explicit ``torch.Generator`` (its numbers
differ from ``jax.random``'s, so parity inputs come from numpy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.utils import testing as jt
from metal_flash_attention_plus_tpu_torch.utils import testing as tt


@pytest.mark.parametrize("shape,seed,lo,hi", [
    ((7,), 42, -1.0, 1.0), ((3, 5, 4), 7, 0.0, 2.0), ((1, 2, 16, 8), 0,
                                                      -3.0, 3.0)])
def test_lcg_data_is_bit_for_bit(shape, seed, lo, hi):
    got = tt.lcg_data(shape, seed, lo, hi)
    want = jt.lcg_data(shape, seed, lo, hi)
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    assert got.tobytes() == want.tobytes()


def test_tolerance_ladder_equals_jax():
    for name in ("TOL_FP32", "TOL_MIXED", "TOL_MIXED_L", "TOL_MIXED_D",
                 "RELTOL_FP16", "RELTOL_INT8"):
        assert getattr(tt, name) == getattr(jt, name), name


def test_error_helpers_agree_with_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 33)).astype(np.float32)
    b = a + 1e-3 * rng.standard_normal((4, 33)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert tt.max_abs_err(ta, tb) == jt.max_abs_err(a, b)
    assert abs(tt.rel_err(ta, tb) - jt.rel_err(a, b)) <= 1e-7
    # bf16 tensors and numpy arrays are taken in fp32 alike.
    assert tt.max_abs_err(ta.bfloat16(), b) == jt.max_abs_err(
        jnp.asarray(a, jnp.bfloat16), b)
    tt.assert_close(ta, tb, 5e-3, "close")
    tt.assert_rel_close(ta, tb, 0.05, "rel close")
    with pytest.raises(AssertionError, match="max abs err"):
        tt.assert_close(ta, tb + 1.0, 5e-3, "far")
    with pytest.raises(AssertionError, match="rel err"):
        tt.assert_rel_close(ta, -tb, 0.05, "far")


def test_random_qkv_takes_an_explicit_generator():
    def draw():
        return tt.random_qkv(torch.Generator().manual_seed(3), 2, 4, 2, 16,
                             24, 32, dtype=torch.bfloat16, device="cpu")

    q, k, v = draw()
    assert q.shape == (2, 4, 16, 32) and k.shape == v.shape == (2, 2, 24, 32)
    assert q.dtype == k.dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip((q, k, v), draw()))
    assert not torch.equal(k, v)

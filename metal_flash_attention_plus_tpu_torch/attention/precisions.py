"""The accuracy ladder the port's tests enforce, and the matmul precision
rule.

A copy of the JAX package's ``TOLERANCES`` table and ``matmul_precision``
(``metal_flash_attention_plus_tpu/attention/precisions.py``), kept here so
that the port imports nothing of that package.  Its ``Precision.HIGHEST``
is a true fp32 product here: :func:`exact_fp32` turns TF32 off around it.
The JAX package's ``MFA_FORCE_FP32`` debugging switch is not carried over:
the rule follows the input dtype alone.
"""

from __future__ import annotations

import contextlib

import torch

TOLERANCES = {
    "fp32": 2e-5,  # max abs err, O and gradients
    "mixed": 5e-2,  # bf16 inputs
    "lse": 7e-3,
    "int8_rel": 0.25,  # relative; measured ~0.01
    "int4_rel": 0.25,  # held to the int8 gate; measured ~0.17
}


def matmul_precision(input_dtype: torch.dtype) -> str:
    """"highest" (exact fp32 products) for fp32 inputs, else "default"
    (the input dtype's own rate)."""
    if input_dtype == torch.float32:
        return "highest"
    return "default"


@contextlib.contextmanager
def exact_fp32():
    """fp32 matrix products in full fp32 (TF32 off) inside the block; the
    caller's setting is restored after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)

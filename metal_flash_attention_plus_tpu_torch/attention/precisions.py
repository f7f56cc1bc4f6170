"""The accuracy ladder the port's tests enforce.

A copy of the JAX package's ``TOLERANCES`` table
(``metal_flash_attention_plus_tpu/attention/precisions.py``), kept here so
that the port imports nothing of that package.
"""

TOLERANCES = {
    "fp32": 2e-5,  # max abs err, O and gradients
    "mixed": 5e-2,  # bf16 inputs
    "lse": 7e-3,
    "int8_rel": 0.25,  # relative; measured ~0.01
    "int4_rel": 0.25,  # held to the int8 gate; measured ~0.17
}

"""Measurement, debugging and test helpers for the port."""

from metal_flash_attention_plus_tpu_torch.utils.roofline import (  # noqa: F401
    attention_flops,
    attention_ginstrs,
)

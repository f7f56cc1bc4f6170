"""Device capability probing and graceful quantization degradation.

The twin of the JAX package's ``quant/capabilities.py`` (the analog of the
reference's ``GEMM/GEMMDeviceCapabilities.swift``): requested quantization
strategies are downgraded, with warnings, to what the device runs well,
never refused.  Axes:

- a fast int8 product path: int8 at over 1.5× the bf16 rate.  The H100's
  int8 tensor cores run 1,979 TOP/s against 989 TFLOP/s bf16, so
  ``has_int8_mxu`` holds there (the name is the JAX package's); without it
  the compensated int8 × int8 GEMM degrades to dequant-on-load;
- int4 is storage only: no int4 product path, always dequant-on-load;
- the compensated GEMM's K-blocks are multiples of 128.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
)


@dataclasses.dataclass(frozen=True)
class DeviceCapabilities:
    device_kind: str
    has_int8_mxu: bool  # int8 products at over 1.5× the bf16 rate
    bf16_tflops: float
    int8_tops: float
    hbm_gbps: float

    @property
    def supports_compensated_int8(self) -> bool:
        return self.has_int8_mxu


def probe_capabilities(device=None) -> DeviceCapabilities:
    from metal_flash_attention_plus_tpu_torch.utils.roofline import (
        detect_chip,
    )

    chip = detect_chip(device)
    return DeviceCapabilities(
        device_kind=chip.name,
        has_int8_mxu=chip.int8_tops > chip.bf16_tflops * 1.5,
        bf16_tflops=chip.bf16_tflops,
        int8_tops=chip.int8_tops,
        hbm_gbps=chip.hbm_gbps,
    )


@dataclasses.dataclass(frozen=True)
class StrategyResolution:
    """Adjusted config and the human-readable downgrades."""

    config: QuantConfig
    use_compensated_path: bool
    warnings: Tuple[str, ...]


def resolve_strategy(
    requested: QuantConfig,
    caps: Optional[DeviceCapabilities] = None,
    *,
    both_operands: bool = False,
) -> StrategyResolution:
    """Downgrade a requested quantization mode to what the device runs well:
    round block sizes up to the alignment the compensated kernel needs,
    fall back from it to dequant-on-load, never fail on a capability
    mismatch.  ``caps`` None: :func:`probe_capabilities`."""
    if caps is None:
        caps = probe_capabilities()
    cfg = requested
    warnings: List[str] = []
    use_comp = False

    if (
        both_operands
        and cfg.bits == 8
        and cfg.granularity == QuantGranularity.BLOCK
    ):
        bs = cfg.block_size or 0
        if not caps.has_int8_mxu:
            warnings.append(
                f"{caps.device_kind} has no fast int8 product path; "
                "compensated int8×int8 degrades to dequant-on-load"
            )
        elif bs % 128 != 0:
            new_bs = max(128, ((bs + 127) // 128) * 128)
            warnings.append(
                f"block_size {bs} not 128-aligned; compensated path needs "
                f"multiples of 128 — rounded to {new_bs}"
            )
            cfg = dataclasses.replace(cfg, block_size=new_bs)
            use_comp = True
        else:
            use_comp = True

    if cfg.bits == 4 and both_operands:
        warnings.append(
            "int4 has no product path; activations stay int8/float, "
            "weights dequantize on load"
        )

    return StrategyResolution(
        config=cfg, use_compensated_path=use_comp, warnings=tuple(warnings)
    )


def capability_report(caps: Optional[DeviceCapabilities] = None) -> str:
    """Human-readable report (``quantizationCapabilityReport`` analog)."""
    if caps is None:
        caps = probe_capabilities()
    comp = "yes (2× bf16)" if caps.has_int8_mxu else "no (runs at bf16 rate)"
    return (
        f"device: {caps.device_kind}\n"
        f"  bf16 peak:        {caps.bf16_tflops:.0f} TFLOP/s\n"
        f"  int8 peak:        {caps.int8_tops:.0f} TOP/s\n"
        f"  HBM bandwidth:    {caps.hbm_gbps:.0f} GB/s\n"
        f"  int8 product path: {comp}\n"
        f"  int4:             storage-only (dequant-on-load)\n"
        f"  compensated GEMM: block_size % 128 == 0 required\n"
    )

"""Op counts and the card's peaks, for roofline fractions.

The twin of the JAX package's ``utils/roofline.py``: the same attention op
model, after the reference's throughput math (``README.md:128-135,
197-213``):

  forward            (2D + 5)·N²   instructions per (head, batch)
  backward dQ        (3D + 5)·N²
  backward dK/dV     (4D + 5)·N²
  fwd+bwd combined   (9D + 15)·N²

with GINSTR = GFLOP / 2 (an FMA counts as one instruction).  The peaks are
the NVIDIA H100 SXM's (data sheet, dense, at its 700 W limit): 989 TFLOP/s
bf16, 1,979 TOP/s int8, 3,350 GB/s HBM3.  The port carries no other card's
spec: :func:`detect_chip` gives the H100's for every device, the CPU
included, as the JAX package falls back to a chip whose int8 rate is
above 1.5× its bf16 rate, so that ``resolve_strategy`` decides the same
way in both packages.
"""

from __future__ import annotations

import dataclasses


def attention_ginstrs(
    seq_q: int,
    seq_kv: int,
    head_dim: int,
    *,
    num_heads: int = 1,
    batch: int = 1,
    phase: str = "forward",
) -> float:
    """Instruction count (FMA = 1) for one attention dispatch."""
    n2 = float(seq_q) * float(seq_kv) * num_heads * batch
    d = head_dim
    per = {
        "forward": 2 * d + 5,
        "dq": 3 * d + 5,
        "dkv": 4 * d + 5,
        "backward": 7 * d + 10,  # dq + dkv
        "fwd_bwd": 9 * d + 15,
    }[phase]
    return per * n2


def attention_flops(seq_q, seq_kv, head_dim, **kw) -> float:
    """FLOPs = 2 × instructions (FMA = 2 FLOPs)."""
    return 2.0 * attention_ginstrs(seq_q, seq_kv, head_dim, **kw)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers for roofline fractions."""

    name: str
    bf16_tflops: float
    int8_tops: float
    hbm_gbps: float


H100_SXM = ChipSpec(name="nvidia-h100-sxm", bf16_tflops=989.0,
                    int8_tops=1979.0, hbm_gbps=3350.0)


def detect_chip(device=None) -> ChipSpec:
    """The spec of ``device``'s card (any device: the H100's; see the
    module docstring)."""
    del device
    return H100_SXM


def utilization(measured_tflops: float, chip: ChipSpec,
                dtype_bits: int = 16) -> float:
    peak = chip.int8_tops if dtype_bits <= 8 else chip.bf16_tflops
    return measured_tflops / peak

"""``QuantizedAttention``: the quantized attention facade.

The twin of the JAX package's ``attention/quantized.py``:

- :class:`QuantizedAttentionConfig`: per-operand bit widths, strategy,
  per-tensor or per-token scales, the Hadamard rotation; JSON
  round-trippable.
- :meth:`QuantizedAttention.quantize_kv`: K/V quantized per token at run
  time by the row kernel (:func:`ops.runtime_quantization.runtime_quantize`;
  per-tensor scales take ``quant.tensor.quantize``).
- :meth:`QuantizedAttention.__call__`: raw Q/K/V in, quantize then attend;
  :meth:`~QuantizedAttention.forward_quantized`: pre-quantized K/V;
  :meth:`~QuantizedAttention.forward_with_lse`: also L;
  :meth:`~QuantizedAttention.benchmark`: the bf16 / int8 / int4 sweep.

Q is not quantized by default (``quantize_q=True`` through ``**kw``).
Block sizes come from the :class:`AttentionTuner` as in the JAX facade
(kind "fwd_q"), unless given: the CUDA kernels choose their own tiles, but
an int8 P rounds over ``block_kv``-key spans, so the facade resolves the
table the JAX facade resolves.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import (
    FULL,
    MaskKind,
    MaskSpec,
)
from metal_flash_attention_plus_tpu_torch.attention.tuning import (
    AttentionTuner,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    BlockSizes,
)
from metal_flash_attention_plus_tpu_torch.ops.hadamard import (
    default_block,
    hadamard_transform,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    quantized_flash_attention,
    quantized_flash_attention_forward,
)
from metal_flash_attention_plus_tpu_torch.ops.runtime_quantization import (
    runtime_quantize,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import QuantizedTensor

CONFIG_VERSION = 1


@dataclasses.dataclass(frozen=True)
class QuantizedAttentionConfig:
    """Per-operand quantization spec.

    ``key_bits`` / ``value_bits``: 8, 4, or None (8).  Scales are per token
    (the KV-cache production choice) with ``strategy``, unless
    ``per_tensor`` (then SYMMETRIC).  ``hadamard``: quantize K/V in the
    Hadamard-rotated basis; Q is rotated on the fly and O un-rotated after
    the kernel, both exact, so only the integer rounding sees the rotation.
    """

    key_bits: Optional[int] = 8
    value_bits: Optional[int] = 8
    strategy: QuantStrategy = QuantStrategy.CENTERED
    per_tensor: bool = False
    hadamard: bool = False
    version: int = CONFIG_VERSION

    def kv_config(self, bits: int) -> QuantConfig:
        return QuantConfig(
            bits=bits,
            granularity=(QuantGranularity.TENSOR if self.per_tensor
                         else QuantGranularity.ROW),
            strategy=(QuantStrategy.SYMMETRIC if self.per_tensor
                      else self.strategy),
        )

    def hadamard_block(self, head_dim: int) -> Optional[int]:
        """Rotation block: the largest power of 2 dividing the head dim
        (≤ 1024), or None without ``hadamard``."""
        return default_block(head_dim) if self.hadamard else None

    def to_json(self) -> str:
        return json.dumps(dict(
            key_bits=self.key_bits,
            value_bits=self.value_bits,
            strategy=self.strategy.value,
            per_tensor=self.per_tensor,
            hadamard=self.hadamard,
            version=self.version,
        ))

    @staticmethod
    def from_json(s: str) -> "QuantizedAttentionConfig":
        d = json.loads(s)
        return QuantizedAttentionConfig(
            key_bits=d["key_bits"],
            value_bits=d["value_bits"],
            strategy=QuantStrategy(d["strategy"]),
            per_tensor=d["per_tensor"],
            hadamard=d.get("hadamard", False),
            version=d.get("version", CONFIG_VERSION),
        )


def _quantize_tokens(x: torch.Tensor, cfg: QuantConfig) -> QuantizedTensor:
    """Per-token quantization of [B, H, S, D] through the 2-D runtime
    quantizer (one row per token)."""
    b, h, s, d = x.shape
    flat = runtime_quantize(x.reshape(b * h * s, d), cfg)
    if cfg.granularity == QuantGranularity.ROW:
        scale = flat.scale.reshape(b, h, s, 1)
        zp = flat.zero_point.reshape(b, h, s, 1)
    else:  # TENSOR
        scale, zp = flat.scale, flat.zero_point
    return QuantizedTensor(
        data=flat.data.reshape(b, h, s, -1), scale=scale, zero_point=zp,
        sums=None, config=cfg, shape=(b, h, s, d), orig_dtype=x.dtype,
    )


@dataclasses.dataclass(frozen=True)
class QuantizedAttention:
    config: QuantizedAttentionConfig = QuantizedAttentionConfig()
    mask: MaskSpec = FULL
    scale: Optional[float] = None
    interleaved_kv: bool = False
    block_sizes: Optional[BlockSizes] = None

    def _blocks(self, seq_len: int, head_dim: int, bits: int) -> BlockSizes:
        if self.block_sizes is not None:
            return self.block_sizes
        return AttentionTuner.shared().recommend(
            "fwd_q", head_dim, seq_len, bits=bits,
            causal=self.mask.kind != MaskKind.NONE)

    def quantize_kv(self, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[QuantizedTensor, QuantizedTensor]:
        hb = self.config.hadamard_block(k.shape[-1])
        if hb:
            k = hadamard_transform(k, hb)
            v = hadamard_transform(v, hb)
        return (_quantize_tokens(k, self.config.kv_config(
                    self.config.key_bits or 8)),
                _quantize_tokens(v, self.config.kv_config(
                    self.config.value_bits or 8)))

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
        """Raw-tensor overload: quantize K/V at run time, then attend."""
        kq, vq = self.quantize_kv(k, v)
        return self.forward_quantized(q, kq, vq, bias, **kw)

    def forward_quantized(self, q: torch.Tensor, k: QuantizedTensor,
                          v: QuantizedTensor,
                          bias: Optional[torch.Tensor] = None,
                          **kw) -> torch.Tensor:
        return quantized_flash_attention(
            q, k, v, bias, mask=self.mask, scale=self.scale,
            block_sizes=self._blocks(q.shape[2], q.shape[3], k.config.bits),
            interleaved_kv=self.interleaved_kv,
            hadamard_block=self.config.hadamard_block(q.shape[3]), **kw)

    def forward_with_lse(self, q, k, v, bias=None, **kw):
        kq, vq = self.quantize_kv(k, v)
        return quantized_flash_attention_forward(
            q, kq, vq, bias=bias, mask=self.mask, scale=self.scale,
            block_sizes=self._blocks(q.shape[2], q.shape[3],
                                     kq.config.bits),
            interleaved_kv=self.interleaved_kv,
            hadamard_block=self.config.hadamard_block(q.shape[3]), **kw)

    def benchmark(self, *, batch: int = 1, num_heads: int = 8,
                  seq_len: int = 4096, head_dim: int = 64, iters: int = 30,
                  device=None) -> dict:
        """The bf16 / int8 / int4 sweep: TFLOP/s of the bf16 flash forward
        and of this facade at 8 and 4 bits (K/V quantized once, outside
        the timing), and each quantized O's relative L2 error against the
        bf16 one: {bf16_tflops, int8_tflops, int8_rel_err, int4_tflops,
        int4_rel_err}.  Inputs from a seeded generator on ``device`` (the
        card by default); times by ``utils.profiling.measure``, which
        includes the host's launches."""
        from metal_flash_attention_plus_tpu_torch._device import (
            resolve_device,
        )
        from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
            flash_attention_forward,
        )
        from metal_flash_attention_plus_tpu_torch.utils.profiling import (
            measure,
            tflops,
        )
        from metal_flash_attention_plus_tpu_torch.utils.roofline import (
            attention_flops,
        )

        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(0)
        shape = (batch, num_heads, seq_len, head_dim)
        q = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(shape, generator=g, device=dev)
                for _ in range(2))
        flops = attention_flops(seq_len, seq_len, head_dim,
                                num_heads=num_heads, batch=batch) / (
            2 if self.mask.kind == MaskKind.CAUSAL else 1)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)

        def fb(q):
            return flash_attention_forward(q, kb, vb, mask=self.mask,
                                           scale=self.scale)[0]

        o_ref = fb(q)
        results = {"bf16_tflops": tflops(flops, measure(fb, q, iters=iters))}
        for bits in (8, 4):
            qa = dataclasses.replace(self, config=dataclasses.replace(
                self.config, key_bits=bits, value_bits=bits))
            kq, vq = qa.quantize_kv(k, v)

            def f(q, qa=qa, kq=kq, vq=vq):
                return qa.forward_quantized(q, kq, vq)

            o = f(q)
            results[f"int{bits}_tflops"] = tflops(flops,
                                                  measure(f, q, iters=iters))
            results[f"int{bits}_rel_err"] = float(
                torch.linalg.vector_norm((o - o_ref).float())
                / torch.linalg.vector_norm(o_ref.float()))
        return results

"""Port parity for MLA's ops: decompression and latent-space attention.

Mirrors the JAX package's tests/test_mla.py, with the same seeded numpy
inputs fed to both packages: ``mla_decompress`` over float weights and
over quantized ones (int8 blockwise, the weight-only GEMM's dequant arm;
int8 ROW SYMMETRIC with a bf16 latent, its folded arm), and
``mla_absorbed_attention`` FULL and CAUSAL, with decoupled RoPE (the flash
path at D = d_c + d_r) and over a quantized latent (the quantized
attention path).  The JAX side runs at HIGHEST matmul precision, its
Pallas kernels in interpret mode; the port's side on the CPU runs its
kernels' plain versions.  fp32 results are held to TOLERANCES["fp32"]
relative to the JAX value's max abs (the same fp32 arithmetic in another
order); the bf16 decompression to one bf16 ulp.  The absorbed path is also
held to decompress-then-attend, the identity it implements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.attention import masking as jm
from metal_flash_attention_plus_tpu.ops import mla as jmla
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import tensor as jtensor
from metal_flash_attention_plus_tpu_torch.attention import masking as tm
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.models.mla_transformer import (
    plain_mla_attention,
)
from metal_flash_attention_plus_tpu_torch.ops import mla as tmla
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm as tqg
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

B, H, SQ, SKV, DH, DC, DR = 1, 4, 128, 256, 64, 256, 32
MASKS = {"full": (jm.FULL, tm.FULL), "causal": (jm.CAUSAL, tm.CAUSAL)}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _setup(seed, h=H, dh=DH, dc=DC, skv=SKV):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, h, SQ, dh)).astype(np.float32)
    latent = rng.standard_normal((B, skv, dc)).astype(np.float32)
    w_uk = (rng.standard_normal((h, dh, dc)) * dc ** -0.5).astype(np.float32)
    w_uv = (rng.standard_normal((h, dc, dh)) * dc ** -0.5).astype(np.float32)
    return q, latent, w_uk, w_uv


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("mask", ["full", "causal"])
def test_absorbed_matches_jax_and_decompressed(mask):
    (jq, jl, juk, juv), (tq, tl, tuk, tuv) = _both(*_setup(0))
    with jax.default_matmul_precision("highest"):
        want = jmla.mla_absorbed_attention(jq, jl, juk, juv,
                                           mask=MASKS[mask][0])
    got = tmla.mla_absorbed_attention(tq, tl, tuk, tuv, mask=MASKS[mask][1])
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOLERANCES["fp32"]
    dense = plain_mla_attention(tq, tl, tuk, tuv, mask=MASKS[mask][1])
    assert (got - dense).abs().max().item() <= 5e-4  # tests/test_mla.py


def test_absorbed_with_decoupled_rope_matches_jax():
    """[Q_lat | Q_rope]·[C | K_rope]ᵀ in one flash call at D = 288, V the
    latent zero-padded over the rope lanes."""
    rng = np.random.default_rng(4)
    q, latent, w_uk, w_uv = _setup(3)
    q_rope = rng.standard_normal((B, H, SQ, DR)).astype(np.float32)
    k_rope = rng.standard_normal((B, SKV, DR)).astype(np.float32)
    jx, tx = _both(q, latent, w_uk, w_uv, q_rope, k_rope)
    with jax.default_matmul_precision("highest"):
        want = jmla.mla_absorbed_attention(*jx[:4], q_rope=jx[4],
                                           k_rope=jx[5], mask=jm.CAUSAL)
    got = tmla.mla_absorbed_attention(*tx[:4], q_rope=tx[4], k_rope=tx[5],
                                      mask=tm.CAUSAL)
    assert _rel(got, want) <= TOLERANCES["fp32"]
    dense = plain_mla_attention(*tx[:4], q_rope=tx[4], k_rope=tx[5],
                                mask=tm.CAUSAL)
    assert (got - dense).abs().max().item() <= 5e-4
    with pytest.raises(ValueError):  # q_rope needs k_rope
        tmla.mla_absorbed_attention(*tx[:4], q_rope=tx[4])


# (q heads, head dim, latent width, keys): the module's widths, and
# DeepSeek-V2-Lite's (d_c = 512, 128-wide heads; two of its 16 heads), whose
# 512 latent the card runs at the quantized kernels' width 576.
LATENT_WIDTHS = {"h4_d64_c256": (H, DH, DC, SKV),
                 "v2_lite_h2_d128_c512": (2, 128, 512, 128)}


@pytest.mark.parametrize("widths", sorted(LATENT_WIDTHS))
def test_absorbed_quantized_latent_matches_jax(widths):
    """The absorbed path over an int8 ROW latent (the quantized forward
    over the latent width, one head shared by every q head) against the
    JAX package's, its output and its gradient in q (``jax.grad``, 1e-4 of
    the JAX value's max abs: fp32 in another order)."""
    h, dh, dc, skv = LATENT_WIDTHS[widths]
    q, latent, w_uk, w_uv = _setup(5, h, dh, dc, skv)
    tcfg = tparams.QuantConfig(granularity=tparams.QuantGranularity.ROW,
                               strategy=tparams.QuantStrategy.CENTERED)
    tc = ttensor.quantize(torch.from_numpy(latent)[:, None], tcfg)
    jc = jtensor.QuantizedTensor(
        data=jnp.asarray(tc.data.numpy()), scale=jnp.asarray(tc.scale.numpy()),
        zero_point=jnp.asarray(tc.zero_point.numpy()), sums=None,
        config=jparams.QuantConfig(
            granularity=jparams.QuantGranularity.ROW,
            strategy=jparams.QuantStrategy.CENTERED),
        shape=tuple(tc.shape))
    (jq, juk, juv), (tq, tuk, tuv) = _both(q, w_uk, w_uv)
    with jax.default_matmul_precision("highest"):
        want = jmla.mla_absorbed_attention(jq, jc, juk, juv, mask=jm.CAUSAL)
    got = tmla.mla_absorbed_attention(tq, tc, tuk, tuv, mask=tm.CAUSAL)
    assert _rel(got, want) <= TOLERANCES["fp32"]
    o_fp = tmla.mla_absorbed_attention(tq, torch.from_numpy(latent), tuk, tuv,
                                       mask=tm.CAUSAL)
    assert (torch.linalg.norm(got - o_fp) / torch.linalg.norm(o_fp)).item() \
        < TOLERANCES["int8_rel"] / 5  # the int8 gate of tests/test_mla.py
    with pytest.raises(NotImplementedError):  # rope with a quantized latent
        tmla.mla_absorbed_attention(tq, tc, tuk, tuv, q_rope=tq[..., :DR],
                                    k_rope=torch.zeros(B, skv, DR))
    g = np.random.default_rng(6).standard_normal(want.shape).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        jdq = jax.grad(lambda x: jnp.sum(jmla.mla_absorbed_attention(
            x, jc, juk, juv, mask=jm.CAUSAL) * g))(jq)
    tq = tq.clone().requires_grad_(True)
    (tmla.mla_absorbed_attention(tq, tc, tuk, tuv, mask=tm.CAUSAL)
     * torch.from_numpy(g)).sum().backward()
    assert _rel(tq.grad, jdq) <= 1e-4


def test_decompress_float_matches_jax():
    _, latent, _, _ = _setup(1)
    rng = np.random.default_rng(9)
    w_uk = rng.standard_normal((DC, H * DH)).astype(np.float32)
    w_uv = rng.standard_normal((DC, H * DH)).astype(np.float32)
    jx, tx = _both(latent, w_uk, w_uv)
    with jax.default_matmul_precision("highest"):
        jk, jv = jmla.mla_decompress(*jx, H)
    tk, tv = tmla.mla_decompress(*tx, H)
    assert tk.shape == tv.shape == (B, H, SKV, DH)
    assert _rel(tk, jk) <= TOLERANCES["fp32"]
    assert _rel(tv, jv) <= TOLERANCES["fp32"]


@pytest.mark.parametrize("cfg_name", ["blockwise128_f32", "row_sym_bf16"])
def test_decompress_quantized_matches_jax(cfg_name):
    """Weights stored transposed [H·dh, d_c]: int8 blockwise (CENTERED,
    128-wide K blocks) over an fp32 latent takes the dequant kernel, int8
    ROW SYMMETRIC over a bf16 latent the folded one; the model's 3-D
    ``w_uk`` / ``w_uv`` give that layout by a reshape."""
    _, latent, w_uk, w_uv = _setup(2)
    gran, strategy, bs, ldt = {
        "blockwise128_f32": ("block", "centered", 128, np.float32),
        "row_sym_bf16": ("row", "symmetric", None, None),
    }[cfg_name]
    jcfg = jparams.QuantConfig(
        granularity=jparams.QuantGranularity(gran),
        strategy=jparams.QuantStrategy(strategy), block_size=bs)
    tcfg = tparams.QuantConfig(
        granularity=tparams.QuantGranularity(gran),
        strategy=tparams.QuantStrategy(strategy), block_size=bs)
    wk = w_uk.reshape(H * DH, DC)
    wv = w_uv.transpose(0, 2, 1).reshape(H * DH, DC)
    jl = jnp.asarray(latent)
    tl = torch.from_numpy(latent)
    if ldt is None:
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    with jax.default_matmul_precision("highest"):
        jk, jv = jmla.mla_decompress(
            jl, jtensor.quantize(jnp.asarray(wk), jcfg),
            jtensor.quantize(jnp.asarray(wv), jcfg), H)
    n = (tqg.wo_folded_gemm.launches, tqg.wo_gemm.launches)
    tk, tv = tmla.mla_decompress(
        tl, ttensor.quantize(torch.from_numpy(wk), tcfg),
        ttensor.quantize(torch.from_numpy(wv), tcfg), H)
    assert (tqg.wo_folded_gemm.launches, tqg.wo_gemm.launches) == n
    assert tk.dtype == tl.dtype and tk.shape == (B, H, SKV, DH)
    for got, want in ((tk, jk), (tv, jv)):
        want = torch.from_numpy(np.array(want, np.float32))
        if ldt is None:  # bf16: within one bf16 ulp
            g = got.float()
            ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                g.abs(), want.abs()).clamp_min(2.0 ** -126))) - 7)
            assert bool(((g - want).abs() <= ulp).all())
        else:
            assert _rel(got, want.numpy()) <= TOLERANCES["fp32"]
    # Against the dense product with the dequantized weights (test_mla.py).
    wq = ttensor.quantize(torch.from_numpy(wk), tcfg)
    k_ref = (tl.float() @ wq.dequantize().t()).reshape(
        B, SKV, H, DH).transpose(1, 2)
    assert (tk.float() - k_ref).abs().max().item() <= (
        1e-3 if ldt else 0.05)

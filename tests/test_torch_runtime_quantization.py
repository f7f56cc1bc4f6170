"""Port parity for runtime quantization (``ops/runtime_quantization.py``)
against the JAX package's ``runtime_quantize``, bit for bit.

The inputs lie on a 2⁻⁶ grid with |x| < 5, so each partial sum behind a
CENTERED mean is exact in any order, and both sides apply the constant
divisors (the count, qmax, qmax − qmin) as multiplies by fp32 reciprocals,
as XLA compiles the JAX kernels (so a scale may differ in the last bit from
``quant.tensor.quantize``'s true division, in both packages): codes,
scales, zero points and Σq agree to the bit.  On other data the mean
depends on the order of its sum; the port fixes the order of its kernels
(``_row_sum``, ``_block_sum``), the tests hold the plain versions to that
order, written out element by element, and to the JAX package within the
last bit of the mean.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.ops import runtime_quantization as jrq
from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu_torch.ops import runtime_quantization as trq
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import tensor as ttensor

STRATEGIES = ["symmetric", "centered", "asymmetric"]


def _grid(rng, shape):
    return (rng.integers(-256, 256, shape) / 64 + 0.75).astype(np.float32)


def _configs(gran, strategy, bits, sums, block_size=None):
    kw = dict(bits=bits, compute_sums=sums, block_size=block_size)
    return (jparams.QuantConfig(granularity=jparams.QuantGranularity(gran),
                                strategy=jparams.QuantStrategy(strategy),
                                **kw),
            tparams.QuantConfig(granularity=tparams.QuantGranularity(gran),
                                strategy=tparams.QuantStrategy(strategy),
                                **kw))


def _same_bits(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype.itemsize == \
        want.dtype.itemsize
    assert got.tobytes() == want.tobytes()


def _assert_identical(t, j):
    assert t.config.granularity.value == j.config.granularity.value
    assert t.shape == tuple(j.shape)
    for field in ("data", "scale", "zero_point"):
        _same_bits(getattr(t, field), getattr(j, field))
    assert (t.sums is None) == (j.sums is None)
    if t.sums is not None:
        _same_bits(t.sums, j.sums)


@pytest.mark.parametrize("sums", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", ["row", "block"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_runtime_quantize_matches_jax_bit_for_bit(strategy, gran, bits,
                                                  sums):
    rng = np.random.default_rng(len(strategy) + bits + 2 * sums)
    x = _grid(rng, (128, 256))
    jcfg, tcfg = _configs(gran, strategy, bits, sums,
                          64 if gran == "block" else None)
    j = jrq.runtime_quantize(jnp.asarray(x), jcfg)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    _assert_identical(t, j)


@pytest.mark.parametrize("gran", ["row", "block"])
def test_counts_that_are_not_powers_of_two(gran):
    """The mean multiplies by the fp32 reciprocal of a count of 96 (a row)
    or 24 x 32 (a block), as XLA compiles the JAX kernels."""
    x = _grid(np.random.default_rng(6), (24, 96))
    jcfg, tcfg = _configs(gran, "centered", 8, True,
                          32 if gran == "block" else None)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    _assert_identical(t, jrq.runtime_quantize(jnp.asarray(x), jcfg))


@pytest.mark.parametrize("case", ["tensor_2d", "row_3d"])
def test_tensor_granularity_and_3d_go_to_quantize(case):
    rng = np.random.default_rng(3)
    shape, gran = ((64, 64), "tensor") if case == "tensor_2d" else (
        (2, 32, 64), "row")
    x = _grid(rng, shape)
    jcfg, tcfg = _configs(gran, "centered", 8, True)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    _assert_identical(t, jrq.runtime_quantize(jnp.asarray(x), jcfg))
    _assert_identical(t, ttensor.quantize(torch.from_numpy(x), tcfg))


def test_bf16_input_quantizes_its_fp32_values():
    x = torch.from_numpy(_grid(np.random.default_rng(4), (64, 128))).to(
        torch.bfloat16)
    for strategy in tparams.QuantStrategy:
        got = trq.rtq_rows(x, strategy, 8, True)
        want = trq.rtq_rows(x.float(), strategy, 8, True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _group(k):
    """The row kernel's lanes a row: the power of two covering ceil(k / 8)
    chunks, at most 32."""
    g = 1
    while g < -(-k // 8) and g < 32:
        g *= 2
    return g


def _butterfly(vals):
    vals, off = list(vals), len(vals) // 2
    while off:
        vals = [np.float32(vals[i] + vals[i ^ off]) for i in range(len(vals))]
        off //= 2
    return vals[0]


def _lane_order_sum(row):
    """The row kernel's order: lane j of G sums the columns of chunks j,
    j + G, ... (8 columns a chunk) in order from 0, then the xor butterfly
    over offsets G/2, ..., 1."""
    g = _group(len(row))
    lanes = [np.float32(0.0)] * g
    for c, x in enumerate(row):
        lanes[(c // 8) % g] = np.float32(lanes[(c // 8) % g] + x)
    return _butterfly(lanes)


def _thread_order_sum(cell, rows, bs, cluster, threads=512):
    """The block kernel's order over a [rows, bs] slab: rank r of the
    cluster takes rows [r·B, (r+1)·B), B = ceil(rows / cluster); its band's
    chunks (8 columns of a row, ceil(bs / 8) to a row) go to threads in
    turn, thread t summing chunks t, t + 512, ... in order from 0; the
    threads combine by xor butterfly in each warp, the warps by xor
    butterfly, and the ranks in rank order."""
    band, cpr = -(-rows // cluster), -(-bs // 8)
    total = None
    for r in range(cluster):
        acc = [np.float32(0.0)] * threads
        for lr in range(band):
            row = r * band + lr
            if row >= rows:
                break
            for col in range(bs):
                t = (lr * cpr + col // 8) % threads
                acc[t] = np.float32(acc[t] + cell[row * bs + col])
        warps = [_butterfly(acc[w:w + 32]) for w in range(0, threads, 32)]
        part = _butterfly(warps)
        total = part if total is None else np.float32(total + part)
    return total


def test_row_group_and_block_cluster():
    assert [trq.row_group(k) for k in (1, 8, 9, 37, 64, 96, 200, 256, 4096)
            ] == [1, 1, 2, 8, 8, 16, 32, 32, 32]
    assert trq.row_group(64) == _group(64) == 8  # a warp holds 4 rows
    # 16 blocks x 16 CTAs at bs 64 on K = 1024; 8 x 16 at bs 128.
    assert trq.block_cluster(1024, 64) == 16
    assert trq.block_cluster(1024, 128) == 16
    assert trq.block_cluster(1024, 1024) == 16
    assert trq.block_cluster(8192, 64) == 2
    assert trq.block_cluster(16384, 64) == 1


@pytest.mark.parametrize("k", [64, 96, 200, 37, 1, 2000])
def test_row_sum_is_the_kernels_order(k):
    rng = np.random.default_rng(5 + k)
    rows = (rng.standard_normal((3, k)) * 3 + 0.7).astype(np.float32)
    got = trq._row_sum(torch.from_numpy(rows)).numpy()
    want = np.array([_lane_order_sum(r) for r in rows], np.float32)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rows,bs,cluster", [
    (30, 100, 16),  # R not a multiple of C, bs not of 8; an empty band
    (5, 64, 8),     # R < C
    (200, 64, 2),   # a band of 800 chunks: threads take two
    (37, 40, 1),    # one CTA a block
    (96, 256, 16),
], ids=["30x100-c16", "5x64-c8", "200x64-c2", "37x40-c1", "96x256-c16"])
def test_block_sum_is_the_kernels_order(rows, bs, cluster):
    rng = np.random.default_rng(rows + bs + cluster)
    cells = (rng.standard_normal((2, rows * bs)) * 3 + 0.7).astype(
        np.float32)
    got = trq._block_sum(torch.from_numpy(cells), rows, bs, cluster).numpy()
    want = np.array([_thread_order_sum(c, rows, bs, cluster) for c in cells],
                    np.float32)
    assert got.tobytes() == want.tobytes()


def test_plain_versions_sum_in_the_kernels_order():
    """The mean a row's or a block's codes see is its sum, in the kernel's
    order, times the reciprocal of the count."""
    rng = np.random.default_rng(5)
    cells = (rng.standard_normal(3000) * 3 + 0.7).astype(np.float32)
    x = torch.from_numpy(cells.reshape(30, 100))
    centered = tparams.QuantStrategy.CENTERED
    assert trq.block_cluster(100, 100) == 16
    _, scale, zp, _ = trq.rtq_blocks_plain(x, 100, centered, 8, False)
    want = np.float32(_thread_order_sum(cells, 30, 100, 16))
    mean = torch.tensor([want]) * trq._recip(3000, "cpu")
    assert torch.equal(zp, torch.round(-mean / scale).to(torch.int32))
    _, scale, zp, _ = trq.rtq_rows_plain(x, centered, 8, False)
    want = np.array([_lane_order_sum(r) for r in cells.reshape(30, 100)],
                    np.float32)
    mean = torch.from_numpy(want) * trq._recip(100, "cpu")
    assert torch.equal(zp, torch.round(-mean / scale).to(torch.int32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("gran,shape,bs", [
    ("row", (512, 64), None),     # the facade's K/V rows
    ("block", (256, 512), 128),
    ("block", (192, 512), 256),
], ids=["row-k64", "block-bs128", "block-bs256"])
def test_main_path_widths_match_jax_bit_for_bit(gran, shape, bs, strategy,
                                                bits):
    rng = np.random.default_rng(len(strategy) + bits + shape[0])
    x = _grid(rng, shape)
    jcfg, tcfg = _configs(gran, strategy, bits, True, bs)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    _assert_identical(t, jrq.runtime_quantize(jnp.asarray(x), jcfg))


@pytest.mark.parametrize("gran,bs", [("row", None), ("block", 64)])
def test_off_grid_data_matches_jax_to_the_last_bit(gran, bs):
    """On data whose sums are not exact the CENTERED mean depends on the
    order of its sum: the scales agree within an ulp, the zero points and
    codes within 1, and almost every code exactly."""
    x = (np.random.default_rng(8).standard_normal((256, 256)) * 2
         + 0.3).astype(np.float32)
    jcfg, tcfg = _configs(gran, "centered", 8, True, bs)
    t = trq.runtime_quantize(torch.from_numpy(x), tcfg)
    j = jrq.runtime_quantize(jnp.asarray(x), jcfg)
    ts, js = t.scale.numpy(), np.asarray(j.scale)
    assert np.all(np.abs(ts - js) <= np.spacing(js))
    for got, want in ((t.zero_point, j.zero_point), (t.data, j.data)):
        diff = np.abs(got.numpy().astype(np.int32)
                      - np.asarray(want).astype(np.int32))
        assert diff.max() <= 1
    codes = t.data.numpy() != np.asarray(j.data)
    assert codes.mean() <= 1e-3

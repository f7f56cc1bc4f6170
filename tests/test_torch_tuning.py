"""Port parity: the tuner's tables, its store and the native resolvers.

The TPU block-size tables that the quantized numerics read, the
calibration keys and JSON store, and the C++ resolvers of
``cpp/mfa_runtime.cc`` must agree with the JAX package's on every input
(exactly: they are integer tables and strings).  The calibration machinery
runs on the CPU at tiny shapes: the rates it records mean nothing there,
what is held is the sweep, the persistence and the read-back.  The GEMM
plans, which only the port has, are held to the planners they stand for.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu import runtime as jrt
from metal_flash_attention_plus_tpu.runtime import native as jnative
from metal_flash_attention_plus_tpu.attention import tuning as jt
from metal_flash_attention_plus_tpu_torch import runtime as trt
from metal_flash_attention_plus_tpu_torch.attention import tuning as tt
from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm as tq

KINDS = ("TPU v4", "TPU v5 lite", "TPU v5e", "TPU v5p", "TPU v5",
         "TPU v6e", "Trillium", "cpu", "NVIDIA H100 80GB HBM3", "", None)
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192, 256, 288, 512)


def test_buckets_match_jax():
    for s in (1, 100, 512, 513, 2048, 5000, 32768, 40000):
        assert tt.seq_bucket(s) == jt.seq_bucket(s)
    for m in (1, 8, 128, 129, 256, 300, 4096, 8192, 9000):
        assert tt.m_bucket(m) == jt.m_bucket(m)
        for bits in (4, 8):
            assert tt.default_gemm_blocks(m, bits) == \
                jt.default_gemm_blocks(m, bits)
    for kind in KINDS:
        assert tt.normalize_device_kind(kind) == jt.normalize_device_kind(
            kind)


@pytest.mark.parametrize("kind", KINDS)
def test_default_block_sizes_match_jax(kind):
    for d in HEAD_DIMS:
        for bits in (4, 8, 16):
            for causal in (True, False):
                got = tt.default_block_sizes(d, bits, causal, kind)
                want = jt.default_block_sizes(d, bits, causal, kind)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                    d, bits, causal)


def test_tune_key_round_trip_and_encoding_match_jax():
    for args in (("fwd", 64, 16, 4096, True), ("fwd_q", 128, 8, 512, False),
                 ("bwd", 256, 4, 32768, True)):
        key = tt.TuneKey(*args)
        assert key.encode() == jt.TuneKey(*args).encode()
        assert tt.TuneKey.decode(key.encode()) == key
    assert tt.TuneKey.decode("fwd:d64:b16:s4096") == tt.TuneKey(
        "fwd", 64, 16, 4096, True)
    assert tt.AttentionTuner._gemm_key(8, 1024, 4096, 8, "dynamic") == \
        jt.AttentionTuner._gemm_key(8, 1024, 4096, 8, "dynamic")


def test_store_is_shared_with_jax_both_ways(tmp_path):
    blocks = tt.default_block_sizes(128, 8, False)
    port = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)))
    port._device_kind = lambda: "TPU v6e"
    port.record(tt.TuneKey("fwd_q", 128, 8, 2048, False), blocks, 12.5)
    jax_tuner = jt.AttentionTuner(store=jt.CalibrationStore(str(tmp_path)))
    jax_tuner._device_kind = lambda: "TPU v6e"
    got = jax_tuner.recommend("fwd_q", 128, 2000, bits=8, causal=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(blocks)

    jblocks = jt.default_block_sizes(64, 16, True)
    jax_tuner.record(jt.TuneKey("bwd", 64, 16, 1024, True), jblocks, 3.0)
    port2 = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)))
    port2._device_kind = lambda: "TPU v6e"
    got = port2.recommend("bwd", 64, 1000)
    assert dataclasses.asdict(got) == dataclasses.asdict(jblocks)
    assert port2.recommend("fwd_q", 128, 2048, bits=8, causal=False) == \
        blocks
    # The file is the JAX package's: one JSON object keyed by TuneKey.
    assert tt.CalibrationStore(str(tmp_path)).load("TPU v6e") == \
        jt.CalibrationStore(str(tmp_path)).load("TPU v6e")


def test_store_honours_mfa_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MFA_CACHE_DIR", str(tmp_path / "c"))
    store = tt.CalibrationStore()
    store.save("NVIDIA H100 80GB HBM3", {"k": {"tflops": 1.0}})
    assert (tmp_path / "c" / "NVIDIA-H100-80GB-HBM3.json").exists()
    assert store.load("NVIDIA H100 80GB HBM3") == {"k": {"tflops": 1.0}}
    monkeypatch.delenv("MFA_CACHE_DIR")
    assert str(tt.CalibrationStore()._dir).endswith(
        ".cache/metal_flash_attention_plus_tpu_torch/tuning")


def test_recommend_cold_start_is_the_table(tmp_path):
    tuner = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)))
    assert tt.device_kind() == "cpu"
    assert tuner.recommend("fwd", 256, 1024) == tt.default_block_sizes(
        256, device_kind="cpu")
    assert tuner.recommend("fwd_q", 64, 300, bits=4, causal=False) == \
        tt.default_block_sizes(64, 4, False, device_kind="cpu")


@pytest.mark.parametrize("kind", ["fwd", "fwd_q", "bwd"])
def test_calibrate_times_the_table_and_persists(tmp_path, kind):
    tuner = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)),
                               device="cpu")
    best = tuner.calibrate(32, 128, kind=kind, bits=8 if kind == "fwd_q"
                           else 16, num_heads=1, batch=1, iters=1,
                           candidates=((128, 128), (256, 256)))
    bits = 8 if kind == "fwd_q" else 16
    assert best == tt.default_block_sizes(32, bits, True, "cpu")
    fresh = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)))
    assert fresh.recommend(kind, 32, 128, bits=bits) == best
    entry = fresh._cache[tt.TuneKey(kind, 32, bits, 512).encode()]
    assert entry["tflops"] >= 0


@pytest.mark.parametrize("mode", ["dynamic", "weight_only"])
def test_calibrate_gemm_persists_the_plan(tmp_path, mode):
    m, n, k = 16, 256, 512
    tuner = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)),
                               device="cpu")
    cold = tuner.recommend_gemm(m, n, k, mode=mode)
    shape_planner = tq.dyn_shape_tile if mode == "dynamic" \
        else tq.wo_shape_tile
    assert tt.tile_of(cold, k, mode) == shape_planner(m, n, k, tt.H100_SMS)
    plan = tuner.calibrate_gemm(m, n, k, mode=mode, iters=1)
    assert plan == cold  # the CPU's plain version reads no plan
    fresh = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)))
    assert fresh.recommend_gemm(m, n, k, mode=mode) == plan
    assert fresh.recommend_gemm(100, n, k, mode=mode) == plan  # M bucket 128
    assert fresh.stored_plan(m, n, k, 4, mode) is None
    with pytest.raises(ValueError, match="mode"):
        tuner.recommend_gemm(m, n, k, mode="folded")


def test_calibrate_all_covers_every_kind(tmp_path):
    tuner = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)),
                               device="cpu")
    entries = tuner.calibrate_all(head_dims=(32,), seq_lens=(64,),
                                  causals=(True,),
                                  gemm_shapes=((16, 256, 256),), iters=1)
    assert sorted(entries) == sorted([
        "fwd:d32:b16:s512:mC", "fwd_q:d32:b8:s512:mC",
        "fwd_q:d32:b4:s512:mC", "bwd:d32:b16:s512:mC",
        "gemm:dynamic:n256:k256:b8:m128",
        "gemm:weight_only:n256:k256:b8:m128"])


def test_calibration_without_a_card_raises(tmp_path):
    tuner = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)))
    assert tuner.recommend("fwd", 32, 128) == tt.default_block_sizes(
        32, device_kind="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuner.calibrate(32, 128, num_heads=1, batch=1, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuner.calibrate_gemm(16, 256, 512, iters=1)
    assert not list(tmp_path.iterdir())  # nothing stored


@pytest.mark.parametrize("mode", ["dynamic", "weight_only"])
@pytest.mark.parametrize("m,n,k", [(8, 1024, 1024), (256, 1024, 4096),
                                   (4096, 4096, 1024), (128, 8192, 8192),
                                   (4096, 1024, 256), (1, 1000, 2048)])
def test_default_candidates_map_back_to_their_tiles(m, n, k, mode):
    plans = tt._default_candidates(m, n, k, mode)
    assert plans
    for plan in plans:
        bm, tile_n, kps = plan
        assert tile_n == 128 and kps % tt.GEMM_K_UNIT[mode] == 0
        assert tt.plan_of(tt.tile_of(plan, k, mode), k, mode) == plan
    cold = tt.plan_of((tq.dyn_shape_tile if mode == "dynamic"
                       else tq.wo_shape_tile)(m, n, k, 132), k, mode)
    assert tt.tile_of(cold, k, mode) == tt.tile_of(
        tt.plan_of(tt.tile_of(cold, k, mode), k, mode), k, mode)


def test_planners_take_a_stored_plan(tmp_path, monkeypatch):
    tuner = tt.AttentionTuner(store=tt.CalibrationStore(str(tmp_path)))
    monkeypatch.setattr(tt.AttentionTuner, "_instance", tuner)
    assert tq.dyn_tile(8, 1024, 4096, 132) == tq.dyn_shape_tile(
        8, 1024, 4096, 132)
    assert tq.wo_tile(128, 8192, 8192, 132) == (128, 4)
    tuner._store_entry(tuner._gemm_key(8, 1024, 4096, 8, "dynamic"),
                       {"gemm_blocks": [16, 128, 1024], "tflops": 1.0})
    tuner._store_entry(tuner._gemm_key(128, 8192, 8192, 8, "weight_only"),
                       {"gemm_blocks": [64, 128, 1024], "tflops": 1.0})
    assert tq.dyn_tile(8, 1024, 4096, 132) == (16, 4)
    assert tq.dyn_tile(8, 1024, 4096, 132, bits=4) == tq.dyn_shape_tile(
        8, 1024, 4096, 132)
    assert tq.wo_tile(128, 8192, 8192, 132) == (64, 8)
    assert tuner.recommend_gemm(8, 1024, 4096) == (16, 128, 1024)


def test_dyn_gemm_is_the_same_under_any_plan():
    # The plain version reads no plan; a stored plan changes nothing here.
    rng = np.random.default_rng(3)
    qa = torch.from_numpy(rng.integers(-127, 128, (16, 256)).astype(np.int8))
    qb = torch.from_numpy(rng.integers(-127, 128, (64, 256)).astype(np.int8))
    sa, rs = torch.rand(16), qa.float().sum(1)
    sb, zb = torch.rand(64), torch.zeros(64)
    ref = tq.dyn_gemm(qa, qb, sa, rs, sb, zb, bits=8)
    for tile in ((16, 1), (16, 2), (64, 1)):
        out = tq.dyn_gemm(qa, qb, sa, rs, sb, zb, bits=8, tile=tile)
        assert torch.equal(out, ref)


def test_native_resolvers_match_jax():
    assert trt.native_available()
    for d, bits in [(64, 16), (128, 16), (256, 16), (64, 8), (512, 16),
                    (128, 8), (256, 8), (128, 4), (256, 4), (80, 8)]:
        for causal in (True, False):
            for kind in (None, "TPU v6e", "NVIDIA H100 80GB HBM3"):
                got = trt.resolve_blocks(d, bits, causal=causal,
                                         device_kind=kind)
                want = jrt.resolve_blocks(d, bits, causal=causal,
                                          device_kind=kind)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = trt.resolve_blocks(128, 16, vmem_budget_bytes=2 << 20)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jrt.resolve_blocks(128, 16, vmem_budget_bytes=2 << 20))
    assert trt.resolve_blocks(64).to_block_sizes().block_q == 512
    for m in (1, 256, 257, 4096):
        for bits in (4, 8):
            for mode in (trt.GEMM_DYNAMIC, trt.GEMM_WEIGHT_ONLY):
                assert trt.resolve_gemm_blocks(m, bits, mode) == \
                    jnative.resolve_gemm_blocks(m, bits, mode)
            assert trt.resolve_gemm_blocks(m, bits, vmem_budget_bytes=1 << 20) \
                == jnative.resolve_gemm_blocks(m, bits,
                                               vmem_budget_bytes=1 << 20)
    for kind in KINDS[:-1]:
        assert trt.device_vmem_budget(kind) == jrt.device_vmem_budget(kind)


def test_native_resolver_falls_back_as_jax_does(monkeypatch):
    # Without the library both packages answer from the Python tables.
    # (The JAX package's resolve_blocks raises there: it builds its
    # BlockConfig from every BlockSizes field, the two backward majors
    # among them; the port takes the BlockConfig's fields of JAX's table.)
    from metal_flash_attention_plus_tpu_torch.runtime import native

    monkeypatch.setattr(native, "_load_or_none", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    for d, bits in [(64, 16), (128, 8), (256, 4)]:
        for kind in (None, "TPU v6e", "cpu"):
            got = native.resolve_blocks(d, bits, causal=False,
                                        device_kind=kind)
            want = jt.default_block_sizes(d, bits, False, kind)
            assert dataclasses.asdict(got) == {
                k: v for k, v in dataclasses.asdict(want).items()
                if not k.endswith("_major") or k == "block_kv_major"}
    assert native.resolve_gemm_blocks(8) == jnative.resolve_gemm_blocks(8)
    for kind in ("TPU v6e", "TPU v5 lite", "cpu"):
        assert native.device_vmem_budget(kind) == \
            jnative.device_vmem_budget(kind)


def test_calib_cache_matches_jax_file_format(tmp_path):
    path = str(tmp_path / "calib.txt")
    c = trt.CalibCache(path)
    cfg = trt.resolve_blocks(64)
    c.put("fwd:d64:b16:s4096", cfg, 123.4)
    assert c.save()
    c.close()
    j = jrt.CalibCache(path)
    got = j.get("fwd:d64:b16:s4096")
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(cfg)
    assert abs(got[1] - 123.4) < 1e-9
    j.put("bwd:d128:b16:s512", jrt.resolve_blocks(128), 7.0)
    assert j.save()
    c2 = trt.CalibCache(path)
    assert len(c2) == 2 and c2.get("missing") is None
    got = c2.get("bwd:d128:b16:s512")
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(
        jrt.resolve_blocks(128)) and got[1] == 7.0
    c2.close()

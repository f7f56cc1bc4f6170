"""Port parity for ``QuantizedTensor`` serialization.

A file written by the JAX package's ``save_quantized`` loads in the
port's ``load_quantized`` and the other way round, in both directions
with the same bytes: every ``.npy`` member of the ``.npz`` (header JSON,
payload, scales, zero points, sums) is byte-identical whichever package
wrote it, and the loaded tensors equal the written ones byte for byte.
Cases: int8 TENSOR, int8 BLOCK with sums, int4 TENSOR, and a bf16
``orig_dtype``.  A newer format version is rejected.
"""

import io
import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu.quant import params as jparams
from metal_flash_attention_plus_tpu.quant import serialization as jser
from metal_flash_attention_plus_tpu.quant.tensor import quantize as jquantize
from metal_flash_attention_plus_tpu_torch.quant import params as tparams
from metal_flash_attention_plus_tpu_torch.quant import serialization as tser
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    quantize as tquantize,
)

# (name, shape, dtype, config kwargs)
CASES = [
    ("tensor8", (8, 64), "float32", dict(bits=8)),
    ("block8-sums", (16, 256), "float32",
     dict(bits=8, granularity="block", strategy="centered", block_size=64,
          compute_sums=True)),
    ("tensor4", (8, 64), "float32", dict(bits=4)),
    ("row8-bf16", (4, 8, 32), "bfloat16",
     dict(bits=8, granularity="row", strategy="asymmetric")),
]


def _config(mod, kw):
    kw = dict(kw)
    for key, enum in (("granularity", mod.QuantGranularity),
                      ("strategy", mod.QuantStrategy)):
        if key in kw:
            kw[key] = enum(kw[key])
    return mod.QuantConfig(**kw)


def _pair(shape, dtype, kw):
    """The same data quantized by both packages (equal bytes, held by
    tests/test_torch_quant.py)."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return (jquantize(jx, _config(jparams, kw)),
            tquantize(tx, _config(tparams, kw)))


def _members(buf: bytes):
    with zipfile.ZipFile(io.BytesIO(buf)) as z:
        return {n: z.read(n) for n in z.namelist()}


def _save(save, t) -> bytes:
    buf = io.BytesIO()
    save(t, buf)
    return buf.getvalue()


def _fields(t):
    names = ["data", "scale", "zero_point"] + (["sums"] if t.sums is not None
                                               else [])
    return {n: np.asarray(getattr(t, n)) if not isinstance(
        getattr(t, n), torch.Tensor) else getattr(t, n).numpy()
        for n in names}


@pytest.mark.parametrize("name,shape,dtype,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_files_are_byte_identical_and_load_across(name, shape, dtype, kw):
    jt, tt = _pair(shape, dtype, kw)
    jbuf, tbuf = _save(jser.save_quantized, jt), _save(tser.save_quantized,
                                                       tt)
    assert _members(jbuf) == _members(tbuf)
    header = json.loads(bytes(np.load(io.BytesIO(tbuf))["header"]).decode())
    assert header["orig_dtype"] == dtype
    assert header["has_sums"] == bool(kw.get("compute_sums"))

    # JAX-written → port.
    got = tser.load_quantized(io.BytesIO(jbuf), device="cpu")
    assert got.config == tt.config and got.shape == tt.shape
    assert got.orig_dtype == tt.orig_dtype
    for key, arr in _fields(jt).items():
        g = _fields(got)[key]
        assert g.dtype == arr.dtype and g.tobytes() == arr.tobytes(), key
    torch.testing.assert_close(got.dequantize(), tt.dequantize(), rtol=0,
                               atol=0)

    # Port-written → JAX.
    back = jser.load_quantized(io.BytesIO(tbuf))
    assert back.config == jt.config and back.shape == jt.shape
    assert jnp.dtype(back.orig_dtype) == jnp.dtype(jt.orig_dtype)
    for key, arr in _fields(tt).items():
        b = _fields(back)[key]
        assert b.dtype == arr.dtype and b.tobytes() == arr.tobytes(), key


def test_round_trip_through_a_path(tmp_path):
    _, tt = _pair((8, 64), "float32", dict(bits=4))
    path = tmp_path / "t.npz"
    tser.save_quantized(tt, str(path))
    got = tser.load_quantized(str(path), device="cpu")
    assert torch.equal(got.data, tt.data) and torch.equal(got.scale, tt.scale)


def test_rejects_future_version(tmp_path):
    _, tt = _pair((8, 16), "float32", dict(bits=8))
    p = tmp_path / "t.npz"
    tser.save_quantized(tt, str(p))
    data = dict(np.load(str(p)))
    hdr = json.loads(bytes(data["header"]).decode())
    hdr["version"] = tser.FORMAT_VERSION + 1
    data["header"] = np.frombuffer(json.dumps(hdr).encode(), dtype=np.uint8)
    np.savez(str(p), **data)
    with pytest.raises(ValueError, match="newer"):
        tser.load_quantized(str(p), device="cpu")


def test_load_defaults_to_the_card():
    """``device=None`` means the card: without one, loading raises rather
    than carrying on on the CPU."""
    _, tt = _pair((8, 16), "float32", dict(bits=8))
    buf = io.BytesIO(_save(tser.save_quantized, tt))
    if torch.cuda.is_available():
        assert tser.load_quantized(buf).data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tser.load_quantized(buf)

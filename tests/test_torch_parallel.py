"""Port parity for context parallelism: ring, zigzag ring, Ulysses, mesh.

The mirror of tests/test_parallel.py's five tests, its zigzag test and
tests/test_long_context.py::test_mla_context_parallel_ring, at small
sizes.  The port runs in one world of 4 gloo CPU ranks, started once for
the module: 4 subprocesses that import only torch, numpy and the port
(the worker's source is below, as tests/test_multiprocess.py passes its
worker), rendezvous through a ``FileStore`` in the test's temporary
directory, run every case on the same numpy inputs and write their local
outputs; the test gathers them along the sequence.  The JAX side runs the
JAX package's functions under ``shard_map`` over 4 of conftest's virtual
CPU devices, at HIGHEST matmul precision with its Pallas kernels in
interpret mode.

Gate: 2e-5 max abs on O and on dQ, dK, dV (fp32; the port's plain
versions and the JAX kernels sum in other orders).  The zigzag chunk
order, its inverse and the pre/post-sharded tensors equal JAX's exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from metal_flash_attention_plus_tpu.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu.parallel import ring as jring
from metal_flash_attention_plus_tpu.parallel.ulysses import (
    ulysses_attention as julysses,
)
from metal_flash_attention_plus_tpu_torch import parallel as tpar

REPO = Path(__file__).resolve().parents[1]
N = 4
TOL = 2e-5
BS = BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                block_kv_dkv=128, block_q_dq=128, block_kv_dq=128)
SEQ = P(None, None, "context", None)

_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                        world_size=world, rank=rank)
from metal_flash_attention_plus_tpu_torch import parallel as par
from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL

inputs = dict(np.load(f"{out_dir}/inputs.npz"))
out, checks = {}, {}


def local(x, n=world):
    c = x.shape[2] // n
    return torch.from_numpy(x[:, :, rank * c:(rank + 1) * c].copy())


def run(case, fn, zigzag=False):
    names = ("q", "k", "v", "do")
    glob = [inputs[f"{case}/{k}"] for k in names]
    if zigzag:
        glob = [par.zigzag_preshard(torch.from_numpy(x), world).numpy()
                for x in glob]
    q, k, v, do = (local(x) for x in glob)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves)
    grads = torch.autograd.grad(o, leaves, do)
    for key, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
        out[f"{case}/{key}"] = t.detach().numpy()


run("ring_causal", lambda q, k, v: par.ring_attention(q, k, v, None, True))
run("ring_full", lambda q, k, v: par.ring_attention(q, k, v, None, False))
run("ring_interleaved", lambda q, k, v: par.ring_attention(
    q, k, v, None, True, interleaved_kv=True))
run("ulysses_h4", lambda q, k, v: par.ulysses_attention(q, k, v))
run("ulysses_h2", lambda q, k, v: par.ulysses_attention(q, k, v))
run("zigzag", lambda q, k, v: par.ring_attention_zigzag(q, k, v),
    zigzag=True)

# MLA: W_uk absorbed locally, the head-shared latent through the ring.
q = local(inputs["mla/q"])
lat = torch.from_numpy(inputs["mla/latent"])
c = lat.shape[1] // world
lat = lat[:, rank * c:(rank + 1) * c]
w_uk = torch.from_numpy(inputs["mla/w_uk"])
w_uv = torch.from_numpy(inputs["mla/w_uv"])
q_lat = torch.einsum("bhsd,hdc->bhsc", q, w_uk)
kv = lat[:, None]
o_lat = par.ring_attention(q_lat, kv, kv, None, True,
                           float(q.shape[-1]) ** -0.5)
out["mla/o"] = torch.einsum("bhsc,hcd->bhsd", o_lat.float(), w_uv).numpy()


def raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


x = torch.zeros(1, 8, 8, 16)
checks["ulysses_errors"] = {
    "interleaved": raises(lambda: par.ulysses_attention(
        x, x[:, :2], x[:, :2], interleaved_kv=True)),
    "hq": raises(lambda: par.ulysses_attention(x[:, :6], x[:, :2],
                                               x[:, :2])),
    "hkv": raises(lambda: par.ulysses_attention(x, x[:, :3], x[:, :3])),
}
mesh = par.make_mesh(1, 1, world, device_type="cpu")
checks["mesh"] = {
    "names": list(mesh.mesh_dim_names),
    "shape": list(mesh.shape),
    "context_size": mesh.get_group("context").size(),
    "batch": [f"shard {p.dim}" if p.is_shard() else "replicate"
              for p in par.batch_sharding(mesh)],
    "replicated": [p.is_replicate() for p in par.replicated(mesh)],
    "wrong_size": raises(lambda: par.make_mesh(2, 1, world,
                                               device_type="cpu")),
}
checks["jax_loaded"] = any(m == "jax" or m.startswith(
    ("jax.", "metal_flash_attention_plus_tpu.")) for m in sys.modules)
np.savez(f"{out_dir}/out_{rank}.npz", **out)
with open(f"{out_dir}/checks_{rank}.json", "w") as f:
    json.dump(checks, f)
dist.destroy_process_group()
'''


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs():
    """Every case's global inputs, from one seeded numpy generator."""
    rng = np.random.default_rng(0)
    cases = {"ring_causal": (4, 2, 256), "ring_full": (4, 2, 256),
             "ring_interleaved": (4, 2, 256), "ulysses_h4": (8, 4, 256),
             "ulysses_h2": (8, 2, 256), "zigzag": (4, 2, 256)}
    arrays = {}
    for case, (hq, hkv, s) in cases.items():
        arrays.update({f"{case}/q": _normal(rng, 1, hq, s, 64),
                       f"{case}/k": _normal(rng, 1, hkv, s, 64),
                       f"{case}/v": _normal(rng, 1, hkv, s, 64),
                       f"{case}/do": _normal(rng, 1, hq, s, 64)})
    b, h, s, dh, dc = 1, 4, 512, 32, 64
    arrays.update({"mla/q": _normal(rng, b, h, s, dh),
                   "mla/latent": _normal(rng, b, s, dc),
                   "mla/w_uk": _normal(rng, h, dh, dc) * dc ** -0.5,
                   "mla/w_uv": _normal(rng, h, dc, dh) * dc ** -0.5})
    return arrays


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the port's world of N gloo ranks once → (inputs, gathered
    outputs by key, each rank's checks)."""
    d = tmp_path_factory.mktemp("gloo_world")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    (d / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(d / "worker.py"), str(r), str(N), str(d)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(N)]
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)
    outs = [dict(np.load(d / f"out_{r}.npz")) for r in range(N)]
    gathered = {key: np.concatenate([o[key] for o in outs], axis=2)
                for key in outs[0]}
    checks = [json.loads((d / f"checks_{r}.json").read_text())
              for r in range(N)]
    return inputs, gathered, checks


def _mesh():
    return Mesh(np.asarray(jax.devices()[:N]), ("context",))


def _jax_fwd_grads(fn, q, k, v, do):
    """``fn`` (local q, k, v → o) and its VJP of ``do`` under one
    shard_map: (o, dq, dk, dv), the gradients of sum(O · dO)."""
    def fwd_vjp(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o, *vjp(do))

    with jax.default_matmul_precision("highest"):
        out = jax.jit(shard_map(fwd_vjp, mesh=_mesh(), in_specs=(SEQ,) * 4,
                                out_specs=(SEQ,) * 4, check_vma=False))(
                                    q, k, v, do)
    return [np.asarray(x) for x in out]


def _case(inputs, case):
    return [jnp.asarray(inputs[f"{case}/{k}"]) for k in ("q", "k", "v", "do")]


def _assert_case(gathered, case, want, post=None):
    for key, w in zip(("o", "dq", "dk", "dv"), want):
        got = gathered[f"{case}/{key}"]
        if post is not None:
            got = post(got)
        err = float(np.max(np.abs(got - w)))
        assert err <= TOL, (case, key, err)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_forward_and_grads(world, causal):
    inputs, gathered, _ = world
    case = "ring_causal" if causal else "ring_full"
    want = _jax_fwd_grads(
        lambda q, k, v: jring.ring_attention(q, k, v, "context", causal,
                                             None, BS),
        *_case(inputs, case))
    _assert_case(gathered, case, want)


def test_ring_attention_interleaved_gqa(world):
    inputs, gathered, _ = world
    want = _jax_fwd_grads(
        lambda q, k, v: jring.ring_attention(q, k, v, "context", True, None,
                                             BS, True),
        *_case(inputs, "ring_interleaved"))
    _assert_case(gathered, "ring_interleaved", want)


@pytest.mark.parametrize("hkv", [4, 2])
def test_ulysses_attention_forward_and_grads(world, hkv):
    inputs, gathered, _ = world
    case = f"ulysses_h{hkv}"
    want = _jax_fwd_grads(
        lambda q, k, v: julysses(q, k, v, "context", mask=CAUSAL,
                                 block_sizes=BS),
        *_case(inputs, case))
    _assert_case(gathered, case, want)


def test_ulysses_raises_where_jax_raises(world):
    for checks in world[2]:
        errs = checks["ulysses_errors"]
        assert "interleaved_kv GQA is unsupported" in errs["interleaved"]
        assert "not divisible by axis size" in errs["hq"]
        assert "need divisibility" in errs["hkv"]


def test_zigzag_ring_forward_and_grads(world):
    inputs, gathered, _ = world
    q, k, v, do = (jring.zigzag_preshard(x, N)
                   for x in _case(inputs, "zigzag"))
    want = _jax_fwd_grads(
        lambda q, k, v: jring.ring_attention_zigzag(q, k, v, "context",
                                                    None, BS),
        q, k, v, do)
    want = [np.asarray(jring.zigzag_postshard(jnp.asarray(w), N))
            for w in want]
    _assert_case(gathered, "zigzag", want,
                 post=lambda x: tpar.zigzag_postshard(
                     torch.from_numpy(x), N).numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zigzag_permutations_equal_jax(n):
    assert tpar.zigzag_order(n) == jring.zigzag_order(n)
    assert tpar.zigzag_inverse(n) == jring.zigzag_inverse(n)
    x = np.arange(2 * 3 * 2 * n * 5 * 4, dtype=np.float32).reshape(
        2, 3, 2 * n * 5, 4)
    pre = tpar.zigzag_preshard(torch.from_numpy(x), n)
    np.testing.assert_array_equal(
        pre.numpy(), np.asarray(jring.zigzag_preshard(jnp.asarray(x), n)))
    np.testing.assert_array_equal(
        tpar.zigzag_postshard(pre, n).numpy(), x)
    np.testing.assert_array_equal(
        tpar.zigzag_postshard(torch.from_numpy(x), n, seq_axis=2).numpy(),
        np.asarray(jring.zigzag_postshard(jnp.asarray(x), n)))


def test_mla_context_parallel_ring(world):
    inputs, gathered, _ = world
    w_uk = jnp.asarray(inputs["mla/w_uk"])
    w_uv = jnp.asarray(inputs["mla/w_uv"])
    dh = w_uk.shape[1]

    def local(q, latent):
        q_lat = jnp.einsum("bhsd,hdc->bhsc", q, w_uk, precision="highest")
        c = latent[:, None]
        o_lat = jring.ring_attention(q_lat, c, c, "context", True,
                                     float(dh) ** -0.5, BS)
        return jnp.einsum("bhsc,hcd->bhsd", o_lat.astype(jnp.float32), w_uv,
                          precision="highest")

    with jax.default_matmul_precision("highest"):
        want = jax.jit(shard_map(
            local, mesh=_mesh(), in_specs=(SEQ, P(None, "context", None)),
            out_specs=SEQ, check_vma=False))(
                jnp.asarray(inputs["mla/q"]),
                jnp.asarray(inputs["mla/latent"]))
    err = float(np.max(np.abs(gathered["mla/o"] - np.asarray(want))))
    assert err <= TOL, err


def test_mesh_axes_and_placements(world):
    for checks in world[2]:
        mesh = checks["mesh"]
        assert mesh["names"] == ["data", "model", "context"]
        assert mesh["shape"] == [1, 1, N] and mesh["context_size"] == N
        assert mesh["batch"] == ["shard 0", "replicate", "shard 1"]
        assert mesh["replicated"] == [True] * 3
        assert "needs 8 ranks" in mesh["wrong_size"]
        assert checks["jax_loaded"] is False


def test_no_process_group_no_mesh_no_ring():
    """Importing the layer starts no process group, and without one every
    entry point raises (in this process, which has none)."""
    assert not dist.is_initialized()
    assert tpar.MeshAxes().all == ("data", "model", "context")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.make_mesh(1, 1, 4, device_type="cpu")
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.ring_attention(x, x, x)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.ulysses_attention(x, x, x)

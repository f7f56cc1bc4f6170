"""Port parity for expert parallelism (MoE) and pipeline parallelism.

The mirror of tests/test_moe_pipeline.py's MoE, pipeline and pipeline
remat tests.  The port runs in one world of 4 gloo CPU ranks, started once
for the module (``tests/test_torch_spmd.py::run_world``: subprocesses
that import only torch, numpy and the port).  Inputs: the JAX
``init_moe_params`` weights (numpy, carried across as arrays) and numpy
tokens and pipeline weights from a seed.  The JAX side: its
``moe_ffn_dense_reference``, ``jax.grad`` of the per-shard dense loss, its
sharded ``moe_ffn`` under ``shard_map`` where capacity drops tokens, and
the sequential stages; HIGHEST matmul precision.

The JAX test's gates: MoE against the dense reference atol 1e-5, its
gradients 1e-4; the pipeline's output 1e-5, gradients 2e-4, remat against
no remat 1e-5.  ``torch.topk`` may order tied probabilities unlike
``jax.lax.top_k``; the seeded random logits make a tie improbable.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from metal_flash_attention_plus_tpu.parallel.moe import (
    init_moe_params,
    moe_ffn,
    moe_ffn_dense_reference,
)
from metal_flash_attention_plus_tpu_torch.parallel import moe as tmoe
from metal_flash_attention_plus_tpu_torch.parallel import pipeline as tpipe
from tests.test_torch_spmd import run_world

N = 4
MOE = dict(num_experts=8, t=64, d=32, f=64)
PIPE = dict(n_stages=N, n_micro=8, m=16, d=32)

_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                        world_size=world, rank=rank)
from metal_flash_attention_plus_tpu_torch.parallel import (
    broadcast_from_last_stage,
    moe_ffn,
    pipeline_apply,
)
from metal_flash_attention_plus_tpu_torch.parallel.comm import all_reduce

arrays = {k: torch.from_numpy(v) for k, v in
          np.load(f"{out_dir}/inputs.npz").items()}
out = {}


def local(seed):
    p = {k.split("/")[1]: v for k, v in arrays.items()
         if k.startswith(f"moe{seed}/")}
    e = p["wg"].shape[0] // world
    return {k: v if k == "router" else v[rank * e:(rank + 1) * e]
            for k, v in p.items()}


for top_k in (1, 2):
    out[f"moe_top{top_k}"] = moe_ffn(local(0), arrays["x0"], top_k=top_k,
                                     capacity_factor=8.0).numpy()
out["moe_drops"] = moe_ffn(local(3), arrays["x3"], top_k=2,
                           capacity_factor=0.5).numpy()

params = {k: v.clone().requires_grad_(True) for k, v in local(5).items()}
t = arrays["x5"].shape[0] // world
y = moe_ffn(params, arrays["x5"][rank * t:(rank + 1) * t],
            capacity_factor=8.0)
g = torch.autograd.grad((y * y).sum(), [params["wd"], params["router"]])
out["moe_grad_wd"] = g[0].numpy()
out["moe_grad_router"] = all_reduce(g[1]).numpy()


def stage(w, x):
    return torch.tanh(x @ w)


for tag in ("0", "7", "13"):
    w = arrays[f"ws{tag}"][rank].clone().requires_grad_(True)
    xs = arrays[f"xs{tag}"]
    for remat in ((False, True) if tag == "13" else (False,)):
        o = broadcast_from_last_stage(pipeline_apply(stage, w, xs,
                                                     remat=remat))
        (gw,) = torch.autograd.grad((o * o).sum(), [w])
        key = f"pipe{tag}" + ("_remat" if remat else "")
        out[f"{key}/out"] = o.detach().numpy()
        out[f"{key}/grad"] = gw.numpy()

np.savez(f"{out_dir}/out_{rank}.npz", **out)
with open(f"{out_dir}/checks_{rank}.json", "w") as f:
    json.dump({"jax_loaded": any(m == "jax" or m.startswith(
        ("jax.", "metal_flash_attention_plus_tpu.")) for m in sys.modules)},
        f)
dist.destroy_process_group()
'''


def _moe_setup(seed):
    params = init_moe_params(jax.random.PRNGKey(seed), MOE["d"], MOE["f"],
                             MOE["num_experts"])
    x = np.random.default_rng(seed + 1).standard_normal(
        (MOE["t"], MOE["d"])).astype(np.float32)
    return {k: np.array(v) for k, v in params.items()}, x


def _pipe_setup(seed):
    g = np.random.default_rng(seed)
    d = PIPE["d"]
    ws = (g.standard_normal((PIPE["n_stages"], d, d)) * d ** -0.5).astype(
        np.float32)
    xs = g.standard_normal((PIPE["n_micro"], PIPE["m"], d)).astype(
        np.float32)
    return ws, xs


def _sequential(ws, xs):
    y = xs.reshape(-1, xs.shape[-1])
    for w in ws:
        y = jnp.tanh(y @ w)
    return y.reshape(xs.shape)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    arrays = {}
    for seed in (0, 3, 5):
        params, x = _moe_setup(seed)
        arrays.update({f"moe{seed}/{k}": v for k, v in params.items()})
        arrays[f"x{seed}"] = x
    for seed in (0, 7, 13):
        arrays[f"ws{seed}"], arrays[f"xs{seed}"] = _pipe_setup(seed)
    outs, checks = run_world(tmp_path_factory.mktemp("moe_pipe_world"),
                             _WORKER, {}, arrays, N)
    assert not any(c["jax_loaded"] for c in checks)
    return outs


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_dense_reference(world, top_k):
    params, x = _moe_setup(0)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(moe_ffn_dense_reference(_j(params), jnp.asarray(x),
                                                 top_k=top_k))
    for o in world:
        np.testing.assert_allclose(o[f"moe_top{top_k}"], ref, atol=1e-5)


def test_moe_capacity_drops_match_jax_sharded(world):
    """Capacity 0.5 drops tokens: finite, and equal to the JAX package's
    sharded ``moe_ffn`` under ``shard_map`` (the same drops)."""
    params, x = _moe_setup(3)
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("model",))
    f = shard_map(
        functools.partial(moe_ffn, axis_name="model", top_k=2,
                          capacity_factor=0.5),
        mesh=mesh,
        in_specs=(dict(router=P(), wg=P("model"), wu=P("model"),
                       wd=P("model")), P()),
        out_specs=P(), check_vma=False)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(f)(_j(params), jnp.asarray(x)))
        dense = np.asarray(moe_ffn_dense_reference(_j(params),
                                                   jnp.asarray(x)))
    assert np.abs(want - dense).max() > 1e-2  # tokens were dropped
    for o in world:
        assert np.isfinite(o["moe_drops"]).all()
        np.testing.assert_allclose(o["moe_drops"], want, atol=1e-5)


def test_moe_grads_flow(world):
    """Tokens sharded over the ranks, experts sharded, the router's
    gradient summed over the ranks: against ``jax.grad`` of the per-shard
    dense losses."""
    params, x = _moe_setup(5)

    def ref_loss(p):
        shards = jnp.asarray(x).reshape(N, -1, x.shape[-1])
        return sum(jnp.sum(moe_ffn_dense_reference(p, s) ** 2)
                   for s in shards)

    with jax.default_matmul_precision("highest"):
        ref = jax.grad(ref_loss)(_j(params))
    e = MOE["num_experts"] // N
    for r, o in enumerate(world):
        np.testing.assert_allclose(o["moe_grad_wd"],
                                   np.asarray(ref["wd"])[r * e:(r + 1) * e],
                                   atol=1e-4)
        np.testing.assert_allclose(o["moe_grad_router"],
                                   np.asarray(ref["router"]), atol=1e-4)


def test_moe_dense_reference_matches_jax():
    params, x = _moe_setup(0)
    got = tmoe.moe_ffn_dense_reference(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x))
    with jax.default_matmul_precision("highest"):
        want = moe_ffn_dense_reference(_j(params), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_init_moe_params_layout():
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 32, 64, 8,
                             dtype=torch.bfloat16, device="cpu")
    want = init_moe_params(jax.random.PRNGKey(0), 32, 64, 8, jnp.bfloat16)
    for k, v in want.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[-1] == str(v.dtype), k


def test_pipeline_forward_matches_sequential(world):
    ws, xs = _pipe_setup(0)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_sequential(jnp.asarray(ws), jnp.asarray(xs)))
    for o in world:
        np.testing.assert_allclose(o["pipe0/out"], want, atol=1e-5)


@pytest.mark.parametrize("key", ["pipe7", "pipe13", "pipe13_remat"])
def test_pipeline_grads_match_sequential(world, key):
    seed = int(key[4:].split("_")[0])
    ws, xs = _pipe_setup(seed)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.grad(lambda w: jnp.sum(
            _sequential(w, jnp.asarray(xs)) ** 2))(jnp.asarray(ws)))
    for r, o in enumerate(world):
        np.testing.assert_allclose(o[f"{key}/grad"], ref[r], atol=2e-4)


def test_pipeline_remat_grads_match(world):
    for o in world:
        np.testing.assert_allclose(o["pipe13_remat/grad"], o["pipe13/grad"],
                                   atol=1e-5)


def test_no_process_group_no_moe_no_pipeline():
    assert not dist.is_initialized()
    params = tmoe.init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4,
                                  device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmoe.moe_ffn(params, torch.zeros(4, 8))
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpipe.pipeline_apply(lambda w, x: x @ w, torch.eye(8),
                             torch.zeros(2, 4, 8))
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpipe.broadcast_from_last_stage(torch.zeros(3))

"""Port parity for the 3D-parallel (DP × TP × CP) transformer.

The mirror of tests/test_spmd.py and of
tests/test_moe_pipeline.py::TestRemat::test_spmd_remat_matches_golden.
The port runs in one world of 4 gloo CPU ranks, started once for the
module: 4 subprocesses that import only torch, numpy and the port (the
worker's source is below), rendezvous through a ``FileStore`` in the
test's temporary directory, take the JAX ``init_params`` weights through
``params_from_jax`` and the same numpy tokens, and write each case's loss
and local gradient shards; the test reassembles the shards by
``param_specs``.  The JAX side is the unsharded golden model:
``jax.value_and_grad(loss_fn)`` and ``forward`` at HIGHEST matmul
precision with the Pallas kernels in interpret mode (no ``shard_map``).

Gates, the JAX test's: loss rtol 1e-5; gradients atol 3e-4, rtol 1e-3;
logits atol 2e-4, rtol 1e-3.  The ranks that hold the same shard of a
gradient (replicas over data and context) hold the same bits.
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
from jax.sharding import Mesh

import __graft_entry__ as graft
from metal_flash_attention_plus_tpu.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
)
from metal_flash_attention_plus_tpu.ops.flash_attention import BlockSizes
from metal_flash_attention_plus_tpu.parallel import spmd as jspmd
from metal_flash_attention_plus_tpu_torch import entry as tentry
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig as TorchConfig,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    init_params as tinit_params,
)
from metal_flash_attention_plus_tpu_torch.parallel import spmd as tspmd

REPO = Path(__file__).resolve().parents[1]
N = 4
AXES = ("data", "model", "context")
CFG_KW = dict(vocab_size=512, d_model=128, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=64, d_ff=256, max_seq=256)
CFG = TransformerConfig(
    **CFG_KW, dtype=jnp.float32,
    block_sizes=BlockSizes(block_q=128, block_kv=128, block_q_dkv=128,
                           block_kv_dkv=128, block_q_dq=128,
                           block_kv_dq=128))
# case: (mesh (data, model, context), attention mode, remat)
CASES = {
    "local_2x2x1": ((2, 2, 1), "local", False),
    "ring_1x2x2": ((1, 2, 2), "ring", False),
    "ring_2x1x2": ((2, 1, 2), "ring", False),
    "ulysses_1x2x2": ((1, 2, 2), "ulysses", False),
    "remat_ring_1x2x2": ((1, 2, 2), "ring", True),
}
FORWARD_MESH = (2, 1, 2)
# validate_mesh: (mesh, attention mode, config overrides) → JAX's message
VALIDATE = {
    "kv_heads": ((1, 4, 1), "ring", {}),
    "d_ff": ((2, 2, 1), "local", {"d_ff": 255}),
    "ulysses_heads": ((1, 1, 4), "ulysses", {"num_heads": 2}),
    "local_context": ((1, 2, 2), "local", {}),
    "valid": ((1, 2, 2), "ring", {}),
}

_WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                        world_size=world, rank=rank)
from metal_flash_attention_plus_tpu_torch.models.convert import (
    params_from_jax,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
)
from metal_flash_attention_plus_tpu_torch.parallel import make_mesh
from metal_flash_attention_plus_tpu_torch.parallel import spmd

spec = json.load(open(f"{out_dir}/spec.json"))
arrays = dict(np.load(f"{out_dir}/inputs.npz"))
cfg = TransformerConfig(**spec["cfg"], dtype=torch.float32)
tree = {"embed": arrays["embed"], "ln_f": arrays["ln_f"],
        "unembed": arrays["unembed"],
        "layers": [{k.split(".")[-1]: v for k, v in arrays.items()
                    if k.startswith(f"layers.{i}.")}
                   for i in range(cfg.num_layers)]}
params = params_from_jax(tree, device="cpu")
tokens = torch.from_numpy(arrays["tokens"])
out, checks = {}, {}


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


for case, (shape, mode, remat) in spec["cases"].items():
    c = dataclasses.replace(cfg, remat=remat)
    mesh = make_mesh(*shape, device_type="cpu")
    sc = spmd.ShardingConfig(attn_mode=mode)
    local = spmd.shard_params(params, mesh, c, sc)
    loss, grads = spmd.make_spmd_loss_and_grad(c, mesh, sc)(
        local, tokens[:, :-1], tokens[:, 1:])
    out[f"{case}/loss"] = loss.numpy()
    for path, g in paths(grads):
        out[f"{case}/{path}"] = g.numpy()

mesh = make_mesh(*spec["forward_mesh"], device_type="cpu")
sc = spmd.ShardingConfig(attn_mode="ring")
out["forward"] = spmd.spmd_forward(spmd.shard_params(params, mesh, cfg, sc),
                                   tokens[:, :-1], cfg, mesh, sc).numpy()

errors = {}
for name, (shape, mode, kw) in spec["validate"].items():
    try:
        spmd.validate_mesh(dataclasses.replace(cfg, **kw),
                           make_mesh(*shape, device_type="cpu"),
                           spmd.ShardingConfig(attn_mode=mode))
        errors[name] = None
    except ValueError as e:
        errors[name] = str(e)
checks["validate"] = errors
checks["jax_loaded"] = any(m == "jax" or m.startswith(
    ("jax.", "metal_flash_attention_plus_tpu.")) for m in sys.modules)
np.savez(f"{out_dir}/out_{rank}.npz", **out)
with open(f"{out_dir}/checks_{rank}.json", "w") as f:
    json.dump(checks, f)
dist.destroy_process_group()
'''


def _jax_params():
    return init_params(CFG, jax.random.PRNGKey(0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def run_world(d, worker, spec, arrays, n, timeout=240):
    """Start ``n`` gloo ranks of ``worker`` in ``d`` and wait for them."""
    np.savez(d / "inputs.npz", **arrays)
    (d / "spec.json").write_text(json.dumps(spec))
    (d / "worker.py").write_text(worker)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(d / "worker.py"), str(r), str(n), str(d)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)
    outs = [dict(np.load(d / f"out_{r}.npz")) for r in range(n)]
    checks = [json.loads((d / f"checks_{r}.json").read_text())
              for r in range(n)]
    return outs, checks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's world of N gloo ranks, run once → (each rank's outputs,
    each rank's checks)."""
    params = jax.tree.map(np.asarray, _jax_params())
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 257))
    arrays = {**_flat(params), "tokens": tokens}
    spec = {"cfg": CFG_KW, "cases": CASES, "forward_mesh": FORWARD_MESH,
            "validate": VALIDATE}
    return run_world(tmp_path_factory.mktemp("spmd_world"), _WORKER, spec,
                     arrays, N)


@pytest.fixture(scope="module")
def golden():
    """The JAX golden loss, gradients and logits on the same inputs."""
    params = _jax_params()
    tokens = jnp.asarray(np.random.default_rng(1).integers(
        0, CFG.vocab_size, (2, 257)))
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn), static_argnums=2)(
            params, tokens, CFG)
        logits = jax.jit(forward, static_argnums=2)(params, tokens[:, :-1],
                                                    CFG)
    return (float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()},
            np.asarray(logits))


def _unflat(arrays, like, prefix=""):
    """``_flat``'s inverse: the tree shaped as ``like`` whose leaf at path
    p is ``arrays[prefix + p]`` as a tensor."""
    if isinstance(like, dict):
        return {k: _unflat(arrays, v, f"{prefix}{k}.")
                for k, v in like.items()}
    if isinstance(like, list):
        return [_unflat(arrays, v, f"{prefix}{i}.")
                for i, v in enumerate(like)]
    return torch.from_numpy(arrays[prefix[:-1]])


def _gathered(outs, case, shape):
    """Each gradient reassembled from the ranks' shards by
    ``unshard_params``; raises unless its replicas agree bit for bit."""
    cfg = TorchConfig(**CFG_KW)
    specs = tspmd.param_specs(cfg)
    shards = {}
    for m in range(shape[1]):
        reps = [outs[tspmd.mesh_rank((d, m, c), shape)]
                for d in range(shape[0]) for c in range(shape[2])]
        for path in _flat(specs):
            for r in reps[1:]:
                np.testing.assert_array_equal(
                    r[f"{case}/{path}"], reps[0][f"{case}/{path}"],
                    err_msg=path)
        shards[m] = _unflat(reps[0], specs, f"{case}/")
    return {k: v.numpy()
            for k, v in _flat(tspmd.unshard_params(shards, cfg)).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_spmd_loss_and_grads_match_golden(world, golden, case):
    outs, _ = world
    loss_ref, grads_ref, _ = golden
    shape = CASES[case][0]
    losses = [float(o[f"{case}/loss"]) for o in outs]
    assert len(set(losses)) == 1, losses  # the same bits on every rank
    np.testing.assert_allclose(losses[0], loss_ref, rtol=1e-5)
    grads = _gathered(outs, case, shape)
    assert grads.keys() == grads_ref.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g, grads_ref[path], atol=3e-4, rtol=1e-3,
                                   err_msg=f"{case} {path}")


def test_spmd_forward_matches_golden(world, golden):
    outs, _ = world
    want = golden[2]
    for o in outs:
        assert o["forward"].shape == want.shape
        np.testing.assert_allclose(o["forward"], want, atol=2e-4, rtol=1e-3)


def test_validate_mesh_raises_where_jax_raises(world):
    _, checks = world
    for name, (shape, mode, kw) in VALIDATE.items():
        mesh = Mesh(np.asarray(jax.devices()[:N]).reshape(shape), AXES)
        cfg = TransformerConfig(**{**CFG_KW, **kw}, dtype=jnp.float32)
        try:
            jspmd.validate_mesh(cfg, mesh, jspmd.ShardingConfig(
                attn_mode=mode))
            want = None
        except ValueError as e:
            want = str(e)
        assert (want is None) == (name == "valid"), (name, want)
        for c in checks:
            assert c["validate"][name] == want, name
    assert not any(c["jax_loaded"] for c in checks)


def test_param_specs_and_sync_groups_match_jax():
    """The placements say over which axis each dimension is sharded, as
    the JAX PartitionSpecs do; the sync groups are JAX's strings."""
    want = _flat(jspmd.param_specs(CFG))
    got = _flat(tspmd.param_specs(TorchConfig(**CFG_KW)))
    assert got.keys() == want.keys()
    for path, spec in want.items():
        sharded = {axis: dim for dim, axis in enumerate(spec)
                   if axis is not None}
        mine = {AXES[i]: p.dim for i, p in enumerate(got[path])
                if p.is_shard()}
        assert mine == sharded, path
    assert (tspmd._grad_sync_groups(TorchConfig(**CFG_KW))
            == jspmd._grad_sync_groups(CFG))


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_equals_jax(n):
    for max_tp in (1, 2, 4):
        assert tentry._factor_mesh(n, max_tp) == graft._factor_mesh(n, max_tp)


def test_sharding_config_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tspmd.ShardingConfig(attn_mode="dense")


def test_no_process_group_no_psum():
    assert not dist.is_initialized()
    x = torch.ones(3)
    for fn in (tspmd.psum_tp, tspmd.psum_id):
        with pytest.raises(RuntimeError, match="init_process_group"):
            fn(x)


def test_unshard_params_inverts_the_model_split():
    """``unshard_params`` joins the model ranks' contiguous shards back
    into the full tree, and ``mesh_rank`` numbers the mesh row-major."""
    cfg = TorchConfig(**CFG_KW)
    full = tinit_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = tspmd.param_specs(cfg)
    at = AXES.index("model")

    def cut(m):
        return tspmd._tree_map(
            lambda x, p: (x.chunk(2, dim=p[at].dim)[m] if p[at].is_shard()
                          else x), full, specs)

    got = _flat(tspmd.unshard_params({1: cut(1), 0: cut(0)}, cfg))
    for path, want in _flat(full).items():
        assert torch.equal(got[path], want), path
    ranks = [tspmd.mesh_rank((d, m, c), (2, 3, 2)) for d in range(2)
             for m in range(3) for c in range(2)]
    assert ranks == list(range(12))

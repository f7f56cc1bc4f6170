"""Port parity for multi-process training and the multi-rank dry run.

The mirror of tests/test_multiprocess.py: 2 OS processes, each one gloo
rank that imports only torch, numpy and the port, train a two-layer MLP
for 3 SGD steps, once data-parallel (mesh (2, 1, 1): the batch split over
the ranks, the gradients summed over ``data``) and once tensor-parallel
(mesh (1, 2, 1): the hidden width split, the output summed through
``psum_id``).  Both ranks must print the same final loss (the collectives
crossed the process boundary), equal to the single-process JAX reference
on the same numpy inputs at 1e-6 relative.  Then ``python -m
metal_flash_attention_plus_tpu_torch.entry dryrun 4 --device cpu`` must
print the JAX ``dryrun_multichip``'s three ``OK`` lines.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parents[1]

_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                        world_size=world, rank=rank)
from metal_flash_attention_plus_tpu_torch.parallel import make_mesh
from metal_flash_attention_plus_tpu_torch.parallel.comm import all_reduce
from metal_flash_attention_plus_tpu_torch.parallel.spmd import psum_id

arrays = {k: torch.from_numpy(v) for k, v in
          np.load(f"{out_dir}/inputs.npz").items()}
losses = {}
for data, model in ((2, 1), (1, 2)):
    mesh = make_mesh(data, model, 1, device_type="cpu")
    dg, mg = mesh.get_group("data"), mesh.get_group("model")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    cols, rows = 128 // model, 16 // data
    w1 = arrays["w1"][:, m * cols:(m + 1) * cols].clone()
    w2 = arrays["w2"][m * cols:(m + 1) * cols].clone()
    x = arrays["x"][d * rows:(d + 1) * rows]
    y = arrays["y"][d * rows:(d + 1) * rows]
    n = arrays["y"].numel()
    for step in range(3):
        w1.requires_grad_(True)
        w2.requires_grad_(True)
        h = torch.relu(x @ w1)
        lsum = ((psum_id(h @ w2, mg) - y) ** 2).sum()
        g1, g2 = torch.autograd.grad(lsum, [w1, w2])
        loss = all_reduce(lsum.detach(), dg) / n
        with torch.no_grad():
            w1 = w1 - 0.1 * all_reduce(g1, dg) / n
            w2 = w2 - 0.1 * all_reduce(g2, dg) / n
    losses[f"{data}x{model}"] = loss.item()
with open(f"{out_dir}/losses_{rank}.json", "w") as f:
    json.dump(losses, f)
dist.destroy_process_group()
'''


def _inputs():
    g = np.random.default_rng(0)
    return {"w1": (g.standard_normal((64, 128)) * 0.05).astype(np.float32),
            "w2": (g.standard_normal((128, 64)) * 0.05).astype(np.float32),
            "x": g.standard_normal((16, 64)).astype(np.float32),
            "y": g.standard_normal((16, 64)).astype(np.float32)}


def _jax_final_loss(a):
    def loss(w1, w2, x, y):
        h = jnp.maximum(x @ w1, 0.0)
        return jnp.mean((h @ w2 - y) ** 2)

    w1, w2 = jnp.asarray(a["w1"]), jnp.asarray(a["w2"])
    x, y = jnp.asarray(a["x"]), jnp.asarray(a["y"])
    with jax.default_matmul_precision("highest"):
        f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
        for _ in range(3):
            val, (g1, g2) = f(w1, w2, x, y)
            w1, w2 = w1 - 0.1 * g1, w2 - 0.1 * g2
    return float(val)


def test_two_process_dp_tp_train_step(tmp_path):
    a = _inputs()
    np.savez(tmp_path / "inputs.npz", **a)
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r), "2",
         str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    ranks = [json.loads((tmp_path / f"losses_{r}.json").read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1], ranks  # the same global loss, bit for bit
    want = _jax_final_loss(a)
    for mesh, val in ranks[0].items():
        np.testing.assert_allclose(val, want, rtol=1e-6, err_msg=mesh)


def test_dryrun_multichip_prints_three_ok_lines():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "metal_flash_attention_plus_tpu_torch.entry",
         "dryrun", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 3, proc.stdout
    m = re.fullmatch(r"dryrun_multichip OK: mesh\(data=1, model=2, "
                     r"context=2\), loss=([0-9.]+)", lines[0])
    assert m and np.isfinite(float(m.group(1))), lines[0]
    assert lines[1] == "dryrun EP OK: 4 experts-axis devices, out (64, 64)"
    assert lines[2] == "dryrun PP OK: 4 pipeline stages, out (4, 8, 32)"

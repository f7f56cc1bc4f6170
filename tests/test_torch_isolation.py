"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of the port (and the module of
``chip_smoke.py``) and then lists what is loaded.  The JAX package's name
is a prefix of the port's, so the check matches the exact key
``metal_flash_attention_plus_tpu`` and keys under
``metal_flash_attention_plus_tpu.``, never a bare prefix.
"""

import functools
import json
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "metal_flash_attention_plus_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import {port}
names = [m.name for m in pkgutil.walk_packages({port}.__path__, "{port}.")]
for name in names:
    importlib.import_module(name)
import ast, importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))  # not __main__
tree = ast.parse(open("chip_smoke.py").read())
smoke_imports = sorted(
    {{a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
      for a in n.names}}
    | {{n.module for n in ast.walk(tree)
       if isinstance(n, ast.ImportFrom) and n.module}}
)
print(json.dumps({{"modules": names, "loaded": sorted(sys.modules),
                  "smoke_imports": smoke_imports}}))
"""


def _is_jax_or_reference(name: str) -> bool:
    ref = "metal_flash_attention_plus_tpu"
    return (
        name == "jax" or name.startswith("jax.")
        or name == "jaxlib" or name.startswith("jaxlib.")
        or name == ref or name.startswith(ref + ".")
    )


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(port=PORT)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("serving.engine", "models.cached", "models.transformer",
                   "attention.masking", "ops.flash_attention",
                   "ops.flash_attention_bwd", "entry", "quant.tensor",
                   "ops.quantized_gemm", "models.quantized_inference",
                   "ops.quantized_attention", "ops.runtime_quantization",
                   "ops.hadamard", "attention.quantized",
                   "attention.descriptor", "attention.multi_head",
                   "attention.tuning", "runtime.native", "utils.profiling",
                   "parallel.mesh", "parallel.ring", "parallel.ulysses",
                   "parallel.comm", "parallel.spmd", "parallel.moe",
                   "parallel.pipeline", "quant.serialization",
                   "models.checkpoint", "utils.debug", "utils.testing"):
        assert f"{PORT}.{module}" in report["modules"], module
    leaked = [m for m in report["loaded"] if _is_jax_or_reference(m)]
    assert leaked == [], leaked
    smoke = [m for m in report["smoke_imports"] if _is_jax_or_reference(m)]
    assert smoke == [], smoke


def test_exact_key_check_tells_the_packages_apart():
    assert _is_jax_or_reference("metal_flash_attention_plus_tpu")
    assert _is_jax_or_reference("metal_flash_attention_plus_tpu.serving")
    assert not _is_jax_or_reference(PORT)
    assert not _is_jax_or_reference(PORT + ".serving.engine")


@functools.lru_cache(maxsize=None)
def _parallel_probe():
    """What the distributed layer's entry points raise in a fresh
    interpreter with no process group, and, where there is no card, what
    the dry run and the MoE initializer say when asked for one."""
    probe = r"""
import json
import torch
from metal_flash_attention_plus_tpu_torch import entry
from metal_flash_attention_plus_tpu_torch.parallel import (
    broadcast_from_last_stage, comm, init_moe_params, moe_ffn,
    pipeline_apply, spmd)

def error(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return type(e).__name__ + ": " + str(e)
    return None

x = torch.zeros(4, 8)
p = init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4, device="cpu")
group = {
    "psum_tp": error(lambda: spmd.psum_tp(x)),
    "psum_id": error(lambda: spmd.psum_id(x)),
    "all_reduce": error(lambda: comm.all_reduce(x)),
    "all_gather": error(lambda: comm.all_gather(x)),
    "ring_shift": error(lambda: comm.ring_shift(x)),
    "all_to_all": error(lambda: comm.all_to_all(x)),
    "moe_ffn": error(lambda: moe_ffn(p, x)),
    "pipeline_apply": error(lambda: pipeline_apply(
        lambda w, y: y @ w, torch.eye(8), x[None])),
    "broadcast": error(lambda: broadcast_from_last_stage(x)),
}
card = None if torch.cuda.is_available() else {
    "dryrun_card": error(lambda: entry.dryrun_multichip(2)),
    "moe_init_card": error(lambda: init_moe_params(
        torch.Generator().manual_seed(0), 8, 16, 4)),
}
print(json.dumps({"group": group, "card": card}))
"""
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_parallel_entry_points_raise_without_card_or_group():
    """With no process group the distributed layer's entry points raise,
    and nothing falls back silently to a single rank."""
    for name, err in _parallel_probe()["group"].items():
        assert err is not None and "init_process_group" in err, (name, err)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where there is no card")
def test_parallel_entry_points_refuse_a_missing_card():
    """Without a card the dry run and the MoE initializer refuse to run on
    one rather than fall back to the CPU."""
    card = _parallel_probe()["card"]
    for name in ("dryrun_card", "moe_init_card"):
        assert "no CUDA device" in card[name], name

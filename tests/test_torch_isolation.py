"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of the port (and the module of
``chip_smoke.py``) and then lists what is loaded.  The JAX package's name
is a prefix of the port's, so the check matches the exact key
``metal_flash_attention_plus_tpu`` and keys under
``metal_flash_attention_plus_tpu.``, never a bare prefix.
"""

import json
import pathlib
import subprocess
import sys

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
                   "parallel.comm", "quant.serialization",
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

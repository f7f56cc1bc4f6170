"""Builds the port's native libraries at first use and loads them.

Two libraries, both with a plain C interface loaded through ctypes:

- ``libmfa_kernels``: every ``csrc/*.cu`` compiled by ``nvcc`` for Hopper
  (``sm_90a``).  No PyTorch header is included, so the build takes
  seconds rather than the minutes ``torch.utils.cpp_extension.load`` needs.
- ``libmfa_runtime``: the host scheduler and page allocator, compiled by
  ``g++`` from the repository's ``cpp/mfa_runtime.cc`` (read, never
  written: the result goes to this package's build directory).

Outputs go to ``BUILD_DIR`` (listed in ``.gitignore``) under a name that
carries a hash of the sources and the command, so an edited source is
rebuilt and a stale library is never loaded.  Each build writes a
temporary file and ``os.replace``s it into place, so parallel test
workers that build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent
BUILD_DIR = PACKAGE_DIR / "_build"
CSRC_DIR = PACKAGE_DIR / "csrc"
RUNTIME_SOURCE = REPO_ROOT / "cpp" / "mfa_runtime.cc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when an existing
# build was reused) — chip_smoke.py prints them.
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed"
    )


def _build(
    name: str, sources: Sequence[Path], command: Callable[[str], List[str]]
) -> Path:
    """Compile ``sources`` with ``command(out_path)`` unless a library with
    the same content hash exists; returns the library's path."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(command("OUT")).encode())
    target = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if target.exists():
        build_seconds[name] = 0.0
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            command(tmp), capture_output=True, text=True, timeout=600
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[name] = time.perf_counter() - t0
    return target


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``kernels`` or ``runtime``."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        if name == "kernels":
            sources = sorted(CSRC_DIR.glob("*.cu"))
            nvcc = _nvcc()
            path = _build(
                "mfa_kernels", sources,
                lambda out: [nvcc, *NVCC_FLAGS, "-o", out,
                             *map(str, sources)],
            )
        elif name == "runtime":
            path = _build(
                "mfa_runtime", [RUNTIME_SOURCE],
                lambda out: ["g++", *GXX_FLAGS, "-o", out,
                             str(RUNTIME_SOURCE)],
            )
        else:
            raise ValueError(f"unknown library {name!r}")
        _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]

"""Builds the port's native libraries at first use and loads them.

Two libraries, both with a plain C interface loaded through ctypes:

- ``libmfa_kernels``: every ``csrc/*.cu`` compiled by ``nvcc`` for Hopper
  (``sm_90a``), one ``nvcc`` per source, all started together, then
  linked into one library.  No PyTorch header is included, so the build
  takes seconds rather than the minutes ``torch.utils.cpp_extension.load``
  needs.
- ``libmfa_runtime``: the host scheduler and page allocator, compiled by
  ``g++`` from the repository's ``cpp/mfa_runtime.cc`` (read, never
  written: the result goes to this package's build directory).

Outputs go to ``BUILD_DIR`` (listed in ``.gitignore``) under a name that
carries a hash of the sources and the command, so an edited source is
rebuilt and a stale library is never loaded.  Each build writes a
temporary directory and ``os.replace``s the library into place, so
parallel test workers that build at once never load a half-written one.

:func:`kernel_function` declares a kernel entry point's ctypes signature
and :func:`check_launch` turns a nonzero return code into an error;
:func:`recording` collects the entry points that a call asks for
(``utils/debug.py::dump_lowered`` names the kernels behind them).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Sequence, Set

PACKAGE_DIR = Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent
BUILD_DIR = PACKAGE_DIR / "_build"
CSRC_DIR = PACKAGE_DIR / "csrc"
RUNTIME_SOURCE = REPO_ROOT / "cpp" / "mfa_runtime.cc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
]
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when an existing
# build was reused), and each of its commands ("<library> <source>", "<library>
# link") — chip_smoke.py prints them.
build_seconds: Dict[str, float] = {}
# The open recorders of :func:`recording`: each collects the names
# :func:`kernel_function` is asked for while it is open.
_recorders: List[Set[str]] = []


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


def _run_parallel(name: str, commands: Sequence[List[str]]) -> List[float]:
    """Run ``commands`` at once; raise with every failure's output.
    Returns each command's seconds."""
    results: List = [None] * len(commands)

    def run(i, cmd):
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            results[i] = (p.returncode, p.stdout, p.stderr)
        except subprocess.TimeoutExpired:  # run() has killed it
            results[i] = (-1, "", "timed out after 600 s")
        results[i] += (time.perf_counter() - t0,)

    threads = [threading.Thread(target=run, args=(i, c))
               for i, c in enumerate(commands)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failures = [f"{' '.join(cmd)} ({rc}):\n{out}\n{err}"
                for cmd, (rc, out, err, _) in zip(commands, results) if rc]
    if failures:
        raise RuntimeError(f"building {name} failed:\n" + "\n".join(failures))
    return [r[3] for r in results]


def _build(
    name: str,
    inputs: Sequence[Path],
    recipe: Callable[[str, str], List[List[List[str]]]],
) -> Path:
    """Build a library unless one with the same content hash exists;
    returns its path.

    ``recipe(out, workdir)`` gives the build as stages, each a list of
    commands run in parallel (the kernels: one ``nvcc -c`` per source, then
    the link).  The hash covers ``inputs`` (sources and headers) and the
    commands.
    """
    h = hashlib.sha256()
    for src in inputs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr(recipe("OUT", "WORK")).encode())
    target = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if target.exists():
        build_seconds[name] = 0.0
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f".{name}-",
                                     dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        for stage in recipe(tmp, work):
            for cmd, sec in zip(stage, _run_parallel(name, stage)):
                what = Path(cmd[-1]).name if "-c" in cmd else "link"
                build_seconds[f"{name} {what}"] = sec
        os.replace(tmp, target)
    build_seconds[name] = time.perf_counter() - t0
    return target


def build_kernels(csrc_dir: Path = CSRC_DIR,
                  name: str = "mfa_kernels") -> Path:
    """Build every ``*.cu`` of ``csrc_dir`` (one ``nvcc`` each, all started
    together, then the link) into ``BUILD_DIR/lib<name>-<hash>.so``."""
    sources = sorted(csrc_dir.glob("*.cu"))
    headers = sorted(csrc_dir.glob("*.cuh"))
    nvcc = _nvcc()

    def recipe(out, work):
        objs = [os.path.join(work, src.stem + ".o") for src in sources]
        return [
            [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
             for src, obj in zip(sources, objs)],
            [[nvcc, "-shared", "-o", out, *objs]],
        ]

    return _build(name, [*sources, *headers], recipe)


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``kernels`` or ``runtime``."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        if name == "kernels":
            path = build_kernels()
        elif name == "runtime":
            path = _build(
                "mfa_runtime", [RUNTIME_SOURCE],
                lambda out, work: [[["g++", *GXX_FLAGS, "-o", out,
                                     str(RUNTIME_SOURCE)]]],
            )
        else:
            raise ValueError(f"unknown library {name!r}")
        _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


def kernel_function(name: str, argtypes: Sequence) -> Callable[..., int]:
    """The kernels library's C entry point ``name``: returns a
    ``cudaError_t`` as int; pointers and the stream are ``c_void_p``."""
    fn = getattr(load_library("kernels"), name)
    for names in _recorders:
        names.add(name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


@contextlib.contextmanager
def recording() -> Iterator[Set[str]]:
    """Collect the entry points :func:`kernel_function` hands out inside
    the ``with`` block (every launch asks for its entry point)."""
    names: Set[str] = set()
    _recorders.append(names)
    try:
        yield names
    finally:
        _recorders.remove(names)


def check_launch(rc: int, name: str):
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if rc != 0:
        lib = load_library("kernels")
        lib.mfa_error_string.restype = ctypes.c_char_p
        lib.mfa_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.mfa_error_string(rc).decode()}"
        )

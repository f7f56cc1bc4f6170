"""Debugging and observability: the JAX package's ``utils/debug.py`` on
Hopper.

- ``MFA_DEBUG=1`` turns on :func:`log`.
- :func:`dump_lowered` writes the artifact that plays StableHLO's role:
  the traced graph of a call (``make_fx``: the ATen operations it runs),
  and, where its arguments are on the card, the SASS of the port's
  kernels that the call launched (``cuobjdump -sass`` of the built
  kernel library, the functions of those kernels only).  The file goes
  to ``MFA_DUMP_DIR`` (default: the temporary directory, ``/tmp`` unless
  ``TMPDIR`` says otherwise), for diffing what the compiler made across
  versions.
- :func:`trace` wraps ``torch.profiler`` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from metal_flash_attention_plus_tpu_torch import _build

# The kernels each C entry point of the kernel library may launch
# (tests/test_torch_checkpoint_debug.py holds the table to csrc/).
ENTRY_KERNELS: Dict[str, Tuple[str, ...]] = {
    "mfa_flash_fwd": ("flash_fwd_tc_kernel", "flash_fwd_wide_kernel",
                      "flash_fwd_latent_kernel", "flash_fwd_kernel",
                      "split_d_fwd_kernel"),
    "mfa_flash_dq": ("flash_dq_tc_kernel", "flash_dq_wide_kernel",
                     "flash_dq_latent_kernel", "flash_dq_kernel",
                     "split_d_dq_kernel"),
    "mfa_flash_dkv": ("flash_dkv_tc_kernel", "flash_dkv_wide_kernel",
                      "flash_dkv_latent_kernel", "flash_dkv_kernel",
                      "split_d_dkv_kernel"),
    "mfa_flash_dkv_merge": ("flash_dkv_merge_kernel",),
    "mfa_split_d_fwd_merge": ("split_d_fwd_merge_kernel",),
    "mfa_split_d_dq_merge": ("split_d_dq_merge_kernel",),
    "mfa_paged_decode": ("paged_decode_tc_kernel", "paged_decode_kernel",
                         "split_d_decode_kernel",
                         "paged_decode_merge_kernel"),
    "mfa_paged_prefill": ("paged_prefill_tc_kernel",
                          "paged_prefill_wide_kernel",
                          "paged_prefill_kernel", "split_d_prefill_kernel"),
    "mfa_qattn_fwd": ("qattn_fwd_tc_kernel", "qattn_fwd_wide_kernel",
                      "qattn_fwd_latent_kernel", "qattn_fwd_kernel",
                      "split_d_qattn_kernel"),
    "mfa_hpack_fwd": ("qattn_fwd_tc_kernel", "qattn_fwd_kernel"),
    "mfa_qflash_bwd": ("qflash_dq_tc_kernel", "qflash_dq_wide_kernel",
                       "qflash_dq_latent_kernel", "qflash_dq_kernel",
                       "qflash_dkv_tc_kernel", "qflash_dkv_wide_kernel",
                       "qflash_dkv_latent_kernel", "qflash_dkv_kernel",
                       "split_d_qdq_kernel", "split_d_qdkv_kernel"),
    "mfa_fullint_bwd": ("fullint_dq_tc_kernel", "fullint_dq_kernel",
                        "fullint_dq32_kernel", "fullint_dkv_tc_kernel",
                        "fullint_dkv_kernel", "fullint_dkv32_kernel",
                        "split_d_fullint_dq_kernel",
                        "split_d_fullint_dkv_kernel"),
    "mfa_dyn_gemm": ("dyn_tc_kernel",),
    "mfa_wo_folded_gemm": ("wo_tc_kernel", "wo_kernel", "wo_reduce_kernel"),
    "mfa_wo_gemm": ("wo_tc_kernel", "wo_kernel", "wo_reduce_kernel"),
    "mfa_qa_folded_gemm": ("qa_tc_kernel", "qa_kernel"),
    "mfa_qa_gemm": ("qa_tc_kernel", "qa_kernel"),
    "mfa_comp_gemm": ("comp_tc_kernel",),
    "mfa_comp_small_tc_gemm": ("comp_tc_kernel",),
    "mfa_comp_small_gemm": ("comp_small_kernel",),
    "mfa_rtq_rows": ("rtq_row_kernel",),
    "mfa_rtq_blocks": ("rtq_block_kernel",),
}


def debug_enabled() -> bool:
    return os.environ.get("MFA_DEBUG") == "1"


def log(*args) -> None:
    if debug_enabled():
        print("[mfa]", *args, flush=True)


def dump_dir(path: Optional[str] = None) -> Path:
    """``path``, else ``MFA_DUMP_DIR``, else the temporary directory."""
    out = Path(path or os.environ.get("MFA_DUMP_DIR")
               or tempfile.gettempdir())
    out.mkdir(parents=True, exist_ok=True)
    return out


def kernels_of(entry_points: Iterable[str]) -> List[str]:
    """The kernels the named entry points may launch, sorted (names that
    launch nothing, such as the body queries, contribute none)."""
    return sorted({k for e in entry_points for k in ENTRY_KERNELS.get(e, ())})


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found: the SASS dump needs the CUDA "
                       "toolkit")


def _source_names(symbol: str) -> List[str]:
    """The length-prefixed names at the head of an Itanium-mangled symbol
    (namespaces, then the function: ``_ZN12_GLOBAL__N_119flash_fwd_tc_
    kernelI...`` → ``_GLOBAL__N_1``, ``flash_fwd_tc_kernel``); a plain
    name → itself."""
    head = re.match(r"_ZN?", symbol)
    if head is None:
        return [symbol]
    names, i = [], head.end()
    while True:
        n = re.match(r"\d+", symbol[i:])
        if n is None:
            return names
        i += n.end()
        names.append(symbol[i:i + int(n.group())])
        i += int(n.group())


def sass_sections(text: str, kernels: Iterable[str]) -> Dict[str, str]:
    """The ``Function : <name>`` sections of ``cuobjdump -sass`` output
    whose function is one of ``kernels`` → {symbol: its SASS}.  The
    symbol is matched by its mangled names (so ``wo_kernel`` never matches
    inside a longer name), or, demangled, as a whole word."""
    wanted = set(kernels)

    def keep(symbol):
        if symbol.startswith("_Z"):
            return bool(wanted & set(_source_names(symbol)))
        return any(re.search(rf"\b{k}\b", symbol) for k in wanted)

    out, name, lines = {}, None, []
    for line in text.splitlines(keepends=True):
        head = re.match(r"\s*Function\s*:\s*(.+?)\s*$", line)
        if head or re.match(r"\s*Fatbin ", line):
            if name is not None and keep(name):
                out[name] = "".join(lines)
            name, lines = (head.group(1) if head else None), []
        if name is not None:
            lines.append(line)
    if name is not None and keep(name):
        out[name] = "".join(lines)
    return out


def _run(cmd: List[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout


def kernel_symbols(lib: str, kernels: Iterable[str]) -> List[str]:
    """The mangled device-function symbols of ``lib`` (``cuobjdump
    -symbols``) that are instances of ``kernels``."""
    wanted = set(kernels)
    out = []
    for line in _run([_cuobjdump(), "-symbols", lib]).splitlines():
        if "STT_FUNC" in line:
            sym = line.split()[-1]
            if sym.startswith("_Z") and wanted & set(_source_names(sym)):
                out.append(sym)
    return sorted(set(out))


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def dump_lowered(fn, *example_args, name: str = "mfa_kernel",
                 path: Optional[str] = None) -> str:
    """Trace ``fn(*example_args)`` and write what it lowers to; returns the
    file's path (``<dir>/<name>.lowered.txt``).

    The file holds the traced ATen graph (``make_fx`` in real mode: the
    call runs once, kernels included).  Where an argument is on the card
    it also names the kernel entry points the call asked for, the kernels
    behind them, and their SASS.  Opt-in, never on every call, as the
    JAX package dumps StableHLO.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    with _build.recording() as entries:
        gm = make_fx(fn, tracing_mode="real")(*example_args)
    parts = [f"# traced graph of {getattr(fn, '__name__', repr(fn))} "
             "(make_fx, ATen operations)\n",
             gm.print_readable(print_output=False)]
    if _on_card(example_args):
        kernels = kernels_of(entries)
        lib = _build.load_library("kernels")._name
        symbols = kernel_symbols(lib, kernels)
        sass = _run([_cuobjdump(), "-sass", "-fun", ",".join(symbols), lib]
                    ) if symbols else ""
        found = sass_sections(sass, kernels)
        parts.append(f"\n# entry points: {', '.join(sorted(entries))}\n"
                     f"# kernels: {', '.join(kernels)}\n"
                     f"# SASS of {len(found)} functions, the instances of "
                     f"those kernels in {lib}\n")
        parts += [f"\n# Function : {fn_name}\n{body}"
                  for fn_name, body in sorted(found.items())]
    out = dump_dir(path) / f"{name}.lowered.txt"
    out.write_text("".join(parts))
    log("dumped the lowered call to", out)
    return str(out)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the ``with`` block (the card's kernels too where there is
    one) and write a Chrome trace into ``log_dir`` (default:
    ``mfa_trace`` in the temporary directory); yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir or Path(tempfile.gettempdir()) / "mfa_trace")
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield str(out)
    fd, file = tempfile.mkstemp(prefix="trace-", suffix=".json", dir=out)
    os.close(fd)
    prof.export_chrome_trace(file)
    log("wrote a Chrome trace to", file)

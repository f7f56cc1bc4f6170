"""Checkpoint / resume round trips and the debug helpers, in the port.

The mirror of tests/test_checkpoint_debug.py: resume is bit-exact on the
CPU at its tiny configuration (the JAX test compares the final loss at
1e-6; here every parameter and the loss after resuming equal the
uninterrupted run's bit for bit), ``force=False`` refuses to overwrite,
``dump_lowered`` writes the traced graph, and ``log`` is gated by
``MFA_DEBUG``.  Also: a template pins dtypes and refuses another layout;
``utils/debug.py``'s table of the kernels behind each C entry point names
every kernel of ``csrc/`` and only those; its SASS filter keeps exactly
the named kernels' functions; ``trace`` writes a Chrome trace.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from metal_flash_attention_plus_tpu_torch.attention.masking import CAUSAL
from metal_flash_attention_plus_tpu_torch.models.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    loss_fn,
    make_train_step,
    trainable_parameters,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    flash_attention_forward,
)
from metal_flash_attention_plus_tpu_torch.utils import debug
from metal_flash_attention_plus_tpu_torch.utils.profiling import (
    params_digest,
)

CSRC = (Path(__file__).resolve().parents[1]
        / "metal_flash_attention_plus_tpu_torch" / "csrc")
CFG = TransformerConfig(vocab_size=64, d_model=32, num_layers=1, num_heads=2,
                        num_kv_heads=1, head_dim=16, d_ff=64, max_seq=64,
                        dtype=torch.float32)


def _fresh():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.Adam(trainable_parameters(params), lr=1e-3)
    return params, opt


def test_checkpoint_resume_bitexact(tmp_path):
    params, opt = _fresh()
    step = make_train_step(CFG, opt)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 64, (2, 33)))
    for _ in range(3):
        params, _, _ = step(params, opt.state, tokens)
    path = tmp_path / "ckpt" / "state.pt"
    save_checkpoint(str(path), dict(params=params, opt=opt.state_dict()))
    for _ in range(2):
        params, _, _ = step(params, opt.state, tokens)
    final_a = loss_fn(params, tokens, CFG).item()

    template_params, template_opt = _fresh()
    restored = load_checkpoint(
        str(path), template=dict(params=template_params,
                                 opt=template_opt.state_dict()),
        device="cpu")
    p2 = restored["params"]
    opt2 = torch.optim.Adam(trainable_parameters(p2), lr=1e-3)
    opt2.load_state_dict(restored["opt"])
    step2 = make_train_step(CFG, opt2)
    for _ in range(2):
        p2, _, _ = step2(p2, opt2.state, tokens)
    assert params_digest(p2) == params_digest(params)
    assert loss_fn(p2, tokens, CFG).item() == final_a


def test_force_false_refuses_to_overwrite(tmp_path):
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, {"x": torch.ones(2)})
    with pytest.raises(FileExistsError):
        save_checkpoint(path, {"x": torch.zeros(2)}, force=False)
    save_checkpoint(path, {"x": torch.zeros(2)})  # force=True overwrites
    got = load_checkpoint(path, device="cpu")
    assert torch.equal(got["x"], torch.zeros(2))
    assert [p.name for p in tmp_path.iterdir()] == ["state.pt"]


def test_template_pins_dtype_and_layout(tmp_path):
    path = str(tmp_path / "state.pt")
    save_checkpoint(path, {"w": torch.arange(6.0).reshape(2, 3),
                           "layers": [{"b": torch.ones(3)}], "step": 7})
    got = load_checkpoint(path, template={
        "w": torch.zeros(2, 3, dtype=torch.bfloat16),
        "layers": [{"b": torch.zeros(3)}], "step": 0})
    assert got["w"].dtype == torch.bfloat16 and got["step"] == 7
    for bad in ({"w": torch.zeros(3, 2), "layers": [{"b": torch.zeros(3)}],
                 "step": 0},
                {"w": torch.zeros(2, 3), "layers": [], "step": 0},
                {"w": torch.zeros(2, 3), "step": 0}):
        with pytest.raises(ValueError, match="checkpoint"):
            load_checkpoint(path, template=bad)


def test_dump_lowered_writes_the_graph(tmp_path):
    path = debug.dump_lowered(lambda x: x * 2.0 + 1.0, torch.ones(4, 4),
                              name="test_dump", path=str(tmp_path))
    text = Path(path).read_text()
    assert path.endswith("test_dump.lowered.txt")
    assert "aten.mul" in text and "aten.add" in text


def test_dump_lowered_of_the_flash_forward(tmp_path, monkeypatch):
    monkeypatch.setenv("MFA_DUMP_DIR", str(tmp_path))
    q = torch.randn(1, 2, 32, 16)
    path = debug.dump_lowered(
        lambda q: flash_attention_forward(q, q, q, mask=CAUSAL), q,
        name="flash")
    assert Path(path).parent == tmp_path
    text = Path(path).read_text()
    assert "aten.exp2" in text and "SASS" not in text  # CPU: no kernel


def test_log_gated(capsys, monkeypatch):
    monkeypatch.delenv("MFA_DEBUG", raising=False)
    debug.log("hidden")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("MFA_DEBUG", "1")
    debug.log("visible")
    assert "visible" in capsys.readouterr().out


def test_entry_kernel_table_matches_the_sources():
    src = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    kernels = set(re.findall(r"__global__.{0,160}?\b(\w+_kernel)\s*\(",
                             src, re.S))
    assert len(kernels) > 20
    assert set(debug.kernels_of(debug.ENTRY_KERNELS)) == kernels
    entries = set(re.findall(r"\bint (mfa_\w+)\(", src))
    assert set(debug.ENTRY_KERNELS) <= entries


def test_sass_sections_keep_the_named_kernels():
    text = (
        "Fatbin elf code:\n================\narch = sm_90a\n"
        "\tcode for sm_90a\n"
        "\t\tFunction : _Z19flash_fwd_tc_kernelILi64ELb0EEvPKv\n"
        "        /*0000*/ MOV R1, c[0x0][0x28] ;\n"
        "\t\tFunction : _Z16flash_fwd_kernelIfLi64ELb0EEvPKf\n"
        "        /*0000*/ MOV R2, c[0x0][0x28] ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_19wo_kernelILi8EEvPKv\n"
        "        /*0000*/ EXIT ;\n"
        "\t\tFunction : _Z18xwo_kernel_variantv\n"
        "        /*0000*/ NOP ;\n"
        "\t\tFunction : void wo_kernel<16>(const void *)\n"
        "        /*0000*/ NOP ;\n")
    got = debug.sass_sections(text, ["flash_fwd_tc_kernel", "wo_kernel"])
    assert sorted(got) == ["_Z19flash_fwd_tc_kernelILi64ELb0EEvPKv",
                           "_ZN12_GLOBAL__N_19wo_kernelILi8EEvPKv",
                           "void wo_kernel<16>(const void *)"]
    assert "MOV R1" in got["_Z19flash_fwd_tc_kernelILi64ELb0EEvPKv"]
    assert "MOV R2" not in got["_Z19flash_fwd_tc_kernelILi64ELb0EEvPKv"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with debug.trace(str(tmp_path)) as out:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert out == str(tmp_path)
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())

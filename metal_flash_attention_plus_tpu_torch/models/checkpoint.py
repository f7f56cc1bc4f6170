"""Training-state checkpoint and resume.

The port of the JAX package's ``models/checkpoint.py`` (orbax there): a
nested state of dicts, lists and tuples with tensor and plain-number
leaves, written with ``torch.save`` and read back with
``torch.load(weights_only=True)``, which unpickles nothing but tensors and
plain containers.

The optimizer goes in as ``optimizer.state_dict()``: the ``opt_state`` of
:func:`models.transformer.make_train_step` is ``optimizer.state``, keyed
by the parameter tensors themselves, so it cannot be saved as it is.  To
resume, build the optimizer over the restored parameters and
``load_state_dict`` the restored state::

    save_checkpoint(path, dict(params=params, opt=optimizer.state_dict()))
    state = load_checkpoint(path, template=dict(params=fresh_params,
                                                opt=fresh.state_dict()),
                            device="cpu")
    optimizer = torch.optim.Adam(trainable_parameters(state["params"]))
    optimizer.load_state_dict(state["opt"])

There the template places the parameters, and the optimizer's state stays
on the host until ``load_state_dict`` moves it beside its parameters, as
``torch.optim`` does (Adam keeps its step counts on the host).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import torch

from metal_flash_attention_plus_tpu_torch._device import (
    DeviceLike,
    resolve_device,
)


def _detached(state: Any) -> Any:
    if isinstance(state, torch.Tensor):
        return state.detach()
    if isinstance(state, dict):
        return {k: _detached(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_detached(v) for v in state)
    return state


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Write ``state`` to the file ``path`` (its directory is made).  With
    ``force=False`` an existing checkpoint is not overwritten
    (``FileExistsError``).  The file is written beside ``path`` and moved
    into place, so a reader never sees half of it."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_detached(state), f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _restore(saved: Any, template: Any, device: DeviceLike, where: str):
    """``saved`` laid out as ``template``: tensors take the template
    tensor's dtype and device (and must have its shape); containers must
    have its keys or length.  An empty dict in the template (an optimizer's
    state before its first step) takes the saved dict as it is, on
    ``device``."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != \
                template.shape:
            raise ValueError(f"checkpoint {where}: {_describe(saved)} where "
                             f"the template has {_describe(template)}")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint {where}: {_describe(saved)} where "
                             "the template has a dict")
        if not template:
            return _restore(saved, None, device, where)
        if set(saved) != set(template):
            raise ValueError(f"checkpoint {where}: keys "
                             f"{sorted(saved, key=str)} where the template "
                             f"has {sorted(template, key=str)}")
        return {k: _restore(saved[k], template[k], device, f"{where}[{k!r}]")
                for k in saved}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != \
                len(template):
            raise ValueError(f"checkpoint {where}: {_describe(saved)} where "
                             f"the template has {len(template)} items")
        return type(template)(_restore(s, t, device, f"{where}[{i}]")
                              for i, (s, t) in enumerate(zip(saved,
                                                             template)))
    if template is not None:
        return saved
    # No template here: tensors to ``device``, containers walked.
    if isinstance(saved, torch.Tensor):
        return saved.to(resolve_device(device))
    if isinstance(saved, dict):
        return {k: _restore(v, None, device, where) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        return type(saved)(_restore(v, None, device, where) for v in saved)
    return saved


def _describe(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return f"a tensor of shape {tuple(x.shape)}"
    return f"a {type(x).__name__}"


def load_checkpoint(path: str, template: Optional[Any] = None,
                    device: DeviceLike = None) -> Any:
    """Read a checkpoint :func:`save_checkpoint` wrote.

    ``template`` (a state of the same layout, e.g. freshly initialized
    parameters) pins the structure, each tensor's dtype and device, and
    its shape; ``ValueError`` where the file differs.  Tensors that no
    template tensor places go to ``device`` (``None``: the card)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return _restore(saved, template, device, "state")

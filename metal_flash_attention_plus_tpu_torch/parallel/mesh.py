"""Device-mesh construction and the canonical axis names.

The port of the JAX package's ``parallel/mesh.py``: a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialized process group, with the axes

- ``data``: data parallelism (batch);
- ``model``: tensor parallelism (heads, MLP hidden, vocabulary);
- ``context``: sequence / context parallelism (ring attention, Ulysses).

``mesh.get_group("context")`` is the process group that
:func:`parallel.ring.ring_attention` and
:func:`parallel.ulysses.ulysses_attention` take.  The mesh is laid out
row-major over global ranks, ``context`` fastest, as the JAX package puts
the latency-critical axes last.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Canonical axis-name bundle so every module agrees on spelling."""

    data: str = "data"
    model: str = "model"
    context: str = "context"

    @property
    def all(self):
        return (self.data, self.model, self.context)


AXES = MeshAxes()


def make_mesh(
    data: int = 1,
    model: int = 1,
    context: int = 1,
    *,
    device_type: Optional[str] = None,
    axes: MeshAxes = AXES,
) -> DeviceMesh:
    """A (data, model, context) ``DeviceMesh`` over the process group's
    ranks.  ``device_type``: ``None`` means ``"cuda"``; the CPU tests pass
    ``"cpu"``.  Needs an initialized process group whose world size is
    data · model · context, and raises otherwise (the mesh never starts a
    process group itself)."""
    shape = (data, model, context)
    n = data * model * context
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialized process group: call "
            "torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes.all)


def batch_sharding(mesh: DeviceMesh, axes: MeshAxes = AXES
                   ) -> Tuple[Placement, ...]:
    """The DTensor placements of a [B, S, ...] batch: B sharded over
    ``data``, S over ``context``, replicated over ``model``."""
    dims = {axes.data: Shard(0), axes.context: Shard(1)}
    return tuple(dims.get(name, Replicate()) for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The DTensor placements of a tensor every rank holds whole."""
    return (Replicate(),) * mesh.ndim

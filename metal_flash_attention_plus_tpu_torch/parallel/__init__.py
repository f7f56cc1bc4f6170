"""The distributed layer over ``torch.distributed`` process groups.

- :mod:`.mesh`: the named mesh axes (data / model / context) as a
  ``DeviceMesh``, and the DTensor placements of a batch.
- :mod:`.ring`: ring attention over the flash kernels, with the
  log-sum-exp merge across ranks, forward and backward; its zigzag
  (causally balanced) variant.
- :mod:`.ulysses`: the head ↔ sequence all-to-all around one flash call.
- :mod:`.spmd`: the 3D-parallel (DP × TP × CP) transformer: forward, loss
  and train step over a mesh's groups.
- :mod:`.moe`: expert parallelism, a top-k routed MoE layer.
- :mod:`.pipeline`: pipeline parallelism, GPipe stages over a group.
- :mod:`.comm`: the collectives under them.

A process group stands where the JAX package has a mesh axis.  Importing
this package starts no process group: the caller initializes one
(``torch.distributed.init_process_group``), and every entry point raises
without it.
"""

from metal_flash_attention_plus_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    MeshAxes,
    batch_sharding,
    make_mesh,
    replicated,
)
from metal_flash_attention_plus_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    ring_attention_zigzag,
    zigzag_inverse,
    zigzag_order,
    zigzag_postshard,
    zigzag_preshard,
)
from metal_flash_attention_plus_tpu_torch.parallel.ulysses import (  # noqa: F401,E501
    ulysses_attention,
)
from metal_flash_attention_plus_tpu_torch.parallel.moe import (  # noqa: F401
    init_moe_params,
    moe_ffn,
)
from metal_flash_attention_plus_tpu_torch.parallel.pipeline import (  # noqa: F401,E501
    broadcast_from_last_stage,
    pipeline_apply,
)

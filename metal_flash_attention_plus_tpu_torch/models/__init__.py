"""Models: the flagship transformer, its cached serving twin, the MLA
model, checkpoints and the parameter converter from the JAX package."""

from metal_flash_attention_plus_tpu_torch.models.transformer import (  # noqa: F401,E501
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
)

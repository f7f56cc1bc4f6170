from metal_flash_attention_plus_tpu_torch.runtime.native import (
    PagePool,
    ScheduledItem,
    Scheduler,
    native_available,
)

__all__ = ["PagePool", "ScheduledItem", "Scheduler", "native_available"]

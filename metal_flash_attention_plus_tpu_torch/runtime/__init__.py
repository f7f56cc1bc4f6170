from metal_flash_attention_plus_tpu_torch.runtime.native import (
    GEMM_DYNAMIC,
    GEMM_WEIGHT_ONLY,
    KIND_BWD,
    KIND_FWD,
    KIND_FWD_Q,
    BlockConfig,
    CalibCache,
    PagePool,
    ScheduledItem,
    Scheduler,
    device_vmem_budget,
    native_available,
    resolve_blocks,
    resolve_gemm_blocks,
)

__all__ = ["GEMM_DYNAMIC", "GEMM_WEIGHT_ONLY", "KIND_BWD", "KIND_FWD",
           "KIND_FWD_Q", "BlockConfig", "CalibCache", "PagePool",
           "ScheduledItem", "Scheduler", "device_vmem_budget",
           "native_available", "resolve_blocks", "resolve_gemm_blocks"]

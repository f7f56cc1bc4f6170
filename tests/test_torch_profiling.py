"""The device-time table of ``utils/profiling.py``, on the CPU.

``kernel_table`` sums the device time of a profiler's events into the busy
time that ``--train``, ``--mla`` and the other modes print beside the idle
share.  A region the host annotates (``Optimizer.step#Adam.step``) shows on
the device's timeline too, spanning kernels that have events of their own,
so the table leaves it out; host events carry no device time.  The events
here are stand-ins for ``prof.key_averages()``'s, since the CPU build's
profiler records no device events.
"""

from types import SimpleNamespace

from torch.autograd import DeviceType

from metal_flash_attention_plus_tpu_torch.utils.profiling import kernel_table


def _event(key, device_type, us, count, annotation=False):
    return SimpleNamespace(key=key, device_type=device_type,
                           self_device_time_total=us, count=count,
                           is_user_annotation=annotation)


def test_kernel_table_sums_kernels_and_leaves_out_annotated_regions():
    events = [
        _event("flash_fwd_wide_kernel<288, false>", DeviceType.CUDA, 450.0,
               1),
        _event("multi_tensor_apply_kernel", DeviceType.CUDA, 300.0, 2),
        _event("Optimizer.step#Adam.step", DeviceType.CUDA, 320.0, 1,
               annotation=True),
        _event("aten::add", DeviceType.CPU, 0.0, 4),
        _event("cudaLaunchKernel", DeviceType.CUDA, 0.0, 3),
    ]
    prof = SimpleNamespace(key_averages=lambda: events)
    total, launches, ranked = kernel_table(prof)
    assert total == 750.0
    assert launches == 3
    assert ranked == [("flash_fwd_wide_kernel<288, false>", 450.0, 1),
                      ("multi_tensor_apply_kernel", 300.0, 2)]

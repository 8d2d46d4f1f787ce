"""Utilities of the port: the profiling and benchmark harness, and the
break-even calibration (`tuning`)."""

from spmm_tpu_torch.utils.profiler import (  # noqa: F401
    BenchResult,
    benchmark,
    cleanup_device,
    device_memory_stats,
    nnz_per_second,
    profile_op,
    repeat_op,
    speed_of_light_spmv_s,
)

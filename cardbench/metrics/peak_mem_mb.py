"""peak_mem_mb: the device memory the window's calls needed beyond what was
allocated when it opened (`torch.cuda.max_memory_allocated()` after a reset
at the window's start, less the allocation then), in MiB."""


def read(run):
    return run.peak_window_bytes / 2**20 if run.peak_window_bytes else None

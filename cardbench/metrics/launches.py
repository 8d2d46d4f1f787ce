"""launches: launches of the port's own kernels per call, from the
program's counter `spmm_tpu_torch.ops.kernels._build.LAUNCHES`, summed
over the window."""


def read(run):
    return sum(run.launches.values()) / len(run.calls_s) if run.calls_s \
        else None

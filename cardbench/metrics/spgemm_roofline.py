"""spgemm_roofline: the least time the card could take for the work a call
asks for (`cardbench/work/spgemm.py`: the larger of its operations over the
float32 peak and its bytes over the memory bandwidth), over the call's
device busy time, in %."""


def read(run):
    if (run.trace is None or run.work is None or run.peaks is None
            or not run.calls_s or not run.trace.busy_s):
        return None
    least_s = max(run.work["flops"] / run.peaks["fp32_flops_per_s"],
                  run.work["bytes"] / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / (run.trace.busy_s / len(run.calls_s))

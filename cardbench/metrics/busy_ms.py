"""busy_ms: device time per call, the union of the traced window's device
events (the harness's own copies left out) over the calls."""


def read(run):
    if run.trace is None or not run.calls_s or not run.trace.busy_s:
        return None
    return run.trace.busy_s / len(run.calls_s) * 1e3

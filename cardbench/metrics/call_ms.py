"""call_ms: the window's whole wall time over the calls it completed."""


def read(run):
    return run.window_s / len(run.calls_s) * 1e3 if run.calls_s else None

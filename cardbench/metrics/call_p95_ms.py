"""call_p95_ms: the 95th percentile of every call of the window, each
timed from entering the entry until the device is synchronised."""

import statistics


def read(run):
    if len(run.calls_s) < 2:
        return None
    return statistics.quantiles(run.calls_s, n=20,
                                method="inclusive")[18] * 1e3

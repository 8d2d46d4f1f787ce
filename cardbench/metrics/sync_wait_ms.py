"""sync_wait_ms: how long the host waits on the device per call, the total
time of the port's `sync.*` spans over the root spans of the traced
window."""

from cardbench import spans


def read(run):
    return spans.per_call(
        run, lambda name, t: (t["total_ns"] / 1e6 if name.startswith("sync.")
                              else 0.0))

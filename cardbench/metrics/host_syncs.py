"""host_syncs: device-to-host reads per call, the count of the port's
`sync.*` spans (one per readback, `_primitives.read_host`) over the root
spans of the traced window."""

from cardbench import spans


def read(run):
    return spans.per_call(
        run, lambda name, t: t["count"] if name.startswith("sync.") else 0)

"""spmm_host_ms: host time per call in the port's SpMM entry, the self
time of the spans `spmm` (the root: checks, promotion, the route) and
`spmm.*` (the chunk plan `spmm.plan`, its host syncs left out, and one
span per path: the wrapper around its kernels) over the root spans of the
traced window.  A port without those spans gives nothing."""

from cardbench import spans


def read(run):
    return spans.per_call(run, spans.self_ms(
        lambda n: n == "spmm" or n.startswith("spmm.")))

"""spmv_host_ms: host time per call in the port's SpMV entry, the self
time of the spans `spmv` (the root: checks, promotion, the route) and
`spmv.*` (one per path: the wrapper around its kernels) over the root
spans of the traced window.  A port without those spans gives nothing."""

from cardbench import spans


def read(run):
    return spans.per_call(run, spans.self_ms(
        lambda n: n == "spmv" or n.startswith("spmv.")))

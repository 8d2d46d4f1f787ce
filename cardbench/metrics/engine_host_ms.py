"""engine_host_ms: host time per call in the SpGEMM engines, the self time
of the port's `spgemm.alg*` spans (their readbacks and the host structural
product left out) over the root spans of the traced window."""

from cardbench import spans


def read(run):
    return spans.per_call(
        run, spans.self_ms(lambda n: n.startswith("spgemm.alg")))

"""host_structure_ms: host time per call in the host structural product,
the self time of the port's `spgemm.structure` span over the root spans of
the traced window."""

from cardbench import spans


def read(run):
    return spans.per_call(
        run, spans.self_ms(lambda n: n == "spgemm.structure"))

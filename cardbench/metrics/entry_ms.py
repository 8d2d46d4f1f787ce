"""entry_ms: host time per call in the port's public entries themselves,
the self time of the root spans `spgemm` and `spgemm_plan.call` (checks,
route, the plan's wrapper) over the root spans of the traced window."""

from cardbench import spans


def read(run):
    return spans.per_call(
        run, spans.self_ms(lambda n: n in ("spgemm", "spgemm_plan.call")))

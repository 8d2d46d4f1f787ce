"""spmm_plan_ms: host time per call building the per-call chunk plan of
the port's SpMM, the total time of the span `spmm.plan` (its host syncs
included) over the root spans of the traced window.  A port without that
span gives nothing."""

from cardbench import spans


def read(run):
    return spans.per_call(
        run, lambda name, t: (t["total_ns"] / 1e6 if name == "spmm.plan"
                              else 0.0))

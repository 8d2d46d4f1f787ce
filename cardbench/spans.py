"""What the port's own spans say about the traced window.

The port keeps totals per span name while a `torch.profiler` runs
(`spmm_tpu_torch.utils.profiler.span_totals()`: count, total and self
nanoseconds, roots).  `run.py` traces one window per process and the
profiler is off during set-up, so the totals are the window's.  A root
span is one public call.  A port without those totals gives nothing.
"""

from __future__ import annotations

from typing import Callable, Optional


def per_call(run, pick: Callable[[str, dict], float]) -> Optional[float]:
    """The sum of `pick(name, totals)` over the span names, per root span;
    None without a traced window or without a root span."""
    if run.trace is None:
        return None
    from spmm_tpu_torch.utils import profiler

    span_totals = getattr(profiler, "span_totals", None)
    if span_totals is None:
        return None
    totals = span_totals()
    roots = sum(t["roots"] for t in totals.values())
    if not roots:
        return None
    return sum(pick(name, t) for name, t in totals.items()) / roots


def self_ms(names: Callable[[str], bool]) -> Callable[[str, dict], float]:
    """A `pick` of the self time, in ms, of the spans `names` accepts."""
    return lambda name, t: t["self_ns"] / 1e6 if names(name) else 0.0

"""What one of the port's spans costs the host, off and on.

    python3 -m tools.span_cost [--spans N]     # from the repository root

Times `N` spans in a tight loop (`with span("x"): pass`) three ways: with
no profiler running (the shared no-op), under a running `torch.profiler`
(host and, where there is a card, device activity: a host event and the
totals), and `torch.profiler.record_function` with no profiler, for scale.
The empty loop is timed too and left in each figure.  Prints one JSON
line: nanoseconds per span, the best of five passes each.
"""

import argparse
import json
import time

import torch

from spmm_tpu_torch.utils.profiler import reset_spans, span


def per_span_ns(body, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        body(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def empty(n):
    for _ in range(n):
        pass


def spans(n):
    for _ in range(n):
        with span("x"):
            pass


def record_functions(n):
    for _ in range(n):
        with torch.profiler.record_function("x"):
            pass


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--spans", type=int, default=200_000)
    n = p.parse_args().spans
    out = {"torch": torch.__version__, "spans": n,
           "empty_loop_ns": per_span_ns(empty, n),
           "span_off_ns": per_span_ns(spans, n),
           "record_function_off_ns": per_span_ns(record_functions, n)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        out["card"] = torch.cuda.get_device_name(0)
    # fewer spans under the profiler: each one is kept in its trace
    with torch.profiler.profile(activities=acts):
        out["span_on_ns"] = per_span_ns(spans, max(n // 10, 1))
    reset_spans()
    print(json.dumps(out))


if __name__ == "__main__":
    main()

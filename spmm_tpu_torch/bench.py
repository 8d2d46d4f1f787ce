"""Headline benchmark of the port: SpGEMM CSR@CSR, n = 1024, density 0.1,
float32 with `precision="highest"` (IEEE), on one NVIDIA GPU.

    python3 -m spmm_tpu_torch.bench

Prints one JSON line whose last keys are `metric`, `value`, `unit` and
`vs_baseline`.  A and B come from the port's generator with seeds 2008 and
2009.  What it measures, every time on the card's clock (CUDA events):

  * `value`: the serving form `_alg1_fixed(A, B, 1.0, cap)` (cap = nnz,
    from one sizing pass: the preallocated-buffer pattern of cuSPARSE
    callers), captured once as a CUDA graph and replayed 100 times between
    one event pair; the median over `RUNS` such runs, divided by 100.  It
    is the time per multiply with the per-call cost of the host wrapper
    removed, the counterpart of the JAX script's in-program loop.  The
    graph's output is checked bitwise against an eager call first;
  * `per_call_ms`: one eager `_alg1_fixed` call between an event pair,
    host wrapper included, median of 25 after 3 warm-up calls;
  * `full_pipeline_ms`: `spgemm(A, B)` the same way (sizing read and all);
  * `cusparse_ms`: torch's own CSR @ CSR (cuSPARSE) on the same chip and
    inputs, the same way: a comparator, never on the port's path;
  * `busy_ms`: the device's busy time per eager `_alg1_fixed` call, from
    a torch.profiler trace.

`vs_baseline` = 2.1494 / `value`: the reference's cuSPARSE ALG1 at this
cell on an unstated GPU (BASELINE.md), context only.  The line names the
card and its power limit.  Without a card the script raises and prints no
number.
"""

from __future__ import annotations

import importlib
import json
import statistics
import warnings

import torch

BASELINE_MS = 2.1494  # reference cuSPARSE ALG1, n=1024, rho=0.1 (BASELINE.md)
SIZE = 1024
DENSITY = 0.1
SEEDS = (2008, 2009)
METRIC = "spgemm_csr_n1024_d0.1_median_ms"
REPLAYS = 100  # graph replays between one event pair
RUNS = 10      # event pairs of REPLAYS replays; `value` is their median
PER_CALL_RUNS = 25
WARMUP = 3


def capture(fn):
    """A CUDA graph of one call of `fn()`, after warm-up calls on a side
    stream (cuBLAS handles and workspaces, the kernel library): (graph,
    the call's outputs in the graph's memory)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def graph_ms(graph, replays: int = REPLAYS, runs: int = RUNS) -> float:
    """Median over `runs` of the event-timed ms of `replays` replays,
    divided by `replays`."""
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / replays)
    return statistics.median(times)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_outputs(xs, ys) -> bool:
    """Bitwise equality of two tuples of tensors."""
    return all(x.shape == y.shape and torch.equal(_bits(x), _bits(y))
               for x, y in zip(xs, ys))


def measure() -> dict:
    """The headline line (module docstring), measured on the card."""
    import spmm_tpu_torch as pt
    from spmm_tpu_torch.utils.profiler import (benchmark, card_info,
                                               device_busy_ms)

    if not torch.cuda.is_available():
        raise RuntimeError("spmm_tpu_torch.bench measures on an NVIDIA GPU "
                           "and torch.cuda.is_available() is false")
    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    dev = torch.device("cuda", 0)
    a = pt.random(SIZE, SIZE, DENSITY, format="csr", seed=SEEDS[0],
                  device=dev)
    b = pt.random(SIZE, SIZE, DENSITY, format="csr", seed=SEEDS[1],
                  device=dev)
    cap = int(sg._alg1_dense_compute(a, b, 1.0)[2])  # the sizing pass

    def fixed():
        return sg._alg1_fixed(a, b, 1.0, cap)

    graph, graph_out = capture(fixed)
    graph.replay()
    eager = fixed()
    torch.cuda.synchronize()
    if not same_outputs(graph_out, eager):
        raise AssertionError("the captured _alg1_fixed graph's output "
                             "differs from an eager call's")
    value = graph_ms(graph)
    del graph, graph_out

    def timed(fn):
        return benchmark(fn, n_repeat=PER_CALL_RUNS, n_warmup=WARMUP,
                         device=dev).median_ms

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # beta notices
        ta, tb = (torch.sparse_csr_tensor(x.indptr.long(), x.indices.long(),
                                          x.data, x.shape) for x in (a, b))
    line = {
        "card": card_info(),
        "device": torch.cuda.get_device_name(0),
        "cell": {"n": SIZE, "density": DENSITY, "seeds": list(SEEDS),
                 "nnz_a": a.nnz, "nnz_b": b.nnz, "nnz_c": cap,
                 "precision": "highest"},
        "graph_bitwise_eager": True,
        "graph_replays": REPLAYS, "graph_runs": RUNS,
        "per_call_ms": timed(fixed),
        "full_pipeline_ms": timed(lambda: pt.spgemm(a, b)),
        "cusparse_ms": timed(lambda: ta @ tb),
        "busy_ms": device_busy_ms(fixed),
        "baseline_ms": BASELINE_MS,
        "metric": METRIC,
        "value": value,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / value,
    }
    return line


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("spmm_tpu_torch.bench: torch.cuda.is_available() "
                         "is false; the headline is measured on an NVIDIA "
                         "GPU only")
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()

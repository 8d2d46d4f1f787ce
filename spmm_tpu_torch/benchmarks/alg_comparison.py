"""SpGEMM ALG1/2/3 time and ΔPeak comparison, on the card.

    python3 -m spmm_tpu_torch.benchmarks.alg_comparison --size 1024 \\
        --density 0.1 --runs 100 [--chunk-fraction 0.2] [--dtype float32]
        [--seed 2008] [--algs 1 2 3] [--memory] [--device-loop] [--json]
        [--save-grid PATH] [--device cuda]

Port of `benchmarks/alg_comparison.py` (the reference's
SpGEMM_alg_comparison/profiler.py:165-230).  For each size x density, A
and B come from the port's generator with seeds `seed` and `seed + 1`, and
`spgemm(A, B, alg, chunk_fraction)` runs for each alg.  A row holds:

  * `median_ms`: the CUDA-event median per call over `runs` calls after
    `warmup` (`repeat_op`), the host wrapper included, each call after a
    garbage collection and a reset of the peak (`profile_op`), so on a
    host whose caches that collection has just walked;
  * `delta_hbm_bytes`: ΔPeak of the last of them (`profile_op`:
    `max_memory_allocated` after the call less `memory_allocated` before
    it, the peak reset right before the call);
  * `per_call_ms`: the CUDA-event median of `runs` calls back to back
    (`benchmark`), measured as `cusparse_ms` is;
  * `busy_ms`: the device's busy time per call (`device_busy_ms`);
  * `engine`: the engine the call runs (`ops.spgemm.spgemm_engine`:
    alg1, esc or the blocked engine's name);
  * `cusparse_ms`: torch's own CSR @ CSR (cuSPARSE) on the same inputs,
    the median of 25 event-timed calls after 3 warm-up calls, as
    `spmm_tpu_torch.bench` measures `cusparse_ms`: a comparator, never on
    the port's path;
  * `ref_ms`, `ref_peak_mb`: the reference's where `REFERENCE` has the
    cell (an unstated GPU: context only);
  * `device`: the card's name and power limit.

`--memory` adds `peak_hbm_bytes`: `max_memory_allocated` over a fresh call
after `reset_peak_memory_stats`, A and B resident (no model column: the
TPU memory model is not ported).  `--device-loop` (card only) adds alg1's
`serving_ms`: `_alg1_fixed(A, B, 1.0, cap)` with cap = nnz, captured as one
CUDA graph and replayed (`bench.capture`, `bench.graph_ms`), the
counterpart of the JAX script's in-program loop.  The JAX script's
memtrace replay and two-K slope serve its relay and are not ported: CUDA
events and the profiler's busy time take their place.  A call that runs out
of memory, or passes ESC's int32 product limit, prints `[SKIP]` with the
error's words and gives no row.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import warnings

import torch

from spmm_tpu_torch.benchmarks.common import (DTYPES, busy_ms, device_name,
                                              driver_device, emit, timed)
from spmm_tpu_torch.ops.spgemm import spgemm_engine
from spmm_tpu_torch.utils.profiler import benchmark, cleanup_device

# The reference's cuSPARSE numbers read off its README figures (BASELINE.md):
# (size, density, alg) -> (ms, peak MB).  Unstated GPU, CUDA 13.
REFERENCE = {
    (512, 0.1, 1): (0.8249, 36), (512, 0.1, 2): (0.8282, 18),
    (512, 0.1, 3): (1.7112, 20),
    (512, 0.5, 1): (3.8035, 776), (512, 0.5, 2): (4.8802, 370),
    (512, 0.5, 3): (7.2505, 318),
    (1024, 0.1, 1): (2.1494, 258), (1024, 0.1, 2): (2.4330, 174),
    (1024, 0.1, 3): (3.8103, 122),
    (1024, 0.5, 1): (67.0011, 6174), (1024, 0.5, 2): (74.4531, 4639),
    (1024, 0.5, 3): (100.9707, 2499),
}
LIBRARY_RUNS = 25
LIBRARY_WARMUP = 3
# the words of cuSPARSE's refusal (CUSPARSE_STATUS_INSUFFICIENT_RESOURCES)
LIBRARY_REFUSAL = "insufficient resources"


def operands(size: int, density: float, seed: int, device,
             dtype=torch.float32):
    """A and B (size^2, CSR) from the port's generator, seeds `seed` and
    `seed + 1`."""
    import spmm_tpu_torch as pt

    return tuple(pt.random(size, size, density, format="csr", dtype=dtype,
                           seed=s, device=device) for s in (seed, seed + 1))


def products(a, b, algs, chunk_fraction: float) -> dict:
    """{alg: spgemm(a, b, alg, chunk_fraction)}: what each timed call
    computes."""
    import spmm_tpu_torch as pt

    return {alg: pt.spgemm(a, b, alg=alg, chunk_fraction=chunk_fraction)
            for alg in algs}


def library_ms(a, b, device) -> float | None:
    """torch's CSR @ CSR on the same arrays (cuSPARSE on the card); None,
    after a `[SKIP]` line, where cuSPARSE refuses the call for want of
    resources (at 2048^2/0.5 on an H100).  Every other error is raised."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # beta notices
        ta, tb = (torch.sparse_csr_tensor(x.indptr.long(), x.indices.long(),
                                          x.data, x.shape) for x in (a, b))
    try:
        return benchmark(lambda: ta @ tb, n_repeat=LIBRARY_RUNS,
                         n_warmup=LIBRARY_WARMUP, device=device).median_ms
    except RuntimeError as e:
        if LIBRARY_REFUSAL not in str(e):
            raise
        print(f"[SKIP] torch CSR @ CSR: {type(e).__name__}: {str(e)[:200]}")
        cleanup_device()
        return None


def fresh_peak_bytes(fn, device) -> int | None:
    """`max_memory_allocated` over one fresh call of `fn` (the peak reset
    right before it, the caching allocator emptied); None on the CPU."""
    if device.type != "cuda":
        return None
    cleanup_device()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del out
    return peak


def serving_ms(a, b, device) -> float:
    """alg1's serving form replayed as one CUDA graph: ms per multiply."""
    from spmm_tpu_torch.bench import capture, graph_ms
    from spmm_tpu_torch.ops.spgemm import _alg1_dense_compute, _alg1_fixed

    cap = int(_alg1_dense_compute(a, b, 1.0)[2])
    graph, out = capture(lambda: _alg1_fixed(a, b, 1.0, cap))
    ms = graph_ms(graph)
    del graph, out
    return ms


def run_case(size, density, runs, chunk_fraction, dtype, seed, algs,
             device, memory=False, device_loop=False, warmup=3,
             busy_calls=5):
    """{alg: measurements} of one cell, and torch's CSR @ CSR ms."""
    import spmm_tpu_torch as pt

    a, b = operands(size, density, seed, device, dtype)
    results = {}
    for alg in algs:
        def op(alg=alg):
            return pt.spgemm(a, b, alg=alg,
                             chunk_fraction=chunk_fraction).data

        r = timed(f"SpGEMM alg{alg} n={size} d={density}", op, runs, warmup,
                  device)
        if r is None:
            continue
        print(r.row())
        per_call = benchmark(op, n_repeat=runs, n_warmup=1,
                             device=device).median_ms
        res = results[alg] = {"time": r, "per_call_ms": per_call,
                              "busy_ms": busy_ms(op, device, busy_calls),
                              "engine": spgemm_engine(a, b, alg,
                                                      chunk_fraction)}
        if memory:
            res["peak_bytes"] = fresh_peak_bytes(op, device)
            ref = REFERENCE.get((size, density, alg))
            refs = f"  (reference GPU: {ref[1]} MB)" if ref else ""
            if res["peak_bytes"] is not None:
                print(f"    peak device memory (fresh call): "
                      f"{res['peak_bytes'] / 2**20:.1f} MB{refs}")
    if device_loop and 1 in results:
        results[1]["serving_ms"] = serving_ms(a, b, device)
        print(f"alg1 CUDA graph (serving path): "
              f"{results[1]['serving_ms']:.4f} ms/multiply")
    lib = library_ms(a, b, device) if results else None
    del a, b
    return results, lib


def save_grid(path: str, cells, device: str) -> int:
    """Merge rows into the grid file at `path`, keyed by (size, density,
    alg); written after every cell, so a cut run keeps what it measured."""
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            for c in json.load(f).get("cells", []):
                merged[(c["size"], c["density"], c["alg"])] = c
    for c in cells:
        merged.setdefault((c["size"], c["density"], c["alg"]), {}).update(c)
    out = {"description": "SpGEMM alg-comparison grid of spmm_tpu_torch: "
                          "CUDA-event median ms per call, device busy ms, "
                          "ΔPeak and fresh-call peak bytes, the engine, "
                          "torch's CSR @ CSR ms, and the reference's "
                          "cuSPARSE numbers (BASELINE.md).",
           "device": device,
           "cells": [merged[k] for k in sorted(merged)]}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return len(merged)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, nargs="+", default=[512, 1024])
    p.add_argument("--density", type=float, nargs="+", default=[0.1, 0.5])
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--busy-calls", type=int, default=5,
                   help="traced calls for busy_ms (0: none)")
    p.add_argument("--chunk-fraction", type=float, default=0.2)
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    p.add_argument("--seed", type=int, default=2008)
    p.add_argument("--algs", type=int, nargs="+", default=[1, 2, 3],
                   choices=[1, 2, 3])
    p.add_argument("--device-loop", action="store_true",
                   help="also time alg1's serving form as a CUDA graph")
    p.add_argument("--memory", action="store_true",
                   help="also record each alg's peak over a fresh call")
    p.add_argument("--json", action="store_true",
                   help="one JSON line per row")
    p.add_argument("--save-grid", metavar="PATH", default=None,
                   help="merge the rows into a grid JSON file at PATH")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = driver_device("alg_comparison", args.device)
    if args.device_loop and device.type != "cuda":
        raise ValueError("--device-loop replays a CUDA graph: it needs the "
                         "card")
    card = device_name(device)
    rows = []
    for size, density in itertools.product(args.size, args.density):
        print(f"=== SpGEMM alg comparison: n={size} density={density} "
              f"runs={args.runs} ===")
        res, lib = run_case(size, density, args.runs, args.chunk_fraction,
                            DTYPES[args.dtype], args.seed, args.algs, device,
                            memory=args.memory, device_loop=args.device_loop,
                            warmup=args.warmup, busy_calls=args.busy_calls)
        cell = []
        for alg, r in res.items():
            row = {"bench": "alg_comparison", "size": size,
                   "density": density, "alg": alg,
                   "median_ms": r["time"].median_ms,
                   "delta_hbm_bytes": r["time"].delta_hbm_bytes,
                   "per_call_ms": r["per_call_ms"],
                   "busy_ms": r["busy_ms"], "engine": r["engine"],
                   "cusparse_ms": lib, "device": card}
            if "serving_ms" in r:
                row["serving_ms"] = r["serving_ms"]
            if "peak_bytes" in r:
                row["peak_hbm_bytes"] = r["peak_bytes"]
            ref = REFERENCE.get((size, density, alg))
            if ref:
                row["ref_ms"], row["ref_peak_mb"] = ref
            cell.append(emit(row, args.json))
        if lib is not None:
            print(f"torch CSR @ CSR: {lib:.4f} ms")
        rows += cell
        cleanup_device()
        if args.save_grid:
            n = save_grid(args.save_grid, cell, card)
            print(f"grid saved: {args.save_grid} ({n} cells)")
    return rows


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Calibrate and check `spgemm`'s alg=0 engine choice on one NVIDIA GPU.

    python3 -m tools.alg0_route [--out FILE] [--only grid rates extra]

For each point, uniform CSR operands A (seed) and B (seed + 1) of
`pt.random`, values U[0, 1): the exact product count P, and the time per
call of alg1 (`spgemm(A, B, alg=1)`), ESC (`spgemm(A, B, alg=2,
impl="esc")`) and alg=0 (`spgemm(A, B)`, with the engine
`spgemm_engine` names), each the median over calls timed on the host
clock from the call to `torch.cuda.synchronize()`, the three in turns
(`in_turns`); ESC's peak allocation over the call (C included) as bytes
per product.  ESC is left out where its workspace would pass `ESC_GIB`.

Groups:
  grid   the upstream break-even grid (`benchmarks/dense_vs_sparse.py`'s
         defaults): n 1024, 2048, 4096, 8192 x density 0.001, 0.005, 0.01,
         0.05, 0.1, float32 "highest";
  rates  alg1 at 4096^2 and 8192^2, density 0.001, float32 in each
         precision mode and float64: each dense rate, 2 (8192^3 - 4096^3)
         over the difference of the two times;
  extra  8192^2/1e-3 in "default" and "high", 4096^2/0.01 in float64.

The last line is a summary: the dense rates, a least-squares fit of ESC's
time as fixed + per product over the float32 points with P up to
`FIT_PRODUCTS`, and ESC's bytes per product at each dtype's largest P.
Every line is JSON; with `--out` the lines go to that file too.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

GRID_N = (1024, 2048, 4096, 8192)
GRID_D = (0.001, 0.005, 0.01, 0.05, 0.1)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
ESC_GIB = 16       # ESC is left out where P * 96 B would pass this
FIT_PRODUCTS = 1e8  # the fit of ESC's time takes the points up to this P


def card() -> str:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return q.stdout.strip() or torch.cuda.get_device_name(0)


def in_turns(calls: dict, rounds: int = 4, seconds: float = 0.25,
             min_calls: int = 3, max_calls: int = 200) -> dict:
    """{name: median wall time of one call, in ms}, each call synchronised,
    the calls timed in turns (rounds in order, then reversed, each name
    for `seconds`), after two warm-ups of each: the card's clocks and the
    host's load drift alike over all of them."""
    for fn in calls.values():
        fn()
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in calls}
    order = list(calls)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            start, n = time.perf_counter(), 0
            while n < max_calls and (n < min_calls or
                                     time.perf_counter() - start < seconds):
                t0 = time.perf_counter()
                calls[name]()
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
                n += 1
    return {name: statistics.median(t) * 1e3 for name, t in times.items()}


def peak_bytes(fn) -> int:
    """The peak allocation over one call above what was held before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def point(n: int, d: float, dtype: str, precision: str, seed: int,
          algs) -> dict:
    import spmm_tpu_torch as pt

    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")

    a = pt.random(n, n, d, format="csr", dtype=DTYPES[dtype], seed=seed,
                  device="cuda")
    b = pt.random(n, n, d, format="csr", dtype=DTYPES[dtype],
                  seed=seed + 1, device="cuda")
    P = sg._esc_work(a, b)[2]
    row = {"n": n, "density": d, "dtype": dtype, "precision": precision,
           "nnz": a.nnz, "products": P}
    calls = {
        "alg1": lambda: sg.spgemm(a, b, alg=1, precision=precision),
        "esc": lambda: sg.spgemm(a, b, alg=2, impl="esc",
                                 precision=precision),
        "alg0": lambda: sg.spgemm(a, b, precision=precision),
    }
    # ESC's workspace, with room over the 48-55 B a product measured
    if "esc" in algs and not (P < 2**31 and P * 96 <= ESC_GIB * 2**30):
        algs = [name for name in algs if name != "esc"]
        row["esc_ms"] = None
    row.update((f"{name}_ms", ms) for name, ms in
               in_turns({name: calls[name] for name in algs}).items())
    if "esc" in algs:
        row["esc_bytes_per_product"] = peak_bytes(calls["esc"]) / max(P, 1)
    if "alg0" in algs:
        row["alg0_engine"] = sg.spgemm_engine(a, b, precision=precision)
        ran = [row.get("alg1_ms"), row.get("esc_ms")]
        best = min(t for t in ran if t is not None)
        row["alg0_over_best"] = row["alg0_ms"] / best
    del a, b
    torch.cuda.empty_cache()
    return row


def points(groups):
    for g in groups:
        if g == "grid":
            for n in GRID_N:
                for d in GRID_D:
                    yield g, n, d, "float32", "highest"
        elif g == "rates":
            for dtype, prec in (("float32", "highest"),
                                ("float32", "default"),
                                ("float32", "high"),
                                ("float64", "highest")):
                for n in (4096, 8192):
                    yield g, n, 0.001, dtype, prec
        elif g == "extra":
            yield g, 8192, 0.001, "float32", "default"
            yield g, 8192, 0.001, "float32", "high"
            yield g, 4096, 0.01, "float64", "highest"


def summary(rows) -> dict:
    rates = {}
    for r in rows:
        if r["group"] == "rates" and r["n"] == 8192:
            small = next(s for s in rows if s["group"] == "rates"
                         and s["n"] == 4096 and s["dtype"] == r["dtype"]
                         and s["precision"] == r["precision"])
            flops = 2 * (8192**3 - 4096**3)
            dt = (r["alg1_ms"] - small["alg1_ms"]) / 1e3
            rates[f"{r['dtype']}.{r['precision']}"] = flops / dt
    esc = [(r["products"], r["esc_ms"] / 1e3) for r in rows
           if r.get("esc_ms") is not None and r["dtype"] == "float32"
           and 0 < r["products"] <= FIT_PRODUCTS]
    fit = None
    if len(esc) >= 2:
        x = np.array([p for p, _ in esc], float)
        y = np.array([t for _, t in esc])
        slope, fixed = np.polyfit(x, y, 1)
        fit = {"fixed_s": fixed, "per_product_s": slope, "points": len(esc)}
    # at the largest P of each dtype, where C's and the fixed allocations
    # weigh least
    largest = {}
    for r in rows:
        if (r.get("esc_bytes_per_product") is not None and r["products"]
                > largest.get(r["dtype"], {}).get("products", 0)):
            largest[r["dtype"]] = r
    per = {d: {"products": r["products"],
               "bytes_per_product": r["esc_bytes_per_product"]}
           for d, r in largest.items()}
    return {"summary": True, "dense_flops": rates, "esc_fit": fit,
            "esc_bytes_per_product": per}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", nargs="+", default=["grid", "rates", "extra"],
                   choices=["grid", "rates", "extra"])
    p.add_argument("--seed", type=int, default=2100)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("alg0_route: needs a CUDA card")
    with (open(args.out, "a") if args.out
          else contextlib.nullcontext()) as out:
        def emit(row):
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        emit({"card": card(), "torch": torch.__version__})
        rows = []
        for group, n, d, dtype, prec in points(args.only):
            algs = ["alg1"] if group == "rates" else ["alg1", "esc", "alg0"]
            row = dict(point(n, d, dtype, prec, args.seed, algs),
                       group=group)
            rows.append(row)
            emit(row)
        emit(summary(rows))

if __name__ == "__main__":
    main()

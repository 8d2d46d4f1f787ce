"""Dense GEMM against sparse SpGEMM (or SpMM): the break-even density.

    python3 -m spmm_tpu_torch.benchmarks.dense_vs_sparse --size 1024 4096 \\
        --density 0.001 0.01 0.05 0.1 --runs 50 [--alg 2]
        [--op spgemm|spmm] [--ncols N] [--json] [--device cuda]

Port of `benchmarks/dense_vs_sparse.py` (the reference's
dense_vs_sparseGEMM/main.py + utils.py): the inputs are made and densified
on the device before any timing, and each side is timed alone
(`repeat_op`, CUDA-event median per call) over size x density, a call
that runs out of memory skipped with `[SKIP]`.  The dense side is
`torch.matmul` with TF32 off, the port's `precision="highest"`
(`ops/spgemm.py::_value_matmul`), in place of JAX's `jnp.dot(...,
HIGHEST)`.  `--op spgemm`: A @ B of two CSRs against `spgemm(A, B, alg)`,
whose engine each row names (alg2 and alg3 take the blocked engines at
JAX's v5e thresholds, so the break-even depends on them); `--op spmm`: a
CSR A against `spmm(A, X, via="csr")` with X of ones, (size, ncols).

The break-even density of a size (`crossover`) is the first density, in
the order given, at which sparse stops being faster than dense after being
faster at the one before.
"""

from __future__ import annotations

import argparse

import torch

from spmm_tpu_torch.benchmarks.common import (DTYPES, busy_ms, device_name,
                                              driver_device, emit, timed)
from spmm_tpu_torch.ops.spgemm import spgemm_engine
from spmm_tpu_torch.utils.profiler import cleanup_device

WARMUP = 3



def dense_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dense side: one GEMM, TF32 off on the card."""
    from spmm_tpu_torch.ops.spgemm import _value_matmul

    return _value_matmul(a, b, "highest")


def crossover(points):
    """The break-even density of one size: `points` are (density, dense
    ms, sparse ms) in sweep order, a missing side None; the first density
    at which sparse is not faster after being faster at the point before,
    else None."""
    prev = None
    for density, dense, sparse in points:
        both = dense is not None and sparse is not None
        now_faster = both and sparse < dense
        if both and prev and not now_faster:
            return density
        prev = now_faster
    return None


def run_case(size, density, runs, dtype, seed, alg, device, op="spgemm",
             ncols=None, busy_calls=5):
    """{"dense": BenchResult, "sparse": BenchResult, "engine": ...,
    busy times} of one cell; a side that was skipped is missing."""
    import spmm_tpu_torch as pt

    a = pt.random(size, size, density, format="csr", dtype=dtype, seed=seed,
                  device=device)
    out = {}
    if op == "spmm":
        bd = torch.ones((size, ncols or size), dtype=dtype, device=device)
        ad = a.toarray()
        dense_fn = lambda: dense_mm(ad, bd)  # noqa: E731
        sparse_fn = lambda: pt.spmm(a, bd, via="csr")  # noqa: E731
        names = (f"dense-gemm n={size} d={density}",
                 f"spmm(csr) n={size} d={density}")
        out["engine"] = "spmm_csr"
    else:
        b = pt.random(size, size, density, format="csr", dtype=dtype,
                      seed=seed + 1, device=device)
        ad, bd = a.toarray(), b.toarray()
        dense_fn = lambda: dense_mm(ad, bd)  # noqa: E731
        sparse_fn = lambda: pt.spgemm(a, b, alg=alg).data  # noqa: E731
        names = (f"dense n={size} d={density}",
                 f"sparse(alg{alg}) n={size} d={density}")
        out["engine"] = spgemm_engine(a, b, alg)
    for side, name, fn in (("dense", names[0], dense_fn),
                           ("sparse", names[1], sparse_fn)):
        r = timed(name, fn, runs, WARMUP, device)
        if r is not None:
            out[side] = r
            out[f"{side}_busy_ms"] = busy_ms(fn, device, busy_calls)
            print(r.row())
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, nargs="+",
                   default=[1024, 2048, 4096, 8192])
    p.add_argument("--density", type=float, nargs="+",
                   default=[0.001, 0.005, 0.01, 0.05, 0.1])
    p.add_argument("--runs", type=int, default=50)
    p.add_argument("--busy-calls", type=int, default=5,
                   help="traced calls for the busy times (0: none)")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alg", type=int, default=2, choices=[1, 2, 3],
                   help="the sparse alg (2: the blocked engines or ESC; 1 "
                        "would itself run dense GEMMs)")
    p.add_argument("--op", choices=["spgemm", "spmm"], default="spgemm",
                   help="spgemm: CSR@CSR vs dense; spmm: CSR@dense vs dense")
    p.add_argument("--ncols", type=int, default=None,
                   help="dense B columns for --op spmm (default: size)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = driver_device("dense_vs_sparse", args.device)
    card = device_name(device)
    points = {}
    for size in args.size:
        for density in args.density:
            print(f"=== dense-vs-sparse: n={size} density={density} ===")
            res = run_case(size, density, args.runs, DTYPES[args.dtype],
                           args.seed, args.alg, device, op=args.op,
                           ncols=args.ncols, busy_calls=args.busy_calls)
            dense = res["dense"].median_ms if "dense" in res else None
            sparse = res["sparse"].median_ms if "sparse" in res else None
            points.setdefault(size, []).append((density, dense, sparse))
            print(f"  engine: {res['engine']}")
            emit({"bench": "dense_vs_sparse", "op": args.op, "size": size,
                  "density": density, "dense_ms": dense,
                  "sparse_ms": sparse,
                  "dense_busy_ms": res.get("dense_busy_ms"),
                  "sparse_busy_ms": res.get("sparse_busy_ms"),
                  "engine": res["engine"], "device": card}, args.json)
            del res
            cleanup_device()
    crossovers = {size: d for size, pts in points.items()
                  if (d := crossover(pts)) is not None}
    if crossovers:
        print("break-even densities:", crossovers)
    return crossovers


if __name__ == "__main__":
    main()

"""Each stage of the SpGEMM, SpMV and SpMM pipelines timed on its own.

    python3 -m spmm_tpu_torch.benchmarks.component_profile --size 1024 \\
        --density 0.1 [--runs 20] [--json] [--device cuda]

Port of `benchmarks/component_profile.py`, with the port's counterpart of
each stage: alg1's densify (kernel `densify_onehot`), value GEMM in IEEE
float32 and in TF32, bf16 pattern GEMM, the whole dense compute and the
extract (kernel `extract_roll`); ESC's expand, lexsort and compress
(kernel `esc_compress.compress_runs` on the card); SpMV
over the binned kernel and over the dense route, SpMM over `spmm_routed`
(`via="csr"`) and over the dense route, X of 128 columns; and alg1, alg2
and alg3 (chunk_fraction 0.2) end to end.  A and B come from the port's
generator with seeds 0 and 1.  Each line is the CUDA-event median per call
(the host clock on the CPU) and, on the card, the device's busy time per
call from a profiler trace beside it; `--json` adds one JSON line a
stage.
"""

from __future__ import annotations

import argparse
import importlib

import torch

from spmm_tpu_torch.benchmarks.common import (busy_ms, device_name,
                                              driver_device, emit)
from spmm_tpu_torch.utils.profiler import benchmark

STAGES = (
    "alg1: densify A (densify_onehot)", "alg1: value GEMM f32 IEEE",
    "alg1: value GEMM f32 TF32", "alg1: pattern GEMM bf16",
    "alg1: dense compute (densify x2, GEMMs, mask)",
    "alg1: extract (extract_roll)",
    "esc: expand", "esc: lexsort", "esc: compress (segsum tree)",
    "spmv: binned (csr route)", "spmv: dense route",
    "spmm: spmm_routed (csr route, k=128)", "spmm: dense route (k=128)",
    "end to end: spgemm alg1", "end to end: spgemm alg2",
    "end to end: spgemm alg3 cf=0.2",
)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--density", type=float, default=0.1)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--busy-calls", type=int, default=5,
                   help="traced calls for the busy times (0: none)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = driver_device("component_profile", args.device)
    import spmm_tpu_torch as pt
    from spmm_tpu_torch.ops import _primitives as prim
    from spmm_tpu_torch.ops.kernels.densify_onehot import densify_onehot

    sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")
    m = k = n = args.size
    card = device_name(device)
    print(f"device: {card}  n={args.size} d={args.density}")
    a = pt.random(m, k, args.density, format="csr", seed=0, device=device)
    b = pt.random(k, n, args.density, format="csr", seed=1, device=device)
    rows = []
    stages = iter(STAGES)

    def timeit(fn, runs=args.runs):
        name = next(stages)
        ms = benchmark(fn, n_repeat=runs, n_warmup=1, device=device
                       ).median_ms
        busy = busy_ms(fn, device, args.busy_calls)
        busy_s = f"{busy:9.4f} ms" if busy is not None else "      n/a"
        print(f"  {name:<46s} {ms:9.4f} ms  busy {busy_s}", flush=True)
        rows.append(emit({"bench": "component_profile", "stage": name,
                          "size": args.size, "density": args.density,
                          "ms": ms, "busy_ms": busy, "device": card},
                         args.json))
        return fn()

    print("[alg1 components]")
    ad, a_pat = timeit(lambda: densify_onehot(a.indptr, a.indices, a.data,
                                              m, k))
    bd, b_pat = densify_onehot(b.indptr, b.indices, b.data, k, n)
    timeit(lambda: sg._value_matmul(ad, bd, "highest"))
    timeit(lambda: sg._value_matmul(ad, bd, "default"))
    timeit(lambda: torch.matmul(a_pat, b_pat))
    del ad, bd, a_pat, b_pat
    c, mask, nnz_dev = timeit(lambda: sg._alg1_dense_compute(a, b, 1.0))
    nnz = int(nnz_dev)
    timeit(lambda: sg._dense_extract(c, mask, nnz))
    print(f"  (nnz_C = {nnz})")
    del c, mask

    print("[alg2 ESC components]")
    counts, ends = sg._work_estimation(a.indices, b.indptr)
    products = int(ends[-1]) if a.nnz else 0
    print(f"  (P = {products})")
    half = max(3, args.runs // 2)
    row, col, val = timeit(lambda: sg._expand(
        a.rows, a.indices, a.data, b.indptr, b.indices, b.data, counts,
        ends, products), half)
    row_s, col_s, (val_s,) = timeit(
        lambda: prim.lexsort_rowcol(row, col, (val,), (m, n)), half)
    del row, col, val
    nnz_c = int(prim.count_unique_sorted(row_s, col_s))
    timeit(lambda: sg._compress(row_s, col_s, val_s, 1.0, nnz_c, m), half)
    del row_s, col_s, val_s

    print("[spmv / spmm]")
    x = torch.ones(k, dtype=torch.float32, device=device)
    xs = torch.ones((k, 128), dtype=torch.float32, device=device)
    timeit(lambda: pt.spmv(a, x))
    timeit(lambda: pt.spmv(a, x, via="dense"))
    timeit(lambda: pt.spmm(a, xs), half)
    timeit(lambda: pt.spmm(a, xs, via="dense"))

    print("[end-to-end]")
    timeit(lambda: pt.spgemm(a, b, alg=1).data)
    timeit(lambda: pt.spgemm(a, b, alg=2).data, half)
    timeit(lambda: pt.spgemm(a, b, alg=3, chunk_fraction=0.2).data,
           max(3, args.runs // 4))
    return rows


if __name__ == "__main__":
    main()

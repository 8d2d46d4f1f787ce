"""SpGEMM and SpMV, scipy on the host against the card end to end, over the
format pairs.

    python3 -m spmm_tpu_torch.benchmarks.spgemm_vs_spmv --size 512 \\
        --density 0.1 --runs 20 [--seed 0] [--json] [--device cuda]

Port of `benchmarks/spgemm_vs_spmv.py` (the reference's
SpGEMM_vs_SpMV/profiler.py): for each size x density, SpGEMM A @ B for all
9 pairs in {csr, csc, coo}^2, then SpMV A @ v for each format of A.  A and
B come from `scipy.sparse.random` (float32, seeds `seed` and `seed + 1`).

  * The host side is scipy's product, each repeat in a child forked for
    it (`profile_op_cpu`): `cpu_ms` and `cpu_rss_kb` are the wall time and
    ΔmaxRSS of the child's first call, as the reference measures them,
    immune to the parent's allocator; `cpu_warm_ms` is a second call in
    the same child, without the copy-on-write faults the first call takes
    on the parent's pages (every Python object it touches).  The child
    runs only the scipy closure: the parent may have initialised CUDA, and
    a forked child must not touch it.
  * The card side (`gpu_ms`) is end to end: the upload of the host COO
    triplets into the port's COO, its conversion to the format, and the
    product, all inside the timed closure (`repeat_op`, CUDA-event median
    per call); SpMV uploads v inside it too.  `gpu_busy_ms` is the
    card's busy time per call of the same closure (`device_busy_ms`, the
    copies included), None on the CPU.

Each cell ends with its fastest SpGEMM pair on the device.
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle
import resource
import statistics
import time

import numpy as np
import scipy.sparse as sp

from spmm_tpu_torch.benchmarks.common import (busy_ms, device_name,
                                              driver_device, emit, timed)
from spmm_tpu_torch.utils.profiler import cleanup_device

FORMATS = ["csr", "csc", "coo"]
WARMUP = 2


def _child(fn, w: int) -> None:
    """A forked repeat: two timed calls of `fn`, (first ms, its ΔmaxRSS KB,
    second ms) or the error's words down the pipe, then exit without
    running the parent's exit handlers (an interrupt sends nothing: the
    parent raises "child died")."""
    try:
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.perf_counter()
        fn()
        first = (time.perf_counter() - t0) * 1e3
        rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.perf_counter()
        fn()
        msg = (first, rss1 - rss0, (time.perf_counter() - t0) * 1e3)
    except Exception as e:  # carried to the parent, which raises it
        msg = f"{type(e).__name__}: {e}"
    try:
        os.write(w, pickle.dumps(msg))
    finally:
        os._exit(0)


def profile_op_cpu(fn, runs: int):
    """(median ms of the first call, largest ΔmaxRSS KB, median ms of the
    second) of `fn` over `runs` repeats, each in a child forked for it (the
    reference's _profile_in_child, SpGEMM_vs_SpMV/profiler.py:94-178).
    `fn` must touch only host objects (numpy, scipy)."""
    times, warm = [], []
    peak = 0
    for _ in range(runs):
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:
            os.close(r)
            _child(fn, w)
        os.close(w)
        chunks = []
        while chunk := os.read(r, 65536):
            chunks.append(chunk)
        os.close(r)
        os.waitpid(pid, 0)
        msg = pickle.loads(b"".join(chunks)) if chunks else "child died"
        if isinstance(msg, str):
            raise RuntimeError(f"profile_op_cpu: the forked repeat failed: "
                               f"{msg}")
        times.append(msg[0])
        peak = max(peak, msg[1])
        warm.append(msg[2])
    return statistics.median(times), peak, statistics.median(warm)


def gen_cpu(size: int, density: float, fmt: str, seed: int):
    return sp.random(size, size, density=density, format=fmt,
                     random_state=np.random.RandomState(seed),
                     dtype=np.float32)


def triplets(a):
    coo = a.tocoo()
    return (np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.data))


def spgemm_op(ah, bh, shape, fa: str, fb: str, device):
    """The card's SpGEMM end to end: the host triplets uploaded into the
    port's COO, converted to `fa` / `fb`, multiplied."""
    import spmm_tpu_torch as pt

    def op():
        a = pt.COO((ah[2], (ah[0], ah[1])), shape=shape,
                   device=device).asformat(fa)
        b = pt.COO((bh[2], (bh[0], bh[1])), shape=shape,
                   device=device).asformat(fb)
        return (a @ b).data
    return op


def spmv_op(ah, shape, fa: str, v: np.ndarray, device):
    """The card's SpMV end to end: A's triplets and v uploaded, A converted
    to `fa`, multiplied."""
    import torch

    import spmm_tpu_torch as pt

    def op():
        a = pt.COO((ah[2], (ah[0], ah[1])), shape=shape,
                   device=device).asformat(fa)
        return pt.spmv(a, torch.as_tensor(v, device=device))
    return op


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, nargs="+", default=[256, 512, 1024])
    p.add_argument("--density", type=float, nargs="+",
                   default=[0.01, 0.1, 0.5])
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = driver_device("spgemm_vs_spmv", args.device)
    card = device_name(device)
    rows = []

    def record(op, pair, size, density, cpu, fn, r):
        """One row: the host's times, the card's median and busy time."""
        cpu_ms, cpu_rss, cpu_warm = cpu
        gpu_ms = r.median_ms if r else float("nan")
        row = {"bench": "spgemm_vs_spmv", "op": op, "pair": pair,
               "size": size, "density": density, "cpu_ms": cpu_ms,
               "gpu_ms": gpu_ms,
               "gpu_busy_ms": busy_ms(fn, device) if r else None,
               "cpu_warm_ms": cpu_warm, "cpu_rss_kb": cpu_rss,
               "device": card}
        print(f"  {pair if op == 'spgemm' else f'spmv[{pair}]'}: cpu "
              f"{cpu_ms:8.3f} ms (warm {cpu_warm:8.3f}) | gpu "
              f"{gpu_ms:8.3f} ms | speedup {cpu_ms / gpu_ms:6.2f}x (warm "
              f"{cpu_warm / gpu_ms:6.2f}x)")
        rows.append(emit(row, args.json))
        return row

    for size, density in itertools.product(args.size, args.density):
        print(f"=== SpGEMM vs SpMV: n={size} d={density} ===")
        shape = (size, size)
        pairs = []
        for fa, fb in itertools.product(FORMATS, FORMATS):
            a_cpu = gen_cpu(size, density, fa, args.seed)
            b_cpu = gen_cpu(size, density, fb, args.seed + 1)
            cpu = profile_op_cpu(lambda: a_cpu @ b_cpu, args.runs)
            fn = spgemm_op(triplets(a_cpu), triplets(b_cpu), shape, fa, fb,
                           device)
            r = timed(f"spgemm {fa}@{fb} n={size} d={density}", fn,
                      args.runs, WARMUP, device)
            row = record("spgemm", f"{fa}@{fb}", size, density, cpu, fn, r)
            pairs.append((f"{fa}@{fb}", row["gpu_ms"]))
        v = np.random.default_rng(9).random(size, dtype=np.float32)
        for fa in FORMATS:
            a_cpu = gen_cpu(size, density, fa, args.seed)
            cpu = profile_op_cpu(lambda: a_cpu @ v, args.runs)
            fn = spmv_op(triplets(a_cpu), shape, fa, v, device)
            r = timed(f"spmv {fa} n={size} d={density}", fn, args.runs,
                      WARMUP, device)
            record("spmv", fa, size, density, cpu, fn, r)
        best = min(pairs, key=lambda x: x[1] if x[1] == x[1]
                   else float("inf"))  # a skipped pair is NaN
        print(f"  best device spgemm pair: {best[0]} @ {best[1]:.3f} ms")
        cleanup_device()
    return rows


if __name__ == "__main__":
    main()

"""Multi-rank scaling of the row-sharded SpMV / SpMM / Aᵀy / streamed SpMV.

The port's twin of `benchmarks/scaling.py`.  For each world size D it
starts D ranks (one process each, NCCL on the card, gloo with `--device
cpu`; `experiments.distributed.launch`), times each op on every rank with
CUDA events (the host clock on the CPU) and prints rank 0's median per
call.  Speedup and efficiency against the smallest D are printed only for
world sizes that ran: on the card a world size needs one card a rank, so
one card runs D = 1 alone and shows no scaling.  CPU times say nothing of
the card.

    python3 -m spmm_tpu_torch.benchmarks.scaling [--size 8192]
        [--density 0.01] [--ncols 256] [--devices 1 2 4] [--device cpu]

Each world size prints its times and then one JSON row of them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

OPS = ("spmv", "spmm", "spmv_t(psum)", "spmv_stream")
MODULE = "spmm_tpu_torch.benchmarks.scaling"
REPS = 10  # calls back to back per timed round
TIMEOUT_S = 900.0  # for every rank of one world size


def timed(fn, device, reps: int = REPS, rounds: int = 3) -> float:
    """Median over `rounds` of the ms per call of `reps` calls back to
    back: CUDA events on the card, the host clock on the CPU."""
    import torch

    fn()
    meds = []
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            meds.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            meds.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(meds)


def rank_main(a) -> None:
    """One rank: the four ops at (size, density, ncols), rank 0's times
    and the card's name written to `--result`."""
    import torch

    import spmm_tpu_torch as pt
    from spmm_tpu_torch import parallel as pp
    from spmm_tpu_torch.parallel import collectives as pc

    dev = pp.init_process_group(
        store_path=a.store, world_size=a.nprocs, rank=a.rank,
        device=None if a.device == "cuda" else "cpu", local_rank=a.rank)
    try:
        mesh = pp.make_mesh(a.nprocs)
        A = pt.random(a.size, a.size, a.density, format="csr", seed=0,
                      device=dev)
        sh = pp.shard_csr(A, mesh, balance="nnz")
        x = torch.ones(a.size, device=dev)
        B = torch.ones((a.size, a.ncols), device=dev)
        plan = pp.spmv_stream_plan(sh, mesh)
        xs = pp.shard_vector(x, mesh)
        calls = {
            "spmv": lambda: pp.spmv_sharded(sh, x, mesh),
            "spmm": lambda: pp.spmm_sharded(sh, B, mesh),
            "spmv_t(psum)": lambda: pp.spmv_t_sharded(
                sh, pp.spmv_sharded(sh, x, mesh), mesh),
            "spmv_stream": lambda: pp.spmv_sharded_streamed(plan, xs, mesh),
        }
        out = {"D": a.nprocs, "nnz": A.nnz, "backend":
               torch.distributed.get_backend()}
        for op, fn in calls.items():
            pc.barrier(mesh, "rows")  # the ranks start each op together
            out[op] = timed(fn, dev)
        if dev.type == "cuda":
            from spmm_tpu_torch.utils.profiler import card_info

            out["card"] = card_info()
        if a.rank == 0:
            with open(a.result, "w") as f:
                json.dump(out, f)
    finally:
        pp.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(prog=MODULE)
    p.add_argument("--size", type=int, default=8192)
    p.add_argument("--density", type=float, default=0.01)
    p.add_argument("--ncols", type=int, default=256)
    p.add_argument("--devices", type=int, nargs="+", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # a rank's own arguments (given by the launcher)
    p.add_argument("--nprocs", type=int)
    p.add_argument("--rank", type=int)
    p.add_argument("--store")
    p.add_argument("--result")
    a = p.parse_args(argv)
    if a.rank is not None:
        return rank_main(a)

    from spmm_tpu_torch.benchmarks.common import driver_device
    from spmm_tpu_torch.experiments.distributed.launch import (run_ranks,
                                                               world_sizes)

    driver_device("scaling", a.device)
    sizes, notes = world_sizes(a.devices, a.device)
    args = ["--size", str(a.size), "--density", str(a.density),
            "--ncols", str(a.ncols)]
    rows = [run_ranks(MODULE, args, d, a.device, TIMEOUT_S) for d in sizes]
    where = rows[0].get("card", "cpu: times say nothing of the card")
    print(f"world sizes run: {sizes} ({a.device}, {rows[0]['backend']}; "
          f"{where})")
    for note in notes:
        print(note)
    base = rows[0]
    for r in rows:
        for op in OPS:
            line = f"D={r['D']} {op:<13s} {r[op]:9.3f} ms"
            if len(rows) > 1:
                speedup = base[op] / r[op] * base["D"]
                line += (f"  speedup {speedup:5.2f}x  "
                         f"efficiency {speedup / r['D'] * 100:5.1f}%")
            print(line)
        print(json.dumps({"size": a.size, "density": a.density,
                          "ncols": a.ncols, **r}))
    if len(rows) == 1:
        print(f"D={base['D']} alone ran"
              + (" (one card)" if a.device == "cuda" else "")
              + ": no speedup or efficiency to show")
    print(f"nnz={base['nnz']}")


if __name__ == "__main__":
    sys.exit(main())

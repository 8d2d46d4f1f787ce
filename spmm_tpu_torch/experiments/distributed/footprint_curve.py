"""Per-rank memory of the distributed SpMV against the world size.

The port's twin of `experiments/distributed/footprint_curve.py`: the
O(n/D) x of `spmv_sharded_streamed` against the O(n) replicated x of
`spmv_sharded`.  JAX reads XLA's buffer assignment; here each rank reads
its card's allocator: the bytes of the path's operands (its shard or
stream plan, and x or its x block) plus the peak increase
(`torch.cuda.max_memory_allocated`) over one call.  For each world size D
it starts D ranks (`launch`); on the card a world size needs one card a
rank, so one card runs D = 1 alone and shows no curve.  With `--device
cpu` the bytes are not measured (the host allocator has no peak), and the
bitwise check of the streamed path against its blocked twin still runs.

    python3 -m spmm_tpu_torch.experiments.distributed.footprint_curve
        [--size 1048576] [--density 5e-7] [--devices 1 2 4] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

MODULE = "spmm_tpu_torch.experiments.distributed.footprint_curve"
TIMEOUT_S = 900.0  # for every rank of one world size


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def peak_bytes(fn, operands, device):
    """Operand bytes + the allocator's peak increase over one call of
    `fn` (None on the CPU)."""
    import torch

    if device.type != "cuda":
        return None
    fn()  # a first call builds what is cached (plans)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return _bytes(*operands) + peak


def rank_main(a) -> None:
    import torch

    import spmm_tpu_torch as pt
    from spmm_tpu_torch import parallel as pp
    from spmm_tpu_torch.parallel import _comm

    dev = pp.init_process_group(
        store_path=a.store, world_size=a.nprocs, rank=a.rank,
        device=None if a.device == "cuda" else "cpu", local_rank=a.rank)
    try:
        mesh = pp.make_mesh(a.nprocs)
        A = pt.random(a.size, a.size, a.density, format="csr", seed=0,
                      device=dev)
        nnz = A.nnz
        sh = pp.shard_csr(A, mesh, balance="nnz")
        del A
        plan = pp.spmv_stream_plan(sh, mesh)
        x = torch.ones(a.size, device=dev)
        xs = pp.shard_vector(x, mesh)
        rep = peak_bytes(lambda: pp.spmv_sharded(sh, x, mesh),
                         (sh.indptr, sh.indices, sh.data, x), dev)
        stream = peak_bytes(
            lambda: pp.spmv_sharded_streamed(plan, xs, mesh),
            (plan.rows, plan.cols, plan.data, xs),
            dev)
        y1 = pp.spmv_sharded_blocked(plan, x, mesh)
        y2 = pp.spmv_sharded_streamed(plan, xs, mesh)
        same = bool(torch.equal(y1.view(torch.int32), y2.view(torch.int32)))
        flags = _comm.gather_ints([same, rep or 0, stream or 0], mesh,
                                  "rows")
        if a.rank == 0:
            out = {"D": a.nprocs, "nnz": nnz,
                   "bitwise": all(f[0] for f in flags),
                   "replicated_bytes": rep and max(f[1] for f in flags),
                   "streamed_bytes": stream and max(f[2] for f in flags)}
            if dev.type == "cuda":
                from spmm_tpu_torch.utils.profiler import card_info

                out["card"] = card_info()
            with open(a.result, "w") as f:
                json.dump(out, f)
    finally:
        pp.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(prog=MODULE)
    # x the dominant operand (the term the streamed path exists to
    # shrink): n = 2^20, ~0.5 entries a row
    p.add_argument("--size", type=int, default=1 << 20)
    p.add_argument("--density", type=float, default=5e-7)
    p.add_argument("--devices", type=int, nargs="+", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None)
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

    driver_device("footprint_curve", a.device)
    sizes, notes = world_sizes(a.devices, a.device)
    args = ["--size", str(a.size), "--density", str(a.density)]
    rows = [run_ranks(MODULE, args, d, a.device, TIMEOUT_S) for d in sizes]
    where = rows[0].get("card", "cpu: bytes not measured")
    for note in notes:
        print(note)
    ref = rows[0]["streamed_bytes"]

    def mb(b):
        return "not measured" if b is None else f"{b / 2**20:7.2f} MB/rank"

    for r in rows:
        ratio = (f" ({ref / max(r['streamed_bytes'], 1):.2f}x vs "
                 f"D={rows[0]['D']})" if ref else "")
        print(f"D={r['D']}: replicated-x {mb(r['replicated_bytes'])}   "
              f"streamed-x {mb(r['streamed_bytes'])}{ratio}   "
              f"bitwise-vs-blocked={r['bitwise']}", flush=True)
    if len(rows) == 1:
        print(f"D={rows[0]['D']} alone ran: no curve to show")
    if not all(r["bitwise"] for r in rows):
        raise SystemExit("footprint_curve: the streamed SpMV is not bitwise "
                         "its blocked twin")
    if a.out:
        with open(a.out, "w") as f:
            f.write(f"# spmv footprint curve: n={a.size} density="
                    f"{a.density} nnz={rows[0]['nnz']} device={where}\n")
            f.write("# D  replicated_bytes_per_rank  streamed_bytes_per_rank"
                    "  bitwise_vs_blocked\n")
            for r in rows:
                f.write(f"{r['D']} {r['replicated_bytes']} "
                        f"{r['streamed_bytes']} {r['bitwise']}\n")
        print(f"wrote {a.out}")


if __name__ == "__main__":
    sys.exit(main())

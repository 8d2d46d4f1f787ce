"""One rank of the multi-process check: Aᵀ(A·1) against scipy.

The port's twin of `experiments/distributed/comm_runner.py`: every rank
makes the same seeded matrix, shards it by nnz over a mesh of every rank,
runs `spmv_sharded` then `spmv_t_sharded` (real collectives, no mocks) and
checks the result against scipy's float64 product.  Started by the
launcher (`python3 -m spmm_tpu_torch.experiments.distributed`), or alone:

    python3 -m spmm_tpu_torch.experiments.distributed.comm_runner \
        --nprocs 1 --rank 0 --store /tmp/store [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--density", type=float, default=0.2)
    a = p.parse_args(argv)

    import torch

    import spmm_tpu_torch as pt
    from spmm_tpu_torch import parallel as pp

    dev = pp.init_process_group(
        store_path=a.store, world_size=a.nprocs, rank=a.rank,
        device=None if a.device == "cuda" else "cpu", local_rank=a.rank)
    try:
        mesh = pp.make_mesh(a.nprocs)
        A = pt.random(a.size, a.size, a.density, format="csr", seed=7,
                      device=dev)
        sh = pp.shard_csr(A, mesh, balance="nnz")
        y = pp.spmv_sharded(sh, torch.ones(a.size, device=dev), mesh)
        xt = pp.spmv_t_sharded(sh, y, mesh)
        As = A.to_scipy().astype(np.float64)
        want = As.T @ (As @ np.ones(a.size))
        np.testing.assert_allclose(xt.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-5)
        print(f"[rank {a.rank}/{a.nprocs}] OK ({dev}, "
              f"{torch.distributed.get_backend()})", flush=True)
    finally:
        pp.destroy_process_group()


if __name__ == "__main__":
    main()

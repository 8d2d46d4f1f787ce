"""The benchmark sweep: alg_comparison, dense_vs_sparse and spgemm_vs_spmv
under `--json`, their output written to a file as it is printed.

    python3 -m spmm_tpu_torch.benchmarks --out FILE [--runs 100]
        [--sizes 512 1024] [--densities 0.1 0.5] [--device cuda]

Port of `benchmarks/run.sh` (the reference's per-directory run.sh), with
its options: the alg comparison at `--sizes` x `--densities` and `--runs`,
the break-even sweep at its own grid and `--runs`, SpGEMM vs SpMV at its
own grid and 20 runs.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import sys

import torch

from spmm_tpu_torch.benchmarks import (alg_comparison, dense_vs_sparse,
                                       spgemm_vs_spmv)
from spmm_tpu_torch.benchmarks.common import device_name, driver_device


class _Tee:
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="benchmark_results_torch.txt")
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--sizes", type=int, nargs="+", default=[512, 1024])
    p.add_argument("--densities", type=float, nargs="+", default=[0.1, 0.5])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = driver_device("the benchmark sweep", args.device)
    dev = ["--device", args.device]
    with open(args.out, "w") as f, \
            contextlib.redirect_stdout(_Tee(sys.stdout, f)):
        now = datetime.datetime.now(datetime.timezone.utc)
        print(f"# spmm_tpu_torch benchmark sweep "
              f"{now.strftime('%Y-%m-%dT%H:%M:%SZ')}")
        print(f"# device: {device_name(device)}; torch {torch.__version__}")
        print("## alg comparison")
        alg_comparison.main(["--size", *map(str, args.sizes), "--density",
                             *map(str, args.densities), "--runs",
                             str(args.runs), "--json", *dev])
        print("## dense vs sparse")
        dense_vs_sparse.main(["--runs", str(args.runs), "--json", *dev])
        print("## spgemm vs spmv")
        spgemm_vs_spmv.main(["--runs", "20", "--json", *dev])


if __name__ == "__main__":
    main()

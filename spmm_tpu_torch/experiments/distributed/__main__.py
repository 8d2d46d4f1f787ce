"""`python3 -m spmm_tpu_torch.experiments.distributed [--nprocs N]
[--device cuda|cpu]`: N ranks of `comm_runner` through `launch`; prints
MULTIPROCESS OK or FAILED and exits non-zero where any rank did."""

import argparse
import sys

from spmm_tpu_torch.experiments.distributed.launch import launch

RUNNER = "spmm_tpu_torch.experiments.distributed.comm_runner"
TIMEOUT_S = 600.0  # for every rank


def main(argv=None):
    p = argparse.ArgumentParser(prog="spmm_tpu_torch.experiments."
                                "distributed")
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    code = launch(RUNNER, [], a.nprocs, a.device, TIMEOUT_S)
    print(f"MULTIPROCESS OK ({a.nprocs} ranks)" if code == 0
          else f"MULTIPROCESS FAILED (exit {code})", flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

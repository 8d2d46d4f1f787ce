"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  With `--trace 0` the result carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a `torch.profiler` trace of the window.  The last line of standard
output is one JSON object; the last lines of standard error are the numbers
of the check beside their limits.  Without as many CUDA cards as the cell
asks for, without the program in this checkout, or with the JAX package
loaded, it prints no result and exits with another code than 0.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the checkout's root, not this folder, heads the import path
    sys.path[0] = str(ROOT)
    # caches that torch may write for itself stay inside the checkout, at
    # fixed paths (the port builds its kernels into build/spmm_tpu_torch)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "cardbench" / sub)
    from cardbench import harness

    try:
        result, lines = harness.run_cell(args.workload, args.seed,
                                         args.seconds, bool(args.trace),
                                         t_start=T_START)
    except harness.Refused as e:
        print(f"cardbench: {e}", file=sys.stderr)
        return 2
    banned = harness.banned_modules()
    if banned:
        print(f"cardbench: the process holds {', '.join(banned)}: the "
              "benchmark measures the port alone", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of the check are set from; not part of a run.

    python3 cardbench/readings.py --workload <cell> --seconds 2 \
        --seeds 11 12 13 ... [--precision default | --control]

Runs the cell once for each seed, all in one process, with short windows,
and prints one JSON line per seed: the check's numbers.  Without
`--precision` or `--control` the program runs as the configuration states
(the sound runs, whose largest reading is the lower one).  The controls,
whose smallest reading is the upper one: `--precision default` runs the
port's TF32 path of the float32 GEMMs; `--control` puts the entry's
`control`, the plain reference on operands rounded one precision below
the configuration's dtype, in the program's place.  Needs a CUDA card, as
a run does.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default=None)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    from cardbench import harness

    wrap = (harness.load_entry(harness.load_cell(args.workload)).control
            if args.control else None)
    for seed in args.seeds:
        result, _ = harness.run_cell(args.workload, seed, args.seconds,
                                     False, precision=args.precision,
                                     wrap=wrap)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "precision": args.precision or "as configured",
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

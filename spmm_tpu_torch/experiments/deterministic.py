"""Run-to-run bitwise determinism suite of the port.

    python3 -m spmm_tpu_torch.experiments.deterministic [--sizes ...]
        [--densities ...] [--seeds ...] [--algs ...] [--device cuda]
        [--report PATH]

Port of `experiments/deterministic/test_deterministic.sh` (the reference's
deterministic/test_deterministic.sh:4-35): for each algorithm and seed,
`run_alg` dumps the products of the whole size x density grid twice, each
time in a fresh OS process, and the two dumps are compared byte for byte.
A generation process that dies is run once more; one that dies twice
gives an ERROR row, not a verdict.

The report (`--report`, else a file in a new temporary directory, never
the JAX package's committed reports) has a header with the grid, the
device and the card's name and power limit, then one row per (alg, seed),
then `ALL DETERMINISTIC` where every row is deterministic.  The exit code
is 0 only then.  Defaults: the reference's grid.
"""

from __future__ import annotations

import argparse
import filecmp
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from spmm_tpu_torch.experiments.run_alg import DENSITIES, SIZES

REPO = Path(__file__).resolve().parents[2]
SEEDS = list(range(1, 11))
ALGS = [1, 2, 3]


def environment() -> dict:
    """The environment of a child process: this one's, with the repository
    on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def device_line(device: str) -> str:
    if device.startswith("cuda"):
        from spmm_tpu_torch.utils.profiler import card_info

        return f"device={device} card=[{card_info()}]"
    return f"device={device} card=[none]"


def _generate(cmd, out: Path):
    return subprocess.Popen(cmd + ["--out", str(out)], cwd=REPO,
                            env=environment(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _finished(proc, what: str) -> bool:
    """Wait for a generation process; True if it exited with 0."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        print(f"warn: {what} died ({proc.returncode}): "
              f"{err.strip()[-500:]}", file=sys.stderr)
    return proc.returncode == 0


def run_pair(args, alg: int, seed: int, outdir: Path) -> str:
    """The row of one (alg, seed): both dumps generated in processes of
    their own (the two at once), a dead one run once more, then
    compared."""
    cmd = [sys.executable, "-m", "spmm_tpu_torch.experiments.run_alg",
           "--alg", str(alg), "--seed", str(seed), "--device", args.device,
           "--sizes", *map(str, args.sizes),
           "--densities", *map(str, args.densities)]
    outs = [outdir / f"alg{alg}_seed{seed}_run{r}.txt" for r in (1, 2)]
    procs = [_generate(cmd, out) for out in outs]
    ok = [_finished(proc, f"alg{alg} seed={seed} {out.name}")
          or _finished(_generate(cmd, out),
                       f"alg{alg} seed={seed} {out.name}, run again")
          for out, proc in zip(outs, procs)]
    if not all(ok):
        return (f"alg{alg} seed={seed}: ERROR (generation process died "
                f"twice; no determinism verdict)")
    same = filecmp.cmp(outs[0], outs[1], shallow=False)
    for out in outs:
        out.unlink()
    return (f"alg{alg} seed={seed}: "
            f"{'deterministic' if same else 'NOT deterministic'}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    p.add_argument("--densities", type=float, nargs="+", default=DENSITIES)
    p.add_argument("--seeds", type=int, nargs="+", default=SEEDS)
    p.add_argument("--algs", type=int, nargs="+", default=ALGS,
                   choices=[1, 2, 3])
    p.add_argument("--device", default="cuda")
    p.add_argument("--report", default=None)
    args = p.parse_args(argv)

    outdir = Path(tempfile.mkdtemp(prefix="spmm_tpu_torch_det_"))
    report = Path(args.report or outdir / "determinism_report.txt")
    lines = [
        f"# determinism grid: sizes={args.sizes} "
        f"densities={args.densities} algs={args.algs} seeds={args.seeds}",
        f"# {device_line(args.device)}",
        "# protocol: each alg x seed generated twice in separate OS "
        "processes over the full size x density grid; CSR text dumps "
        "compared byte for byte",
    ]
    rows = []
    for alg in args.algs:
        for seed in args.seeds:
            row = run_pair(args, alg, seed, outdir)
            print(row, flush=True)
            rows.append(row)
    if any(r.endswith("NOT deterministic") for r in rows):
        verdict = "DETERMINISM FAILURES DETECTED"
    elif any("ERROR" in r for r in rows):
        verdict = ("GENERATION ERRORS (determinism neither proven nor "
                   "disproven for ERROR rows)")
    else:
        verdict = "ALL DETERMINISTIC"
    report.write_text("\n".join(lines + rows + [verdict]) + "\n")
    print(f"report: {report}")
    print(verdict)
    return 0 if verdict == "ALL DETERMINISTIC" else 1


if __name__ == "__main__":
    sys.exit(main())

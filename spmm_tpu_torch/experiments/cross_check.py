"""Cross-implementation check of the port's SpGEMM against the native C++
replay, with a PASS/FAIL report.

    python3 -m spmm_tpu_torch.experiments.cross_check [--sizes ...]
        [--densities ...] [--algs ...] [--seed 123] [--device cuda]
        [--report PATH]

Port of `experiments/cross_check/{gen_and_save.py,compare_csrs_txt.py,
run_all.sh}` (the reference's cupy_cusparse/run_all_alg3.sh:27-77), in one
process.  `native/spgemm_cross_check.cpp` is built with g++ (the flags of
`native/build.sh`) into `build/native/`; `native/` is left as it is.  For
each case, A and B come from the port's generator (seeds `seed` and
`seed + 1`) and C from `spgemm` on the device: the ESC engine for alg 2/3,
whose expansion and doubling tree the binary replays bitwise, and the
default engine for alg 1, whose dense-intermediate values the binary
replays in double.  A, B and C are dumped through the port's text io, the
binary recomputes C from the A and B files (`--alg1` for alg 1), and the
two are compared: indptr and indices bitwise; the data bitwise for alg
2/3, within rtol = atol = 1e-5 for alg 1.

The report (`--report`, else a file in a new temporary directory, never
the JAX package's `cross_check_report.txt`) has a header with the grid,
the device and the card, then a PASS or FAIL row per case.  The exit code
is 0 only where every case passes.  Defaults: the reference's grid.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from spmm_tpu_torch.experiments.deterministic import device_line

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "spgemm_cross_check.cpp"
BUILD_DIR = REPO / "build" / "native"
SIZES = [32, 64, 128, 256, 512]
DENSITIES = [0.01, 0.1, 0.5]
ALGS = [1, 2, 3]
CHUNK_FRACTION = 0.2
ALG1_RTOL = 1e-5


def build_native() -> Path:
    """The replay binary, compiled afresh into `build/native/` (a second
    or two: a binary left there by another machine may not run here)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("cross_check needs g++ to build "
                           f"{SOURCE.relative_to(REPO)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = BUILD_DIR / "spgemm_cross_check"
    tmp = exe.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-o", str(tmp),
                    str(SOURCE)], check=True, capture_output=True)
    tmp.replace(exe)  # atomic: no process sees half a file
    return exe


def compare(prefix_py: str, prefix_cpp: str, alg: int) -> dict:
    """{"shape", "indptr", "indices", "data": equal?} of two text dumps."""
    from spmm_tpu_torch.sparse.io import read_csr_txt

    a = read_csr_txt(prefix_py)
    b = read_csr_txt(prefix_cpp)
    if alg == 1:
        data = (a[2].shape == b[2].shape
                and np.allclose(a[2], b[2], rtol=ALG1_RTOL, atol=ALG1_RTOL))
    else:
        data = np.array_equal(a[2].view(np.uint32), b[2].view(np.uint32))
    return {"shape": a[3] == b[3], "indptr": np.array_equal(a[0], b[0]),
            "indices": np.array_equal(a[1], b[1]), "data": bool(data)}


def run_case(exe: Path, workdir: Path, alg: int, size: int,
             density: float, seed: int, device) -> str:
    import spmm_tpu_torch as pt
    from spmm_tpu_torch.sparse import io

    a = pt.random(size, size, density, format="csr", seed=seed,
                  device=device)
    b = pt.random(size, size, density, format="csr", seed=seed + 1,
                  device=device)
    c = pt.spgemm(a, b, alg=alg, chunk_fraction=CHUNK_FRACTION,
                  impl="esc" if alg in (2, 3) else "auto")
    prefix = str(workdir / f"cc_{alg}_{size}_{density}")
    io.save_csr_txt(prefix + "_A", a)
    io.save_csr_txt(prefix + "_B", b)
    io.save_csr_txt(prefix + "_C_py", c)
    cmd = [str(exe), prefix + "_A", prefix + "_B", prefix + "_C_cpp"]
    proc = subprocess.run(cmd + (["--alg1"] if alg == 1 else []),
                          capture_output=True, text=True)
    case = f"alg={alg} size={size} density={density}"
    if proc.returncode != 0:
        return f"FAIL {case} (native replay exited {proc.returncode}: " \
               f"{proc.stderr.strip()[-300:]})"
    checks = compare(prefix + "_C_py", prefix + "_C_cpp", alg)
    for f in workdir.glob(Path(prefix).name + "_*"):
        f.unlink()
    bad = [k for k, ok in checks.items() if not ok]
    return f"PASS {case}" if not bad else f"FAIL {case} ({', '.join(bad)} differ)"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    p.add_argument("--densities", type=float, nargs="+", default=DENSITIES)
    p.add_argument("--algs", type=int, nargs="+", default=ALGS,
                   choices=[1, 2, 3])
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda")
    p.add_argument("--report", default=None)
    args = p.parse_args(argv)

    exe = build_native()
    workdir = Path(tempfile.mkdtemp(prefix="spmm_tpu_torch_cc_"))
    report = Path(args.report or workdir / "cross_check_report.txt")
    lines = [
        f"# cross-check grid: sizes={args.sizes} densities={args.densities}"
        f" algs={args.algs} seed={args.seed}",
        f"# {device_line(args.device)}",
        "# protocol: the port's C vs the native C++ replay, indptr/indices "
        "bitwise (+ data bitwise for alg2/3, rtol=atol=1e-5 for alg1)",
    ]
    rows = []
    for alg in args.algs:
        for size in args.sizes:
            for density in args.densities:
                row = run_case(exe, workdir, alg, size, density, args.seed,
                               args.device)
                print(row, flush=True)
                rows.append(row)
    passed = all(r.startswith("PASS") for r in rows)
    report.write_text("\n".join(lines + rows) + "\n")
    print(f"report: {report}")
    print(f"{sum(r.startswith('PASS') for r in rows)} of {len(rows)} "
          f"cases pass")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())

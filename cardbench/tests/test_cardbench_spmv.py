"""The SpMV entry, its reference, work count and dense answers, and a cell
of it on HPCG's stencil added to a copy of the benchmark as new files.

    python -m pytest cardbench/tests -q -p no:cacheprovider

`add_hpcg_cells(root)` adds, as new files and new `BENCHMARK.json`
entries only, a float64 `stencil27` configuration at HPCG's 104^3, two
SpMV traffic mixes (a plan made once, and none), their cells, and a
reader; the proof test runs them at the law's small size and runs the
copied tests of the benchmark over them.  On a card the same function
sets up the cells at their full size.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cardbench import check, harness, operands  # noqa: E402
from cardbench.files import load_file  # noqa: E402
from cardbench.reference import spmv as reference  # noqa: E402
from cardbench.work import spmv as counts  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
LAWS = ROOT / "cardbench" / "laws"
SPMV = load_file(ROOT / "cardbench" / "entries" / "spmv.py")


def np_spmv(a, x):
    """y = A @ x in float64 numpy, row by row."""
    ip, ix, v = (t.numpy() for t in a[:3])
    x = x.numpy().astype(np.float64)
    return np.array([np.dot(v[ip[r]:ip[r + 1]].astype(np.float64),
                            x[ix[ip[r]:ip[r + 1]]])
                     for r in range(a.shape[0])])


def matrices():
    stencil = load_file(LAWS / "stencil27.py").make(
        {"grid": [6, 5, 4]}, 0, torch.float64, "cpu")
    uniform = load_file(LAWS / "uniform.py").uniform_csr(
        50, 70, 0.1, 2**31 + 1, torch.float32, "cpu")
    return [stencil, uniform]


@pytest.mark.parametrize("which", [0, 1])
def test_reference_against_numpy(which):
    a = matrices()[which]
    x = operands.values_pool(1, a.shape[1], 9, a.data.dtype, "cpu")[0]
    want = np_spmv(a, x)
    for block_rows in (7, 2**18):
        got = reference.spmv(a, x, block_rows=block_rows)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                                   atol=1e-13)


def test_reference_control_rounds_one_precision_below():
    a = matrices()[0]
    x = operands.values_pool(1, a.shape[1], 9, torch.float64, "cpu")[0]
    exact = reference.spmv(a, x)
    low = reference.spmv(a, x, "float32")
    err = float((exact - low).abs().max() / exact.abs().max())
    assert 1e-10 < err < 1e-6


def test_work_counts_by_hand():
    a = matrices()[0]
    nnz, n = a.indices.numel(), a.shape[0]
    assert counts.spmv_call(a) == {
        "flops": 2 * nnz, "bytes": (n + 1) * 4 + nnz * (4 + 8) + 2 * n * 8}


@pytest.mark.parametrize("plan", [True, False])
@pytest.mark.parametrize("which", [0, 1])
def test_entry_against_numpy(which, plan):
    a = matrices()[which]
    traffic = {"entry": "spmv", "plan": plan, "pool": 3,
               "pool_seed_offset": 4, "warmup_calls": 1}
    timed = SPMV.Timed({"A": a}, traffic, {"canonical": True}, None,
                       2**31 + 3, "cpu")
    for i in range(5):
        y = timed.answer(timed.call(i))
        want = np_spmv(a, timed.xs[timed.key(i)])
        assert y.dtype == a.data.dtype and y.shape == (a.shape[0],)
        tol = 1e-12 if a.data.dtype == torch.float64 else 1e-5
        np.testing.assert_allclose(y.numpy(), want, rtol=tol, atol=tol)
        ref = timed.expected(timed.key(i))
        assert check.numbers_of(y, ref)["value_err"] < tol
    # the program gets its own copies of the pool
    assert timed._xs[0].data_ptr() != timed.xs[0].data_ptr()


def test_dense_check_numbers():
    r = torch.tensor([1.0, -4.0, 2.0], dtype=torch.float64)
    assert check.numbers_of(r.clone(), r) == {"shape_mismatch": 0.0,
                                              "value_err": 0.0}
    assert check.numbers_of(r[:2], r) == {"shape_mismatch": 1.0,
                                          "value_err": None}
    assert check.numbers_of(r[None], r)["shape_mismatch"] == 1.0
    y = r.to(torch.float32)
    y[1] += 0.5
    assert check.numbers_of(y, r) == {"shape_mismatch": 0.0,
                                      "value_err": 0.5 / 4.0}
    y[2] = float("nan")
    assert check.numbers_of(y, r) == {"shape_mismatch": 0.0,
                                      "value_err": None}
    limits = {"shape_mismatch": 0, "value_err": 1e-10}
    for got in (r[:2], y):
        seen = {"numbers": check.numbers_of(got, r), "compared": 1}
        ok, lines, checks = check.judge(seen, limits, 0, 1)
        assert not ok and check.numbers_over(checks)


# The configuration, mixes and limits of HPCG's SpMV, for `add_hpcg_cells`.
# value_err's limit here only serves this proof: a sound float64 run reads
# about 1e-16, the float32 control about 1e-8
# (`test_reference_control_rounds_one_precision_below`).
HPCG = {
    "source": "https://github.com/hpcg-benchmark/hpcg",
    "study": "src/GenerateProblem_ref.cpp: the 27-point stencil, 26 on the "
             "diagonal, -1 off it; bin/hpcg.dat: local grid 104 104 104; "
             "float64, as HPCG computes",
    "format": "csr", "dtype": "float64", "precision": "highest",
    "canonical": True,
    "matrices": {"A": {"law": "stencil27", "grid": [104, 104, 104]}},
    "reduced": [],
}
MIXES = {"spmv-plan": True, "spmv-oneshot": False}
READER = '''"""spmv_roofline: the least time for an SpMV call's work (bytes over
the memory bandwidth, operations over the float64 peak) over its device
busy time, in %."""


def read(run):
    if (run.trace is None or run.work is None or run.peaks is None
            or not run.calls_s or not run.trace.busy_s):
        return None
    least_s = max(run.work["flops"] / run.peaks["fp64_flops_per_s"],
                  run.work["bytes"] / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / (run.trace.busy_s / len(run.calls_s))
'''


def add_hpcg_cells(root: Path) -> list:
    """Add HPCG's SpMV cells to the benchmark at `root` with new files and
    new BENCHMARK.json entries only; returns the cells' names."""
    bench = root / "cardbench"
    (bench / "configs" / "hpcg-104.json").write_text(json.dumps(HPCG))
    cells = []
    for mix, plan in MIXES.items():
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(
            {"entry": "spmv", "plan": plan, "pool": 16,
             "pool_seed_offset": 0, "warmup_calls": 8}))
        cell = f"hpcg-104.{mix}"
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"limits": {"shape_mismatch": 0, "value_err": 1e-10}}))
        cells.append(cell)
    (bench / "metrics" / "spmv_roofline.py").write_text(READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "hpcg-104", "source": HPCG["source"],
                            "file": "cardbench/configs/hpcg-104.json",
                            "reduced": [], "why": "HPCG's SpMV"})
    spec["workloads"] += [{"name": c, "config": "hpcg-104",
                           "traffic": c.split(".", 1)[1], "chips": 1,
                           "why": "HPCG's SpMV"} for c in cells]
    spec["end_to_end"].append({"name": "call_p95_ms.hpcg", "unit": "ms",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock", "workloads": cells})
    for name, unit, better, layer in (
            ("spmv_roofline", "%", "higher", "kernels"),
            ("busy_ms.hpcg", "ms", "lower", "device"),
            ("device_idle.hpcg", "%", "lower", "device")):
        spec["per_layer"].append({
            "name": name, "unit": unit, "better": better,
            "source": "device_trace", "layer": layer, "moves": "call_ms",
            "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return cells


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def env():
    e = dict(os.environ)
    e.pop("PYTHONPATH", None)
    return e


def test_a_cell_of_another_entry_and_law_added_as_new_files(tmp_path):
    """A float64 `stencil27` configuration and SpMV cells come as new files
    and BENCHMARK.json entries: they run correct at the law's small size,
    the entry's control and each fault are caught by a number, the copied
    tests parametrised over cells take the new cells and pass, and every
    file there before keeps its bytes."""
    skip = shutil.ignore_patterns("__pycache__")
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench", ignore=skip)
    shutil.copytree(ROOT / "spmm_tpu_torch", tmp_path / "spmm_tpu_torch",
                    ignore=skip)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = digest(tmp_path / "cardbench")
    cells = add_hpcg_cells(tmp_path)
    for cell in cells:
        small = harness.small(cell, tmp_path)
        assert small == {"matrices": {"A": {"law": "stencil27",
                                            "grid": [6, 5, 4]}}}
        result, _ = harness.run_cell(cell, 2**31 + 21, 0.3, True,
                                     device="cpu", root=tmp_path,
                                     config_patch=small)
        assert result["correct"], result
        assert result["checks"]["value_err"]["value"] < 1e-14
        entry = harness.load_entry(harness.load_cell(cell, tmp_path),
                                   tmp_path)
        for wrap in [entry.control, *entry.faults.values()]:
            r, _ = harness.run_cell(cell, 2**31 + 22, 0.3, False,
                                    device="cpu", root=tmp_path,
                                    config_patch=small, wrap=wrap)
            assert (not r["correct"] and r["failed"] == 0
                    and check.numbers_over(r["checks"])), (wrap, r)
    after = digest(tmp_path / "cardbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == sorted(
        ["configs/hpcg-104.json", "metrics/spmv_roofline.py"]
        + [f"traffic/{m}.json" for m in MIXES]
        + [f"workloads/{c}.json" for c in cells])

    tests = str(tmp_path / "cardbench" / "tests")
    opts = ["-p", "no:cacheprovider", "-q"]
    out = subprocess.run(
        [sys.executable, "-m", "pytest", tests, "--collect-only", *opts],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=env())
    assert out.returncode == 0, out.stdout[-3000:]
    ids = [line for line in out.stdout.splitlines() if "::" in line]

    def functions(cell):
        """The test functions with a case of `cell`."""
        return {i.split("[")[0] for i in ids if f"[{cell}" in i}
    assert functions(CELLS[0])
    for cell in cells:
        assert functions(CELLS[0]) <= functions(cell), cell
    out = subprocess.run(
        [sys.executable, "-m", "pytest", tests, "-k", "hpcg", *opts],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=env())
    assert out.returncode == 0, out.stdout[-3000:]
    assert " passed" in out.stdout and "failed" not in out.stdout

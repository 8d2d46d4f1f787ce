"""The port's experiment suites on the CPU at a tiny grid (sizes 32 and
64, densities 0.1 and 0.5, one seed, algs 1-3): the determinism suite
(each alg and seed generated twice in processes of their own, the dumps
compared byte for byte) and the cross-check against the native C++
replay (`native/spgemm_cross_check.cpp`, built with g++; skipped without
it).  On the card the same suites run from chip_smoke.py, phase 20.
"""

import shutil

import pytest

pytest.importorskip("torch")

from spmm_tpu_torch.experiments import (cross_check,  # noqa: E402
                                        deterministic, run_alg)

GRID = ["--sizes", "32", "64", "--densities", "0.1", "0.5"]


def test_determinism_suite_on_cpu(tmp_path, capsys):
    report = tmp_path / "determinism_report.txt"
    rc = deterministic.main(GRID + ["--seeds", "1", "--algs", "1", "2", "3",
                                    "--device", "cpu",
                                    "--report", str(report)])
    lines = report.read_text().splitlines()
    assert rc == 0, lines
    assert lines[0].startswith("# determinism grid: sizes=[32, 64]")
    assert lines[1] == "# device=cpu card=[none]"
    assert [ln for ln in lines if not ln.startswith("#")] == [
        "alg1 seed=1: deterministic", "alg2 seed=1: deterministic",
        "alg3 seed=1: deterministic", "ALL DETERMINISTIC"]
    assert capsys.readouterr().out.splitlines()[-1] == "ALL DETERMINISTIC"


def test_run_alg_dump_format(tmp_path):
    """nnz, indptr, indices and the data's bits, per size and density."""
    out = tmp_path / "dump.txt"
    run_alg.main(["--alg", "2", "--out", str(out), "--seed", "3",
                  "--sizes", "16", "--densities", "0.2", "--device", "cpu"])
    lines = out.read_text().splitlines()
    assert lines[0] == "# size=16 density=0.2 alg=2"
    nnz = int(lines[1].split()[1])
    assert len(lines) == 2 + 17 + 2 * nnz
    assert int(lines[2 + 16]) == nnz  # the last indptr entry
    assert all(ln.isdigit() for ln in lines[2:])


def test_cross_check_on_cpu(tmp_path, capsys):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/spgemm_cross_check.cpp")
    report = tmp_path / "cross_check_report.txt"
    rc = cross_check.main(GRID + ["--algs", "1", "2", "3", "--device", "cpu",
                                  "--report", str(report)])
    lines = report.read_text().splitlines()
    rows = [ln for ln in lines if not ln.startswith("#")]
    assert rc == 0, rows
    assert len(rows) == 12 and all(r.startswith("PASS") for r in rows)
    assert lines[1] == "# device=cpu card=[none]"
    assert capsys.readouterr().out.splitlines()[-1] == "12 of 12 cases pass"

"""The port's speed drivers (`spmm_tpu_torch.benchmarks`) on the CPU, at
sizes of at most 64, held against the JAX package and its scripts.

Each alg_comparison cell's operands, made by the port's generator, go as
the same host arrays to `spmm_tpu.spgemm`: the port's alg 1-3 products
have JAX's structure bitwise and its values within rtol 1e-6 plus atol
1e-6 * max|C| (the blocked engines' GEMMs sum in another order), and
bitwise where both run ESC.  The crossover rule is held against
`benchmarks/dense_vs_sparse.py`'s own loop, and `REFERENCE` against
`benchmarks/alg_comparison.py`'s table, both scripts loaded by path.  On
the card the drivers run from chip_smoke.py, phase 21.
"""

import ast
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import spmm_tpu_torch.benchmarks.__main__ as sweep  # noqa: E402
from spmm_tpu_torch.benchmarks import (alg_comparison,  # noqa: E402
                                       component_profile, dense_vs_sparse,
                                       make_figures, spgemm_vs_spmv)
from spmm_tpu_torch.experiments import numerical_error  # noqa: E402
from torch_port_helpers import (assert_csr_bitwise,  # noqa: E402
                                assert_csr_match)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")


def _jax_script(name):
    """A JAX benchmark script of `benchmarks/`, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_jax(x):
    import spmm_tpu as st

    return st.CSR.from_parts(x.indptr.numpy(), x.indices.numpy(),
                             x.data.numpy(), tuple(x.shape), canonical=True)


def _json_rows(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_reference_table_equals_jax_scripts():
    assert alg_comparison.REFERENCE == _jax_script("alg_comparison").REFERENCE


@pytest.mark.parametrize("size,density", [(32, 0.1), (64, 0.1), (64, 0.5)])
@pytest.mark.parametrize("impl", ["auto", "esc"])
def test_alg_comparison_products_match_jax(monkeypatch, size, density,
                                           impl):
    """alg 1-3 at one cell: structure bitwise JAX's; values within 1e-6 on
    the blocked engines and alg1, bitwise on ESC (`_blocked_feasible`
    turned off in the port, `impl="esc"` in JAX)."""
    import spmm_tpu as st

    a, b = alg_comparison.operands(size, density, 2008, "cpu")
    if impl == "esc":
        monkeypatch.setattr(sg, "_blocked_feasible", lambda a, b: False)
    got = alg_comparison.products(a, b, (1, 2, 3), 0.2)
    ra, rb = _as_jax(a), _as_jax(b)
    for alg, c in got.items():
        want = st.spgemm(ra, rb, alg=alg, chunk_fraction=0.2, impl=impl)
        if impl == "esc" and alg != 1:
            assert_csr_bitwise(c, want)
        else:
            assert_csr_match(c, want)
    engines = [alg_comparison.spgemm_engine(a, b, alg, 0.2) for alg in (2, 3)]
    assert engines == (["esc", "esc"] if impl == "esc"
                       else ["unrolled", "group"])


def test_alg_comparison_rows_on_cpu(tmp_path, capsys):
    """Every alg's row with JAX's keys and the port's own; the grid file
    merges cells across calls."""
    grid = tmp_path / "grid.json"
    for density in ("0.1", "0.5"):
        alg_comparison.main(["--size", "32", "--density", density, "--runs",
                             "1", "--warmup", "1", "--memory", "--json",
                             "--save-grid", str(grid)] + CPU)
    rows = _json_rows(capsys.readouterr().out)
    assert [(r["density"], r["alg"]) for r in rows] == [
        (d, a) for d in (0.1, 0.5) for a in (1, 2, 3)]
    for r in rows:
        assert {"bench", "size", "density", "alg", "median_ms",
                "delta_hbm_bytes", "peak_hbm_bytes", "device", "busy_ms",
                "engine", "cusparse_ms", "per_call_ms"} <= set(r)
        assert r["median_ms"] > 0 and r["cusparse_ms"] > 0
        assert r["per_call_ms"] > 0
        assert r["device"] == "cpu" and r["busy_ms"] is None
    saved = json.loads(grid.read_text())
    assert len(saved["cells"]) == 6 and saved["device"] == "cpu"


def test_product_limit_is_skipped_and_other_errors_raised(capsys):
    """ESC's refusal past 2^31 products prints [SKIP] with its words (as an
    out-of-memory does); any other ValueError is raised."""
    from spmm_tpu_torch.benchmarks.common import timed

    def past_limit():
        sg._check_products(2**31, "alg=2")

    cpu = torch.device("cpu")
    assert timed("cell", past_limit, 1, 0, cpu) is None
    out = capsys.readouterr().out
    assert out.startswith("[SKIP] cell: ValueError: spgemm ESC: alg=2 holds")

    def other():
        raise ValueError("dimension mismatch")

    with pytest.raises(ValueError, match="dimension mismatch"):
        timed("cell", other, 1, 0, cpu)


def test_library_refusal_is_skipped(monkeypatch, capsys):
    """A library CSR @ CSR that fails gives no cusparse_ms and a [SKIP]
    line; the port's rows stand."""
    def refuse(*a, **k):
        raise RuntimeError("CUDA error: insufficient resources")

    monkeypatch.setattr(alg_comparison, "benchmark", refuse)
    a, b = alg_comparison.operands(16, 0.2, 1, "cpu")
    assert alg_comparison.library_ms(a, b, torch.device("cpu")) is None
    assert "[SKIP] torch CSR @ CSR: RuntimeError" in capsys.readouterr().out


def test_library_errors_other_than_a_refusal_are_raised(monkeypatch):
    """Only cuSPARSE's want of resources is skipped: any other error of the
    library call (a fault left by an earlier kernel, say) is raised."""
    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(alg_comparison, "benchmark", fault)
    a, b = alg_comparison.operands(16, 0.2, 1, "cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        alg_comparison.library_ms(a, b, torch.device("cpu"))


ENGINE_CASES = {
    # (alg, limits of spgemm_blocked set for the case) -> the engine
    "alg1": (1, {}),
    "alg0 to alg1": (0, {}),
    "alg2 unrolled": (2, {}),
    "alg2 scan": (2, {"_ALG2_MAX_UNROLL_TILES": 0}),
    "alg3 group": (3, {}),
    "alg3 unrolled": (3, {"_GROUP_MAX_BLOCKS": 0}),
    "alg3 scan3": (3, {"_GROUP_MAX_BLOCKS": 0, "MAX_UNROLL_BLOCKS": 0}),
    "alg3 scan2": (3, {"_GROUP_MAX_BLOCKS": 0, "MAX_UNROLL_BLOCKS": 0,
                       "_SCAN3_MAX_TILES": 0}),
    "alg2 esc": (2, "esc"),
    "alg3 esc": (3, "esc"),
    # alg 0 within the dense budget, with ESC's modelled cost set to nothing
    "alg0 esc": (0, {"_ESC_FIXED_S": 0.0, "_ESC_PRODUCT_S": 0.0}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_spgemm_engine_names_what_runs(monkeypatch, case):
    """`spgemm_engine` names the engine `spgemm` then runs, found here by
    wrapping each engine's entry, with the blocked engines' limits (or
    alg 0's cost model) set so that each is reached at 200^2."""
    bl = importlib.import_module("spmm_tpu_torch.ops.spgemm_blocked")
    alg, limits = ENGINE_CASES[case]
    if limits == "esc":
        monkeypatch.setattr(sg, "_blocked_feasible", lambda a, b: False)
    else:
        for k, v in limits.items():
            monkeypatch.setattr(bl if hasattr(bl, k) else sg, k, v)
    ran = []

    def wrap(mod, fn, name):
        inner = getattr(mod, fn)

        def run(*a, **k):
            ran.append(name)
            return inner(*a, **k)
        monkeypatch.setattr(mod, fn, run)

    wrap(sg, "_spgemm_alg1", "alg1")
    wrap(sg, "_spgemm_alg2_esc", "esc")
    wrap(sg, "_spgemm_alg3_esc", "esc")
    wrap(bl, "_alg2_compute_unrolled", "unrolled")
    wrap(bl, "_alg2_compute", "scan")
    for e in ("group", "unrolled", "scan3", "scan2"):
        wrap(bl, f"_spgemm_alg3_{e}", e)
    a, b = alg_comparison.operands(200, 0.05, 3, "cpu")
    named = alg_comparison.spgemm_engine(a, b, alg, 0.2)
    assert not ran
    sg.spgemm(a, b, alg=alg, chunk_fraction=0.2)
    assert ran == [named] and case.split()[-1] == named


def test_device_loop_needs_the_card(capsys):
    with pytest.raises(ValueError, match="needs the card"):
        alg_comparison.main(["--size", "16", "--device-loop"] + CPU)
    assert capsys.readouterr().out == ""


class _Fake:
    def __init__(self, ms):
        self.median_ms = ms


# hand-made sweeps: (density, dense ms, sparse ms), None = skipped
SWEEPS = {
    1: [(0.001, 1.0, 0.5), (0.01, 1.0, 0.8), (0.1, 1.0, 1.5)],
    2: [(0.001, 1.0, 2.0), (0.01, 1.0, 3.0), (0.1, 1.0, 4.0)],   # never
    3: [(0.001, 1.0, 0.1), (0.01, 1.0, 0.2), (0.1, 1.0, 0.3)],   # always
    4: [(0.001, 1.0, 0.5), (0.01, None, 0.5), (0.1, 1.0, 2.0)],  # gap
    5: [(0.001, 1.0, 2.0), (0.01, 1.0, 0.5), (0.1, 1.0, 1.0)],
    6: [(0.001, 1.0, 0.5), (0.01, 1.0, 1.0), (0.1, 1.0, 0.5)],   # equal
}


def _fake_result(size, density):
    _, dense, sparse = next(p for p in SWEEPS[size] if p[0] == density)
    out = {"engine": "fake"}
    if dense is not None:
        out["dense"] = _Fake(dense)
    if sparse is not None:
        out["sparse"] = _Fake(sparse)
    return out


def test_crossover_agrees_with_jax_rule(monkeypatch, capsys):
    """`crossover`, and the port's main loop around it, against the loop
    of `benchmarks/dense_vs_sparse.py` on the same hand-made results."""
    jax_script = _jax_script("dense_vs_sparse")
    # its sweep clears JAX's caches between cells; the rule needs no device
    monkeypatch.setattr(jax_script.profiler, "cleanup_device", lambda: None)
    monkeypatch.setattr(jax_script, "run_case",
                        lambda size, density, *a, **k:
                        _fake_result(size, density))
    argv = ["--size", *map(str, SWEEPS), "--density", "0.001", "0.01", "0.1"]
    jax_script.main(argv)
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("break-even densities:")]
    want = ast.literal_eval(line[0].split(":", 1)[1].strip())
    assert want == {1: 0.1, 5: 0.1, 6: 0.01}  # 4: the gap resets it
    assert {s: d for s, pts in SWEEPS.items()
            if (d := dense_vs_sparse.crossover(pts)) is not None} == want
    monkeypatch.setattr(dense_vs_sparse, "run_case",
                        lambda size, density, *a, **k:
                        _fake_result(size, density))
    assert dense_vs_sparse.main(argv + CPU) == want


def test_crossover_edges():
    assert dense_vs_sparse.crossover([]) is None
    assert dense_vs_sparse.crossover([(0.1, 1.0, 0.5)]) is None
    assert dense_vs_sparse.crossover([(0.1, None, None),
                                      (0.2, 1.0, 2.0)]) is None


@pytest.mark.parametrize("op", ["spgemm", "spmm"])
def test_dense_vs_sparse_on_cpu(capsys, op):
    dense_vs_sparse.main(["--size", "32", "--density", "0.05", "0.3",
                          "--runs", "1", "--op", op, "--json"] + CPU)
    rows = _json_rows(capsys.readouterr().out)
    assert [r["density"] for r in rows] == [0.05, 0.3]
    for r in rows:
        assert r["dense_ms"] > 0 and r["sparse_ms"] > 0
        assert r["engine"] == ("unrolled" if op == "spgemm" else "spmm_csr")


def test_dense_side_is_ieee_matmul():
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.random((16, 16), dtype=np.float32))
            for _ in range(2))
    assert torch.equal(dense_vs_sparse.dense_mm(a, b), a @ b)


def test_fork_profiler_positive():
    a = spgemm_vs_spmv.gen_cpu(64, 0.1, "csr", 0)
    b = spgemm_vs_spmv.gen_cpu(64, 0.1, "csc", 1)
    ms, drss, warm = spgemm_vs_spmv.profile_op_cpu(lambda: a @ b, 2)
    assert ms > 0 and warm > 0 and isinstance(drss, int) and drss >= 0


def test_fork_profiler_carries_a_child_error():
    def boom():
        raise ValueError("in the child")

    with pytest.raises(RuntimeError, match="in the child"):
        spgemm_vs_spmv.profile_op_cpu(boom, 1)


def test_spgemm_vs_spmv_rows_on_cpu(capsys):
    """9 SpGEMM and 3 SpMV rows with the JAX script's keys, `gpu_ms` for
    its `tpu_ms`."""
    spgemm_vs_spmv.main(["--size", "32", "--density", "0.1", "--runs", "2",
                         "--json"] + CPU)
    out = capsys.readouterr().out
    rows = _json_rows(out)
    assert [r["op"] for r in rows] == ["spgemm"] * 9 + ["spmv"] * 3
    assert [r["pair"] for r in rows[:9]] == [
        f"{x}@{y}" for x in ("csr", "csc", "coo") for y in ("csr", "csc",
                                                            "coo")]
    jax_keys = {"bench", "op", "pair", "size", "density", "cpu_ms",
                "tpu_ms"}
    for r in rows:
        assert jax_keys - {"tpu_ms"} | {"gpu_ms"} <= set(r)
        assert "tpu_ms" not in r
        assert r["cpu_ms"] > 0 and r["gpu_ms"] > 0 and r["cpu_warm_ms"] > 0
        assert r["gpu_busy_ms"] is None  # a profiler trace of the card
    assert "best device spgemm pair:" in out


@pytest.mark.parametrize("fa,fb", [("csr", "csc"), ("coo", "coo")])
def test_spgemm_vs_spmv_products_match_jax(fa, fb):
    """The timed closures' products against JAX's on the same triplets."""
    import spmm_tpu as st

    a = spgemm_vs_spmv.gen_cpu(32, 0.2, fa, 0)
    b = spgemm_vs_spmv.gen_cpu(32, 0.2, fb, 1)
    ah, bh = spgemm_vs_spmv.triplets(a), spgemm_vs_spmv.triplets(b)
    got = spgemm_vs_spmv.spgemm_op(ah, bh, (32, 32), fa, fb, "cpu")()
    ja = st.COO((ah[2], (ah[0], ah[1])), shape=(32, 32)).asformat(fa)
    jb = st.COO((bh[2], (bh[0], bh[1])), shape=(32, 32)).asformat(fb)
    want = np.asarray((ja @ jb).data)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    v = np.random.default_rng(9).random(32, dtype=np.float32)
    y = spgemm_vs_spmv.spmv_op(ah, (32, 32), fa, v, "cpu")()
    np.testing.assert_allclose(y.numpy(), np.asarray(st.spmv(ja, v)),
                               rtol=1e-6, atol=1e-6)


def test_component_profile_prints_every_stage(capsys):
    rows = component_profile.main(["--size", "48", "--runs", "1"] + CPU)
    out = capsys.readouterr().out
    for stage in component_profile.STAGES:
        assert any(ln.strip().startswith(stage) and " ms" in ln
                   for ln in out.splitlines()), stage
    assert [r["stage"] for r in rows] == list(component_profile.STAGES)
    assert all(r["ms"] > 0 for r in rows)


def test_make_figures_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    lines = [
        "# a header line, skipped",
        *(json.dumps({"bench": "alg_comparison", "size": 32,
                      "density": d, "alg": alg, "median_ms": 0.1 * alg,
                      "delta_hbm_bytes": 2**20 * alg,
                      "cusparse_ms": 0.2}) for d in (0.1, 0.5)
          for alg in (1, 2, 3)),
        *(json.dumps({"bench": "dense_vs_sparse", "size": s, "density": d,
                      "dense_ms": 1.0, "sparse_ms": d * 10})
          for s in (32, 64) for d in (0.01, 0.1, 0.5)),
    ]
    results = tmp_path / "results.txt"
    results.write_text("\n".join(lines) + "\n")
    grid = tmp_path / "grid.json"
    alg_comparison.save_grid(str(grid), [json.loads(x) for x in lines[1:7]],
                             "cpu")
    written = make_figures.main([str(results), "--outdir",
                                 str(tmp_path / "fig"), "--grid-json",
                                 str(grid)])
    assert sorted(Path(w).name for w in written) == [
        "alg_comparison.png", "alg_comparison_grid.png",
        "runtime_vs_density.png"]
    for w in written:
        assert Path(w).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


DRIVERS = {
    "alg_comparison": (alg_comparison.main, ["--size", "16"]),
    "dense_vs_sparse": (dense_vs_sparse.main, ["--size", "16"]),
    "spgemm_vs_spmv": (spgemm_vs_spmv.main, ["--size", "16"]),
    "component_profile": (component_profile.main, ["--size", "16"]),
    "numerical_error": (numerical_error.main, ["error", "--sizes", "16"]),
    "sweep": (sweep.main, ["--sizes", "16"]),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_drivers_refuse_a_missing_card(monkeypatch, capsys, tmp_path, name):
    """Without `--device cpu` and without a card each driver raises, and
    prints nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main, argv = DRIVERS[name]
    with pytest.raises(RuntimeError, match="unless --device cpu is given"):
        main(argv)
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []


def test_sweep_tees_the_three_drivers(tmp_path, capsys, monkeypatch):
    """The sweep gives each driver run.sh's arguments under --json, in
    run.sh's order, and writes to the file what it prints."""
    calls = []

    def fake(name):
        def main(argv):
            calls.append((name, argv))
            print(f"row of {name}")
        return main

    for mod in (alg_comparison, dense_vs_sparse, spgemm_vs_spmv):
        monkeypatch.setattr(mod, "main", fake(mod.__name__.split(".")[-1]))
    out = tmp_path / "sweep.txt"
    sweep.main(["--out", str(out), "--runs", "7", "--sizes", "16", "32",
                "--densities", "0.2"] + CPU)
    assert calls == [
        ("alg_comparison", ["--size", "16", "32", "--density", "0.2",
                            "--runs", "7", "--json"] + CPU),
        ("dense_vs_sparse", ["--runs", "7", "--json"] + CPU),
        ("spgemm_vs_spmv", ["--runs", "20", "--json"] + CPU)]
    text = out.read_text()
    assert text == capsys.readouterr().out
    lines = text.splitlines()
    assert lines[0].startswith("# spmm_tpu_torch benchmark sweep ")
    assert lines[1].startswith("# device: cpu; torch ")
    assert lines[2:] == ["## alg comparison", "row of alg_comparison",
                         "## dense vs sparse", "row of dense_vs_sparse",
                         "## spgemm vs spmv", "row of spgemm_vs_spmv"]


def test_driver_modules_import_neither_jax_nor_spmm_tpu():
    code = (
        "import sys\n"
        "import spmm_tpu_torch.benchmarks.alg_comparison, "
        "spmm_tpu_torch.benchmarks.dense_vs_sparse, "
        "spmm_tpu_torch.benchmarks.spgemm_vs_spmv, "
        "spmm_tpu_torch.benchmarks.component_profile, "
        "spmm_tpu_torch.benchmarks.make_figures, "
        "spmm_tpu_torch.benchmarks.__main__, "
        "spmm_tpu_torch.experiments.numerical_error\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spmm_tpu' or m.startswith('spmm_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)

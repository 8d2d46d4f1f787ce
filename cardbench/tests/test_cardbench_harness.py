"""CPU tests of the benchmark's pieces: SpGEMM's work counts and
reference, the names in BENCHMARK.json, discovery by name, readers and the
trace reading.

    python -m pytest cardbench/tests -q -p no:cacheprovider
"""

import hashlib
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cardbench import check, harness, tracing  # noqa: E402
from cardbench.files import load_file  # noqa: E402
from cardbench.reference import spgemm as reference  # noqa: E402
from cardbench.reference.rounding import round_tf32  # noqa: E402
from cardbench.work import spgemm as counts  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
uniform_csr = load_file(ROOT / "cardbench" / "laws" / "uniform.py"
                        ).uniform_csr


def dense(m):
    d = np.zeros(m.shape, np.float64)
    ip = m.indptr.numpy()
    for r in range(m.shape[0]):
        for j in range(ip[r], ip[r + 1]):
            d[r, int(m.indices[j])] += float(m.data[j])
    return d


def small_pair(seed=7):
    a = uniform_csr(48, 40, 0.1, seed, device="cpu")
    b = uniform_csr(40, 56, 0.2, seed + 1, device="cpu")
    return a, b


def test_operands_have_exact_count_and_canonical_rows():
    m = uniform_csr(30, 50, 0.1, 2**31 + 3, device="cpu")
    assert m.indices.numel() == m.data.numel() == int(0.1 * 30 * 50)
    ip = m.indptr.tolist()
    assert ip[0] == 0 and ip[-1] == m.indices.numel()
    for r in range(30):
        row = m.indices[ip[r]:ip[r + 1]].tolist()
        assert row == sorted(set(row))
    assert 0 <= float(m.data.min()) and float(m.data.max()) < 1
    again = uniform_csr(30, 50, 0.1, 2**31 + 3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(m[:3], again[:3]))


def test_work_counts_by_hand():
    a, b = small_pair()
    lens = np.diff(b.indptr.numpy())
    P = int(lens[a.indices.numpy()].sum())
    assert counts.products(a.indices, b.indptr) == P
    w = counts.spgemm_call(a, b, nnz_c=100)
    nnz_a, nnz_b = a.indices.numel(), b.indices.numel()
    assert w["flops"] == 2 * P
    assert w["bytes"] == (49 * 4 + nnz_a * 8) + (41 * 4 + nnz_b * 8) + (
        49 * 4 + 100 * 8)
    w = counts.plan_call(a, b, nnz_c=100)
    assert w == {"flops": 2 * P, "bytes": (nnz_a + nnz_b + 100) * 4}


def test_reference_against_dense_numpy():
    a, b = small_pair()
    ip, ix, v = reference.spgemm(a, b, block_rows=7)
    da, db = dense(a), dense(b)
    want = da @ db
    pattern = ((da != 0) * 1.0) @ ((db != 0) * 1.0) > 0
    got = np.zeros_like(want)
    mask = np.zeros_like(pattern)
    for r in range(want.shape[0]):
        cols = ix[ip[r]:ip[r + 1]].numpy()
        assert list(cols) == sorted(cols)
        got[r, cols] = v[ip[r]:ip[r + 1]].numpy()
        mask[r, cols] = True
    np.testing.assert_array_equal(mask, pattern)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_reference_tf32_rounds_the_operands():
    x = torch.rand(1000, dtype=torch.float32)
    t = round_tf32(x)
    assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((t - x).abs() / x).max()) <= 2.0**-11
    a, b = small_pair()
    exact = reference.spgemm(a, b)
    low = reference.spgemm(a, b, operand_round="tf32")
    assert torch.equal(exact[1], low[1])
    err = float((exact[2] - low[2]).abs().max() / exact[2].abs().max())
    assert 1e-6 < err < 2e-3


def test_names_and_units_use_only_the_allowed_characters():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in metrics]
             + [w["config"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in SPEC[group]]
        assert len(seen) == len(set(seen))
    seen = [m["name"] for m in metrics]
    assert len(seen) == len(set(seen))
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p


def test_benchmark_json_has_the_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_is_found_as_a_file():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (ROOT / "cardbench" / "entries"
                / f"{cell.traffic['entry']}.py").is_file()
        assert set(cell.limits) in [set(k) for k in check.KINDS.values()]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_mix_config_and_metric_added_as_new_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric with new files and new BENCHMARK.json entries only."""
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    before = digest(tmp_path / "cardbench")
    bench = tmp_path / "cardbench"
    cfg = json.loads((ROOT / SPEC["configs"][0]["file"]).read_text())
    cfg["matrices"]["A"]["density"] = 0.2
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "alg2-new.json").write_text(json.dumps(
        {"entry": "spgemm", "kwargs": {"alg": 2}, "warmup_calls": 1}))
    (bench / "workloads" / "tiny-new.alg2.json").write_text(json.dumps(
        {"limits": {"structure_mismatch": 0, "value_err": 1e-5}}))
    (bench / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return float(len(run.calls_s))\n")
    spec["configs"].append({"name": "tiny-new", "source": "https://x.org",
                            "file": "cardbench/configs/tiny-new.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-new.alg2", "config": "tiny-new",
                              "traffic": "alg2-new", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "calls_seen", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry and engines",
                              "moves": "call_ms",
                              "workloads": ["tiny-new.alg2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = harness.run_cell(
        "tiny-new.alg2", 5, 0.2, True, device="cpu", root=tmp_path,
        config_patch=harness.small("tiny-new.alg2", tmp_path))
    assert result["correct"], result
    assert result["metrics"]["calls_seen"]["value"] >= 1
    after = digest(tmp_path / "cardbench")
    assert {k: v for k, v in after.items() if k in before} == before


def run_of(**kw):
    base = dict(setup_s=2.0, window_s=1.0, calls_s=[0.01] * 100,
                attempted=100, failed=0, peak_window_bytes=2**21,
                launches={"k": 300})
    base.update(kw)
    return harness.Run(**base)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    run = run_of()
    assert harness.load_reader("call_ms")(run) == pytest.approx(10.0)
    assert harness.load_reader("peak_mem_mb")(run) == pytest.approx(2.0)
    assert harness.load_reader("launches")(run) == pytest.approx(3.0)
    for name in ("busy_ms", "device_idle", "gemm_ms", "spgemm_roofline"):
        assert harness.load_reader(name)(run) is None
    run.trace = tracing.Trace(busy_s=0.5, window_s=1.0,
                              device_ops={"densify_rows": 0.5})
    assert harness.load_reader("gemm_ms")(run) is None
    assert harness.load_reader("spgemm_roofline")(run) is None  # no work
    run.work = {"flops": 2e6, "bytes": 3.35e6}
    run.peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    # 1 us of bytes over 5 ms of busy time a call
    assert harness.load_reader("spgemm_roofline")(run) == pytest.approx(0.02)
    assert harness.load_reader("device_idle")(run) == pytest.approx(50.0)


def test_a_dotted_metric_shares_its_base_reader():
    run = run_of()
    assert harness.load_reader("call_ms.some_group")(run) == \
        harness.load_reader("call_ms")(run)


def test_p95_is_of_every_call():
    run = run_of(calls_s=[i / 1000 for i in range(1, 101)])
    assert harness.load_reader("call_p95_ms")(run) == pytest.approx(95.05)


def test_trace_summary_busy_keep_and_idle_names():
    host = [(0, 1000, tracing.WINDOW), (100, 300, "cardbench.call"),
            (120, 200, "aten::mm"), (600, 700, tracing.KEEP),
            (500, 900, "cardbench.call")]
    device = [(150, 250, "sgemm_kernel"), (200, 280, "densify_rows"),
              (610, 690, "Memcpy DtoH"), (950, 1100, "extract_tiles")]
    t = tracing.summarize(host, device)
    assert t.window_s == pytest.approx(1000 / 1e9)
    assert t.busy_s == pytest.approx((130 + 50) / 1e9)
    assert "Memcpy DtoH" not in t.device_ops
    assert t.device_ops["extract_tiles"] == pytest.approx(50 / 1e9)
    # gaps: 0-150 (mid 75: nothing), 280-950 (mid 615: the keep span is
    # not a host activity of the program; cardbench.call is open)
    assert t.idle_gaps == {"harness loop": pytest.approx(150 / 1e9),
                           "cardbench.call": pytest.approx(670 / 1e9)}
    assert tracing.innermost(host[1:], [150, 250, 800]) == [
        "aten::mm", "cardbench.call", "cardbench.call"]

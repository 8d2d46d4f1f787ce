"""The readers of the port's spans: `host_syncs`, `sync_wait_ms`,
`entry_ms`, `engine_host_ms` and `host_structure_ms`.

They read `spmm_tpu_torch.utils.profiler.span_totals()` after a traced
window and give nothing without a trace, without a root span, or with a
port that keeps no span totals.  Traced runs of every cell on the CPU at
its laws' small sizes report them where `BENCHMARK.json` lists them, and
the readers came as new files: every other file of the benchmark keeps its
bytes.

    python -m pytest cardbench/tests -q -p no:cacheprovider
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cardbench import harness, tracing  # noqa: E402
from spmm_tpu_torch.utils import profiler  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("host_syncs", "sync_wait_ms", "entry_ms", "engine_host_ms",
           "host_structure_ms")
NEW_FILES = [f"metrics/{name}.py" for name in READERS] + ["spans.py"]
CELLS = [w["name"] for w in SPEC["workloads"]]

# two alg3 calls by hand: each a root `spgemm` whose engine holds the
# structural product, two readbacks each
TOTALS = {
    "spgemm": {"count": 2, "total_ns": 300e6, "self_ns": 0.1e6, "roots": 2},
    "spgemm.alg3.blocked": {"count": 2, "total_ns": 299.9e6,
                            "self_ns": 50e6, "roots": 0},
    "spgemm.structure": {"count": 2, "total_ns": 247.9e6,
                         "self_ns": 246e6, "roots": 0},
    "sync.operands": {"count": 4, "total_ns": 3.9e6, "self_ns": 3.9e6,
                      "roots": 0},
}
PER_CALL = {"host_syncs": 2.0, "sync_wait_ms": 1.95, "entry_ms": 0.05,
            "engine_host_ms": 25.0, "host_structure_ms": 123.0}


def traced_run():
    run = harness.Run(setup_s=1.0, window_s=1.0, calls_s=[0.15, 0.15],
                      attempted=2, failed=0, peak_window_bytes=0,
                      launches={})
    run.trace = tracing.Trace(busy_s=0.01, window_s=1.0)
    return run


@pytest.mark.parametrize("name", READERS)
def test_reader_per_call_from_totals_set_by_hand(name, monkeypatch):
    monkeypatch.setattr(profiler, "span_totals", lambda: TOTALS)
    assert harness.load_reader(name)(traced_run()) == \
        pytest.approx(PER_CALL[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_without_trace_or_root(name, monkeypatch):
    monkeypatch.setattr(profiler, "span_totals", lambda: TOTALS)
    run = traced_run()
    run.trace = None
    assert harness.load_reader(name)(run) is None
    no_root = {k: dict(v, roots=0) for k, v in TOTALS.items()}
    monkeypatch.setattr(profiler, "span_totals", lambda: no_root)
    assert harness.load_reader(name)(traced_run()) is None
    monkeypatch.setattr(profiler, "span_totals", dict)
    assert harness.load_reader(name)(traced_run()) is None
    # a port without span totals, as before it had spans
    monkeypatch.delattr(profiler, "span_totals")
    assert harness.load_reader(name)(traced_run()) is None


def test_a_plan_call_reads_zero_syncs(monkeypatch):
    monkeypatch.setattr(profiler, "span_totals", lambda: {
        "spgemm_plan.call": {"count": 4, "total_ns": 0.2e6,
                             "self_ns": 0.2e6, "roots": 4}})
    assert harness.load_reader("host_syncs")(traced_run()) == 0
    assert harness.load_reader("entry_ms")(traced_run()) == \
        pytest.approx(0.05)


# host syncs a call of each of these cells makes
SYNCS = {"n1024-d0.1.alg1": 1, "n8192-d0.001.auto": 1,
         "n1024-d0.1.alg3": 2, "n1024-d0.1.plan": 0}


def listed_span_metrics(cell):
    """The metrics of the span readers that BENCHMARK.json lists for a
    cell (a `<reader>.<group>` metric by its reader)."""
    return {m["name"] for m in SPEC["per_layer"]
            if m["name"].split(".")[0] in READERS
            and cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_reports_its_listed_span_metrics(cell):
    profiler.reset_spans()
    try:
        result, _ = harness.run_cell(
            cell, 2**31 + 5, 0.2, True, device="cpu",
            config_patch=harness.small(cell, ROOT))
    finally:
        totals = profiler.span_totals()
        profiler.reset_spans()
    assert result["correct"], result
    listed = listed_span_metrics(cell)
    got = result["metrics"]
    assert listed <= set(got)
    if cell in SYNCS:
        syncs, = (n for n in listed if n.split(".")[0] == "host_syncs")
        assert got[syncs]["value"] == SYNCS[cell]
    assert all(got[name]["value"] >= 0 for name in listed)
    if listed:  # a cell that reads spans makes one root span a call
        roots = sum(t["roots"] for t in totals.values())
        assert roots == result["attempted"]


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_the_readers_came_as_new_files(tmp_path):
    """The benchmark without the five readers, then with them added as new
    files and new `per_layer` entries: every file there before keeps its
    bytes, and a traced run reports the new metrics."""
    bench = tmp_path / "cardbench"
    shutil.copytree(ROOT / "cardbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in NEW_FILES + ["tests/test_cardbench_spans.py"]:
        (bench / rel).unlink()
    spec = json.loads(json.dumps(SPEC))
    new = [m for m in spec["per_layer"] if m["name"] in READERS]
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] not in READERS]
    before = digest(bench)
    for rel in NEW_FILES:
        shutil.copy(ROOT / "cardbench" / rel, bench / rel)
    spec["per_layer"] += new
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # a cell that lists every one of the readers
    cell = next(c for c in CELLS if listed_span_metrics(c) >= set(READERS))
    profiler.reset_spans()
    try:
        result, _ = harness.run_cell(cell, 7, 0.2, True, device="cpu",
                                     root=tmp_path,
                                     config_patch=harness.small(cell,
                                                                tmp_path))
    finally:
        profiler.reset_spans()
    assert result["correct"], result
    assert set(READERS) <= set(result["metrics"])
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == sorted(NEW_FILES)

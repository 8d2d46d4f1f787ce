"""The SpMM cell `g500-s22.sage-mean-k100`: Graph500's Kronecker law, the
SpMM reference and work count, the entry, and the readers of its spans.

    python -m pytest cardbench/tests -q -p no:cacheprovider

The tests parametrised over every cell (`test_cardbench_correct.py`,
`test_cardbench_spans.py`, `test_cardbench_operands.py`,
`test_cardbench_isolation.py`) run this cell at its law's small size too:
a sound run is correct, its control and each of its faults are caught by
a number.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cardbench import check, harness, operands, tracing  # noqa: E402
from cardbench.files import load_file  # noqa: E402
from cardbench.reference import spmm as reference  # noqa: E402
from cardbench.work import spmm as counts  # noqa: E402
from spmm_tpu_torch.utils import profiler  # noqa: E402

CELL = "g500-s22.sage-mean-k100"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LAW = load_file(ROOT / "cardbench" / "laws" / "kronecker.py")
SPMM = load_file(ROOT / "cardbench" / "entries" / "spmm.py")
METRICS = [m["name"] for m in SPEC["per_layer"]
           if CELL in m.get("workloads", [])]


def graph(scale=8, seed=2**31 + 31):
    return LAW.make({"scale": scale, "edgefactor": 16,
                     "initiator": [0.57, 0.19, 0.19]}, seed, torch.float32,
                    "cpu")


def np_spmm(a, h):
    """Y = A @ H in float64 numpy, row by row."""
    ip, ix, v = (t.numpy() for t in a[:3])
    h = h.numpy().astype(np.float64)
    y = np.zeros((a.shape[0], h.shape[1]))
    for r in range(a.shape[0]):
        y[r] = v[ip[r]:ip[r + 1]].astype(np.float64) @ h[ix[ip[r]:ip[r + 1]]]
    return y


def test_generator_is_the_spec_transcribed():
    """`edges` against a line-by-line transcription of the specification's
    reference `kronecker_generator` (Octave) fed the same random numbers:
    ii_bit = rand > ab, jj_bit = rand > (c_norm * ii_bit + a_norm *
    not(ii_bit)), ij += 2^(ib-1) * [ii_bit; jj_bit], ij = p(ij)."""
    scale, ef = 9, 16
    n, m = 2**scale, ef * 2**scale
    A, B, C = 0.57, 0.19, 0.19
    got = LAW.edges(scale, ef, [A, B, C],
                    operands.generator(77, "cpu"), "cpu")
    g = operands.generator(77, "cpu")
    ij = np.zeros((2, m), np.int64)
    ab, c_norm, a_norm = A + B, C / (1 - (A + B)), A / (A + B)
    for ib in range(1, scale + 1):
        r1 = torch.rand(m, generator=g).numpy()
        r2 = torch.rand(m, generator=g).numpy()
        ii_bit = r1 > ab
        jj_bit = r2 > (np.float32(c_norm) * ii_bit
                       + np.float32(a_norm) * ~ii_bit)
        ij += 2**(ib - 1) * np.stack([ii_bit, jj_bit]).astype(np.int64)
    p = torch.randperm(n, generator=g).numpy()
    ij = p[ij]
    np.testing.assert_array_equal(got[0].numpy(), ij[0])
    np.testing.assert_array_equal(got[1].numpy(), ij[1])
    # the initiator's shares: a row bit is 1 with 1 - (A + B)
    assert abs(float((r1 > ab).mean()) - (1 - ab)) < 0.01


def test_graph_is_the_generated_edges_undirected():
    src, dst = LAW.edges(8, 16, [0.57, 0.19, 0.19],
                         operands.generator(5, "cpu"), "cpu")
    want = set()
    for s, d in zip(src.tolist(), dst.tolist()):
        if s != d:
            want |= {(s, d), (d, s)}
    a = graph(seed=5)
    ip = a.indptr.tolist()
    got = {(r, c) for r in range(256)
           for c in a.indices[ip[r]:ip[r + 1]].tolist()}
    assert got == want


@pytest.mark.parametrize("block_entries", [7, 1000, 2**21])
def test_reference_against_numpy(block_entries):
    a = graph()
    h = operands.values_pool(1, 256 * 9, 3, device="cpu").view(256, 9)
    got = reference.spmm(a, h, block_entries=block_entries)
    assert got.dtype == torch.float64 and got.shape == (256, 9)
    np.testing.assert_allclose(got.numpy(), np_spmm(a, h), rtol=1e-13,
                               atol=1e-13)


def test_reference_control_rounds_to_tf32():
    a = graph()
    h = operands.values_pool(1, 256 * 100, 3, device="cpu").view(256, 100)
    exact = reference.spmm(a, h)
    low = reference.spmm(a, h, "tf32")
    err = float((exact - low).abs().max() / exact.abs().max())
    assert 1e-5 < err < 2e-3


def test_work_counts_by_hand():
    a = graph()
    nnz = a.indices.numel()
    referenced = int((np.diff(a.indptr.numpy()) > 0).sum())  # symmetric
    assert counts.spmm_call(a, 100) == {
        "flops": 2 * nnz * 100,
        "bytes": 257 * 4 + nnz * 8 + (referenced + 256) * 100 * 4}


def test_entry_against_numpy():
    a = graph()
    traffic = json.loads((ROOT / "cardbench" / "traffic"
                          / "spmm-k100-pool2.json").read_text())
    timed = SPMM.Timed({"A": a}, traffic, {"canonical": True}, None,
                       2**31 + 3, "cpu")
    for i in range(3):
        y = timed.answer(timed.call(i))
        assert y.dtype == torch.float32 and y.shape == (256, 100)
        want = np_spmm(a, timed.hs[timed.key(i)])
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)
        ref = timed.expected(timed.key(i))
        assert check.numbers_of(y, ref)["value_err"] < 1e-6
    assert timed.key(0) != timed.key(1)
    # the program gets its own copies of the pool
    assert timed._hs[0].data_ptr() != timed.hs[0].data_ptr()
    with pytest.raises(ValueError, match="plan"):
        SPMM.Timed({"A": a}, dict(traffic, plan=True), {"canonical": True},
                   None, 1, "cpu")


def test_the_cell_lists_its_seven_metrics():
    assert sorted(METRICS) == sorted([
        "spmm_host_ms", "spmm_plan_ms", "host_syncs.spmm", "launches.spmm",
        "busy_ms.spmm", "device_idle.spmm", "spmm_roofline"])
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if CELL in m.get("workloads", [CELL])]
    assert sorted(e2e) == ["call_ms", "peak_mem_mb", "setup_s"]


def test_traced_small_run_reads_its_spans():
    profiler.reset_spans()
    try:
        result, _ = harness.run_cell(CELL, 2**31 + 41, 0.3, True,
                                     device="cpu",
                                     config_patch=harness.small(CELL))
    finally:
        profiler.reset_spans()
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # no device here: the device readers give nothing
    assert set(got) == {"spmm_host_ms", "spmm_plan_ms", "host_syncs.spmm",
                        "launches.spmm"}
    assert got["host_syncs.spmm"] == 3 and got["launches.spmm"] == 0
    assert 0 < got["spmm_plan_ms"] and 0 < got["spmm_host_ms"]


def traced_run():
    run = harness.Run(setup_s=1.0, window_s=1.0, calls_s=[0.01] * 100,
                      attempted=100, failed=0, peak_window_bytes=0,
                      launches={"spmm_routed": 100})
    run.trace = tracing.Trace(busy_s=0.5, window_s=1.0)
    return run


# two calls by hand: the root, its plan with three syncs, the kernel
TOTALS = {
    "spmm": {"count": 2, "total_ns": 20e6, "self_ns": 0.2e6, "roots": 2},
    "spmm.plan": {"count": 2, "total_ns": 3e6, "self_ns": 1e6, "roots": 0},
    "sync.long_rows": {"count": 2, "total_ns": 1e6, "self_ns": 1e6,
                       "roots": 0},
    "sync.long_chunks": {"count": 2, "total_ns": 0.6e6, "self_ns": 0.6e6,
                         "roots": 0},
    "sync.long_nnz": {"count": 2, "total_ns": 0.4e6, "self_ns": 0.4e6,
                      "roots": 0},
    "spmm.routed": {"count": 2, "total_ns": 16.8e6, "self_ns": 0.6e6,
                    "roots": 0},
}


def test_span_readers_from_totals_set_by_hand(monkeypatch):
    monkeypatch.setattr(profiler, "span_totals", lambda: TOTALS)
    run = traced_run()
    read = harness.load_reader
    assert read("spmm_host_ms")(run) == pytest.approx(0.9)
    assert read("spmm_plan_ms")(run) == pytest.approx(1.5)
    assert read("host_syncs.spmm")(run) == pytest.approx(3.0)
    # a port whose spmm opens no span (as before it had them): nothing
    monkeypatch.setattr(profiler, "span_totals", dict)
    for name in ("spmm_host_ms", "spmm_plan_ms", "host_syncs.spmm"):
        assert read(name)(run) is None
    assert read("launches.spmm")(run) == 1.0


def test_roofline_by_hand():
    run = traced_run()
    read = harness.load_reader("spmm_roofline")
    assert read(run) is None  # no work count
    run.work = {"flops": 2 * 10**9, "bytes": 3.35e9}
    run.peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    # 1 ms of bytes over 5 ms of busy time a call
    assert read(run) == pytest.approx(20.0)

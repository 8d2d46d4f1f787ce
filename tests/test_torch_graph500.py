"""SpMM on Graph500's Kronecker graph under GraphSAGE's mean aggregation,
on the CPU.

The benchmark's law `cardbench/laws/kronecker.py` (loaded by path, with
the plain reference `cardbench/reference/spmm.py` and the work count
`cardbench/work/spmm.py`) makes the graph at a small scale: undirected,
no self-loops, duplicates merged, each entry 1 / deg(row).  `spmm(A, H)`
and the CPU emulation of `csrc/spmm_routed.cu`'s work split with hub rows
on the chunk path are held against the float64 reference by the number
that decides the cell `g500-s22.sage-mean-k100`'s `correct`, value_err =
max|Y - R| / max|R|, within that cell's limit (its workload file, which
says why); the reference on TF32-rounded operands fails it by 10x.  A
traced call opens the spans `spmm`, `spmm.plan`, `spmm.routed` and three
`sync.*` spans (the chunk plan's host syncs); an untraced one opens none.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import spmm_tpu_torch as pt  # noqa: E402
from cardbench.files import load_file  # noqa: E402
from spmm_tpu_torch.ops.kernels import spmv_routed as kr  # noqa: E402
from spmm_tpu_torch.sparse.csr import CSR  # noqa: E402
from spmm_tpu_torch.utils import profiler  # noqa: E402

LAW = load_file(ROOT / "cardbench" / "laws" / "kronecker.py")
REFERENCE = load_file(ROOT / "cardbench" / "reference" / "spmm.py")
WORK = load_file(ROOT / "cardbench" / "work" / "spmm.py")
CELL = "g500-s22.sage-mean-k100"
LIMIT = json.loads((ROOT / "cardbench" / "workloads" / f"{CELL}.json")
                   .read_text())["limits"]["value_err"]
SPEC = {"law": "kronecker", "scale": 8, "edgefactor": 16,
        "initiator": [0.57, 0.19, 0.19], "values": "mean", "seed_offset": 0}


def graph(scale=8, seed=2**31 + 5):
    return LAW.make(dict(SPEC, scale=scale), seed, torch.float32, "cpu")


def port_csr(a):
    return CSR.from_parts(a.indptr, a.indices, a.data, a.shape,
                          canonical=True, device="cpu")


def features(n, k, seed=11):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, k), generator=g)


def value_err(y, r) -> float:
    """max|y - r| / max|r| in float64, as the benchmark's check."""
    assert y.shape == r.shape
    return float((y.double() - r).abs().max() / r.abs().max())


@pytest.mark.parametrize("scale", [6, 7, 8])
def test_law_is_an_undirected_mean_graph(scale):
    a = graph(scale)
    n = 1 << scale
    assert a.shape == (n, n)
    assert a.indptr.dtype == a.indices.dtype == torch.int32
    assert a.data.dtype == torch.float32
    ip = a.indptr.tolist()
    assert ip[0] == 0 and ip[-1] == a.indices.numel() == a.data.numel()
    d = np.zeros((n, n))
    for r in range(n):
        cols = a.indices[ip[r]:ip[r + 1]].tolist()
        assert cols == sorted(set(cols))  # canonical: ascending, unique
        vals = a.data[ip[r]:ip[r + 1]]
        assert torch.equal(vals, torch.full_like(vals, 1 / max(len(cols),
                                                                1)))
        d[r, cols] = 1
    assert not d.diagonal().any()  # no self-loops
    np.testing.assert_array_equal(d, d.T)  # both directions
    lens = np.diff(ip)
    # Graph500's skew, at these scales too: isolated vertices and hubs
    assert (lens == 0).any() and lens.max() > 3 * lens.mean()


def test_law_same_seed_same_graph_and_small_size():
    a, b, c = graph(seed=3), graph(seed=3), graph(seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert not (a.indices.numel() == c.indices.numel()
                and torch.equal(a.indices, c.indices))
    assert LAW.small(dict(SPEC, scale=22))["scale"] == 8
    assert LAW.small(dict(SPEC, scale=6))["scale"] == 6


@pytest.mark.parametrize("k", [100, 64])
def test_spmm_within_the_cell_limit(k):
    a = graph()
    h = features(a.shape[1], k)
    y = pt.spmm(port_csr(a), h)
    assert y.dtype == torch.float32 and y.shape == (a.shape[0], k)
    ref = REFERENCE.spmm(a, h, block_entries=999)
    assert value_err(y, ref) <= LIMIT
    assert torch.equal(ref, REFERENCE.spmm(a, h))  # blocks of any size
    # isolated vertices aggregate to zero
    empty = (a.indptr[1:] == a.indptr[:-1]).nonzero().flatten()
    assert empty.numel() and not y[empty].any()


@pytest.mark.parametrize("k", [100, 64])
def test_kernel_schedule_with_hubs_on_the_chunk_path(k):
    """`csrc/spmm_routed.cu`'s work split, emulated on the CPU with the
    plan's cut and chunk lowered to 8 and 16, so that every hub row is
    summed in chunks and closed by one group: within the cell's limit."""
    a = graph()
    h = features(a.shape[1], k, seed=12)
    plan = kr.spmv_routed_plan(a.indptr, a.indices, a.data, *a.shape,
                               cut=8, ch=16, sell=False)
    assert plan.chunk_row.numel() > 2 * plan.long_rows.numel() > 0
    group, vec = kr.spmm_groups(k, True)
    y = kr.spmm_routed_schedule(h, plan, group, vec, seed=5)
    assert value_err(y, REFERENCE.spmm(a, h)) <= LIMIT


def test_tf32_control_fails_the_limit_tenfold():
    a = graph()
    h = features(a.shape[1], 100)
    low = REFERENCE.spmm(a, h, "tf32").float()
    assert value_err(low, REFERENCE.spmm(a, h)) > 10 * LIMIT


def test_traced_call_opens_its_spans_and_three_syncs():
    a = graph()
    A, h = port_csr(a), features(a.shape[1], 100)
    profiler.reset_spans()
    try:
        want = pt.spmm(A, h)
        assert profiler.span_totals() == {}  # no profiler: no span
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = pt.spmm(A, h)
        tot = profiler.span_totals()
    finally:
        profiler.reset_spans()
    assert torch.equal(got, want)
    syncs = sorted(n for n in tot if n.startswith("sync."))
    assert syncs == ["sync.long_chunks", "sync.long_nnz", "sync.long_rows"]
    assert set(tot) - set(syncs) == {"spmm", "spmm.plan", "spmm.routed"}
    assert all(t["count"] == 1 for t in tot.values())
    assert tot["spmm"]["roots"] == 1 and sum(
        t["roots"] for t in tot.values()) == 1
    assert tot["spmm.plan"]["total_ns"] >= sum(
        tot[s]["total_ns"] for s in syncs)


def test_work_count_is_of_the_inputs_not_the_path():
    a = graph()
    k = 100
    h = features(a.shape[1], k)
    ref = REFERENCE.spmm(a, h)
    nnz, m = a.indices.numel(), a.shape[0]
    referenced = len(set(a.indices.tolist()))
    want = {"flops": 2 * nnz * k,
            "bytes": (m + 1) * 4 + nnz * 8 + (referenced + m) * k * 4}
    for via in ("csr", "dense"):
        y = pt.spmm(port_csr(a), h, via=via)
        assert value_err(y, ref) <= LIMIT
        assert WORK.spmm_call(a, k) == want

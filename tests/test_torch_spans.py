"""The port's spans and host-sync count (`spmm_tpu_torch.utils.profiler`'s
`span`, `span_totals`, `reset_spans`, and `_primitives.read_host`), on the
CPU under a CPU `torch.profiler`.

A span records nothing while no profiler runs; under one, it is a host
event of its name in the trace, and its totals hold count, total and self
time and the root count.  Each SpGEMM entry records its root and engine
spans and its `sync.*` readbacks, one root per call, and returns the same
bits with the profiler on as off; `spmv` records its root and the span of
the path it takes, and `spmv_plan` its own root `spmv_plan.build`.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spmm_tpu_torch.ops.serving import spgemm_plan  # noqa: E402
from spmm_tpu_torch.ops.spgemm import spgemm, spgemm_engine  # noqa: E402
from spmm_tpu_torch.sparse.csr import CSR  # noqa: E402
from spmm_tpu_torch.utils import profiler  # noqa: E402

from torch_port_helpers import csr_arrays  # noqa: E402


@pytest.fixture(autouse=True)
def clean_totals():
    profiler.reset_spans()
    yield
    profiler.reset_spans()


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def host_events(prof):
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def pair(m=64, k=48, n=56, density=0.1, seed=3):
    a = CSR.from_parts(*(torch.from_numpy(x) for x in
                         csr_arrays(m, k, density, seed)), (m, k),
                       canonical=True, device="cpu")
    b = CSR.from_parts(*(torch.from_numpy(x) for x in
                         csr_arrays(k, n, density, seed + 1)), (k, n),
                       canonical=True, device="cpu")
    return a, b


def test_span_off_is_the_shared_noop_and_records_nothing():
    first, second = profiler.span("x"), profiler.span("y")
    assert first is second
    with first:
        with profiler.span("x.child"):
            pass
    assert profiler.span_totals() == {}


def test_nested_spans_are_host_events_with_self_time():
    with cpu_profile() as prof:
        with profiler.span("outer"):
            time.sleep(0.002)
            with profiler.span("outer.inner"):
                time.sleep(0.003)
    names = [e[0] for e in host_events(prof)]
    assert "outer" in names and "outer.inner" in names
    tot = profiler.span_totals()
    assert set(tot) == {"outer", "outer.inner"}
    outer, inner = tot["outer"], tot["outer.inner"]
    assert outer["count"] == inner["count"] == 1
    assert (outer["roots"], inner["roots"]) == (1, 0)
    assert inner["self_ns"] == inner["total_ns"] >= 3e6
    assert outer["total_ns"] >= inner["total_ns"] + 2e6
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    profiler.reset_spans()
    assert profiler.span_totals() == {}


def test_totals_are_a_copy():
    with cpu_profile():
        with profiler.span("a"):
            pass
    got = profiler.span_totals()
    got["a"]["count"] = 99
    assert profiler.span_totals()["a"]["count"] == 1


def sync_count(totals):
    return sum(t["count"] for name, t in totals.items()
               if name.startswith("sync."))


def roots(totals):
    return sum(t["roots"] for t in totals.values())


# (entry, root span, the engine spans it opens, host syncs per call)
CALLS = {
    "alg1": ("spgemm", {"spgemm.alg1"}, 1),
    "alg2-esc": ("spgemm", {"spgemm.alg2.esc"}, 2),
    "alg3-group": ("spgemm", {"spgemm.alg3.blocked", "spgemm.structure"},
                   2),
    "plan": ("spgemm_plan.call", set(), 0),
}


def make_call(kind, a, b):
    if kind == "alg1":
        return lambda: spgemm(a, b, alg=1)
    if kind == "alg2-esc":
        return lambda: spgemm(a, b, alg=2, impl="esc")
    if kind == "alg3-group":
        assert spgemm_engine(a, b, alg=3) == "group"
        return lambda: spgemm(a, b, alg=3)
    plan = spgemm_plan(a, b)
    return lambda: plan(a.data, b.data)


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_entry_records_its_spans_roots_and_syncs(kind):
    a, b = pair()
    call = make_call(kind, a, b)
    profiler.reset_spans()
    calls = 3
    with cpu_profile() as prof:
        for _ in range(calls):
            call()
    root, engines, syncs = CALLS[kind]
    tot = profiler.span_totals()
    spans = {n for n in tot if not n.startswith("sync.")}
    assert spans == {root} | engines
    assert roots(tot) == tot[root]["roots"] == tot[root]["count"] == calls
    # ESC alg2 reads back its product count and its output count; alg3's
    # group engine, in one staging group, reads A's and B's indices once
    # for its engine rule and its tile counts once, in `spgemm.structure`
    assert sync_count(tot) == syncs * calls
    if kind == "alg3-group":
        assert tot["sync.operands"]["count"] == calls
        assert tot["sync.tile_counts"]["count"] == calls
    names = {e[0] for e in host_events(prof)}
    assert set(tot) <= names
    for name in engines:
        assert tot[name]["roots"] == 0


PLAN_METHODS = {
    "__call__": lambda plan, a, b: plan(a.data, b.data),
    "values": lambda plan, a, b: plan.values(a.data, b.data),
    "values_accumulate": lambda plan, a, b: plan.values_accumulate(
        torch.zeros(plan.nnz), a.data, b.data),
    "values_batch": lambda plan, a, b: plan.values_batch(
        a.data[None], b.data[None]),
}


@pytest.mark.parametrize("method", sorted(PLAN_METHODS))
def test_each_plan_method_is_one_root_span(method):
    a, b = pair()
    plan = spgemm_plan(a, b)
    with cpu_profile():
        PLAN_METHODS[method](plan, a, b)
    tot = profiler.span_totals()
    assert set(tot) == {"spgemm_plan.call"}
    assert tot["spgemm_plan.call"]["count"] == 1
    assert tot["spgemm_plan.call"]["roots"] == 1


def test_plan_build_is_its_own_root():
    a, b = pair()
    with cpu_profile():
        spgemm_plan(a, b)
    tot = profiler.span_totals()
    assert tot["spgemm_plan.build"]["roots"] == 1
    assert tot["spgemm.structure"]["roots"] == 0
    assert tot["sync.operands"]["count"] == 1


def csr_bits(c):
    return tuple(np.asarray(x).tobytes() for x in
                 (c.indptr, c.indices, c.data.view(torch.int32)))


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_outputs_bitwise_equal_with_the_profiler_on_and_off(kind):
    a, b = pair(seed=11)
    call = make_call(kind, a, b)
    off = csr_bits(call())
    with cpu_profile():
        on = csr_bits(call())
    assert on == off


def test_tensor_alpha_is_one_sync():
    a, b = pair()
    alpha = torch.tensor(0.5)
    with cpu_profile():
        got = spgemm(a, b, alpha=alpha, alg=2, impl="esc")
    # ESC alg2 rounds alpha once, in its one compression
    assert profiler.span_totals()["sync.alpha"]["count"] == 1
    want = spgemm(a, b, alpha=0.5, alg=2, impl="esc")
    assert csr_bits(got) == csr_bits(want)


# ---------------------------------------------------------------------------
# spmv: one root `spmv` a call, the path's span inside it
# ---------------------------------------------------------------------------

SPMV_PATHS = ("routed", "binned", "onehot", "gather", "dense")


def spmv_call(path):
    """A call of `spmv` that takes `path`: a routed or a onehot plan, the
    per-call float32 path (the binned kernel's), float64 data (the gather
    path) or via="dense"."""
    from spmm_tpu_torch.ops.kernels.spmv_onehot import spmv_onehot_plan
    from spmm_tpu_torch.ops.kernels.spmv_routed import spmv_routed_plan
    from spmm_tpu_torch.ops.spmv import spmv

    a, _ = pair(m=40, k=30, density=0.2, seed=13)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(30)
                         .astype(np.float32))
    m, n = a.shape
    if path == "routed":
        plan = ("routed", spmv_routed_plan(a.indptr, a.indices, a.data, m,
                                           n, cut=4, ch=8))
        return lambda: spmv(a, x, plan=plan)
    if path == "onehot":
        plan = ("onehot", spmv_onehot_plan(a.indptr, m, n, ch=256))
        return lambda: spmv(a, x, plan=plan)
    if path == "gather":
        a64, x64 = a.astype(torch.float64), x.double()
        return lambda: spmv(a64, x64)
    via = "dense" if path == "dense" else "auto"
    return lambda: spmv(a, x, via=via)


@pytest.mark.parametrize("path", SPMV_PATHS)
def test_spmv_is_one_root_with_its_path_inside(path):
    call = spmv_call(path)
    profiler.reset_spans()
    calls = 3
    with cpu_profile() as prof:
        for _ in range(calls):
            call()
    tot = profiler.span_totals()
    assert set(tot) == {"spmv", f"spmv.{path}"}
    assert roots(tot) == tot["spmv"]["roots"] == tot["spmv"]["count"] == calls
    inner = tot[f"spmv.{path}"]
    assert inner["count"] == calls and inner["roots"] == 0
    assert tot["spmv"]["total_ns"] >= inner["total_ns"]
    assert set(tot) <= {e[0] for e in host_events(prof)}


def test_spmv_without_a_profiler_records_nothing():
    assert profiler.span("spmv") is profiler.span("spmv.routed")
    for path in SPMV_PATHS:
        spmv_call(path)()
    assert profiler.span_totals() == {}


def test_spmv_plan_build_is_its_own_root():
    from spmm_tpu_torch.ops.spmv import spmv_plan

    a, _ = pair()
    with cpu_profile():
        assert spmv_plan(a) is None  # off the card, as in the JAX package
        spmv_plan(a, effort="fast")
    tot = profiler.span_totals()
    assert set(tot) == {"spmv_plan.build"}
    assert tot["spmv_plan.build"]["roots"] == \
        tot["spmv_plan.build"]["count"] == 2


@pytest.mark.parametrize("path", SPMV_PATHS)
def test_spmv_bitwise_equal_with_the_profiler_on_and_off(path):
    call = spmv_call(path)
    off = call().numpy().tobytes()
    with cpu_profile():
        on = call().numpy().tobytes()
    assert on == off


# ---------------------------------------------------------------------------
# spmm: one root `spmm` a call, the path's span inside it
# ---------------------------------------------------------------------------

# path: the spans besides the root, and the host syncs a call
SPMM_PATHS = {"plan": ({"spmm.routed"}, 0),
              "csr": ({"spmm.plan", "spmm.routed"}, 3),
              "dense": ({"spmm.dense"}, 0),
              "bsr": ({"spmm.bsr"}, 0),
              "gather": ({"spmm.gather"}, 0)}


def spmm_call(path):
    """A call of `spmm` that takes `path`: a routed plan, the default
    float32 path (its chunk plan made per call), via="dense", via="bsr",
    or float64 data (the gather path)."""
    from spmm_tpu_torch.ops.kernels.spmv_routed import spmv_routed_plan
    from spmm_tpu_torch.ops.spmm import spmm

    a, _ = pair(m=40, k=30, density=0.2, seed=17)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal((30, 5))
                         .astype(np.float32))
    if path == "plan":
        plan = ("routed", spmv_routed_plan(a.indptr, a.indices, a.data,
                                           *a.shape, cut=4, ch=8))
        return lambda: spmm(a, b, plan=plan)
    if path == "gather":
        a64, b64 = a.astype(torch.float64), b.double()
        return lambda: spmm(a64, b64)
    via = path if path in ("dense", "bsr") else "csr"
    return lambda: spmm(a, b, via=via)


@pytest.mark.parametrize("path", sorted(SPMM_PATHS))
def test_spmm_is_one_root_with_its_path_inside(path):
    call = spmm_call(path)
    inner, syncs = SPMM_PATHS[path]
    profiler.reset_spans()
    calls = 3
    with cpu_profile() as prof:
        for _ in range(calls):
            off = call()
    tot = profiler.span_totals()
    assert {n for n in tot if not n.startswith("sync.")} == {"spmm", *inner}
    assert roots(tot) == tot["spmm"]["roots"] == tot["spmm"]["count"] == calls
    assert all(tot[n]["count"] == calls and not tot[n]["roots"]
               for n in inner)
    assert sum(t["count"] for n, t in tot.items()
               if n.startswith("sync.")) == syncs * calls
    assert set(tot) <= {e[0] for e in host_events(prof)}
    profiler.reset_spans()
    assert call().numpy().tobytes() == off.numpy().tobytes()
    assert profiler.span_totals() == {}

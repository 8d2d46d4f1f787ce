"""The port's blocked dense alg2/alg3 engines and the pattern-only densify
kernel against the JAX package.

Every input is made with numpy (`torch_port_helpers`) and handed to both
packages.  Structure (indptr, indices, nnz, the alg2 mask and counts, the
host structure and production order of alg3) is compared bitwise; values
pass through a GEMM that sums in another order than XLA's, so they are held
to rtol 1e-6 plus atol 1e-6 * max|C| (`assert_csr_match`).  Within the port
the two alg2 engines, and the four alg3 engines, are compared bitwise, as
the JAX package compares its own (tests/test_spgemm.py).  On the CPU the
kernels run their plain versions; tests/test_torch_cuda.py runs the CUDA
path on the card.  JAX results are computed once per module.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.ops.kernels.densify_onehot import (  # noqa: E402
    densify_onehot_pattern as jax_pattern, densify_onehot_plan)
from spmm_tpu_torch.ops.kernels import _build  # noqa: E402
from spmm_tpu_torch.ops.kernels.densify_onehot import (  # noqa: E402
    densify_onehot_pattern, densify_onehot_pattern_plain)
from torch_port_helpers import (  # noqa: E402
    assert_bitwise, assert_csr_bitwise, assert_csr_match, csr_arrays, pair)

jbl = importlib.import_module("spmm_tpu.ops.spgemm_blocked")
pbl = importlib.import_module("spmm_tpu_torch.ops.spgemm_blocked")
jsg = importlib.import_module("spmm_tpu.ops.spgemm")
psg = importlib.import_module("spmm_tpu_torch.ops.spgemm")

ENGINES = ("group", "unrolled", "scan3", "scan2")


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# kernel: densify_onehot_pattern
# ---------------------------------------------------------------------------


def _jax_pattern(indptr, indices, m, k):
    plan = densify_onehot_plan(indptr, m, k, ch=256, out_bytes_per_cell=2)
    assert plan is not None
    return jax_pattern(jnp.asarray(indptr), jnp.asarray(indices), m, k, plan,
                       interpret=True)


@pytest.mark.parametrize("m,k,density,seed,kw", [
    # the cases of test_densify_onehot.py::test_densify_onehot_pattern_only
    (64, 128, 0.1, 0, {}),
    (100, 300, 0.05, 1, {}),
    (256, 256, 0.3, 2, {}),
    (33, 136, 0.2, 4, {}),
    # stored zeros and empty rows (first, middle, last)
    (40, 45, 0.3, 6, {"zeros": 3, "empty_rows": (0, 7, 8, 39)}),
])
def test_densify_pattern_plain_bitwise_vs_pallas(m, k, density, seed, kw):
    indptr, indices, _ = csr_arrays(m, k, density, seed, **kw)
    want = _jax_pattern(indptr, indices, m, k)
    got = densify_onehot_pattern_plain(*_t(indptr, indices), m, k)
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    assert_bitwise(got, want)


def test_densify_pattern_keeps_explicit_zeros():
    # the case of tests/test_densify_onehot.py: a stored zero is structural
    indptr = np.array([0, 2, 3], np.int32)
    indices = np.array([1, 5, 0], np.int32)
    want = _jax_pattern(indptr, indices, 2, 8)
    got = densify_onehot_pattern_plain(*_t(indptr, indices), 2, 8)
    assert_bitwise(got, want)
    assert got.float().sum() == 3 and float(got[0, 1]) == 1.0


def test_densify_pattern_wrapper_on_cpu_is_plain_and_counts_nothing():
    indptr, indices, data = _t(*csr_arrays(30, 40, 0.2, seed=9))
    before = dict(_build.LAUNCHES)
    got = densify_onehot_pattern(indptr, indices, 30, 40)
    assert_bitwise(got, densify_onehot_pattern_plain(indptr, indices, 30, 40))
    assert _build.LAUNCHES == before
    # the pattern of densify_onehot's value+pattern mode
    from spmm_tpu_torch.ops.kernels.densify_onehot import densify_onehot

    assert_bitwise(got, densify_onehot(indptr, indices, data, 30, 40)[1])
    empty = densify_onehot_pattern(*_t(np.zeros(4, np.int32),
                                       np.zeros(0, np.int32)), 3, 5)
    assert empty.shape == (3, 5) and not empty.any()


def test_densify_pattern_wrapper_checks_inputs():
    indptr, indices, _ = _t(*csr_arrays(10, 12, 0.3, seed=10))
    with pytest.raises(ValueError, match="indptr"):
        densify_onehot_pattern(indptr.long(), indices, 10, 12)
    with pytest.raises(ValueError, match="indices"):
        densify_onehot_pattern(indptr, indices.long(), 10, 12)
    with pytest.raises(ValueError, match="rows"):
        densify_onehot_pattern(indptr, indices, 11, 12)


# ---------------------------------------------------------------------------
# operands, each JAX result computed once
# ---------------------------------------------------------------------------

# (m, k, n, density of A, density of B, seed, extra arguments of A)
CASES = {
    "square": (128, 128, 128, 0.1, 0.1, 0, {}),
    # m, k and n not multiples of 128
    "nonsquare": (200, 150, 170, 0.1, 0.1, 1, {}),
    "zeros_empty_rows": (150, 140, 130, 0.12, 0.1, 2,
                         {"zeros": 5, "empty_rows": (0, 9, 128, 149)}),
    # the non-uniform panels of tests/test_spgemm.py:219 (n_pad 640)
    "wide": (150, 140, 600, 0.1, 0.08, 3, {}),
}


def _disjoint(m=8):
    """A stores column 0 only, B row 5 only: an empty product of two
    non-empty operands."""
    a_arr = (np.arange(m + 1, dtype=np.int32), np.zeros(m, np.int32),
             np.ones(m, np.float32))
    b_arr = (np.array([0] * 6 + [1] * 4, np.int32), np.array([2], np.int32),
             np.ones(1, np.float32))
    a_ref = st.CSR.from_parts(*a_arr, (m, 9), canonical=True)
    b_ref = st.CSR.from_parts(*b_arr, (9, 7), canonical=True)
    return (a_ref, pt.from_reference(a_ref, device="cpu"), b_ref,
            pt.from_reference(b_ref, device="cpu"))


@pytest.fixture(scope="module")
def ops():
    # over two row tiles: the group engine's host-structure path is
    # reachable
    out = {"empty_product": _disjoint(), "empty_product_tall": _disjoint(300)}
    for name, (m, k, n, da, db, seed, kw) in CASES.items():
        a_ref, a = pair(m, k, da, seed, **kw)
        b_ref, b = pair(k, n, db, seed + 100)
        out[name] = (a_ref, a, b_ref, b)
    return out


@pytest.fixture(scope="module")
def jax_runs(ops):
    """JAX outputs, computed on first use and kept."""
    cache = {}

    def run(name, key, fn):
        if (name, key) not in cache:
            a_ref, _, b_ref, _ = ops[name]
            cache[(name, key)] = fn(a_ref, b_ref)
        return cache[(name, key)]

    return run


# ---------------------------------------------------------------------------
# alg2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["nonsquare", "zeros_empty_rows"])
def test_alg2_count_bitwise_vs_jax(ops, name):
    a_ref, a, b_ref, b = ops[name]
    m, k = a.shape
    n = b.shape[1]
    m_pad = -(-m // 128) * 128
    T = m_pad // 128
    ip_h = pbl._pad_indptr_h(np.asarray(a_ref.indptr), m_pad)
    want = jbl._alg2_count(jnp.asarray(ip_h), a_ref.indices, a_ref.data,
                           b_ref.indptr, b_ref.indices, b_ref.data, m_pad, k,
                           n, T)
    got = pbl._alg2_count(pbl._pad_indptr(a.indptr, m_pad), a.indices,
                          b.indptr, b.indices, m_pad, k, n, T)
    for x, y in zip(got, want):
        assert_bitwise(x, np.asarray(y))


@pytest.mark.parametrize("name", ["square", "nonsquare", "zeros_empty_rows",
                                  "empty_product"])
def test_alg2_blocked_matches_jax(ops, jax_runs, name):
    _, a, _, b = ops[name]
    want = jax_runs(name, "alg2", lambda x, y: st.spgemm(x, y, alg=2,
                                                         impl="dense"))
    got = pt.spgemm(a, b, alg=2, impl="dense")
    assert got.has_canonical_format and got.nnz == want.nnz
    assert_csr_match(got, want)
    assert_csr_bitwise(pt.spgemm(a, b, alg=2, impl="dense"), got)  # rerun


def test_alg2_blocked_alpha_matches_jax(ops, jax_runs):
    _, a, _, b = ops["nonsquare"]
    want = jax_runs("nonsquare", "alg2 alpha", lambda x, y: st.spgemm(
        x, y, alpha=-2.5, alg=2, impl="dense"))
    assert_csr_match(pt.spgemm(a, b, alpha=-2.5, alg=2, impl="dense"), want)


@pytest.mark.parametrize("name", ["nonsquare", "zeros_empty_rows"])
def test_alg2_scan_engine_matches_jax_and_unrolled(ops, jax_runs, name,
                                                   monkeypatch):
    """`_ALG2_MAX_UNROLL_TILES` = 1 forces the scan engine in both
    packages; in the port it gives the unrolled engine's bits."""
    _, a, _, b = ops[name]
    unrolled = pt.spgemm(a, b, alpha=1.5, alg=2, impl="dense")
    monkeypatch.setattr(jbl, "_ALG2_MAX_UNROLL_TILES", 1)
    monkeypatch.setattr(pbl, "_ALG2_MAX_UNROLL_TILES", 1)
    want = jax_runs(name, "alg2 scan", lambda x, y: st.spgemm(
        x, y, alpha=1.5, alg=2, impl="dense"))
    got = pt.spgemm(a, b, alpha=1.5, alg=2, impl="dense")
    assert_csr_match(got, want)
    assert_csr_bitwise(got, unrolled)


# ---------------------------------------------------------------------------
# alg3: host structure, engines, chunk fractions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.05, 0.3, 1.0])
def test_alg3_host_structure_and_rank_bitwise_vs_jax(ops, cf):
    a_ref, a, b_ref, b = ops["wide"]
    n_b, P, _, _, T = pbl._alg3_grid(a.shape[0], b.shape[1], cf)
    for x, y in zip(pbl._alg3_host_structure(a, b, n_b, P, T),
                    jbl._alg3_host_structure(a_ref, b_ref, n_b, P, T)):
        assert_bitwise(x, y)
    got = pbl._alg3_rank(a, b, n_b, T, b.shape[1])
    want = jbl._alg3_rank(a_ref, b_ref, n_b, T, b.shape[1])
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        assert_bitwise(x, y)


def _jax_engine(engine, cf):
    return lambda x, y: jbl.spgemm_alg3_blocked(x, y, 1.0, cf, engine=engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cf", [0.05, 0.3, 1.0])
def test_alg3_engine_matches_jax(ops, jax_runs, cf, engine):
    _, a, _, b = ops["wide"]
    want = jax_runs("wide", (engine, cf), _jax_engine(engine, cf))
    got = pbl.spgemm_alg3_blocked(a, b, 1.0, cf, engine=engine)
    assert got.has_canonical_format
    assert_csr_match(got, want)


@pytest.mark.parametrize("name", ["nonsquare", "zeros_empty_rows", "wide"])
@pytest.mark.parametrize("cf", [0.05, 0.3, 1.0])
def test_alg3_engines_bitwise(ops, name, cf):
    """The four engines run the same block step and differ only in how
    they assemble the output: bitwise-equal CSRs."""
    _, a, _, b = ops[name]
    outs = [pbl.spgemm_alg3_blocked(a, b, -0.75, cf, engine=e)
            for e in ENGINES]
    for c in outs[1:]:
        assert_csr_bitwise(c, outs[0])


def _no_host_product(a, b):
    raise AssertionError("the host structural product ran")


@pytest.mark.parametrize("alpha", [-0.75, 0.0])
@pytest.mark.parametrize("name", ["square", "nonsquare", "zeros_empty_rows",
                                  "wide", "empty_product",
                                  "empty_product_tall"])
def test_alg3_group_device_structure_bitwise(ops, jax_runs, monkeypatch,
                                             name, alpha):
    """Where one staging group holds every tile (G == T) the group engine
    sizes its output from the staged mask, without the host structural
    product: the same structure as JAX's group engine, its values within
    the GEMM's rounding, and the bits of the port's host-structure path
    (G < T, forced by a smaller staging budget; at one tile the path
    itself, there at G == T)."""
    _, a, _, b = ops[name]
    m, n = a.shape[0], b.shape[1]
    cf = 0.3
    want = jax_runs(name, ("group", cf, alpha), lambda x, y:
                    jbl.spgemm_alg3_blocked(x, y, alpha, cf, engine="group"))
    with monkeypatch.context() as mp:
        mp.setattr(pbl, "_structural_product", _no_host_product)
        got = pbl.spgemm_alg3_blocked(a, b, alpha, cf, engine="group")
    assert got.has_canonical_format and got.nnz == want.nnz
    assert_bitwise(got.indptr, np.asarray(want.indptr))
    assert_bitwise(got.indices, np.asarray(want.indices))
    assert_csr_match(got, want)
    n_b, P, _, m_pad, T = pbl._alg3_grid(m, n, cf)
    ran = []
    real = pbl._structural_product
    monkeypatch.setattr(pbl, "_structural_product",
                        lambda x, y: ran.append(1) or real(x, y))
    if T > 1:
        monkeypatch.setattr(pbl, "_GROUP_STAGING_BYTES", 1)
        host = pbl.spgemm_alg3_blocked(a, b, alpha, cf, engine="group")
    else:
        ops_h = [x.numpy() for x in (a.indptr, a.indices, b.indptr,
                                     b.indices)]
        host = pbl._alg3_group_host(a, b, ops_h, alpha, n_b, P, T, 1,
                                    m_pad, False, "highest")
    assert ran
    assert_csr_bitwise(got, host)


def test_alg3_blocked_chunk_fraction_struct_invariant(ops):
    """Twin of the JAX test of the same name: exact structure, values
    within fp32 accumulation error, at every chunk fraction."""
    _, a, _, b = ops["wide"]
    ref = (a.to_scipy() @ b.to_scipy()).tocsr()
    ref.sort_indices()
    for cf in (0.05, 0.3, 1.0):
        c = pt.spgemm(a, b, alg=3, chunk_fraction=cf, impl="dense")
        assert_bitwise(c.indptr, ref.indptr.astype(np.int32))
        assert_bitwise(c.indices, ref.indices.astype(np.int32))
        np.testing.assert_allclose(c.data.numpy(), ref.data, rtol=2e-5,
                                   atol=1e-6)


def test_alg3_scan_streamed_count_matches_fast(ops, monkeypatch):
    """Twin of the JAX test of the same name, with the scan2 engine forced
    (the JAX test's `unroll=False` now selects the group engine): the
    streamed sizing pass and the resident-pattern one give the same counts
    (and JAX's fast count's), and the output is bitwise the same."""
    a_ref, a, b_ref, b = ops["wide"]
    m, k = a.shape
    n = b.shape[1]
    n_b, P, n_pad, m_pad, T = pbl._alg3_grid(m, n, 0.3)
    host = [x.numpy() for x in (a.indptr, a.indices, b.indptr, b.indices)]
    blocks = pbl._Blocks(a, b, host, n_b, P, m_pad)
    fast = pbl._alg3_count_fast(blocks, b.indptr, b.indices, n_b, T, P)
    slow = pbl._alg3_count(blocks, T, P)
    ip_d = jnp.asarray(pbl._pad_indptr_h(np.asarray(a_ref.indptr), m_pad))
    want = jbl._alg3_count_fast(ip_d, a_ref.indices, a_ref.data,
                                b_ref.indptr, b_ref.indices, b_ref.data,
                                m_pad, k, n, n_pad, n_b, T, P)
    for x, y, w in zip(fast, slow, want):
        assert_bitwise(x.contiguous(), y.contiguous())
        assert_bitwise(x.contiguous(), np.asarray(w))
    c_fast = pbl.spgemm_alg3_blocked(a, b, 1.0, 0.3, engine="scan2")
    monkeypatch.setattr(pbl, "_FAST_COUNT_BUDGET", 0)
    c_slow = pbl.spgemm_alg3_blocked(a, b, 1.0, 0.3, engine="scan2")
    assert_csr_bitwise(c_fast, c_slow)


def test_alg3_fast_count_nonuniform_panels(ops, jax_runs):
    """Twin of the JAX test of the same name: n = 600, cf = 0.4 gives
    n_pad 640, n_b 256, P 3 (P * n_b > n_pad), through the scan2 engine."""
    _, a, _, b = ops["wide"]
    assert pbl._alg3_grid(150, 600, 0.4)[:3] == (256, 3, 640)
    c = pbl.spgemm_alg3_blocked(a, b, 1.0, 0.4, engine="scan2")
    ref = (a.to_scipy() @ b.to_scipy()).tocsr()
    ref.sort_indices()
    assert_bitwise(c.indptr, ref.indptr.astype(np.int32))
    assert_bitwise(c.indices, ref.indices.astype(np.int32))
    np.testing.assert_allclose(c.data.numpy(), ref.data, rtol=2e-5,
                               atol=1e-30)
    assert_csr_match(c, jax_runs("wide", ("scan2", 0.4),
                                 _jax_engine("scan2", 0.4)))


def test_alg3_blocked_unrolled_matches_scan_bitwise(ops):
    """Twin of the JAX test of the same name: `unroll=True` (the unrolled
    engine) and `unroll=False` (the scan family, here the group engine)
    give the same bits."""
    _, a, _, b = ops["wide"]
    for cf in (0.2, 0.6):
        assert_csr_bitwise(
            pbl.spgemm_alg3_blocked(a, b, 1.0, cf, unroll=True),
            pbl.spgemm_alg3_blocked(a, b, 1.0, cf, unroll=False))


def test_alg3_blocked_three_engines_bitwise(ops):
    """Twin of the JAX test of the same name (which runs all four)."""
    _, a, _, b = ops["nonsquare"]
    for cf in (0.2, 0.6):
        outs = [pbl.spgemm_alg3_blocked(a, b, 1.0, cf, engine=e)
                for e in ENGINES]
        for c in outs[1:]:
            assert_csr_bitwise(c, outs[0])


@pytest.mark.parametrize("cf", [0.0, 5.0])
def test_alg3_chunk_fraction_clamps_as_jax(ops, jax_runs, cf):
    _, a, _, b = ops["wide"]
    want = jax_runs("wide", ("clamp", cf), lambda x, y: st.spgemm(
        x, y, alg=3, chunk_fraction=cf, impl="dense"))
    got = pt.spgemm(a, b, alg=3, chunk_fraction=cf, impl="dense")
    assert_csr_match(got, want)
    edge = 1e-3 if cf == 0.0 else 1.0
    assert_csr_bitwise(got, pt.spgemm(a, b, alg=3, chunk_fraction=edge,
                                      impl="dense"))


def test_alg3_unknown_engine_raises(ops):
    _, a, _, b = ops["square"]
    with pytest.raises(ValueError, match="engine"):
        pbl.spgemm_alg3_blocked(a, b, 1.0, 0.2, engine="hash")


@pytest.mark.parametrize("T,P,products,n_pad,want", [
    (8, 4, 10**7, 1024, "group"),         # 1024^2 at cf 0.2
    (8, 12, 10**7, 1024, "group"),        # 96 blocks: the group bound
    (13, 8, 10**7, 1024, "scan3"),        # 104 blocks, T within 32
    (6, 8, 3 * 10**9, 1024, "unrolled"),  # past the host product bound
    (32, 5, 10**7, 1024, "scan3"),
    (33, 5, 10**7, 1024, "scan2"),
    (64, 5, 6 * 10**5, 8192, "scan2"),    # 8192^2/1e-3 at cf 0.2
    (8, 4, 10**7, 2**24, "scan2"),        # block keys past int32
])
def test_alg3_engine_selection(T, P, products, n_pad, want):
    assert pbl.select_alg3_engine(100, 100, products, T, P, n_pad) == want


# ---------------------------------------------------------------------------
# dispatch through spgemm
# ---------------------------------------------------------------------------


def _engine_line(out: str) -> str:
    """The engine line of a verbose run, without JAX's TPU-only onehot=
    field."""
    lines = [x for x in out.splitlines() if "/blocked]" in x]
    assert len(lines) == 1, out
    return lines[0].split(" onehot=")[0]


@pytest.mark.parametrize("alg,cf,name", [
    (2, 0.2, "nonsquare"),
    (3, 0.2, "nonsquare"),
    (3, 0.05, "wide"),
    (3, 1.0, "zeros_empty_rows"),
])
def test_auto_takes_the_blocked_engine_jax_takes(ops, capsys, alg, cf, name):
    a_ref, a, b_ref, b = ops[name]
    assert psg._blocked_feasible(a, b) and jsg._blocked_feasible(a_ref, b_ref)
    want = st.spgemm(a_ref, b_ref, alg=alg, chunk_fraction=cf, verbose=True)
    jax_line = _engine_line(capsys.readouterr().out)
    got = pt.spgemm(a, b, alg=alg, chunk_fraction=cf, verbose=True)
    assert _engine_line(capsys.readouterr().out) == jax_line
    assert_csr_match(got, want)
    again = pt.spgemm(a, b, alg=alg, chunk_fraction=cf)
    assert_csr_bitwise(again, got)


@pytest.mark.parametrize("alg", [2, 3])
def test_auto_takes_esc_where_blocked_is_infeasible(ops, monkeypatch, alg):
    """Past the dense budget "auto" runs ESC in both packages: the values
    are then bitwise JAX's."""
    a_ref, a, b_ref, b = ops["nonsquare"]
    monkeypatch.setattr(jsg, "_DENSE_BUDGET_BYTES", 1000)
    monkeypatch.setattr(psg, "_DENSE_BUDGET_BYTES", 1000)
    assert not psg._blocked_feasible(a, b)
    assert not jsg._blocked_feasible(a_ref, b_ref)
    assert_csr_bitwise(pt.spgemm(a, b, alg=alg),
                       st.spgemm(a_ref, b_ref, alg=alg))


def test_alg0_past_budget_takes_blocked_alg2_as_jax(ops, capsys, monkeypatch):
    """alg 0 past the dense budget goes to alg 2, blocked where the A and B
    panels still fit, in both packages."""
    a_ref, a, b_ref, b = ops["square"]
    budget = 4 * (128 * 128 * 2) + 1000  # panels fit, alg1's C does not
    monkeypatch.setattr(jsg, "_DENSE_BUDGET_BYTES", budget)
    monkeypatch.setattr(psg, "_DENSE_BUDGET_BYTES", budget)
    want = st.spgemm(a_ref, b_ref, alg=0, verbose=True)
    jax_out = capsys.readouterr().out
    got = pt.spgemm(a, b, alg=0, verbose=True)
    out = capsys.readouterr().out
    assert "alg2" in out and out.splitlines()[0] == jax_out.splitlines()[0]
    assert _engine_line(out) == _engine_line(jax_out)
    assert_csr_match(got, want)


def test_blocked_operand_checks_still_apply(ops):
    _, a, _, b = ops["nonsquare"]
    with pytest.raises(ValueError, match="unknown impl"):
        pt.spgemm(a, b, alg=2, impl="hash")
    # "high" computes now, as in JAX (IEEE float32 on the CPU in both)
    a_ref, _, b_ref, _ = ops["nonsquare"]
    assert_csr_match(
        pt.spgemm(a, b, alg=3, impl="dense", precision="high"),
        st.spgemm(a_ref, b_ref, alg=3, impl="dense", precision="high"))
    with pytest.raises(ValueError, match="precision"):
        pt.spgemm(a, b, alg=3, impl="dense", precision="tf32")
    with pytest.raises(ValueError, match="mismatch"):
        pt.spgemm(a, a, alg=2, impl="dense")

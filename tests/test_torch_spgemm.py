"""The port's alg1 SpGEMM slice against the JAX package.

Each test builds its operands once with numpy (`torch_port_helpers.pair`),
runs `spmm_tpu` and `spmm_tpu_torch` on the same arrays, and compares:
structure (indptr, indices, nnz, padding) bitwise, values within
rtol = 1e-6 and atol = 1e-6 * max|C| (the repo's error target; the two
GEMMs sum in different orders).  On the CPU the port's kernels run their
plain versions; `tests/test_torch_cuda.py` runs the CUDA path on the
card.
"""

import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu_torch.ops import _primitives as prim  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_bitwise, assert_csr_bitwise, assert_csr_match, csr_arrays, pair)

jax_prim = importlib.import_module("spmm_tpu.ops._primitives")
jax_sg = importlib.import_module("spmm_tpu.ops.spgemm")
pt_sg = importlib.import_module("spmm_tpu_torch.ops.spgemm")

REPO = pathlib.Path(__file__).resolve().parents[1]

# (m, k, n, density of A, density of B, seed, extra arguments of A)
SPGEMM_CASES = {
    "square": (64, 64, 64, 0.1, 0.1, 0, {}),
    "nonsquare": (40, 72, 56, 0.2, 0.15, 1, {}),
    "tall_thin": (200, 30, 90, 0.1, 0.3, 2, {}),
    "explicit_zeros": (48, 48, 48, 0.15, 0.15, 3, {"zeros": 5}),
    "empty_rows": (50, 40, 30, 0.2, 0.2, 4, {"empty_rows": (0, 9, 49)}),
    "dense_output": (32, 32, 32, 0.9, 0.9, 5, {}),  # g = 0 holes
    "headline_shape": (256, 256, 256, 0.1, 0.1, 6, {}),
}


def _operands(m, k, n, da, db, seed, kw):
    a_ref, a = pair(m, k, da, seed, **kw)
    b_ref, b = pair(k, n, db, seed + 100)
    return a_ref, a, b_ref, b


@pytest.mark.parametrize("name", list(SPGEMM_CASES))
def test_spgemm_alg1_matches_jax(name):
    a_ref, a, b_ref, b = _operands(*SPGEMM_CASES[name])
    want = st.spgemm(a_ref, b_ref, alg=1)
    got = pt.spgemm(a, b, alg=1)
    assert got.has_canonical_format and got.device == torch.device("cpu")
    assert_csr_match(got, want)


def test_dense_output_has_no_holes():
    a_ref, a, b_ref, b = _operands(*SPGEMM_CASES["dense_output"])
    assert pt.spgemm(a, b).nnz == 32 * 32


@pytest.mark.parametrize("alpha", [2.5, -0.3, 0.0])
def test_spgemm_alpha_matches_jax(alpha):
    a_ref, a, b_ref, b = _operands(40, 50, 60, 0.2, 0.2, 7, {})
    want = st.spgemm(a_ref, b_ref, alpha=alpha, alg=1)
    got = pt.spgemm(a, b, alpha=alpha, alg=1)
    assert_csr_match(got, want)


def test_cancellation_stays_structural():
    # C[0, 0] = 1*1 + (-1)*1 = 0 numerically, but it is a structural entry
    a_arr = (np.array([0, 2], np.int32), np.array([0, 1], np.int32),
             np.array([1.0, -1.0], np.float32))
    b_arr = (np.array([0, 1, 2], np.int32), np.array([0, 0], np.int32),
             np.array([1.0, 1.0], np.float32))
    a_ref = st.CSR.from_parts(*a_arr, (1, 2), canonical=True)
    b_ref = st.CSR.from_parts(*b_arr, (2, 1), canonical=True)
    want = st.spgemm(a_ref, b_ref, alg=1)
    got = pt.spgemm(pt.from_reference(a_ref, device="cpu"),
                    pt.from_reference(b_ref, device="cpu"))
    assert got.nnz == want.nnz == 1
    assert float(got.data[0]) == 0.0
    assert_csr_match(got, want)


@pytest.mark.parametrize("which", ["a", "b", "both"])
def test_spgemm_empty_operand(which):
    a_ref, a = pair(20, 30, 0.0 if which in ("a", "both") else 0.2, 8)
    b_ref, b = pair(30, 25, 0.0 if which in ("b", "both") else 0.2, 9)
    want = st.spgemm(a_ref, b_ref, alg=1)
    got = pt.spgemm(a, b, alg=1)
    assert got.nnz == 0
    assert_csr_match(got, want)


def test_alg0_takes_alg1_within_budget():
    a_ref, a, b_ref, b = _operands(*SPGEMM_CASES["nonsquare"])
    got0 = pt.spgemm(a, b, alg=0)
    got1 = pt.spgemm(a, b, alg=1)
    for x, y in ((got0.indptr, got1.indptr), (got0.indices, got1.indices),
                 (got0.data, got1.data)):
        assert_bitwise(x, y)
    assert_csr_match(got0, st.spgemm(a_ref, b_ref, alg=0))


def test_alg1_dense_compute_matches_jax():
    a_ref, a, b_ref, b = _operands(*SPGEMM_CASES["explicit_zeros"])
    m, k = a.shape
    n = b.shape[1]
    jc, jmask, jnnz = jax_sg._alg1_dense_compute(
        a_ref.indptr, a_ref.indices, a_ref.data, b_ref.indptr,
        b_ref.indices, b_ref.data, np.float32(1.0), m, k, n)
    c, mask, nnz = pt_sg._alg1_dense_compute(a, b, 1.0)
    assert_bitwise(mask, np.asarray(jmask))
    assert int(nnz) == int(jnnz)
    jc = np.asarray(jc)
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-6,
                               atol=1e-6 * np.abs(jc).max())


# ---------------------------------------------------------------------------
# spgemm_fixed: the serving form with a static capacity
# ---------------------------------------------------------------------------


def _fixed_operands():
    return _operands(*SPGEMM_CASES["nonsquare"])


def test_spgemm_fixed_exact_capacity():
    a_ref, a, b_ref, b = _fixed_operands()
    want, wnnz = st.spgemm_fixed(a_ref, b_ref)
    got, nnz = pt.spgemm_fixed(a, b)
    assert int(nnz) == int(wnnz) == got.nnz
    assert_csr_match(got, want)


@pytest.mark.parametrize("extra", [1, 37])
def test_spgemm_fixed_padded_capacity(extra):
    a_ref, a, b_ref, b = _fixed_operands()
    exact = pt.spgemm(a, b).nnz
    want, wnnz = st.spgemm_fixed(a_ref, b_ref, cap=exact + extra)
    got, nnz = pt.spgemm_fixed(a, b, cap=exact + extra)
    assert int(nnz) == int(wnnz) == exact
    assert got.nnz == exact + extra
    # padding and clamped indptr bitwise; values within tolerance
    assert_csr_match(got, want)
    assert_bitwise(got.data[exact:], np.asarray(want.data)[exact:])
    assert not got.data[exact:].any() and not got.indices[exact:].any()


def test_spgemm_fixed_capacity_too_small_raises_in_both():
    a_ref, a, b_ref, b = _fixed_operands()
    exact = pt.spgemm(a, b).nnz
    with pytest.raises(ValueError, match="capacity"):
        st.spgemm_fixed(a_ref, b_ref, cap=exact - 1)
    with pytest.raises(ValueError, match="capacity"):
        pt.spgemm_fixed(a, b, cap=exact - 1)


def test_alg1_fixed_clamps_indptr_below_nnz():
    a_ref, a, b_ref, b = _fixed_operands()
    m, k = a.shape
    n = b.shape[1]
    exact = pt.spgemm(a, b).nnz
    cap = exact // 2
    want = jax_sg._alg1_fixed(
        a_ref.indptr, a_ref.indices, a_ref.data, b_ref.indptr,
        b_ref.indices, b_ref.data, np.float32(1.0), m, k, n, cap,
        exact_cap=False)
    got = pt_sg._alg1_fixed(a, b, 1.0, cap)
    assert_bitwise(got[0], np.asarray(want[0]))
    assert_bitwise(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-6)
    assert int(got[3]) == int(want[3]) == exact


def test_spgemm_nnz_estimate_matches_jax():
    a_ref, a, b_ref, b = _fixed_operands()
    assert pt.spgemm_nnz_estimate(a, b) == st.spgemm_nnz_estimate(a_ref,
                                                                   b_ref)
    e_ref, e = pair(40, 72, 0.0, 1)
    assert pt.spgemm_nnz_estimate(e, b) == (0, 0)


# ---------------------------------------------------------------------------
# the @ operator and the errors
# ---------------------------------------------------------------------------


def test_matmul_operator_takes_the_same_path():
    a_ref, a, b_ref, b = _operands(*SPGEMM_CASES["square"])
    got = a @ b
    direct = pt.spgemm(a, b)
    assert_bitwise(got.data, direct.data)
    assert_csr_match(got, a_ref @ b_ref)
    assert_csr_match(pt.matmul(a, b, alpha=2.0), st.spgemm(a_ref, b_ref,
                                                           alpha=2.0))


def test_matmul_rejects_scalars_and_dense():
    _, a, _, b = _operands(*SPGEMM_CASES["square"])
    for scalar in (2.0, 3, torch.tensor(2.0), np.float32(2.0)):
        with pytest.raises(ValueError, match="Scalar"):
            a @ scalar
    # sparse @ dense is SpMM now (tests/test_torch_spmv.py); a dense
    # operand of more than two dimensions is still rejected
    np.testing.assert_allclose((a @ torch.ones(64, 3)).numpy(),
                               a.to_scipy() @ np.ones((64, 3)), rtol=1e-5)
    with pytest.raises(ValueError, match="3-D"):
        a @ torch.ones(64, 3, 2)


@pytest.mark.parametrize("alg", [2, 3])
def test_unported_algs_raise(alg):
    """alg 2 and 3 with the default impl run the blocked engines, as in JAX
    (the name is kept from when they were not ported and raised)."""
    a_ref, a, b_ref, b = _operands(*SPGEMM_CASES["square"])
    got = pt.spgemm(a, b, alg=alg)
    assert got.has_canonical_format
    assert_csr_match(got, st.spgemm(a_ref, b_ref, alg=alg))


def test_alg0_past_budget_raises(monkeypatch):
    # past the dense budget alg 0 goes to alg 2, as in JAX: the blocked
    # engine where A and B panels still fit, ESC where they do not (the
    # name is kept from when the blocked engine raised)
    a_ref, a, b_ref, b = _operands(*SPGEMM_CASES["square"])
    monkeypatch.setattr(pt_sg, "_DENSE_BUDGET_BYTES", 40000)
    monkeypatch.setattr(jax_sg, "_DENSE_BUDGET_BYTES", 40000)
    assert pt_sg._blocked_feasible(a, b)
    assert_csr_match(pt.spgemm(a, b, alg=0), st.spgemm(a_ref, b_ref, alg=0))
    monkeypatch.setattr(pt_sg, "_DENSE_BUDGET_BYTES", 1000)
    monkeypatch.setattr(jax_sg, "_DENSE_BUDGET_BYTES", 1000)
    got = pt.spgemm(a, b, alg=0)
    want = st.spgemm(a_ref, b_ref, alg=0)
    for x, y in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert_bitwise(x, np.asarray(y))
    assert pt.spgemm(a, b, alg=1).nnz > 0


def _reads(monkeypatch):
    """The `what` of every host read `spgemm` makes, in order."""
    reads = []
    inner = prim.read_host

    def read_host(x, what):
        reads.append(what)
        return inner(x, what)
    monkeypatch.setattr(prim, "read_host", read_host)
    return reads


def test_alg0_takes_esc_at_8192_sparse():
    """8192^2 at density 1e-3 (0.55 M products against two 8192^3
    GEMMs): alg 0 names and runs ESC, as the benchmark's auto cell."""
    a = pt.random(8192, 8192, 1e-3, format="csr", seed=12, device="cpu")
    b = pt.random(8192, 8192, 1e-3, format="csr", seed=13, device="cpu")
    assert pt_sg._dense_bytes(a, b) <= pt_sg._DENSE_BUDGET_BYTES
    assert pt_sg.spgemm_engine(a, b) == "esc"
    assert pt_sg.spgemm_engine(a, b, alg=1) == "alg1"


def test_alg0_keeps_cheap_dense_on_alg1_with_no_added_read(monkeypatch):
    """1024^2 at 0.1: the dense GEMMs cost less than ESC's fixed cost, so
    alg 0 runs alg1 exactly, with alg1's one readback and no product
    count read."""
    a_ref, a = pair(1024, 1024, 0.1, 21)
    b_ref, b = pair(1024, 1024, 0.1, 22)
    assert pt_sg.spgemm_engine(a, b) == "alg1"

    def no_work(*args):
        raise AssertionError("alg 0 read the product count")
    monkeypatch.setattr(pt_sg, "_esc_work", no_work)
    reads = _reads(monkeypatch)
    got = pt.spgemm(a, b)
    assert reads == ["nnz"]
    assert_csr_bitwise(got, pt.spgemm(a, b, alg=1))
    assert_csr_match(got, st.spgemm(a_ref, b_ref, alg=0))


def test_alg0_esc_is_alg2_esc_bitwise(monkeypatch, capsys):
    """With ESC's modelled cost set to nothing, alg 0 runs ESC alg2 at a
    small shape: bitwise `alg=2, impl="esc"`, scipy's product, one
    estimate of the work and one read of P, handed on to ESC."""
    monkeypatch.setattr(pt_sg, "_ESC_FIXED_S", 0.0)
    monkeypatch.setattr(pt_sg, "_ESC_PRODUCT_S", 0.0)
    _, a, _, b = _operands(*SPGEMM_CASES["nonsquare"])
    assert pt_sg.spgemm_engine(a, b) == "esc"
    estimates = []
    inner = pt_sg._work_estimation
    monkeypatch.setattr(pt_sg, "_work_estimation",
                        lambda *x: estimates.append(1) or inner(*x))
    reads = _reads(monkeypatch)
    got = pt.spgemm(a, b, verbose=True)
    assert "→ alg2 esc" in capsys.readouterr().out
    assert (estimates, reads) == ([1], ["products", "nnz"])
    assert_csr_bitwise(got, pt.spgemm(a, b, alg=2, impl="esc"))
    want = (a.to_scipy() @ b.to_scipy()).tocsr()
    want.sort_indices()
    assert_csr_match(got, want)


# (m = k = n, dtype, precision, P or None where it must not be read) ->
# the engine, with the synthetic model of `test_alg0_engine_table`: dense
# rates 1e12 ("highest"), 1e13 ("default"), 3e12 ("high") and 5e11
# (float64), ESC 1 ms fixed, 1 ns and 10 B a product (20 B in float64), a
# budget of 1e9 B.  At n = 2000 the dense GEMMs take 16 ms ("highest"),
# 5.33 ms ("high") and 1.6 ms ("default"); ESC 4 ms at P = 3e6, 6 ms at
# P = 5e6.
ALG0_TABLE = {
    "cheap dense, P never read": (100, torch.float32, "highest", None,
                                  "alg1"),
    "sparse products": (1000, torch.float32, "highest", 10**5, "esc"),
    "ESC slower than dense": (1000, torch.float32, "highest", 2 * 10**6,
                              "alg1"),
    "P past 2^31": (10**5, torch.float32, "highest", 2**31, "alg1"),
    "workspace past the budget": (10**5, torch.float32, "highest",
                                  10**8 + 1, "alg1"),
    "highest, P 5e6": (2000, torch.float32, "highest", 5 * 10**6, "esc"),
    "high, P 5e6": (2000, torch.float32, "high", 5 * 10**6, "alg1"),
    "high, P 3e6": (2000, torch.float32, "high", 3 * 10**6, "esc"),
    "default, P 3e6": (2000, torch.float32, "default", 3 * 10**6, "alg1"),
    "default, cheaper than ESC's fixed": (1000, torch.float32, "default",
                                          None, "alg1"),
    "float64 in any mode": (1000, torch.float64, "default", 10**5, "esc"),
    "float64 workspace": (10**4, torch.float64, "highest", 6 * 10**7,
                          "alg1"),
    "float32 at that P": (10**4, torch.float32, "highest", 6 * 10**7,
                          "esc"),
    "complex64 keeps the budget's rule": (10**4, torch.complex64,
                                          "highest", None, "alg1"),
    "bfloat16 keeps the budget's rule": (10**4, torch.bfloat16, "highest",
                                         None, "alg1"),
}


@pytest.mark.parametrize("case", list(ALG0_TABLE))
def test_alg0_engine_table(monkeypatch, case):
    n, dtype, precision, P, want = ALG0_TABLE[case]
    monkeypatch.setattr(pt_sg, "_DENSE_FLOPS", {
        (torch.float32, "highest"): 1e12, (torch.float32, "default"): 1e13,
        (torch.float32, "high"): 3e12, (torch.float64, "highest"): 5e11})
    monkeypatch.setattr(pt_sg, "_ESC_FIXED_S", 1e-3)
    monkeypatch.setattr(pt_sg, "_ESC_PRODUCT_S", 1e-9)
    monkeypatch.setattr(pt_sg, "_ESC_PRODUCT_BYTES",
                        {torch.float32: 10, torch.float64: 20})
    monkeypatch.setattr(pt_sg, "_DENSE_BUDGET_BYTES", 10**9)
    asked = []

    def products():
        asked.append(1)
        return P
    engine, why = pt_sg._alg0_engine(n, n, n, dtype, precision, products)
    assert (engine, bool(asked)) == (want, P is not None), why


def test_alg0_engine_at_the_measured_constants():
    """The card's constants: 8192^2 at 1e-3 (0.55 M products) takes ESC in
    "highest"; 1024^3 never reads P in any mode; 4 G products refuse."""
    def never():
        raise AssertionError("P read")
    for precision in pt_sg.PRECISIONS:
        assert pt_sg._alg0_engine(1024, 1024, 1024, torch.float32,
                                  precision, never)[0] == "alg1"
    assert pt_sg._alg0_engine(8192, 8192, 8192, torch.float32, "highest",
                              lambda: 550_000)[0] == "esc"
    assert pt_sg._alg0_engine(8192, 8192, 8192, torch.float32, "highest",
                              lambda: 2**32)[0] == "alg1"


def test_bad_arguments_raise():
    _, a, _, b = _operands(*SPGEMM_CASES["nonsquare"])
    with pytest.raises(ValueError, match="unknown alg"):
        pt.spgemm(a, b, alg=7)
    with pytest.raises(ValueError, match="mismatch"):
        pt.spgemm(a, a)
    with pytest.raises(TypeError):
        pt.spgemm(a, b.toarray())
    # the precision modes and float64 compute now, as in JAX (on the CPU
    # every mode is IEEE float32 in both); an unknown mode still raises
    a_ref, _, b_ref, _ = _operands(*SPGEMM_CASES["nonsquare"])
    for precision in ("high", "default"):
        assert_csr_match(pt.spgemm(a, b, precision=precision),
                         st.spgemm(a_ref, b_ref, precision=precision))
        assert_csr_match(pt.spgemm_fixed(a, b, precision=precision)[0],
                         st.spgemm_fixed(a_ref, b_ref,
                                         precision=precision)[0])
    with pytest.raises(ValueError, match="precision"):
        pt.spgemm(a, b, precision="tf32")
    with pytest.raises(KeyError):
        st.spgemm(a_ref, b_ref, alg=1, precision="tf32")
    b64 = pt.CSR.from_parts(b.indptr, b.indices, b.data.double(), b.shape,
                            canonical=True)
    with jax.enable_x64(True):
        b64_ref = st.CSR.from_parts(np.asarray(b_ref.indptr),
                                    np.asarray(b_ref.indices),
                                    np.asarray(b_ref.data, np.float64),
                                    b_ref.shape, canonical=True)
        want = st.spgemm(a_ref, b64_ref)
        got = pt.spgemm(a, b64)
        assert got.dtype == torch.float64 and want.dtype == np.float64
        assert_csr_match(got, want, rtol=1e-12)


def test_non_canonical_input_raises():
    # row 0 holds columns (3, 1): unsorted
    indptr = np.array([0, 2, 3], np.int32)
    indices = np.array([3, 1, 0], np.int32)
    data = np.array([1.0, 2.0, 3.0], np.float32)
    a = pt.CSR.from_parts(indptr, indices, data, (2, 4), device="cpu")
    b = pt.random(4, 3, 0.5, format="csr", seed=1, device="cpu")
    assert not a.check_canonical()
    a_ref = st.CSR.from_parts(indptr, indices, data, (2, 4))
    assert_bitwise(a.toarray(), np.asarray(a_ref.toarray()))
    # canonicalised now, as in JAX (tests/test_torch_esc.py covers
    # duplicates and the ESC primitives)
    fixed = a.sum_duplicates()
    assert fixed.has_canonical_format and fixed.check_canonical()
    assert fixed.indices.tolist() == [1, 3, 0]
    assert_bitwise(fixed.toarray(), a.toarray())
    b_ref = st.CSR.from_parts(b.indptr.numpy(), b.indices.numpy(),
                              b.data.numpy(), (4, 3), canonical=True)
    want = st.spgemm(a_ref, b_ref, alg=1)
    assert_csr_match(pt.spgemm(a, b), want)
    assert_csr_match(a @ b, want)


@pytest.mark.parametrize("indptr,indices", [
    ([0, 2, 3], [1, 4, 0]),       # column 4 of a 4-column matrix
    ([0, 2, 3], [1, -1, 0]),      # negative column
    ([0, 2, 4], [1, 2, 0]),       # indptr ends past nnz
    ([1, 2, 3], [1, 2, 0]),       # indptr does not start at 0
    ([0, 3, 2], [1, 2, 0]),       # indptr decreases
])
def test_from_parts_rejects_out_of_bounds_structure(indptr, indices):
    data = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="invalid CSR structure"):
        pt.CSR.from_parts(np.array(indptr, np.int32),
                          np.array(indices, np.int32), data, (2, 4),
                          device="cpu")


def test_unflagged_sorted_input_is_accepted():
    arrays = csr_arrays(30, 20, 0.2, seed=12)
    a_ref = st.CSR.from_parts(*arrays, (30, 20), canonical=True)
    # canonical flag not set
    a = pt.CSR.from_parts(*arrays, (30, 20), device="cpu")
    b_ref, b = pair(20, 25, 0.3, 13)
    assert not a.has_canonical_format
    assert a.sum_duplicates().has_canonical_format
    assert_csr_match(pt.spgemm(a, b), st.spgemm(a_ref, b_ref, alg=1))


def test_entry_points_default_to_the_card(monkeypatch):
    """`random`, `from_reference`, `CSR.from_scipy`, `CSR.from_parts` of
    host arrays and `power_law_rows` place data on the card unless asked
    for the CPU, and raise where there is no card (no fallback)."""
    import scipy.sparse as sp

    from spmm_tpu_torch.models import power_law_rows

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = csr_arrays(8, 8, 0.5, seed=0)
    s = sp.csr_matrix((arrays[2], arrays[1], arrays[0]), shape=(8, 8))
    builders = [lambda **kw: pt.random(8, 8, 0.5, format="csr", seed=0, **kw),
                lambda **kw: pt.from_reference(s, **kw),
                lambda **kw: pt.CSR.from_scipy(s, **kw),
                lambda **kw: pt.CSR.from_parts(*arrays, (8, 8), **kw),
                lambda **kw: power_law_rows(64, 64, 4, seed=0, **kw)]
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        assert build(device="cpu").device == torch.device("cpu")
    # a tensor keeps its own device
    data = torch.from_numpy(arrays[2])
    assert pt.CSR.from_parts(arrays[0], arrays[1], data,
                             (8, 8)).device == torch.device("cpu")


def test_random_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: random() lands on it "
                    "(tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.random(8, 8, 0.5, format="csr")


def test_to_cuda_without_cuda_raises(monkeypatch):
    _, a = pair(8, 8, 0.3, 14)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        a.to("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.random(8, 8, 0.3, format="csr", seed=0, device="cuda")
    assert a.to("cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# container, construction and primitives
# ---------------------------------------------------------------------------


def test_from_reference_carries_arrays_and_flag():
    import scipy.sparse as sp

    a_ref, a = pair(30, 40, 0.2, 15, zeros=2)
    assert a.has_canonical_format and a.shape == (30, 40)
    assert a.indptr.dtype == a.indices.dtype == torch.int32
    assert a.dtype == torch.float32 and a.nnz == a_ref.nnz
    assert a.density == pytest.approx(a_ref.density)
    assert_bitwise(a.data, np.asarray(a_ref.data))
    assert_bitwise(a.toarray(), np.asarray(a_ref.toarray()))
    s = a.to_scipy()
    assert (s != a_ref.to_scipy()).nnz == 0
    assert pt.from_reference(s, device="cpu").has_canonical_format
    assert_bitwise(pt.CSR.from_scipy(s, device="cpu").data, a.data)
    # every ported format is carried across; others raise
    csc = pt.from_reference(sp.csc_matrix(s), device="cpu")
    assert isinstance(csc, pt.CSC)
    assert_bitwise(csc.toarray(), a.toarray())
    with pytest.raises(TypeError, match="format"):
        pt.from_reference(sp.lil_matrix(s), device="cpu")


def test_random_semantics():
    a = pt.random(50, 60, 0.1, format="csr", seed=3, device="cpu")
    assert a.nnz == int(0.1 * 50 * 60) and a.shape == (50, 60)
    assert a.has_canonical_format and a.check_canonical()
    assert a.dtype == torch.float32
    assert float(a.data.min()) >= 0.0 and float(a.data.max()) < 1.0
    again = pt.random(50, 60, 0.1, format="csr", seed=3, device="cpu")
    assert_bitwise(again.indices, a.indices)
    assert_bitwise(again.data, a.data)
    gen = np.random.default_rng(3)
    assert_bitwise(pt.random(50, 60, 0.1, format="csr", seed=gen,
                             device="cpu").data,
                   a.data)
    assert pt.random(50, 60, 0.1, format="csr", dtype=torch.float64, seed=3,
                     device="cpu").dtype == torch.float64
    assert pt.random(7, 9, 0.0, format="csr", seed=1, device="cpu").nnz == 0
    assert pt.random(7, 9, 1.0, format="csr", seed=1, device="cpu").nnz == 63
    # a COO unless told otherwise, as in JAX; the same entries in any format
    coo = pt.random(50, 60, 0.1, seed=3, device="cpu")
    assert isinstance(coo, pt.COO) and coo.has_canonical_format
    assert_csr_bitwise(coo.tocsr(), a)
    for fmt, cls in (("csc", pt.CSC), ("bsr", pt.BSR), ("dia", pt.DIA)):
        other = pt.random(50, 60, 0.1, format=fmt, seed=3, device="cpu")
        assert isinstance(other, cls)
        assert_bitwise(other.toarray(), a.toarray())
    with pytest.raises(ValueError, match="density"):
        pt.random(5, 5, 1.5, format="csr", device="cpu")


def test_primitives_match_jax():
    indptr, indices, data = csr_arrays(40, 30, 0.2, seed=16,
                                       empty_rows=(0, 5, 39))
    nnz = data.size
    rows = prim.rows_from_indptr(torch.from_numpy(indptr), nnz)
    assert_bitwise(rows, np.asarray(jax_prim.rows_from_indptr(indptr, nnz)))
    assert_bitwise(prim.build_indptr(rows, 40),
                   np.asarray(jax_prim.build_indptr(np.asarray(rows), 40)))
    dense = prim.csr_to_dense_canonical(*map(torch.from_numpy,
                                             (indptr, indices, data)),
                                        (40, 30))
    assert_bitwise(dense, np.asarray(jax_prim.csr_to_dense_canonical(
        indptr, indices, data, (40, 30))))
    cols = torch.from_numpy(indices)
    assert bool(prim.is_sorted_canonical(rows, cols))
    swapped = cols.clone()
    swapped[[1, 2]] = swapped[[2, 1]]
    assert bool(prim.is_sorted_canonical(rows, swapped)) == bool(
        jax_prim.is_sorted_canonical(np.asarray(rows), swapped.numpy()))


def test_port_names_no_jax():
    srcs = sorted((REPO / "spmm_tpu_torch").rglob("*.py"))
    assert srcs
    for path in srcs:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or "import spmm_tpu " in s + " "
                        or s.startswith("from spmm_tpu ")
                        or s.startswith("from spmm_tpu.")), (path, line)


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['spmm_tpu'] = None; "
            "import spmm_tpu_torch as pt; "
            "import spmm_tpu_torch.ops.kernels._build; "
            "c = pt.random(16, 16, 0.2, seed=0, device='cpu') "
            "@ pt.random(16, 16, 0.2, seed=1, device='cpu'); "
            "print(c.nnz)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 0

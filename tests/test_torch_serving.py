"""The port's fixed-structure serving path against the JAX package.

`kernels/route.py`: the plain versions of `expand_routed` and
`compress_routed` against JAX's `densify_routed` / `extract_routed` in
interpret mode, bitwise (pure data movement).  `SpgemmPlan`: against JAX's
`spgemm_plan(..., interpret=True)` and `use_routed=False`, structure
bitwise, values within rtol 1e-6 + atol 1e-6*max|C| (the two CPU f32 GEMMs
sum in different orders); against the port's own `spgemm(alg=1)` bitwise
(the same dense operands through the same matmul).  Inputs are made with
numpy and handed to both packages.
"""

import importlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.ops.kernels import route as jax_route  # noqa: E402
from spmm_tpu_torch.ops.kernels import _build  # noqa: E402
from spmm_tpu_torch.ops.kernels import route  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_bitwise, assert_csr_bitwise, assert_csr_match, csr_arrays, pair,
    unsorted_csr_arrays, unsorted_pair)

jax_serving = importlib.import_module("spmm_tpu.ops.serving")
pt_serving = importlib.import_module("spmm_tpu_torch.ops.serving")


def _rows(indptr):
    return np.repeat(np.arange(indptr.size - 1), np.diff(indptr))


# ---------------------------------------------------------------------------
# routed data movement (twins of tests/test_route.py)
# ---------------------------------------------------------------------------


def _expand_both(m, n, indptr, indices, data):
    jplan = jax_route.expand_route_plan(indptr, indices, m, n)
    want = jax_route.densify_routed(jnp.asarray(data), jplan, interpret=True)
    plan = route.expand_route_plan(indptr, indices, m, n, device="cpu")
    got = route.densify_routed(torch.from_numpy(data), plan)
    return got, want


@pytest.mark.parametrize("m,n,density", [
    (256, 256, 0.1),
    (128, 384, 0.02),
    (384, 128, 0.5),
    (256, 128, 0.003),
    (128, 128, 1.0),
])
def test_expand_bitwise(m, n, density):
    indptr, indices, data = csr_arrays(m, n, density, seed=m + n)
    before = dict(_build.LAUNCHES)
    (dense, pattern), (jdense, jpattern) = _expand_both(m, n, indptr,
                                                        indices, data)
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version
    assert_bitwise(dense, np.asarray(jdense))
    assert_bitwise(pattern, np.asarray(jpattern))
    ref = sp.csr_matrix((data, indices, indptr), shape=(m, n)).toarray()
    assert_bitwise(dense, ref)
    pat_ref = np.zeros((m, n), bool)
    pat_ref[_rows(indptr), indices] = True
    np.testing.assert_array_equal(pattern.float().numpy() != 0, pat_ref)


def test_expand_explicit_zero_stays_structural():
    indptr, indices, data = csr_arrays(128, 128, 0.05, seed=7, zeros=3)
    (dense, pattern), (jdense, jpattern) = _expand_both(128, 128, indptr,
                                                        indices, data)
    assert_bitwise(dense, np.asarray(jdense))
    assert_bitwise(pattern, np.asarray(jpattern))
    z = np.flatnonzero(data == 0)
    r, c = _rows(indptr)[z], indices[z]
    assert (dense[r, c] == 0).all() and (pattern[r, c] == 1).all()


def test_expand_value_bits_preserved():
    # negative zero and the smallest normal travel bitwise
    indptr, indices, data = csr_arrays(128, 128, 0.03, seed=3)
    data[1] = -0.0
    data[2] = np.float32(1.1754944e-38)
    (dense, _), (jdense, _) = _expand_both(128, 128, indptr, indices, data)
    assert_bitwise(dense, np.asarray(jdense))
    got = dense.numpy()[_rows(indptr), indices]
    assert got.tobytes() == data.tobytes()


def test_expand_value_only_and_workspace():
    """emit_pattern=False returns the values alone, as in JAX; `out` is
    zero-filled and reused."""
    indptr, indices, data = csr_arrays(37, 45, 0.3, seed=4)  # m*k % 128 != 0
    plan = route.expand_route_plan(indptr, indices, 37, 45, device="cpu")
    vals = torch.from_numpy(data)
    ws = torch.full((37, 45), 7.0)
    got = route.densify_routed(vals, plan, emit_pattern=False, out=ws)
    assert got is ws
    ref = sp.csr_matrix((data, indices, indptr), shape=(37, 45)).toarray()
    assert_bitwise(got, ref)
    with pytest.raises(ValueError, match="values"):
        route.densify_routed(vals[:-1], plan)
    with pytest.raises(ValueError, match="out"):
        route.densify_routed(vals, plan, out=torch.zeros(45, 37))
    # the TPU gate m*k % 128 does not exist here
    assert jax_route.expand_route_plan(indptr, indices, 37, 45) is None


def test_route_plans_of_host_arrays_go_to_the_card():
    # as the constructors and spmv_onehot_plan: a host array's plan is made
    # on the card, and raises where there is none; a tensor's plan lies
    # where the tensor does
    indptr, indices, _ = csr_arrays(30, 40, 0.2, seed=3)
    mask = np.eye(30, 40, dtype=bool)
    if torch.cuda.is_available():
        assert route.expand_route_plan(indptr, indices, 30,
                                       40).pos.device.type == "cuda"
        assert route.compress_route_plan(mask, 40).pos.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            route.expand_route_plan(indptr, indices, 30, 40)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            route.compress_route_plan(mask, 40)
    t = torch.from_numpy(indices)
    p = route.expand_route_plan(indptr, t, 30, 40)
    assert p.pos.device == p.win.device == torch.device("cpu")
    assert route.compress_route_plan(torch.from_numpy(mask),
                                     40).pos.device.type == "cpu"


def test_expand_plan_sorts_out_of_order_structures():
    """An unsorted structure without duplicates: positions sorted, each
    with the index of its value; the result is that of the canonical
    structure (scipy's toarray and JAX's plan of the sorted entries)."""
    indptr, indices, data = unsorted_csr_arrays(128, 256, 0.1, seed=4,
                                                max_run=1)
    plan = route.expand_route_plan(indptr, indices, 128, 256, device="cpu")
    assert plan.src is not None
    assert (np.diff(plan.pos.numpy()) > 0).all()
    rows = _rows(indptr)
    flat = rows * 256 + indices
    assert plan.pos.tolist() == flat[plan.src.numpy()].tolist()
    dense, pattern = route.densify_routed(torch.from_numpy(data), plan)
    ref = sp.csr_matrix((data, indices, indptr), shape=(128, 256))
    assert_bitwise(dense, ref.toarray())
    order = np.argsort(flat, kind="stable")
    srt = sp.csr_matrix((data[order], indices[order], indptr),
                        shape=(128, 256))
    (jd, jp) = jax_route.densify_routed(
        jnp.asarray(srt.data), jax_route.expand_route_plan(
            srt.indptr, srt.indices, 128, 256), interpret=True)
    assert_bitwise(dense, np.asarray(jd))
    assert_bitwise(pattern, np.asarray(jp))
    # a canonical structure carries no source index
    ip, ix, _ = csr_arrays(128, 256, 0.1, seed=4)
    assert route.expand_route_plan(ip, ix, 128, 256, device="cpu").src is None


def test_expand_plan_refuses_duplicates_and_stray_columns():
    indptr, indices, _ = unsorted_csr_arrays(60, 50, 0.2, seed=3, max_run=3)
    with pytest.raises(ValueError, match="duplicate"):
        route.expand_route_plan(indptr, indices, 60, 50, device="cpu")
    ip, ix, _ = csr_arrays(20, 30, 0.2, seed=5)
    for bad in (30, -1):
        cols = ix.copy()
        cols[3] = bad
        with pytest.raises(ValueError, match="column ids"):
            route.expand_route_plan(ip, cols, 20, 30, device="cpu")


def _compress_both(mask, c):
    jplan = jax_route.compress_route_plan(mask, mask.shape[1])
    want = jax_route.extract_routed(jnp.asarray(c), jplan, interpret=True)
    plan = route.compress_route_plan(mask, mask.shape[1], device="cpu")
    return route.extract_routed(torch.from_numpy(c), plan), want, plan, jplan


@pytest.mark.parametrize("m,n,density", [
    (256, 256, 0.9),
    (256, 256, 0.3),
    (128, 384, 0.05),
    (128, 128, 1.0),
    (384, 128, 0.2),
])
def test_compress_bitwise(m, n, density):
    rng = np.random.default_rng(m + int(density * 100))
    mask = rng.random((m, n)) < density
    c = rng.standard_normal((m, n)).astype(np.float32)
    got, want, plan, jplan = _compress_both(mask, c)
    assert_bitwise(got, np.asarray(want))
    assert_bitwise(got, c[mask])
    assert plan.cap == jplan.cap == int(mask.sum())
    assert_bitwise(plan.indptr, np.asarray(jplan.indptr))
    assert_bitwise(plan.indices, np.asarray(jplan.indices))
    S = sp.csr_matrix(mask)
    assert_bitwise(plan.indptr, S.indptr.astype(np.int32))
    assert_bitwise(plan.indices, S.indices.astype(np.int32))


def test_compress_empty_rows_and_tail():
    rng = np.random.default_rng(0)
    mask = np.zeros((256, 256), bool)
    mask[3, :] = True
    mask[10, :] = True
    mask[60, 250] = True
    c = rng.standard_normal((256, 256)).astype(np.float32)
    got, want, _, _ = _compress_both(mask, c)
    assert_bitwise(got, np.asarray(want))
    assert_bitwise(got, c[mask])


def test_compress_ultra_sparse_applies():
    """JAX returns no plan here: one 128-entry output block would span more
    than the 128 source rows its VMEM-resident slice holds (a TPU gate).
    The port's plan gathers by flat position and applies."""
    rng = np.random.default_rng(1)
    mask = np.zeros((256, 256), bool)
    mask[3, 250] = True
    mask[200, :] = True
    sparse_mask = rng.random((384, 128)) < 0.001
    sparse_mask[0, 0] = sparse_mask[-1, -1] = True
    for mk in (mask, sparse_mask):
        assert jax_route.compress_route_plan(mk, mk.shape[1]) is None
        plan = route.compress_route_plan(mk, mk.shape[1], device="cpu")
        assert plan is not None and plan.cap == int(mk.sum())
        c = rng.standard_normal(mk.shape).astype(np.float32)
        assert_bitwise(route.extract_routed(torch.from_numpy(c), plan), c[mk])
    assert route.compress_route_plan(np.zeros((8, 8), bool), 8,
                                     device="cpu") is None


def test_compress_alpha_and_accumulate():
    """(alpha*c)[pos] and beta*prev + (alpha*c)[pos], each product and the
    sum rounded to float32 on its own; `out` may be `c_prev`."""
    rng = np.random.default_rng(2)
    mask = rng.random((64, 96)) < 0.2
    c = rng.standard_normal((64, 96)).astype(np.float32)
    prev = rng.standard_normal(int(mask.sum())).astype(np.float32)
    plan = route.compress_route_plan(mask, 96, device="cpu")
    alpha, beta = np.float32(-1.7), np.float32(0.3)
    got = route.extract_routed(torch.from_numpy(c), plan, alpha=-1.7)
    assert_bitwise(got, alpha * c[mask])
    buf = torch.from_numpy(prev.copy())
    out = route.extract_routed(torch.from_numpy(c), plan, alpha=-1.7,
                               c_prev=buf, beta=0.3, out=buf)
    assert out is buf
    assert_bitwise(out, beta * prev + alpha * c[mask])
    with pytest.raises(ValueError, match="c_prev"):
        route.extract_routed(torch.from_numpy(c), plan,
                             c_prev=torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        route.extract_routed(torch.from_numpy(c).T, plan)


@pytest.mark.parametrize("m,n,want", [
    (1, 2**31 - 1, torch.int32),    # m*n = 2^31 - 1: every position fits
    (1, 2**31, torch.int64),
    (2, 2**30, torch.int64),         # m*n = 2^31
    (46340, 46341, torch.int32),     # 2^31 - 1 - 70 cells
    (46341, 46341, torch.int64),     # past 2^31
])
def test_compress_position_type_from_shape_alone(m, n, want):
    """The compress plan keeps int32 positions below 2^31 cells and int64
    at and past it, decided from (m, n) alone: a one-entry structure in the
    last cell, no such matrix made."""
    assert route.pos_dtype(m, n) == np.dtype(str(want).split(".")[1])
    flat = np.array([0, m * n - 1], np.int64)
    plan = route.compress_plan_from_flat(flat, m, n, "cpu")
    assert plan.pos.dtype == want
    assert plan.pos.tolist() == flat.tolist()
    assert plan.indptr.tolist()[-1] == 2 and plan.indptr.numel() == m + 1


@pytest.mark.parametrize("m,n,density", [(256, 256, 0.3), (37, 45, 0.5),
                                         (1, 1000, 0.1)])
def test_compress_int32_and_int64_positions_agree(m, n, density):
    """A plan's int32 positions and the same positions as int64 are the
    same flat indices, and give `extract_routed_plain` the same bits, with
    and without the accumulate."""
    rng = np.random.default_rng(m + n)
    mask = rng.random((m, n)) < density
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    prev = torch.from_numpy(rng.standard_normal(int(mask.sum())).astype(
        np.float32))
    plan = route.compress_route_plan(mask, n, device="cpu")
    wide = plan._replace(pos=plan.pos.long())
    assert plan.pos.dtype == torch.int32
    assert_bitwise(wide.pos, np.flatnonzero(mask.ravel()).astype(np.int64))
    assert plan.pos.tolist() == wide.pos.tolist()
    for kw in ({}, {"alpha": -1.7, "c_prev": prev, "beta": 0.3}):
        got = route.extract_routed_plain(c, plan, **kw)
        assert_bitwise(got, route.extract_routed_plain(c, wide, **kw))
        assert_bitwise(got, route.extract_routed(c, wide, **kw))
    with pytest.raises(ValueError, match="int32 or int64"):
        route.extract_routed(c, plan._replace(pos=plan.pos.short()))


def test_f32_rounds_as_numpy():
    """The wrappers' float32 rounding of alpha and beta (a 4-byte pack)
    gives numpy's value, also where the pack refuses the value."""
    from spmm_tpu_torch.ops import _primitives as prim

    with np.errstate(over="ignore"):  # numpy's inf past float32's range
        for x in (1.0, -1.7, 0.1, 1 / 3, 3.4028235e38, 3.4028236e38, 1e39,
                  -1e300, 1e-46, 2**200, np.float32(0.3), np.float64(2.2), 7,
                  float("inf"), True):
            assert prim.f32(x) == float(np.float32(x)), x
    assert np.isnan(prim.f32(float("nan")))


def test_roundtrip_spgemm_shapes():
    # expansion then compression: the serving pipeline's movement
    m = k = n = 256
    A = csr_arrays(m, k, 0.1, seed=11)
    B = csr_arrays(k, n, 0.1, seed=12)
    pa = route.expand_route_plan(A[0], A[1], m, k, device="cpu")
    pb = route.expand_route_plan(B[0], B[1], k, n, device="cpu")
    da, _ = route.densify_routed(torch.from_numpy(A[2]), pa)
    db, _ = route.densify_routed(torch.from_numpy(B[2]), pb)
    Sa = sp.csr_matrix((A[2], A[1], A[0]), shape=(m, k))
    Sb = sp.csr_matrix((B[2], B[1], B[0]), shape=(k, n))
    cref = Sa.toarray().astype(np.float64) @ Sb.toarray().astype(np.float64)
    mask = (Sa.toarray() != 0).astype(np.float64) @ (
        Sb.toarray() != 0).astype(np.float64) > 0
    c = (da.double() @ db.double()).float()
    vals = route.extract_routed(c, route.compress_route_plan(mask, n,
                                                             "cpu"))
    np.testing.assert_allclose(vals.numpy(), cref[mask].astype(np.float32),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# SpgemmPlan (twins of tests/test_serving.py)
# ---------------------------------------------------------------------------


def _pair(m, k, n, da, db, seed, **kw):
    a_ref, a = pair(m, k, da, seed, **kw)
    b_ref, b = pair(k, n, db, seed + 1)
    return a_ref, a, b_ref, b


def _assert_close(got, want):
    """Values within rtol 1e-6 + atol 1e-6*max|want|."""
    w = np.asarray(want)
    atol = 1e-6 * float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("m,k,n,da,db", [
    (256, 256, 256, 0.1, 0.1),
    (128, 384, 256, 0.05, 0.02),
    (256, 128, 128, 0.3, 0.3),
])
def test_plan_matches_jax_and_alg1(m, k, n, da, db):
    a_ref, a, b_ref, b = _pair(m, k, n, da, db, seed=m + n)
    jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
    plan = pt.spgemm_plan(a, b)
    assert plan.shape == jplan.shape and plan.nnz == jplan.nnz
    assert (plan.nnz_a, plan.nnz_b) == (jplan.nnz_a, jplan.nnz_b)
    assert plan.dtype == torch.float32
    C = plan(a.data, b.data)
    assert C.has_canonical_format
    assert_csr_match(C, jplan(a_ref.data, b_ref.data))
    # the same dense operands through the same matmul: alg 1's bits
    assert_csr_bitwise(C, pt.spgemm(a, b, alg=1))
    # bitwise on rerun
    assert_bitwise(plan(a.data, b.data).data, C.data)


def test_plan_routed():
    _, a, _, b = _pair(256, 256, 256, 0.1, 0.1, seed=3)
    assert pt.spgemm_plan(a, b).routed == (True, True, True)
    # use_routed is accepted for signature parity and changes nothing
    assert pt.spgemm_plan(a, b, use_routed=False).routed == (True, True,
                                                              True)


def test_plan_fallback_matches():
    """JAX's scatter/gather fallback (use_routed=False) against the port's
    plan."""
    a_ref, a, b_ref, b = _pair(256, 256, 256, 0.1, 0.1, seed=5)
    jplan = st.spgemm_plan(a_ref, b_ref, use_routed=False)
    assert jplan.routed == (False, False, False)
    assert_csr_match(pt.spgemm_plan(a, b)(a.data, b.data),
                     jplan(a_ref.data, b_ref.data))


def test_plan_new_values_same_structure():
    a_ref, a, b_ref, b = _pair(256, 256, 256, 0.08, 0.08, seed=9)
    jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
    plan = pt.spgemm_plan(a, b)
    rng = np.random.default_rng(0)
    for _ in range(3):
        av = rng.standard_normal(plan.nnz_a).astype(np.float32)
        bv = rng.standard_normal(plan.nnz_b).astype(np.float32)
        C = plan(torch.from_numpy(av), torch.from_numpy(bv))
        assert_csr_match(C, jplan(jnp.asarray(av), jnp.asarray(bv)))
        a2 = pt.CSR.from_parts(a.indptr, a.indices, torch.from_numpy(av),
                               a.shape, canonical=True)
        b2 = pt.CSR.from_parts(b.indptr, b.indices, torch.from_numpy(bv),
                               b.shape, canonical=True)
        assert_csr_bitwise(C, pt.spgemm(a2, b2, alg=1))
        # structure is shared, not recomputed
        assert C.indptr is plan.indptr and C.indices is plan.indices


@pytest.mark.parametrize("alpha", [2.5, -0.3])
def test_plan_alpha(alpha):
    a_ref, a, b_ref, b = _pair(128, 128, 128, 0.2, 0.2, seed=21)
    plan = pt.spgemm_plan(a, b)
    C = plan(a.data, b.data, alpha=alpha)
    jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
    assert_csr_match(C, jplan(a_ref.data, b_ref.data, alpha=alpha))
    assert_csr_bitwise(C, pt.spgemm(a, b, alpha=alpha, alg=1))


def test_plan_explicit_zero_and_tiny_values():
    # explicit zeros stay structural and the smallest normal travels
    a_ref, a, b_ref, b = _pair(128, 128, 128, 0.1, 0.1, seed=33)
    data = a.data.clone()
    data[0] = 0.0
    data[1] = float(np.float32(1.1754944e-38))
    a = pt.CSR.from_parts(a.indptr, a.indices, data, a.shape, canonical=True)
    a_ref = st.CSR.from_parts(a_ref.indptr, a_ref.indices,
                              jnp.asarray(data.numpy()), a_ref.shape,
                              canonical=True)
    C = pt.spgemm_plan(a, b)(a.data, b.data)
    assert_csr_match(C, st.spgemm_plan(a_ref, b_ref, interpret=True)(
        a_ref.data, b_ref.data))
    ones = [sp.csr_matrix((np.ones(x.nnz), x.indices.numpy(),
                           x.indptr.numpy()), shape=x.shape) for x in (a, b)]
    S = (ones[0] @ ones[1]).tocsr()
    S.sort_indices()
    assert_bitwise(C.indptr, S.indptr.astype(np.int32))
    assert_bitwise(C.indices, S.indices.astype(np.int32))


def test_plan_empty_output():
    # A stores column 0 only; B stores row 99 only -> no product
    a_arr = (np.arange(129, dtype=np.int32), np.zeros(128, np.int32),
             np.ones(128, np.float32))
    bi = np.zeros(129, np.int32)
    bi[100:] = 1
    b_arr = (bi, np.array([5], np.int32), np.ones(1, np.float32))
    a_ref = st.CSR.from_parts(*a_arr, (128, 128), canonical=True)
    b_ref = st.CSR.from_parts(*b_arr, (128, 128), canonical=True)
    a = pt.from_reference(a_ref, device="cpu")
    b = pt.from_reference(b_ref, device="cpu")
    plan = pt.spgemm_plan(a, b)
    assert plan.nnz == st.spgemm_plan(a_ref, b_ref, interpret=True).nnz == 0
    assert plan.routed == (True, True, False)
    C = plan(a.data, b.data)
    assert C.nnz == 0 and C.indptr.tolist() == [0] * 129
    c = torch.zeros(0)
    assert plan.values_accumulate(c, a.data, b.data) is c
    assert plan.values_batch(a.data[None], b.data[None]).shape == (1, 0)


def test_plan_validates():
    a_ref, a, b_ref, b = _pair(128, 128, 128, 0.1, 0.1, seed=41)
    plan = pt.spgemm_plan(a, b)
    jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
    for fn, args in ((plan, (a.data[:-1], b.data)),
                     (jplan, (a_ref.data[:-1], b_ref.data))):
        with pytest.raises(ValueError, match="do not match"):
            fn(*args)
    with pytest.raises(ValueError, match="float32"):
        plan(a.data.double(), b.data)
    with pytest.raises(TypeError, match="CSR"):
        pt.spgemm_plan(a, b.toarray())
    with pytest.raises(ValueError, match="mismatch"):
        pt.spgemm_plan(a, pt.random(64, 8, 0.1, format="csr", seed=0,
                                    device="cpu"))
    # "high" and a float64 operand compute now, as in JAX: a wide plan in
    # float32, its CSR cast back to float64; an unknown mode still raises
    want = st.spgemm_plan(a_ref, b_ref, precision="high",
                          interpret=True)(a_ref.data, b_ref.data)
    got = pt.spgemm_plan(a, b, precision="high")(a.data, b.data)
    _assert_close(got.data, want.data)
    with pytest.raises(ValueError, match="precision"):
        pt.spgemm_plan(a, b, precision="tf32")
    b64 = pt.CSR.from_parts(b.indptr, b.indices, b.data.double(), b.shape,
                            canonical=True)
    with jax.enable_x64(True):
        b64_ref = st.CSR.from_parts(np.asarray(b_ref.indptr),
                                    np.asarray(b_ref.indices),
                                    np.asarray(b_ref.data, np.float64),
                                    b_ref.shape, canonical=True)
        jplan64 = st.spgemm_plan(a_ref, b64_ref, interpret=True)
        want = jplan64(a_ref.data, b64_ref.data)
        got = pt.spgemm_plan(a, b64)(a.data, b64.data)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        _assert_close(got.data, want.data)


@pytest.mark.parametrize("alpha", [2.0, "vector"])
def test_plan_values_batch(alpha):
    """K value sets through one set of workspaces == K single calls,
    bitwise; and within tolerance of JAX's scan."""
    a_ref, a, b_ref, b = _pair(192, 192, 192, 0.1, 0.1, seed=5)
    plan = pt.spgemm_plan(a, b)
    jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
    rng = np.random.default_rng(0)
    K = 3
    av = rng.random((K, plan.nnz_a), dtype=np.float32)
    bv = rng.random((K, plan.nnz_b), dtype=np.float32)
    alphas = (np.array([1.0, 0.5, -2.0], np.float32) if alpha == "vector"
              else alpha)
    batch = plan.values_batch(torch.from_numpy(av), torch.from_numpy(bv),
                              alpha=(torch.from_numpy(alphas)
                                     if alpha == "vector" else alpha))
    assert batch.shape == (K, plan.nnz)
    want = jplan.values_batch(jnp.asarray(av), jnp.asarray(bv),
                              alpha=jnp.asarray(alphas))
    for i in range(K):
        one = plan.values(torch.from_numpy(av[i]), torch.from_numpy(bv[i]),
                          alpha=np.broadcast_to(alphas, (K,))[i])
        assert_bitwise(batch[i], one)
        _assert_close(batch[i], np.asarray(want)[i])


def test_plan_values_batch_validates():
    _, a, _, b = _pair(64, 64, 64, 0.1, 0.1, seed=11)
    plan = pt.spgemm_plan(a, b)
    with pytest.raises(ValueError, match="stacked"):
        plan.values_batch(a.data, torch.stack([b.data]))
    with pytest.raises(ValueError, match="batch sizes"):
        plan.values_batch(torch.stack([a.data]),
                          torch.stack([b.data, b.data]))
    with pytest.raises(ValueError, match="do not match"):
        plan.values_batch(torch.stack([a.data[:-1]]), torch.stack([b.data]))


def test_plan_values_accumulate():
    """beta*C + alpha*A@B written into the caller's C buffer."""
    a_ref, a, b_ref, b = _pair(160, 160, 160, 0.1, 0.1, seed=7)
    plan = pt.spgemm_plan(a, b)
    jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
    base = plan.values(a.data, b.data)
    c = torch.zeros(plan.nnz)
    out = plan.values_accumulate(c, a.data, b.data)          # C = A@B
    assert out is c
    assert_bitwise(c, base)
    plan.values_accumulate(c, a.data, b.data, alpha=1.0, beta=1.0)
    assert_bitwise(c, 2.0 * base)
    c2 = plan.values_accumulate(base.clone(), a.data, b.data, alpha=-1.0,
                                beta=1.0)                    # C - A@B
    assert not c2.any()
    prev = torch.linspace(-1, 1, plan.nnz)
    got = plan.values_accumulate(prev.clone(), a.data, b.data, alpha=0.5,
                                 beta=-2.0)
    assert_bitwise(got, torch.add(prev * -2.0, base * 0.5))
    want = jplan.values_accumulate(jnp.asarray(prev.numpy()), a_ref.data,
                                   b_ref.data, alpha=0.5, beta=-2.0)
    _assert_close(got, want)
    with pytest.raises(ValueError, match="planned nnz"):
        plan.values_accumulate(torch.zeros(plan.nnz + 1), a.data, b.data)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16", "complex64"])
def test_plan_values_accumulate_wide(dtype):
    """beta*C + alpha*A@B for a C buffer of another dtype, against JAX's
    (x64 on): JAX's result dtype, float32 beta times C plus the float32
    product; in place for float64 and complex64, a new float32 tensor for
    bfloat16."""
    a_ref, a, b_ref, b = _pair(128, 128, 128, 0.1, 0.1, seed=17)
    plan = pt.spgemm_plan(a, b)
    rng = np.random.default_rng(3)
    prev = rng.standard_normal(plan.nnz)
    if dtype == "complex64":
        prev = prev + 1j * rng.standard_normal(plan.nnz)
    with jax.enable_x64(True):
        jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
        prev_j = jnp.asarray(prev).astype(dtype)
        # the same values (bfloat16 exactly as float32), copied before
        # JAX's call takes the donated buffer
        prev_np = np.array(prev_j.astype(jnp.float32)
                           if dtype == "bfloat16" else prev_j)
        want = jplan.values_accumulate(prev_j, a_ref.data, b_ref.data,
                                       alpha=0.5, beta=-2.0)
    c = torch.from_numpy(prev_np).to(getattr(torch, dtype))
    got = plan.values_accumulate(c, a.data, b.data, alpha=0.5, beta=-2.0)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert (got is c) == (dtype != "bfloat16")
    if dtype == "bfloat16":  # the buffer is left as it was
        assert_bitwise(c.float(), torch.from_numpy(prev_np))
    _assert_close(got, want)


def test_plan_of_unsorted_duplicate_operands():
    """The plan canonicalises its operands (`sum_duplicates`), as JAX's
    does; the values of a call are then the canonical ones."""
    a_ref, a = unsorted_pair(96, 80, 0.1, 13, max_run=2)
    b_ref, b = unsorted_pair(80, 64, 0.1, 14, max_run=2)
    plan = pt.spgemm_plan(a, b)
    jplan = st.spgemm_plan(a_ref, b_ref, interpret=True)
    ac, bc = a.sum_duplicates(), b.sum_duplicates()
    assert plan.nnz_a == ac.nnz < a.nnz
    assert_csr_match(plan(ac.data, bc.data),
                     jplan(a_ref.sum_duplicates().data,
                           b_ref.sum_duplicates().data))


def test_structural_product_numpy_fallback(monkeypatch):
    """Without scipy both packages fall back to a dense numpy product with
    the same output."""
    a_ref, a, b_ref, b = _pair(50, 40, 30, 0.1, 0.2, seed=15, zeros=2)
    with_scipy = pt_serving._structural_product(a, b)
    monkeypatch.setitem(sys.modules, "scipy.sparse", None)
    without = pt_serving._structural_product(a, b)
    jax_without = jax_serving._structural_product(a_ref, b_ref)
    for x, y, z in zip(with_scipy, without, jax_without):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)

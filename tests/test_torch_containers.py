"""The port's sparse containers (COO, CSR, CSC, BSR, DIA) against the JAX
package: twins of tests/test_containers.py, test_container_basics.py,
test_data_ops.py, test_extrema_compare.py, test_construct.py and
test_extract_construct.py, without the parts that wait for the indexing
slice (`__getitem__`, row iteration, `setdiag`, `getcol`) and the pytree
test (the port's containers are not pytrees).

Every input is made with numpy (`torch_port_helpers`) and handed to both
packages.  Structure (indptr, indices, row, col, offsets, block ids) is
compared bitwise.  Values are bitwise where they are data movement, one
float32 operation per value, or an in-order sum (the duplicate and axis
sums, `_primitives.segment_sum_inorder`, add in JAX's order).  The
exceptions, each with its tolerance: the whole-matrix `sum`/`mean` (XLA's
reduction tree, rtol 1e-6) and the transcendental ufuncs (another libm,
rtol 1e-6 / atol 1e-7).  Where spmm_tpu departs from scipy, the port pins
JAX's behaviour: a stored -0.0 reads +0.0 where JAX adds into zeros
(COO/CSC/BSR `toarray`, duplicate sums).
"""

import operator
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.sparse import DIA as JDIA  # noqa: E402
from spmm_tpu.sparse import (find as jfind, kron as jkron,  # noqa: E402
                             kronsum as jkronsum, tril as jtril,
                             triu as jtriu)
from spmm_tpu_torch.sparse import (DIA, find, kron, kronsum,  # noqa: E402
                                   tril, triu)
from torch_port_helpers import (  # noqa: E402
    assert_bitwise, assert_same, coo_arrays, sparse_pair)

FORMATS = ["coo", "csr", "csc"]


def _dense(x):
    x = x.toarray() if hasattr(x, "toarray") else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(cls_name, *args, **kw):
    """The same constructor call in both packages (the port's on the
    CPU)."""
    return (getattr(st, cls_name)(*args, **kw),
            getattr(pt, cls_name)(*args, **kw, device="cpu"))


# ---------------------------------------------------------------------- COO


def test_coo_sum_duplicates():
    row = [0, 1, 0, 1, 0, 1]
    col = [1, 2, 1, 2, 0, 2]
    val = [1.0, 2.0, 3.0, 4.0, 5.0, 2.0**-24]
    want, got = _both("COO", (val, (row, col)), shape=(3, 4))
    assert not got.has_canonical_format
    b = got.sum_duplicates()
    assert b.nnz == 3 and b.has_canonical_format
    assert_same(b, want.sum_duplicates())
    S = sp.coo_matrix((val, (row, col)), shape=(3, 4))
    np.testing.assert_allclose(_dense(b), S.toarray(), rtol=1e-7)


def test_coo_eliminate_zeros():
    want, got = _both("COO", ([1.0, 0.0, 2.0], ([0, 1, 2], [0, 1, 2])),
                      shape=(3, 3))
    b = got.eliminate_zeros()
    assert b.nnz == 2
    assert_same(b, want.eliminate_zeros())
    np.testing.assert_array_equal(_dense(b), np.diag([1.0, 0, 2.0]))


def test_coo_transpose():
    want, got = sparse_pair(40, 30, 0.15, 0, "coo")
    assert_same(got.T, want.T)
    assert_bitwise(got.T.toarray(), np.asarray(want.T.toarray()))


def test_coo_from_dense():
    x = np.array([[1.0, 0, 2], [0, 0, 3]])
    want, got = _both("COO", x)
    assert got.nnz == 3 and got.dtype == torch.float32  # x64 off, as JAX
    assert_same(got, want)
    np.testing.assert_array_equal(_dense(got), x)


def test_coo_toarray_adds_into_zeros():
    # duplicates summed in stored order, and -0.0 stored alone reads +0.0,
    # as JAX's zeros.at[row, col].add(data)
    row, col = [0, 0, 0, 1], [0, 0, 0, 1]
    val = np.array([1.0, 2.0**-24, 2.0**-24, -0.0], np.float32)
    want, got = _both("COO", (val, (row, col)), shape=(2, 2))
    assert_bitwise(got.toarray(), np.asarray(want.toarray()))
    assert got.toarray().numpy().view(np.uint32)[1, 1] == 0


# ---------------------------------------------------------------------- CSR


def test_csr_from_triplet_tuple():
    As = sp.random(20, 25, density=0.2, random_state=0, format="csr",
                   dtype=np.float32)
    want, got = _both("CSR", (As.data, As.indices, As.indptr),
                      shape=As.shape)
    assert_same(got, want)
    assert_bitwise(got.toarray(), As.toarray())


def test_csr_constructor_forms():
    x = np.array([[0, 1.5, 0], [2.0, 0, 0]], np.float32)
    triplets = ([1.5, 2.0], ([0, 1], [1, 0]))
    for args, kw in (((x,), {}), (((2, 3),), {}),
                     ((triplets,), {"shape": (2, 3)})):
        want, got = _both("CSR", *args, **kw)
        assert_same(got, want)
    want, got = _both("CSR", x)
    assert_same(pt.CSR(got.tocoo()), st.CSR(want.tocoo()))
    assert_same(pt.CSC(got), st.CSC(want))


def test_csr_sort_indices():
    indptr = np.array([0, 3, 5])
    indices = np.array([2, 0, 1, 4, 3])
    data = np.array([1.0, 2, 3, 4, 5])
    want, got = _both("CSR", (data, indices, indptr), shape=(2, 5))
    b = got.sort_indices()
    np.testing.assert_array_equal(b.indices.numpy(), [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(b.data.numpy(), [2, 3, 1, 5, 4])
    assert b.check_canonical()
    assert_same(b, want.sort_indices())


def test_csr_check_canonical_detects_duplicates():
    _, a = _both("CSR", (np.ones(2), np.array([1, 1]), np.array([0, 2])),
                 shape=(1, 3))
    assert not a.check_canonical()


def test_csr_transpose_roundtrip():
    want, got = sparse_pair(40, 30, 0.15, 0)
    assert_same(got.T, want.T)
    assert_same(got.T.T, want.T.T)
    # a CSR with duplicates and unsorted rows transposes to JAX's output
    want, got = _both("CSR", (np.array([1.0, 2.0, 3.0], np.float32),
                              np.array([2, 0, 2]), np.array([0, 3, 3])),
                      shape=(2, 3))
    assert_same(got.T, want.T)


def test_csr_getrow_diagonal():
    want, got = sparse_pair(20, 20, 0.15, 0)
    assert_same(got.getrow(3), want.getrow(3))
    for k in (-2, 0, 5, 30):
        assert_bitwise(got.diagonal(k), np.asarray(want.diagonal(k)))
    # duplicates on the diagonal are summed in stored order, as JAX does
    want, got = _both("CSR", (np.array([1.0, 2.0**-24, 2.0**-24],
                                       np.float32),
                              np.array([0, 0, 0]), np.array([0, 3, 3])),
                      shape=(2, 2))
    assert_bitwise(got.diagonal(), np.asarray(want.diagonal()))


@pytest.mark.parametrize("fmt", FORMATS)
def test_csr_reductions(fmt):
    want, got = sparse_pair(40, 30, 0.15, 0, fmt)
    # the axis sums add in stored order, as JAX's .at[].add: bitwise
    for axis in (0, 1, -1, -2):
        assert_bitwise(got.sum(axis=axis), np.asarray(want.sum(axis=axis)))
        assert_bitwise(got.mean(axis=axis), np.asarray(want.mean(axis=axis)))
    # the whole sum is XLA's reduction tree there, torch's here
    np.testing.assert_allclose(float(got.sum()), float(want.sum()),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got.mean()), float(want.mean()),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        got.sum(axis=2)


@pytest.mark.parametrize("i", [-1, -20, 19, 3.7, -1.2])
def test_csr_getrow_out_of_order_indices_as_scipy(i):
    # scipy's getrow: int() of the index, negative from the end; JAX's
    # getrow returns a corrupt empty row for a negative index, so the port
    # pins scipy's behaviour
    _, got = sparse_pair(20, 20, 0.15, 0)
    ref = got.to_scipy().tocsr()
    want = ref.getrow(i)
    row = got.getrow(i)
    assert row.shape == want.shape == (1, 20)
    np.testing.assert_array_equal(_dense(row), want.toarray())


@pytest.mark.parametrize("i", [20, -21, 1000])
def test_csr_getrow_out_of_range_raises_as_scipy(i):
    _, got = sparse_pair(20, 20, 0.15, 0)
    with pytest.raises(IndexError):
        got.to_scipy().tocsr().getrow(i)
    with pytest.raises(IndexError, match="out of range"):
        got.getrow(i)


def test_diagonal_is_linear_and_jax_bitwise():
    # 1024^2/0.1 (105 k entries): the off-diagonal entries are dropped
    # before the in-order sum, so the cost follows the entries
    import time

    want, got = sparse_pair(1024, 1024, 0.1, 5)
    t0 = time.perf_counter()
    diag = got.diagonal()
    elapsed = time.perf_counter() - t0
    assert elapsed < 0.5, elapsed
    assert_bitwise(diag, np.asarray(want.diagonal()))
    for k in (3, -7):
        assert_bitwise(got.diagonal(k), np.asarray(want.diagonal(k)))


def test_axis_sum_is_linear_and_jax_bitwise():
    # a power-law matrix whose longest row holds 2^16 entries: the in-order
    # axis sums cost O(entries), not (longest row) x (rows)
    import importlib
    import time

    from spmm_tpu_torch.models import power_law_rows

    jax_models = importlib.import_module("spmm_tpu.models.matrices")
    got = power_law_rows(1 << 16, 1 << 16, 16, seed=0, device="cpu")
    want = jax_models.power_law_rows(1 << 16, 1 << 16, 16, seed=0)
    t0 = time.perf_counter()
    rows = got.sum(axis=1)
    elapsed = time.perf_counter() - t0
    assert elapsed < 2.0, elapsed
    assert_bitwise(rows, np.asarray(want.sum(axis=1)))
    assert_bitwise(got.sum(axis=0), np.asarray(want.sum(axis=0)))


def test_csr_scalar_ops():
    want, got = sparse_pair(40, 30, 0.15, 0)
    for g, w in ((got * 2.0, want * 2.0), (2.0 * got, 2.0 * want),
                 (got / 4.0, want / 4.0), (-got, -want),
                 (got * np.float32(3.0), want * np.float32(3.0))):
        assert_same(g, w)


def test_csr_astype_copy_conj():
    want, got = sparse_pair(40, 30, 0.15, 0)
    assert got.astype(torch.float64).dtype == torch.float64
    assert got.astype(np.float64).dtype == torch.float64
    b = got.copy()
    assert_same(b, want.copy())
    b.data[0] = 7.0  # a copy owns its values
    assert float(got.data[0]) != 7.0
    assert_same(got.conj(), want.conj())
    assert_same(got.real, want.real)
    assert_same(got.imag, want.imag)
    assert got.count_nonzero() == want.count_nonzero()


# ---------------------------------------------------------------------- CSC


def test_csc_roundtrip():
    want, got = sparse_pair(40, 30, 0.15, 0, "csc")
    assert isinstance(got, pt.CSC)
    assert_same(got, want)
    assert_bitwise(got.toarray(), np.asarray(want.toarray()))
    assert_same(got.tocsr(), want.tocsr())
    assert_same(got.T.T.tocsc(), want.T.T.tocsc())
    assert_same(got.tocoo(), want.tocoo())


def test_csc_free_transpose_is_csr():
    want, got = sparse_pair(40, 30, 0.15, 0, "csc")
    T = got.transpose()
    assert isinstance(T, pt.CSR)
    assert_same(T, want.transpose())


def test_csc_sort_and_sum_duplicates():
    args = ((np.array([1.0, 2.0, 3.0, 4.0], np.float32),
             np.array([2, 0, 2, 1]), np.array([0, 3, 4])),)
    want, got = _both("CSC", *args, shape=(3, 2))
    assert_same(got.sort_indices(), want.sort_indices())
    assert_same(got.sum_duplicates(), want.sum_duplicates())


# ---------------------------------------------------------------------- BSR


@pytest.mark.parametrize("blocksize", [(2, 2), (4, 8), (8, 128), (16, 128)])
def test_bsr_roundtrip(blocksize):
    want, got = sparse_pair(37, 260, 0.05, 0)
    b, w = got.tobsr(blocksize=blocksize), want.tobsr(blocksize=blocksize)
    assert isinstance(b, pt.BSR) and b.blocksize == blocksize
    assert_same(b, w)
    assert b.nblocks == w.nblocks and b.nnz == w.nnz
    assert b.block_density == w.block_density
    assert_bitwise(b.block_rows, np.asarray(w.block_rows))
    assert_bitwise(b.toarray(), np.asarray(w.toarray()))
    assert_same(b.tocoo(), w.tocoo())
    assert_same(b.tocsr(), w.tocsr())
    assert_same(b.T, w.T)
    assert b.tobsr(blocksize) is b
    np.testing.assert_array_equal(_dense(b), want.to_scipy().toarray())


def test_bsr_block_density():
    want = st.eye(64, 64, format="csr").tobsr(blocksize=(8, 8))
    b = pt.eye(64, 64, format="csr", device="cpu").tobsr(blocksize=(8, 8))
    assert b.nblocks == 8  # diagonal blocks only
    assert 0 < b.block_density <= 0.125 + 1e-9
    assert_same(b, want)


def test_bsr_constructor_and_zeros():
    # explicit zeros and -0.0 inside blocks: tocoo drops them, toarray adds
    # into zeros, as JAX's dense round trip does
    dense = np.zeros((16, 256), np.float32)
    dense[0, 0], dense[3, 200], dense[9, 5] = 1.0, -2.0, 3.0
    want = st.BSR(st.CSR(dense), blocksize=(8, 128))
    got = pt.BSR(pt.CSR(dense, device="cpu"), blocksize=(8, 128))
    assert_same(got, want)
    data = got.data.clone()
    data[0, 1, 1] = -0.0
    g2 = pt.BSR((data, got.indices, got.indptr), shape=got.shape)
    w2 = st.BSR((data.numpy(), np.asarray(want.indices),
                 np.asarray(want.indptr)), shape=want.shape)
    assert_bitwise(g2.toarray(), np.asarray(w2.toarray()))
    assert_same(g2.tocoo(), w2.tocoo())
    e = pt.CSR((16, 256), device="cpu").tobsr()
    assert e.nblocks == 0 and e.indptr.tolist() == [0, 0, 0]
    assert_same(e, st.CSR((16, 256)).tobsr())


# ---------------------------------------------------------- interconversion


@pytest.mark.parametrize("fmt2", FORMATS + ["bsr", "dia"])
@pytest.mark.parametrize("fmt", FORMATS + ["bsr", "dia"])
def test_format_interconversion_matrix(fmt, fmt2):
    want, got = sparse_pair(40, 30, 0.15, 0, fmt)
    w, g = want.asformat(fmt2), got.asformat(fmt2)
    assert_same(g, w)
    np.testing.assert_array_equal(_dense(g), want.to_scipy().toarray())


# ------------------------------------------------------- container basics


def _mat():
    return _both("CSR", np.array([[1., 0, 2], [0, 3, 0], [4, 0, 5]],
                                 np.float32))


def test_len_raises():
    with pytest.raises(TypeError):
        len(_mat()[1])


def test_asfptype():
    _, a = _mat()
    assert a.asfptype() is a
    b = a.astype(np.int32)
    assert b.dtype == torch.int32
    assert b.asfptype().dtype == torch.float32


@pytest.mark.parametrize("order", [None, "C", "F"])
def test_toarray_order(order):
    want, got = _mat()
    assert_bitwise(got.toarray(order=order), np.asarray(want.toarray()))
    assert_bitwise(got.todense(), np.asarray(want.todense()))


def test_toarray_unknown_order():
    with pytest.raises(TypeError):
        _mat()[1].toarray(order="K")
    with pytest.raises(ValueError):
        _mat()[1].toarray(out=np.zeros((3, 3)))


def test_dot_scalar():
    want, got = _mat()
    assert_same(got.dot(2.0), want.dot(2.0))
    with pytest.raises(ValueError):
        got @ 2.0  # matmul still rejects scalars


@pytest.mark.parametrize("cls", ["CSR", "CSC"])
def test_component_validation(cls):
    data = np.array([1., 2, 3], np.float32)
    idx = np.array([0, 2, 1])
    ptr = np.array([0, 2, 3])
    Pcls = getattr(pt, cls)
    ok = Pcls((data, idx, ptr), shape=(2, 3) if cls == "CSR" else (3, 2),
              device="cpu")
    assert ok.nnz == 3
    with pytest.raises(ValueError):  # data/indices length mismatch
        Pcls((data[:2], idx, ptr), shape=(2, 3), device="cpu")
    bad_shape = (3, 3) if cls == "CSR" else (2, 3)  # major+1 != 3
    with pytest.raises(ValueError):  # indptr length != major+1
        Pcls((data, idx, ptr), shape=bad_shape, device="cpu")
    with pytest.raises(ValueError):  # 2-D data
        Pcls((data[None, :], idx, ptr), shape=(2, 3), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        Pcls("not a matrix", device="cpu")


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("shape", [(9, 1), (1, 9), (3, 3)])
def test_reshape(order, shape):
    want, got = _mat()
    g = got.reshape(shape, order=order)
    assert g.format == "csr"
    assert_same(g, want.reshape(shape, order=order))
    S = sp.csr_matrix(_dense(want))
    np.testing.assert_array_equal(_dense(g),
                                  S.reshape(shape, order=order).toarray())


def test_reshape_invalid():
    with pytest.raises(ValueError):
        _mat()[1].reshape((2, 4))
    with pytest.raises(NotImplementedError):  # as JAX's COO
        _mat()[1].tocoo().reshape((9, 1))


def test_resize():
    want, got = _mat()
    assert got.resize((2, 2)) is None
    want.resize((2, 2))
    assert got.shape == (2, 2)
    assert_same(got, want)
    np.testing.assert_array_equal(_dense(got), [[1, 0], [0, 3]])
    _, a2 = _mat()
    a2.resize((4, 4))
    assert a2.shape == (4, 4) and a2.nnz == 5


def test_repr_and_scipy_bridge():
    want, got = sparse_pair(12, 9, 0.3, 4, "coo")
    assert "COOrdinate" in repr(got) and "cpu" in repr(got)
    for fmt in ("coo", "csr", "csc", "bsr", "dia"):
        s = got.asformat(fmt).to_scipy()
        assert s.format == (fmt if fmt in ("coo", "csr", "csc") else "csr")
        np.testing.assert_array_equal(s.toarray(), want.to_scipy().toarray())
        assert pt.issparse(got.asformat(fmt))
    assert not pt.issparse(np.zeros((2, 2)))


# ----------------------------------------------------------------- data ops

UFUNCS_EXACT = ["ceil", "floor", "rint", "sign", "trunc", "abs", "sqrt"]
UFUNCS_LIBM = ["arcsin", "arcsinh", "arctan", "arctanh", "deg2rad",
               "expm1", "log1p", "rad2deg", "sin", "sinh", "tan", "tanh"]


def _positive_pair(m, n, d, seed, fmt):
    want, got = sparse_pair(m, n, d, seed, fmt)
    vals = np.abs(np.asarray(want.data)) * np.float32(0.9) + np.float32(0.05)
    return (want._with_data(np.asarray(vals)),
            got._with_data(torch.from_numpy(vals)))


@pytest.mark.parametrize("name", UFUNCS_EXACT + UFUNCS_LIBM)
@pytest.mark.parametrize("fmt", FORMATS)
def test_unary_ufunc(name, fmt):
    # values inside every ufunc's domain: (0, 1)
    want, got = _positive_pair(23, 17, 0.2, 3, fmt)
    g, w = getattr(got, name)(), getattr(want, name)()
    assert g.shape == got.shape and g.nnz == got.nnz
    if name in UFUNCS_EXACT:
        assert_same(g, w)
    else:
        assert_same(g, w, rtol=1e-6)
    S = _dense(want)
    ref = getattr(np, "absolute" if name == "abs" else name)(S) * (S != 0)
    np.testing.assert_allclose(_dense(g), ref, rtol=1e-5, atol=1e-6)


def test_power_and_scalar_extrema():
    want, got = _positive_pair(23, 17, 0.2, 3, "csr")
    assert_same(got.power(2), want.power(2))
    assert_same(got.maximum_scalar(-0.5), want.maximum_scalar(-0.5))
    assert_same(got.minimum_scalar(0.5), want.minimum_scalar(0.5))
    with pytest.raises(ValueError):
        got.maximum_scalar(0.5)
    with pytest.raises(ValueError):
        got.minimum_scalar(-0.5)


@pytest.mark.parametrize("which", ["max", "min"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1, -2])
@pytest.mark.parametrize("fmt", FORMATS)
def test_minmax_axis(which, axis, fmt):
    want, got = sparse_pair(19, 31, 0.25, 7, fmt)
    g = getattr(got, which)(axis=axis)
    w = getattr(want, which)(axis=axis)
    if axis is None:
        assert_bitwise(g, np.asarray(w))
    else:
        assert_same(g, w)
        S = sp.csr_matrix(_dense(want))
        np.testing.assert_array_equal(
            _dense(g), getattr(S, which)(axis=axis).toarray())


@pytest.mark.parametrize("which", ["max", "min"])
def test_minmax_explicit(which):
    dense = np.array([[0.0, -2.0, 0.0],
                      [0.0, 0.0, 0.0],
                      [3.0, 1.0, 2.0]], np.float32)
    want, got = _both("CSR", dense)
    g = getattr(got, which)(axis=1, explicit=True)
    assert_same(g, getattr(want, which)(axis=1, explicit=True))
    stored = [-2.0, 0.0, 3.0] if which == "max" else [-2.0, 0.0, 1.0]
    np.testing.assert_array_equal(_dense(g).ravel(), stored)
    g0 = getattr(got, which)(axis=None, explicit=True)
    assert float(g0) == (3.0 if which == "max" else -2.0)


def test_minmax_full_matrix_no_zero_compete():
    _, a = _both("CSR", np.arange(1, 13, dtype=np.float32).reshape(3, 4))
    assert float(a.min()) == 1.0 and float(a.max()) == 12.0


def test_minmax_empty_and_errors():
    _, a = _both("CSR", np.zeros((3, 4), np.float32))
    assert float(a.max()) == 0.0 and float(a.min()) == 0.0
    with pytest.raises(ValueError):
        a.max(axis=2)
    with pytest.raises(ValueError):
        a.max(axis=0, out=np.zeros(4))


@pytest.mark.parametrize("which", ["argmax", "argmin"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_argminmax(which, axis):
    rng = np.random.default_rng(11)
    dense = np.where(rng.random((9, 13)) < 0.3,
                     rng.standard_normal((9, 13)), 0.0).astype(np.float32)
    want, got = _both("CSR", dense)
    g, w = getattr(got, which)(axis=axis), getattr(want, which)(axis=axis)
    if axis is None:
        assert g == w == int(getattr(np, which)(dense))
    else:
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_getnnz_axis():
    want, got = sparse_pair(12, 18, 0.3, 5)
    assert got.getnnz() == want.getnnz()
    for axis in (0, 1, -1, -2):
        np.testing.assert_array_equal(got.getnnz(axis=axis),
                                      want.getnnz(axis=axis))
    with pytest.raises(ValueError):
        got.getnnz(axis=2)


# ------------------------------------------------ extrema and comparisons


def _mk(shape=(10, 12), d=0.35, seed=7):
    """A matrix of mixed signs (A - A.power(2)), as the JAX tests make it,
    in both packages."""
    want, got = sparse_pair(*shape, d, seed)
    return want - want.power(2), got - got.power(2)


@pytest.mark.parametrize("opt", ["maximum", "minimum"])
@pytest.mark.parametrize("rhs_shape", [(10, 12), (1, 12), (10, 1)])
def test_extremum_sparse(opt, rhs_shape):
    want, got = _mk(seed=1)
    assert_same(got, want)
    wb, gb = _mk(shape=rhs_shape, d=0.5, seed=2)
    assert_same(getattr(got, opt)(gb), getattr(want, opt)(wb))
    np.testing.assert_array_equal(
        _dense(getattr(got, opt)(gb)),
        getattr(np, opt)(_dense(want), _dense(wb)))


@pytest.mark.parametrize("opt", ["maximum", "minimum"])
def test_extremum_dense(opt):
    want, got = _mk(seed=7)
    wb, _ = _mk(seed=8)
    bd = _dense(wb)
    g = getattr(got, opt)(bd)
    assert isinstance(g, torch.Tensor)
    assert_bitwise(g, np.asarray(getattr(want, opt)(bd)))


@pytest.mark.parametrize("opt,s", [("maximum", 0.5), ("maximum", -0.5),
                                   ("minimum", 0.5), ("minimum", -0.5),
                                   ("maximum", 0.0), ("minimum", 0.0)])
def test_extremum_scalar(opt, s):
    want, got = _mk(seed=9)
    g, w = getattr(got, opt)(s), getattr(want, opt)(s)
    densifies = (opt == "maximum" and s > 0) or (opt == "minimum" and s < 0)
    assert pt.issparse(g) != densifies
    if densifies:
        assert_bitwise(g, np.asarray(w))
    else:
        assert_same(g, w)


@pytest.mark.parametrize("opt", ["maximum", "minimum"])
def test_extremum_ng_shape(opt):
    _, a = _mk()
    for shape in [(9, 12), (11, 12), (10, 11), (10, 13)]:
        _, b = _mk(shape=shape, seed=10)
        with pytest.raises(ValueError):
            getattr(a, opt)(b)


_OPS = ["eq", "ne", "lt", "gt", "le", "ge"]


def _cmp(a, b, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return getattr(operator, name)(a, b)


def _assert_cmp_same(g, w):
    if pt.issparse(g):
        assert_same(g, w)
    else:
        assert_bitwise(g, np.asarray(w))


@pytest.mark.parametrize("name", _OPS)
@pytest.mark.parametrize("rhs", ["sparse", "dense", "row"])
def test_compare(name, rhs):
    want, got = _mk(seed=11)
    shape = (1, 12) if rhs == "row" else (10, 12)
    wb, gb = _mk(shape=shape, d=0.5, seed=12)
    if rhs == "dense":
        wb = gb = _dense(wb)
    g, w = _cmp(got, gb, name), _cmp(want, wb, name)
    _assert_cmp_same(g, w)
    np.testing.assert_array_equal(
        _dense(g), getattr(operator, name)(_dense(want), _dense(wb)))


@pytest.mark.parametrize("name", _OPS)
@pytest.mark.parametrize("s", [0.5, -0.5, 0.0, np.nan])
def test_compare_scalar(name, s):
    want, got = _mk(seed=15)
    _assert_cmp_same(_cmp(got, s, name), _cmp(want, s, name))


def test_compare_sparse_result_type():
    """Zero-false comparisons of two sparse matrices stay sparse; the
    inefficient (zero-true) ones warn."""
    _, a = _mk(seed=19)
    _, b = _mk(seed=20)
    assert pt.issparse(a < b)
    with pytest.warns(UserWarning):
        _ = a >= b


def test_compare_ng_shape_and_none():
    _, a = _mk()
    _, b = _mk(shape=(9, 11), seed=21)
    for name in _OPS:
        with pytest.raises(ValueError):
            _cmp(a, b, name)
    assert (a == None) is False  # noqa: E711
    assert (a != None) is True  # noqa: E711
    assert hash(a) == hash(a)


# ------------------------------------------------------------ constructors


def test_random_formats_and_semantics():
    for fmt, cls in [("coo", pt.COO), ("csr", pt.CSR), ("csc", pt.CSC),
                     ("bsr", pt.BSR), ("dia", pt.DIA)]:
        a = pt.random(16, 24, density=0.1, format=fmt, seed=0, device="cpu")
        assert isinstance(a, cls) and a.shape == (16, 24)
    a = pt.rand(50, 40, 0.3, seed=3, device="cpu")
    assert a.format == "coo" and a.nnz == int(0.3 * 50 * 40)
    pos = set(zip(a.row.tolist(), a.col.tolist()))
    assert len(pos) == a.nnz
    with pytest.raises(ValueError):
        pt.random(8, 8, density=1.5, device="cpu")


@pytest.mark.parametrize("k", [-2, 0, 3])
@pytest.mark.parametrize("fmt", ["dia", "csr", "coo"])
def test_eye(k, fmt):
    got = pt.eye(6, 8, k=k, format=fmt, device="cpu")
    assert_same(got, st.eye(6, 8, k=k, format=fmt))
    np.testing.assert_array_equal(_dense(got), sp.eye(6, 8, k=k).toarray())


def test_identity():
    assert_same(pt.identity(5, format="csr", device="cpu"),
                st.identity(5, format="csr"))
    np.testing.assert_array_equal(_dense(pt.identity(5, device="cpu")),
                                  np.eye(5))


def test_spdiags():
    data = np.array([[1, 2, 3, 4.0], [5, 6, 7, 8.0]], np.float32)
    for fmt in ("csr", "dia"):
        got = pt.spdiags(data, [0, -1], 4, 4, format=fmt, device="cpu")
        assert_same(got, st.spdiags(data, [0, -1], 4, 4, format=fmt))
        np.testing.assert_array_equal(
            _dense(got), sp.spdiags(data, [0, -1], 4, 4).toarray())
    # a row shorter than a diagonal reads its last value, as JAX's gather
    assert_same(pt.spdiags(data[:, :2], [0], 4, 4, format="csr",
                           device="cpu"),
                st.spdiags(data[:, :2], [0], 4, 4, format="csr"))


def test_diags():
    d = [np.array([1.0, 2, 3], np.float32), np.array([4.0, 5], np.float32)]
    got = pt.diags(d, [0, 1], format="csr", device="cpu")
    assert_same(got, st.diags(d, [0, 1], format="csr"))
    np.testing.assert_array_equal(
        _dense(got), sp.diags([[1, 2, 3], [4, 5]], [0, 1]).toarray())
    got = pt.diags(np.float32(2.5), 1, shape=(4, 4), format="csr",
                   device="cpu")
    assert_same(got, st.diags(np.float32(2.5), 1, shape=(4, 4),
                              format="csr"))


def test_bmat_hstack_vstack():
    wa, ga = sparse_pair(4, 5, 0.4, 0)
    wb, gb = sparse_pair(4, 3, 0.4, 1)
    assert_same(pt.bmat([[ga, gb]], format="csr"),
                st.bmat([[wa, wb]], format="csr"))
    assert_same(pt.bmat([[ga, None], [None, ga]], format="csr"),
                st.bmat([[wa, None], [None, wa]], format="csr"))
    assert_same(pt.hstack([ga, gb]), st.hstack([wa, wb]))
    assert_same(pt.vstack([ga, ga], format="csc"),
                st.vstack([wa, wa], format="csc"))
    np.testing.assert_array_equal(
        _dense(pt.bmat([[ga, None], [None, ga]])),
        sp.bmat([[wa.to_scipy(), None], [None, wa.to_scipy()]]).toarray())
    with pytest.raises(ValueError):
        pt.bmat([[ga, None], [None, None]])


# ------------------------------------------ kron, find, tril/triu and DIA


@pytest.fixture
def ab():
    wa, ga = sparse_pair(7, 5, 0.4, 1)
    wb, gb = sparse_pair(4, 6, 0.5, 2, "coo")
    return wa, ga, wb, gb


@pytest.mark.parametrize("format", [None, "csr", "coo", "csc"])
def test_kron_vs_jax(ab, format):
    wa, ga, wb, gb = ab
    K = kron(ga, gb, format=format)
    assert K.shape == (28, 30)
    assert_same(K, jkron(wa, wb, format=format))
    np.testing.assert_array_equal(
        _dense(K), sp.kron(wa.to_scipy(), wb.to_scipy()).toarray())


def test_kron_empty_and_dense_operand(ab):
    wa, ga, wb, gb = ab
    z = pt.random(3, 3, 0.0, format="csr", device="cpu")
    K = kron(ga, z)
    assert K.shape == (21, 15) and K.nnz == 0
    dense = ga.toarray()
    assert_same(kron(dense, gb), jkron(dense.numpy(), wb))


def test_kronsum_vs_jax():
    wa, ga = sparse_pair(5, 5, 0.4, 3)
    wb, gb = sparse_pair(4, 4, 0.4, 4)
    assert_same(kronsum(ga, gb), jkronsum(wa, wb))
    np.testing.assert_allclose(
        _dense(kronsum(ga, gb)),
        sp.kronsum(wa.to_scipy(), wb.to_scipy()).toarray(), rtol=1e-6)
    with pytest.raises(ValueError, match="square"):
        kronsum(pt.random(3, 4, 0.5, device="cpu"), gb)


def test_find_vs_jax(ab):
    wa, ga, _, _ = ab
    for g, w in zip(find(ga), jfind(wa)):
        assert_bitwise(g, np.asarray(w))
    # explicit zeros dropped
    z = pt.CSR.from_parts([0, 2], [0, 1], np.array([0.0, 3.0], np.float32),
                          (1, 4), canonical=True, device="cpu")
    assert find(z)[1].tolist() == [1]


@pytest.mark.parametrize("k", [-3, -1, 0, 1, 2])
def test_tril_triu_vs_jax(ab, k):
    wa, ga, _, _ = ab
    assert_same(tril(ga, k), jtril(wa, k))
    assert_same(triu(ga, k), jtriu(wa, k))
    assert_same(tril(ga, k, format="csr"), jtril(wa, k, format="csr"))
    np.testing.assert_array_equal(_dense(triu(ga, k)),
                                  sp.triu(wa.to_scipy(), k).toarray())


def test_dia_roundtrip_vs_jax(ab):
    wa, ga, _, _ = ab
    D, W = ga.todia(), wa.todia()
    assert D.format == "dia"
    assert_same(D, W)
    assert_bitwise(D.offsets, np.asarray(W.offsets))
    assert D.nnz == W.nnz == wa.to_scipy().todia().nnz
    assert_bitwise(D.toarray(), np.asarray(W.toarray()))
    assert_same(D.tocoo(), W.tocoo())
    assert_same(D.tocsr(), W.tocsr())
    assert_same(D.T, W.T)
    for k in (-2, 0, 1, 9):
        assert_bitwise(D.diagonal(k), np.asarray(W.diagonal(k)))


def test_dia_constructor_and_ops():
    data = np.arange(10, dtype=np.float32).reshape(2, 5)
    dd = DIA((data, [0, -1]), shape=(5, 5), device="cpu")
    assert_same(dd, JDIA((data, [0, -1]), shape=(5, 5)))
    ref = sp.dia_matrix((data, [0, -1]), shape=(5, 5))
    np.testing.assert_array_equal(_dense(dd), ref.toarray())
    assert dd.nnz == ref.nnz
    x = np.linspace(0, 1, 5).astype(np.float32)
    np.testing.assert_allclose((dd @ x).numpy(), ref @ x, rtol=1e-6)
    assert_same(dd * 2.0, JDIA((data, [0, -1]), shape=(5, 5)) * 2.0)
    np.testing.assert_array_equal(dd.diagonal(-1).numpy(),
                                  ref.toarray().diagonal(-1))
    with pytest.raises(ValueError, match="duplicate"):
        DIA((data, [0, 0]), shape=(5, 5), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        DIA((data, [0, 1]), device="cpu")


def test_dia_default_constructors():
    e = pt.eye(6, k=1, device="cpu")
    assert e.format == "dia"
    assert_same(e, st.eye(6, k=1))
    d = pt.diags([np.arange(1, 5, dtype=np.float32)], [1], shape=(5, 5),
                 device="cpu")
    assert_same(d, st.diags([np.arange(1, 5, dtype=np.float32)], [1],
                            shape=(5, 5)))
    s = pt.spdiags(np.ones((2, 4), np.float32), [0, 1], 4, 4, device="cpu")
    assert_same(s, st.spdiags(np.ones((2, 4), np.float32), [0, 1], 4, 4))


def test_scipy_aliases():
    from spmm_tpu_torch import sparse

    for name, cls in (("coo", pt.COO), ("csr", pt.CSR), ("csc", pt.CSC),
                      ("bsr", pt.BSR), ("dia", pt.DIA)):
        assert getattr(sparse, f"{name}_matrix") is cls
    a = pt.random(6, 5, 0.3, seed=0, device="cpu")
    assert sparse.isspmatrix_coo(a) and sparse.isspmatrix_csr(a.tocsr())
    assert sparse.isspmatrix_csc(a.tocsc()) and sparse.isspmatrix_dia(
        a.todia())
    assert sparse.isspmatrix(a) and not sparse.isspmatrix(a.toarray())


def test_from_reference_every_format():
    row, col, data = coo_arrays(30, 40, 0.2, 9)
    ref = st.COO((data, (row, col)), shape=(30, 40))
    for fmt in ("coo", "csr", "csc", "bsr", "dia"):
        w = ref.asformat(fmt)
        g = pt.from_reference(w, device="cpu")
        assert g.format == fmt
        assert_bitwise(g.toarray(), np.asarray(w.toarray()))


def test_constructors_default_to_the_card(monkeypatch):
    """Every format's constructors place host data on the card unless asked
    for the CPU, and raise where there is none (no fallback); tensors keep
    their own device."""
    from spmm_tpu_torch.models import banded, block_sparse, uniform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dense = np.eye(6, 8, dtype=np.float32)
    row, col = np.array([0, 1]), np.array([1, 2])
    data = np.array([1.0, 2.0], np.float32)
    builders = [
        lambda **kw: pt.COO((data, (row, col)), shape=(4, 4), **kw),
        lambda **kw: pt.COO(dense, **kw), lambda **kw: pt.CSC(dense, **kw),
        lambda **kw: pt.CSR((3, 3), **kw),
        lambda **kw: pt.BSR((np.ones((1, 2, 2), np.float32), [0], [0, 1]),
                            shape=(2, 2), **kw),
        lambda **kw: pt.DIA((dense[:2], [0, 1]), shape=(6, 8), **kw),
        lambda **kw: pt.eye(5, **kw), lambda **kw: pt.diags([data], [1], **kw),
        lambda **kw: pt.random(9, 9, 0.2, format="bsr", **kw),
        lambda **kw: block_sparse(16, 16, (4, 4), 0.3, **kw),
        lambda **kw: banded(8, 8, 1, **kw), lambda **kw: uniform(8, 8, 0.3,
                                                                 **kw)]
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        assert build(device="cpu").device == torch.device("cpu")
    assert pt.COO((torch.from_numpy(data), (row, col)),
                  shape=(4, 4)).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.random(9, 9, 0.2, device="cpu").to("cuda")

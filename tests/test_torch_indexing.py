"""CSR indexing and assignment of the PyTorch port against the JAX package.

Twins of tests/test_indexing.py (all 32 test functions), of
test_container_basics.py's row iteration and out-of-range checks, and of
test_extrema_compare.py's setdiag / getcol tests.  Every matrix is made
once from a seed with numpy and handed as the same host arrays to both
packages (the port on the CPU); every result is held bitwise against
JAX's: structure, values and the canonical flag of a sparse result, the
bits of a dense one.  Keys and assigned values are the JAX tests'.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import spmm_tpu as st  # noqa: E402
import spmm_tpu_torch as pt  # noqa: E402
from spmm_tpu.sparse.dia import DIA  # noqa: E402
from torch_port_helpers import (assert_bitwise, assert_same,  # noqa: E402
                                sparse_pair, unsorted_pair)


@pytest.fixture
def pair():
    return sparse_pair(30, 40, 0.2, 0)


def _pair(m=20, n=16, d=0.3, seed=5):
    return sparse_pair(m, n, d, seed)


def same(got, want):
    """A port result against JAX's: a sparse matrix by `assert_same`, a
    dense one bit for bit."""
    if st.issparse(want):
        assert_same(got, want)
    else:
        assert isinstance(got, torch.Tensor)
        assert_bitwise(got, np.asarray(want))


def same_key(ref, got, key):
    same(got[key], ref[key])


def test_single_row(pair):
    for i in (3, -1):
        same_key(*pair, i)


def test_row_slice(pair):
    ref, got = pair
    same_key(ref, got, slice(5, 12))
    same_key(ref, got, slice(4, 4))
    assert got[4:4].shape == (0, 40)


def test_element(pair):
    for key in ((0, 0), (3, 7), (29, 39)):
        same_key(*pair, key)


def test_col_slice(pair):
    same_key(*pair, (slice(None), slice(10, 25)))


def test_row_array(pair):
    same_key(*pair, np.array([2, 17, 2, 29]))


def test_row_then_colslice(pair):
    same_key(*pair, (4, slice(3, 17)))


def test_data_ops(pair):
    ref, got = pair
    ref_b, got_b = ref - ref * 2.0, got - got * 2.0
    same(abs(got_b), abs(ref_b))
    same(got.power(2), ref.power(2))
    # XLA's float32 sqrt on the CPU is not correctly rounded (1 ulp off
    # torch's at a few entries): held at the JAX test's own rtol 1e-6
    assert_same(got.sqrt(), ref.sqrt(), rtol=1e-6)
    same(got_b.sign(), ref_b.sign())
    assert got.count_nonzero() == ref.count_nonzero()
    for mat in (ref, got):
        with pytest.raises(ValueError):
            mat.maximum_scalar(1.0)


def test_boolean_row_mask():
    mask = np.zeros(20, bool)
    mask[[1, 4, 7, 15]] = True
    same_key(*_pair(), mask)


def test_strided_row_slice():
    ref, got = _pair()
    for sl in (slice(None, None, 2), slice(1, 18, 3), slice(None, None, -1)):
        same_key(ref, got, sl)


def test_column_array_indexing():
    same_key(*_pair(), (slice(None), np.array([3, 0, 3, 9])))


def test_strided_column_slice():
    same_key(*_pair(), (slice(None), slice(None, None, 2)))


def test_row_col_pair_indexing():
    rows = np.array([0, 3, 7, 19, 3])
    cols = np.array([5, 2, 0, 15, 2])
    same_key(*_pair(), (rows, cols))


def _assign(ref, got, key, ref_value, got_value=None):
    """The same assignment on both matrices, then the whole matrices held
    bitwise."""
    ref[key] = ref_value
    got[key] = ref_value if got_value is None else got_value
    assert_same(got, ref)


def test_setitem_scalar():
    ref, got = _pair()
    _assign(ref, got, (2, 3), 7.5)
    _assign(ref, got, (0, 0), -1.0)
    assert got.has_canonical_format


def test_setitem_unsupported_raises():
    for mat in _pair():
        with pytest.raises(NotImplementedError):
            mat["bad key"] = 1.0


def test_setitem_pairs_array():
    """Explicit zeros stored, the last of duplicate positions wins."""
    ref, got = _pair()
    rows = np.array([1, 3, 3, 7])
    cols = np.array([2, 5, 5, 0])
    vals = np.array([9.0, 1.0, 4.0, 0.0], np.float32)
    _assign(ref, got, (rows, cols), vals)
    assert float(got[7, 0]) == 0.0 and float(got[3, 5]) == 4.0


def test_setitem_pairs_scalar_broadcast():
    _assign(*_pair(), (np.array([0, 2, 4]), np.array([1, 1, 1])), 5.0)


def test_setitem_sparse_row_block():
    ref, got = _pair()
    b_ref, b_got = sparse_pair(2, 16, 0.3, 9)
    _assign(ref, got, np.array([1, 6]), b_ref, b_got)


def test_setitem_dense_row():
    ref, got = _pair()
    v = np.linspace(0, 1, 16).astype(np.float32)
    _assign(ref, got, 4, v)
    assert got.nnz == ref.nnz  # every position of the row stored


def test_setitem_row_slice_sparse():
    ref, got = _pair()
    b_ref, b_got = sparse_pair(3, 16, 0.25, 11)
    _assign(ref, got, slice(2, 5), b_ref, b_got)


def test_getitem_ix_mesh():
    rows = np.array([2, 0, 7, 7])
    cols = np.array([1, 5, 3])
    same_key(*_pair(), np.ix_(rows, cols))


def test_getitem_broadcast_mesh():
    rows = np.array([1, 4, 9])
    cols = np.array([0, 2, 5, 11])
    same_key(*_pair(), (rows[:, None], cols[None, :]))


def test_getitem_slice_x_array():
    same_key(*_pair(), (slice(2, 9), np.array([3, 0, 9, 3])))


def test_getitem_array_x_slice_step():
    same_key(*_pair(), (np.array([0, 5, 5, 13]), slice(1, 14, 3)))


def test_getitem_slice_x_slice():
    same_key(*_pair(), (slice(3, 15, 2), slice(2, 12, 3)))


def test_getitem_array_x_int_pairs():
    same_key(*_pair(), (np.array([0, 4, 9]), 3))


def test_setitem_submatrix_dense():
    vals = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
    _assign(*_pair(), (slice(1, 3), slice(4, 7)), vals)


def test_setitem_submatrix_sparse():
    """The block's old entries stay as explicit zeros, B's overlay."""
    ref, got = _pair()
    b_ref, b_got = sparse_pair(4, 5, 0.4, 21)
    _assign(ref, got, (slice(2, 6), slice(3, 8)), b_ref, b_got)


def test_setitem_submatrix_rows_array_cols_step():
    _assign(*_pair(), (np.array([0, 3, 11]), slice(2, 14, 4)), 7.0)


def test_setitem_ix_mesh_dense():
    vals = np.linspace(1, 6, 6, dtype=np.float32).reshape(2, 3)
    _assign(*_pair(), np.ix_(np.array([1, 8]), np.array([0, 5, 9])), vals)


def test_setitem_ix_mesh_sparse():
    ref, got = _pair()
    b_ref, b_got = sparse_pair(3, 2, 0.6, 33)
    _assign(ref, got, np.ix_(np.array([2, 7, 12]), np.array([1, 4])), b_ref,
            b_got)


def test_setitem_col_range_sparse():
    ref, got = _pair()
    b_ref, b_got = sparse_pair(20, 3, 0.3, 44)
    _assign(ref, got, (slice(None), slice(5, 8)), b_ref, b_got)


def test_getcols_array_large_fast():
    """A 1M-entry column select within JAX's time bound, bitwise JAX's."""
    ref, got = sparse_pair(4000, 4000, 0.0625, 3)
    assert got.nnz >= 900_000
    ref, got = ref.sum_duplicates(), got.sum_duplicates()
    cols = np.arange(0, 4000, 7)
    t0 = time.time()
    out = got[:, cols]
    dt = time.time() - t0
    assert dt < 8.0, f"column select took {dt:.2f}s"
    same(out, ref[:, cols])


# -- container basics (test_container_basics.py) ----------------------------


def _mat3():
    dense = np.array([[1., 0, 2], [0, 3, 0], [4, 0, 5]], np.float32)
    return st.CSR(dense), pt.CSR(dense, device="cpu")


def test_iter_rows():
    ref, got = _mat3()
    rows = list(got)
    assert len(rows) == 3
    for r, w in zip(rows, ref):
        same(r, w)


def test_iter_rows_coo():
    ref, got = _mat3()
    rows = list(got.tocoo())
    assert len(rows) == 3
    for r, w in zip(rows, ref.tocoo()):
        same(r, w)


def test_getitem_out_of_range():
    ref, got = _mat3()
    for key in (3, -4, (0, 3), [0, 5]):
        for mat in (ref, got):
            with pytest.raises(IndexError):
                mat[key]
    same(got[-1], ref[-1])


# -- setdiag / getcol (test_extrema_compare.py) -----------------------------


def test_setdiag_grid():
    """Every k in (-m, n), diagonal lengths d - 1, d and d + 1, on copies of
    one matrix, which keeps its own values."""
    m, n = 8, 5
    ref0, got0 = sparse_pair(m, n, 0.5, 22)
    before = got0.data.clone()
    for k in range(-m + 1, n):
        m_st, n_st = max(0, -k), max(0, k)
        for d in (-1, 0, 1):
            x_len = min(m - m_st, n - n_st) + d
            if x_len <= 0:
                continue
            x = np.linspace(1, 2, x_len).astype(np.float32)
            ref, got = ref0.copy(), got0.copy()
            ref.setdiag(x, k=k)
            got.setdiag(x, k=k)
            assert_same(got, ref)
    assert_bitwise(got0.data, before)


def test_setdiag_scalar():
    ref, got = sparse_pair(5, 8, 0.4, 23)
    for k in (-2, 0, 3):
        ref.setdiag(1.5, k=k)
        got.setdiag(1.5, k=k)
        assert_same(got, ref)


def test_setdiag_invalid():
    m, n = 6, 4
    for mat in sparse_pair(m, n, 0.4, 24):
        for k in (-m, n):
            with pytest.raises(ValueError):
                mat.setdiag(1.0, k=k)


def test_getcol():
    ref, got = sparse_pair(10, 12, 0.35, 7)
    ref, got = ref - ref.power(2), got - got.power(2)  # mixed signs
    for j in range(12):
        col = got.getcol(j)
        assert col.shape == (10, 1)
        same(col, ref.getcol(j))


# -- beyond the JAX tests ---------------------------------------------------


@pytest.mark.parametrize("key", [
    3, slice(2, 9), slice(None, None, -3), np.array([5, 0, 5, 39]),
    (4, 7), (slice(None), slice(3, 30)), (slice(None), np.array([8, 1, 8])),
    (np.array([1, 2, 38]), np.array([0, 5, 5])),
    np.ix_(np.array([3, 1]), np.array([2, 0, 7])),
], ids=["row", "slice", "stride -3", "rows", "element", "cols",
        "col array", "pairs", "mesh"])
def test_getitem_unsorted_duplicates(key):
    """A CSR out of column order with duplicate entries: the forms that
    keep the stored order keep it, and the flag, as JAX's."""
    ref, got = unsorted_pair(40, 41, 0.15, seed=6)
    same(got[key], ref[key])


def test_getitem_tensor_keys(pair):
    """A tensor key reads as the numpy key of the same values."""
    ref, got = pair
    rows = np.array([2, 17, 2, 29])
    same(got[torch.from_numpy(rows)], ref[rows])
    mask = np.arange(30) % 4 == 1
    same(got[torch.from_numpy(mask)], ref[mask])


def test_setitem_keeps_views_and_copies():
    """Assignment swaps in new tensors: a copy, a row slice (views of the
    old tensors) and the old tensors themselves keep their values."""
    _, got = _pair()
    copy, row, data = got.copy(), got[2], got.data
    want_copy, want_row, want_data = (copy.toarray().clone(),
                                      row.toarray().clone(), data.clone())
    got[2] = np.arange(16, dtype=np.float32)
    got[np.array([0, 19]), np.array([1, 1])] = -3.0
    assert_bitwise(copy.toarray(), want_copy)
    assert_bitwise(row.toarray(), want_row)
    assert_bitwise(data, want_data)
    assert got.data is not data


def test_dia_from_parts_host_arrays():
    """`DIA.from_parts` of numpy data: on the CPU when asked, converted as
    `jnp.asarray` converts it, bitwise JAX's `toarray()`."""
    rng = np.random.default_rng(12)
    data = rng.standard_normal((3, 9))  # float64: float32, as x64 off
    offsets, shape = [-2, 0, 3], (8, 9)
    got = pt.DIA.from_parts(data, offsets, shape, device="cpu")
    ref = DIA.from_parts(data, offsets, shape)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert_bitwise(got.toarray(), np.asarray(ref.toarray()))
    assert_bitwise(got.tocsr().data, np.asarray(ref.tocsr().data))
    t = torch.from_numpy(data.astype(np.float32))
    kept = pt.DIA.from_parts(t, offsets, shape)
    assert kept.data.data_ptr() == t.data_ptr()  # a tensor stays, no copy
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.DIA.from_parts(data, offsets, shape)

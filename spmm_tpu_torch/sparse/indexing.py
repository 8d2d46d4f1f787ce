"""CSR indexing: element access, slicing, row and column selection, masks,
and assignment.

Port of `spmm_tpu/sparse/indexing.py`, function for function, with scipy's
index rules: `A[i]`, `A[i:j]`, `A[i:j:s]`, `A[i, j]`, `A[:, j0:j1]`,
`A[:, cols]`, `A[rows]`, `A[bool_mask]`, `A[rows, cols]` pair extraction,
2-D fancy meshes (`A[np.ix_(rows, cols)]`), general outer indexing, and
assignment of scalars, pairs, rows and submatrices.

The keys are checked and normalised on the host with numpy, as in JAX.  The
selection itself runs with torch ops on the matrix's own device
(`searchsorted`, `repeat_interleave`, stable sorts, boolean compaction)
where JAX runs it on the host with numpy; no Python loop runs over rows or
columns, and a result's size is read to the host where JAX sizes it on the
host too.  Every result is bitwise JAX's: structure, values and the
canonical flag (forms that JAX builds through `COO(...).tocsr()` go
through the port's COO, so a stored -0.0 becomes +0.0 there as in JAX).

Assignment works in place, as scipy's and JAX's: the container's tensors
are rebuilt and swapped, never written into, so a copy, a view or a plan
that holds the old tensors keeps the old values.  Assigned positions store
their value, explicit zeros included; of duplicate assigned positions the
last wins.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim

INDEX_DTYPE = prim.INDEX_DTYPE
_ARRAY_KEYS = (list, np.ndarray, torch.Tensor)


def _host_key(key) -> np.ndarray:
    """An index key as a host numpy array (a tensor is read back)."""
    if isinstance(key, torch.Tensor):
        return key.detach().cpu().numpy()
    return np.asarray(key)


def _long(x, device) -> torch.Tensor:
    """Host indices as an int64 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _values(x, dtype, device) -> torch.Tensor:
    """Values to assign as a tensor of the matrix's dtype on its device (a
    host array through numpy, as JAX's `np.asarray(vals, dtype)`)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _csr(indptr, indices, data, shape, canonical):
    from spmm_tpu_torch.sparse.csr import CSR

    return CSR._wrap(indptr, indices, data, shape, canonical=canonical)


def _coo_to_csr(row, col, data, shape):
    """JAX's `COO((data, (row, col)), shape=shape).tocsr()`: an unflagged
    COO, canonicalised by the port's COO (bitwise JAX's)."""
    from spmm_tpu_torch.sparse.coo import COO

    return COO._wrap(row.to(INDEX_DTYPE), col.to(INDEX_DTYPE), data, shape,
                     canonical=False).tocsr()


def _getrow_slice(a, start: int, stop: int):
    """Contiguous row slice A[start:stop]: one host read of its two entry
    bounds, then views of the entries."""
    e0, e1 = a.indptr[[start, stop]].tolist()
    indptr = a.indptr[start:stop + 1] - e0
    return _csr(indptr, a.indices[e0:e1], a.data[e0:e1],
                (stop - start, a.shape[1]), a.has_canonical_format)


def _getitem_element(a, i: int, j: int) -> torch.Tensor:
    """A[i, j] as a 0-d tensor: the sum of the matching entries of row i."""
    s, e = a.indptr[[i, i + 1]].tolist()
    seg_idx = a.indices[s:e]
    seg_dat = a.data[s:e]
    return torch.where(seg_idx == j, seg_dat,
                       torch.zeros((), dtype=seg_dat.dtype,
                                   device=seg_dat.device)).sum()


def _getrows_array(a, rows):
    """A[rows] for an integer array: whole rows gathered in the given order
    (duplicates allowed); one host read of the output's size."""
    dev = a.device
    rows = _long(rows, dev)
    ip = a.indptr.long()
    starts = ip[rows]
    lens = ip[rows + 1] - starts
    out_indptr = torch.zeros(rows.numel() + 1, dtype=INDEX_DTYPE,
                             device=dev)
    out_indptr[1:] = torch.cumsum(lens, 0)
    nnz_out = int(out_indptr[-1])
    shape = (rows.numel(), a.shape[1])
    if nnz_out == 0:
        return _csr(out_indptr, torch.zeros(0, dtype=INDEX_DTYPE, device=dev),
                    torch.zeros(0, dtype=a.dtype, device=dev), shape, True)
    # entry t of output row r reads a's entry starts[r] + (t - out_start[r])
    shift = torch.repeat_interleave(starts - out_indptr[:-1].long(), lens,
                                    output_size=nnz_out)
    src = torch.arange(nnz_out, device=dev) + shift
    return _csr(out_indptr, a.indices[src], a.data[src], shape,
                a.has_canonical_format)


def _getcols_slice(a, j0: int, j1: int):
    """A[:, j0:j1]: the entries with a column in [j0, j1), in stored order
    (one host read, the compaction's size)."""
    keep = (a.indices >= j0) & (a.indices < j1)
    pos = torch.nonzero(keep).squeeze(1)
    indptr = prim.build_indptr(a.rows[pos], a.shape[0])
    return _csr(indptr, a.indices[pos] - j0, a.data[pos],
                (a.shape[0], j1 - j0), a.has_canonical_format)


def _getcols_array(a, cols):
    """A[:, cols] for an integer array (duplicates allowed, any order), the
    column counterpart of `_getrows_array`: each entry of the canonical
    form expands to its matches among the requested columns, found by two
    searchsorteds into the sorted request (no loop over columns)."""
    a = a.sum_duplicates()
    dev = a.device
    cols = _long(cols, dev)
    order = torch.sort(cols, stable=True).indices
    sc = cols[order]
    ix = a.indices.long()
    lo = torch.searchsorted(sc, ix)
    cnt = torch.searchsorted(sc, ix, right=True) - lo  # matches an entry
    total = int(cnt.sum())
    src = torch.repeat_interleave(torch.arange(ix.numel(), device=dev), cnt,
                                  output_size=total)
    heads = torch.cumsum(cnt, 0) - cnt
    ofs = torch.arange(total, device=dev) - torch.repeat_interleave(
        heads, cnt, output_size=total)
    out_cols = order[lo[src] + ofs]  # output column = request position
    return _coo_to_csr(a.rows[src], out_cols, a.data[src],
                       (a.shape[0], cols.numel()))


def _lookup_pairs(a, rows, cols):
    """Values at flat (row, col) positions against the canonical entry
    keys: (values, hit mask), one searchsorted over row*n+col keys."""
    a = a.sum_duplicates()
    dev = a.device
    n = a.shape[1]
    ekeys = a.rows.long() * n + a.indices.long()  # ascending (canonical)
    pkeys = _long(rows, dev) * n + _long(cols, dev)
    if ekeys.numel() == 0:
        return (torch.zeros(pkeys.shape, dtype=a.dtype, device=dev),
                torch.zeros(pkeys.shape, dtype=torch.bool, device=dev))
    posc = torch.searchsorted(ekeys, pkeys).clamp_(max=ekeys.numel() - 1)
    hit = ekeys[posc] == pkeys
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    return torch.where(hit, a.data[posc], zero), hit


def _get_mesh(a, ri, cj):
    """2-D fancy mesh `A[ri, cj]` with broadcastable index arrays (e.g.
    `A[np.ix_(rows, cols)]`): a sparse matrix of the broadcast shape, with
    the stored entries found (explicit zeros kept) in row-major order."""
    ri, cj = np.broadcast_arrays(np.asarray(ri, np.int64),
                                 np.asarray(cj, np.int64))
    shape = ri.shape
    vals, hit = _lookup_pairs(a, ri.ravel(), cj.ravel())
    flat = torch.nonzero(hit).squeeze(1)
    return _coo_to_csr(flat // shape[1], flat % shape[1], vals[flat], shape)


def _get_pairs(a, rows, cols) -> torch.Tensor:
    """A[rows, cols] pair extraction: a dense (1, N) tensor (scipy's matrix
    semantics for paired fancy indexing)."""
    rows = np.asarray(rows, np.int64).ravel()
    cols = np.asarray(cols, np.int64).ravel()
    if rows.shape != cols.shape:
        raise IndexError("row and column index arrays must match in length")
    out, _ = _lookup_pairs(a, rows, cols)
    return out[None, :]


def check_int(i, extent: int, what: str) -> int:
    """A scalar index as scipy takes it: truncated as `int()` does, negative
    counted from the end; IndexError outside [-extent, extent) (also what
    ends `for row in A` under the legacy sequence protocol)."""
    i = int(i)
    if not -extent <= i < extent:
        raise IndexError(f"{what} index {i} out of range (extent {extent})")
    return i % extent


def _check_arr(arr, extent: int, what: str) -> np.ndarray:
    """An integer index array, bounds-checked, as non-negative int64."""
    arr = np.asarray(arr)
    if arr.size and (arr.min() < -extent or arr.max() >= extent):
        raise IndexError(f"{what} index out of range (extent {extent})")
    return arr.astype(np.int64) % extent


def _normalize_rows_key(a, key):
    """slice / int array / bool mask -> (explicit row index array, None), or
    (None, (start, stop)) where the key selects rows contiguously."""
    m = a.shape[0]
    if isinstance(key, slice):
        start, stop, step = key.indices(m)
        if step == 1:
            return None, (start, stop)
        return np.arange(start, stop, step, dtype=np.int64), None
    arr = _host_key(key)
    if arr.dtype == np.bool_:
        if arr.shape[0] != m:
            raise IndexError(f"boolean row mask length {arr.shape[0]} != "
                             f"rows {m}")
        return np.nonzero(arr)[0], None
    return _check_arr(arr, m, 'row'), None


def _as_indices(key) -> np.ndarray:
    """An array key as host indices, a boolean mask as its set positions."""
    arr = _host_key(key)
    return np.nonzero(arr)[0] if arr.dtype == np.bool_ else arr


def csr_getitem(a, key):
    """`a[key]` by scipy's rules (module docstring)."""
    m, n = a.shape
    if isinstance(key, tuple) and len(key) == 2:
        ik, jk = key
        int_i = isinstance(ik, (int, np.integer))
        int_j = isinstance(jk, (int, np.integer))
        if int_i and int_j:
            return _getitem_element(a, check_int(ik, m, 'row'),
                                    check_int(jk, n, 'column'))
        arr_i = isinstance(ik, _ARRAY_KEYS)
        arr_j = isinstance(jk, _ARRAY_KEYS)
        if (arr_i or int_i) and (arr_j or int_j):
            # array-valued on both axes: broadcast pairs (1-D -> a (1, N)
            # vector) or a 2-D mesh (-> a sparse matrix of its shape)
            ri = _check_arr(_as_indices(ik), m, 'row')
            cj = _check_arr(_as_indices(jk), n, 'column')
            if ri.ndim > 1 or cj.ndim > 1:
                return _get_mesh(a, ri, cj)
            return _get_pairs(a, *np.broadcast_arrays(ri, cj))
        if isinstance(ik, slice) and ik == slice(None):
            if isinstance(jk, slice):
                j0, j1, step = jk.indices(n)
                if step == 1:
                    return _getcols_slice(a, j0, j1)
                return _getcols_array(a, np.arange(j0, j1, step))
            if int_j:
                j = check_int(jk, n, 'column')
                return _getcols_slice(a, j, j + 1)
            if arr_j:
                return _getcols_array(a, _check_arr(_as_indices(jk), n,
                                                    'column'))
        if int_i and isinstance(jk, slice):
            i = check_int(ik, m, 'row')
            row = _getrow_slice(a, i, i + 1)
            j0, j1, step = jk.indices(n)
            if step == 1:
                return _getcols_slice(row, j0, j1)
            return _getcols_array(row, np.arange(j0, j1, step))
        if (arr_i or isinstance(ik, slice)) and isinstance(jk, slice) \
                and jk == slice(None):
            return csr_getitem(a, ik)
        if (arr_i or isinstance(ik, slice)) and (
                arr_j or int_j or isinstance(jk, slice)):
            # general outer indexing: the rows, then the columns of those
            sub = csr_getitem(a, ik)
            return csr_getitem(sub, (slice(None), jk))
        raise NotImplementedError(f"unsupported index {key!r}")
    if isinstance(key, (int, np.integer)):
        i = check_int(key, m, 'row')
        return _getrow_slice(a, i, i + 1)
    if isinstance(key, slice):
        rows, contig = _normalize_rows_key(a, key)
        if contig is not None:
            start, stop = contig
            return _getrow_slice(a, start, max(stop, start))
        return _getrows_array(a, rows)
    if isinstance(key, _ARRAY_KEYS):
        rows, _ = _normalize_rows_key(a, key)
        return _getrows_array(a, rows)
    raise NotImplementedError(f"unsupported index {key!r}")


def _assign_entries(a, new_rows, new_cols, new_vals, clear_rows=None,
                    clear_cols=None):
    """The assignment merge, one stable sort: assigned positions take the
    new value (explicit zeros stored); with `clear_rows` (and optionally
    `clear_cols`) every stored entry of that region is set to an explicit 0
    first, so the pattern is the union; of duplicate assigned positions
    the last wins.  Swaps in the rebuilt tensors of `a`; returns `a`."""
    a2 = a.sum_duplicates()
    m, n = a2.shape
    dev = a2.device
    ix = a2.indices.long()
    erows = a2.rows.long()
    dv = a2.data
    if clear_rows is not None and erows.numel():
        cleared = torch.isin(erows, _long(clear_rows, dev))
        if clear_cols is not None:
            cleared &= torch.isin(ix, _long(clear_cols, dev))
        dv = torch.where(cleared, torch.zeros((), dtype=dv.dtype,
                                              device=dev), dv)
    nkeys = (_long(new_rows, dev) * n + _long(new_cols, dev)).reshape(-1)
    all_keys = torch.cat([erows * n + ix, nkeys])
    all_vals = torch.cat([dv, _values(new_vals, dv.dtype, dev).reshape(-1)])
    ks, order = torch.sort(all_keys, stable=True)
    last = torch.ones_like(ks, dtype=torch.bool)
    last[:-1] = ks[1:] != ks[:-1]
    sel = order[last]
    out_keys = ks[last]
    a._set(prim.build_indptr(out_keys // n, m),
           (out_keys % n).to(INDEX_DTYPE), all_vals[sel], (m, n), True)
    return a


def _set_rows(a, rows_sel, value):
    """Row-block assignment `A[rows] = B`, B sparse (its entries overlay,
    the rows' old entries become explicit zeros) or dense (every position
    of the rows stored, as scipy)."""
    from spmm_tpu_torch.sparse.base import issparse

    n = a.shape[1]
    dev = a.device
    rows_sel = _long(rows_sel, dev)
    R = rows_sel.numel()
    if issparse(value):
        if value.shape != (R, n):
            raise ValueError(f"shape mismatch: assigning {value.shape} into "
                             f"{(R, n)} rows")
        b = value.tocsr().sum_duplicates().to(dev)
        return _assign_entries(a, rows_sel[b.rows.long()], b.indices,
                               b.data, clear_rows=rows_sel)
    vals = torch.broadcast_to(_values(value, a.dtype, dev), (R, n))
    nr = torch.repeat_interleave(rows_sel, n)
    nc = torch.arange(n, device=dev).repeat(R)
    return _assign_entries(a, nr, nc, vals, clear_rows=rows_sel)


def _set_submatrix(a, rows_sel, cols_sel, value):
    """Submatrix assignment `A[rows, cols] = B` over an outer rows x cols
    selection, B sparse (the region's old entries become explicit zeros,
    B's entries overlay) or dense / scalar (every position stored)."""
    from spmm_tpu_torch.sparse.base import issparse

    dev = a.device
    rows_sel = _long(rows_sel, dev)
    cols_sel = _long(cols_sel, dev)
    R, C = rows_sel.numel(), cols_sel.numel()
    if issparse(value):
        if value.shape != (R, C):
            raise ValueError(
                f"shape mismatch: assigning {value.shape} into {(R, C)}")
        b = value.tocsr().sum_duplicates().to(dev)
        return _assign_entries(a, rows_sel[b.rows.long()],
                               cols_sel[b.indices.long()], b.data,
                               clear_rows=rows_sel, clear_cols=cols_sel)
    vals = torch.broadcast_to(_values(value, a.dtype, dev), (R, C))
    nr = torch.repeat_interleave(rows_sel, C)
    nc = cols_sel.repeat(R)
    return _assign_entries(a, nr, nc, vals)


def _normalize_axis_key(key, extent):
    """slice / int / int array / bool mask -> explicit host index array."""
    if isinstance(key, slice):
        start, stop, step = key.indices(extent)
        return np.arange(start, stop, step, dtype=np.int64)
    if isinstance(key, (int, np.integer)):
        return np.asarray([check_int(key, extent, 'axis')], np.int64)
    arr = _host_key(key)
    if arr.dtype == np.bool_:
        if arr.shape[0] != extent:
            raise IndexError(
                f"boolean mask length {arr.shape[0]} != extent {extent}")
        return np.nonzero(arr)[0]
    return _check_arr(arr, extent, 'axis').ravel()


def csr_setitem(a, key, value):
    """Assignment in place (the container's tensors rebuilt and swapped):

      * `A[i, j] = v`: one element;
      * `A[rows, cols] = v | vals`: paired positions (explicit zeros
        stored, the last duplicate wins), or a 2-D mesh;
      * `A[i] = B`, `A[rows] = B`, `A[i:j] = B`: rows, B sparse or dense;
      * `A[rows, cols] = B` over outer row and column keys: a submatrix.
    """
    from spmm_tpu_torch.sparse.base import issparse

    m, n = a.shape
    if isinstance(key, tuple) and len(key) == 2:
        ik, jk = key
        int_i = isinstance(ik, (int, np.integer))
        int_j = isinstance(jk, (int, np.integer))
        if int_i and int_j:
            return _assign_entries(a, [check_int(ik, m, 'row')],
                                   [check_int(jk, n, 'column')], [value])
        arr_i = isinstance(ik, _ARRAY_KEYS)
        arr_j = isinstance(jk, _ARRAY_KEYS)
        if (arr_i or int_i) and (arr_j or int_j):
            ri = _as_indices(ik).astype(np.int64)
            cj = _as_indices(jk).astype(np.int64)
            if ri.ndim > 1 or cj.ndim > 1:
                # 2-D mesh (np.ix_ / rows[:, None] form)
                ri2, cj2 = np.broadcast_arrays(_check_arr(ri, m, 'row'),
                                               _check_arr(cj, n, 'column'))
                if issparse(value):
                    rows_sel = ri2[:, 0]
                    cols_sel = cj2[0, :]
                    outer = (np.array_equal(
                        ri2, np.broadcast_to(rows_sel[:, None], ri2.shape))
                        and np.array_equal(
                            cj2, np.broadcast_to(cols_sel, cj2.shape)))
                    if outer:
                        return _set_submatrix(a, rows_sel, cols_sel, value)
                    value = value.toarray()
                vals = torch.broadcast_to(_values(value, a.dtype, a.device),
                                          ri2.shape)
                return _assign_entries(a, ri2.ravel(), cj2.ravel(), vals)
            ri = _check_arr(ri, m, 'row').ravel()
            cj = _check_arr(cj, n, 'column').ravel()
            ri, cj = np.broadcast_arrays(ri, cj)
            vals = _values(value, a.dtype, a.device)
            vals = torch.broadcast_to(vals.reshape(-1) if vals.dim()
                                      else vals, ri.shape)
            return _assign_entries(a, ri, cj, vals)
        if isinstance(jk, slice) and jk == slice(None):
            key = ik  # fall through to the row forms below
        elif (arr_i or int_i or isinstance(ik, slice)) and (
                arr_j or int_j or isinstance(jk, slice)):
            # a submatrix over an outer rows x cols selection
            return _set_submatrix(a, _normalize_axis_key(ik, m),
                                  _normalize_axis_key(jk, n), value)
        else:
            raise NotImplementedError(f"unsupported assignment key "
                                      f"{key!r}")
    if isinstance(key, (int, np.integer)):
        rows_sel = np.asarray([check_int(key, m, 'row')], np.int64)
        if not issparse(value) and (value.dim() if isinstance(
                value, torch.Tensor) else np.ndim(value)):
            value = _values(value, a.dtype, a.device).reshape(1, -1)
        return _set_rows(a, rows_sel, value)
    if isinstance(key, slice):
        start, stop, step = key.indices(m)
        return _set_rows(a, np.arange(start, stop, step, dtype=np.int64),
                         value)
    if isinstance(key, _ARRAY_KEYS):
        rows, _ = _normalize_rows_key(a, key)
        return _set_rows(a, rows, value)
    raise NotImplementedError(f"unsupported assignment key {key!r}")

"""CSR (compressed sparse row) matrix on an explicit torch device.

Port of `spmm_tpu/sparse/csr.py`: int32 `indptr` and `indices`, a `data`
tensor (float32 on the SpGEMM/SpMV paths), the static shape and a canonical
flag (sorted, duplicate-free indices), all three tensors on one device;
JAX's constructor forms, `sort_indices`, `sum_duplicates` and
`eliminate_zeros` (through COO, as in JAX), `tocoo`, `tocsc`, `toarray`,
`transpose`, `getrow`, `getcol`, `diagonal`, `setdiag`, and indexing and
assignment (`__getitem__`, `__setitem__`: `sparse/indexing.py`).  `_Compressed` holds what CSR and CSC
share: the constructor forms and the structure checks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.base import (INDEX_DTYPE, SparseMatrix,
                                        as_data, as_tensor, axis_sum,
                                        checked_device, is_dense_2d,
                                        issparse, resolve_device,
                                        torch_dtype)


class _Compressed(SparseMatrix):
    """indptr over the major axis (rows of a CSR, columns of a CSC), minor
    indices and data."""

    _major = 0  # the axis indptr runs over

    def __init__(self, arg1, shape: Optional[Tuple[int, int]] = None,
                 dtype=None, copy: bool = False, *, canonical: bool = False,
                 device=None):
        """From another sparse matrix, `(data, indices, indptr)`,
        `(data, (row, col))`, `(m, n)` (empty) or a dense 2-D array, on
        `device` (default: the device of the tensors given, else the card;
        raises where there is none)."""
        from spmm_tpu_torch.sparse.coo import COO

        dtype = torch_dtype(dtype)
        convert = "to" + self.format
        if issparse(arg1):
            a = getattr(arg1, convert)()
            if device is not None:
                a = a.to(device)
        elif isinstance(arg1, tuple) and len(arg1) == 3:
            data, indices, indptr = arg1
            dev = resolve_device(device, data, indices, indptr)
            data = as_data(data, dtype, dev)
            indices = as_tensor(indices, INDEX_DTYPE, dev)
            indptr = as_tensor(indptr, INDEX_DTYPE, dev)
            if indptr.dim() == 1 and indptr.numel() < 1:
                raise ValueError("indptr must have at least one element")
            if shape is None:
                major = indptr.numel() - 1
                minor = int(indices.max()) + 1 if indices.numel() else 0
                shape = (major, minor) if self._major == 0 else (minor, major)
            a = self._wrap(indptr, indices, data, shape, canonical=canonical)
        elif (isinstance(arg1, tuple) and len(arg1) == 2
              and isinstance(arg1[1], (tuple, list))):
            a = getattr(COO(arg1, shape=shape, dtype=dtype, device=device),
                        convert)()
        elif isinstance(arg1, tuple) and len(arg1) == 2 and shape is None:
            dev = resolve_device(device)
            m, n = int(arg1[0]), int(arg1[1])
            a = self._wrap(
                torch.zeros((m, n)[self._major] + 1, dtype=INDEX_DTYPE,
                            device=dev),
                torch.zeros(0, dtype=INDEX_DTYPE, device=dev),
                torch.zeros(0, dtype=dtype or torch.float32, device=dev),
                (m, n), canonical=True)
        elif is_dense_2d(arg1):
            a = getattr(COO(arg1, dtype=dtype, device=device), convert)()
        else:
            raise ValueError(f"unsupported {self.format.upper()} constructor "
                             "argument")
        data = a.data if dtype is None else a.data.to(dtype)
        self._set(a.indptr, a.indices, data, a.shape, a._canonical)

    def _set(self, indptr, indices, data, shape, canonical):
        if not (indptr.dim() == indices.dim() == data.dim() == 1):
            raise ValueError("data, indices and indptr must be 1-D")
        if indptr.dtype != INDEX_DTYPE or indices.dtype != INDEX_DTYPE:
            raise ValueError("indptr and indices must be int32")
        if not (indptr.device == indices.device == data.device):
            raise ValueError("indptr, indices and data must share a device")
        if indices.numel() != data.numel():
            raise ValueError(f"data length {data.numel()} != indices length "
                             f"{indices.numel()}")
        shape = (int(shape[0]), int(shape[1]))
        major = shape[self._major]
        if indptr.numel() != major + 1:
            what = "rows" if self._major == 0 else "cols"
            raise ValueError(f"indptr length {indptr.numel()} != {what}+1 "
                             f"({major + 1})")
        self.indptr, self.indices, self.data = indptr, indices, data
        self._shape = shape
        self._canonical = bool(canonical)

    @classmethod
    def _wrap(cls, indptr, indices, data, shape, *, canonical=False):
        """A matrix of tensors already on one device: checked in type, shape
        and device, not in values (no copy, no host sync)."""
        obj = cls.__new__(cls)
        obj._set(indptr, indices, data, shape, canonical)
        return obj

    @classmethod
    def from_parts(cls, indptr, indices, data, shape, *, canonical=False,
                   device=None):
        """From tensors or arrays, moved to `device` (default: the device
        of `data` when it is a tensor, else the card; raises where there is
        none).  The structure is checked (one host sync)."""
        device = resolve_device(device, data)
        out = cls._wrap(as_tensor(indptr, INDEX_DTYPE, device),
                        as_tensor(indices, INDEX_DTYPE, device),
                        as_tensor(data, None, device), shape,
                        canonical=canonical)
        out._check_structure()
        return out

    def _check_structure(self) -> None:
        """Reject structure the kernels would read or write out of bounds
        (one host sync): indptr must run from 0 to nnz without decreasing,
        and every minor index must lie in [0, minor extent)."""
        ip = self.indptr
        minor = self._shape[1 - self._major]
        bad = (ip[0] != 0) | (ip[-1] != self.nnz) | (ip[1:] < ip[:-1]).any()
        if self.nnz:
            bad |= (self.indices.min() < 0) | (self.indices.max() >= minor)
        if bool(bad):
            kind = "column" if self._major == 0 else "row"
            raise ValueError(f"invalid {self.format.upper()} structure for "
                             f"shape {self._shape}: indptr must go from 0 to "
                             f"nnz without decreasing and {kind} indices "
                             "must lie in range")

    def _with_data(self, data):
        return self._wrap(self.indptr, self.indices, data, self._shape,
                          canonical=self._canonical)

    def to(self, device):
        """The same matrix on `device`.  Raises if the device is not
        available, rather than staying where it is."""
        device = checked_device(device)
        return self._wrap(self.indptr.to(device), self.indices.to(device),
                          self.data.to(device), self._shape,
                          canonical=self._canonical)

    @property
    def has_canonical_format(self) -> bool:
        return self._canonical

    @property
    def _majors(self) -> torch.Tensor:
        """Per-entry major index (the row of a CSR entry, the column of a
        CSC entry)."""
        return prim.rows_from_indptr(self.indptr, self.nnz)

    def _sorted_minor(self):
        """(indices, data) with the minor indices sorted within each major
        slice; duplicates stay, in their stored order."""
        major, minor = self._shape[self._major], self._shape[1 - self._major]
        _, idx_s, (data_s,) = prim.lexsort_rowcol(
            self._majors, self.indices, (self.data,), (major, minor))
        return idx_s, data_s


class CSR(_Compressed):
    format = "csr"

    @classmethod
    def from_scipy(cls, mat, device="cuda") -> "CSR":
        mat = mat.tocsr()
        return cls.from_parts(mat.indptr, mat.indices, mat.data, mat.shape,
                              canonical=bool(mat.has_canonical_format),
                              device=device)

    @property
    def rows(self) -> torch.Tensor:
        """Per-entry row ids (csr2coo direction)."""
        return self._majors

    def check_canonical(self) -> bool:
        """Check on the device that indices are per-row sorted and
        duplicate-free."""
        return bool(prim.is_sorted_canonical(self.rows, self.indices))

    def sort_indices(self) -> "CSR":
        """A CSR with each row's column indices sorted (the `csrsort`
        analogue); duplicates stay, in their stored order."""
        return CSR._wrap(self.indptr, *self._sorted_minor(), self._shape,
                         canonical=self._canonical)

    def sorted_indices(self) -> "CSR":
        return self.sort_indices()

    def sum_duplicates(self) -> "CSR":
        """Canonical form: sorted indices, duplicates summed in stored order
        (through COO, as in JAX: one host read)."""
        if self._canonical:
            return self
        return self.tocoo().tocsr()

    def eliminate_zeros(self) -> "CSR":
        return self.tocoo().eliminate_zeros().tocsr()

    # -- conversions ---------------------------------------------------------

    def tocsr(self) -> "CSR":
        return self

    def tocoo(self):
        from spmm_tpu_torch.sparse.coo import COO

        return COO._wrap(self.rows, self.indices, self.data, self._shape,
                         canonical=self._canonical)

    def tocsc(self):
        from spmm_tpu_torch.sparse.csc import CSC

        a = self.sum_duplicates()
        m, n = self._shape
        col_s, row_s, (data_s,) = prim.lexsort_rowcol(
            a.indices, a.rows, (a.data,), (n, m))
        return CSC._wrap(prim.build_indptr(col_s, n), row_s, data_s,
                         self._shape, canonical=True)

    def toarray(self, order=None, out=None) -> torch.Tensor:
        """Dense (m, n) tensor on the matrix's device."""
        self._check_order(order, out)
        if self._canonical:
            return prim.csr_to_dense_canonical(self.indptr, self.indices,
                                               self.data, self._shape)
        return self.tocoo().toarray()

    def transpose(self) -> "CSR":
        """Aᵀ as a canonical CSR of shape (n, m): a stable sort on column of
        the canonical form (no host sync when A is canonical), the same
        output as JAX's `tocoo().transpose().tocsr()`."""
        a = self.sum_duplicates()
        indptr, indices, data = prim.csr_transpose(a.indptr, a.indices,
                                                   a.data, self._shape)
        m, n = self._shape
        return CSR._wrap(indptr, indices, data, (n, m), canonical=True)

    def getrow(self, i: int) -> "CSR":
        """Row i as a (1, n) CSR (one host read of indptr), as scipy's:
        i truncated as `int()` does, a negative i counted from the end, an
        index outside [-m, m) an IndexError (`indexing.check_int`, the rule
        of `A[i]`; JAX's `getrow` returns a corrupt empty row there)."""
        from spmm_tpu_torch.sparse.indexing import check_int

        i = check_int(i, self._shape[0], "row")
        start, end = self.indptr[i:i + 2].tolist()
        indptr = torch.tensor([0, end - start], dtype=INDEX_DTYPE,
                              device=self.device)
        return CSR._wrap(indptr, self.indices[start:end],
                         self.data[start:end], (1, self._shape[1]),
                         canonical=self._canonical)

    def diagonal(self, k: int = 0) -> torch.Tensor:
        """Diagonal k, duplicates summed in stored order from 0 as JAX's
        `.at[].add` sums them."""
        return diagonal_of(self.tocoo(), k)

    # -- indexing (sparse/indexing.py) ---------------------------------------

    def __getitem__(self, key):
        from spmm_tpu_torch.sparse import indexing

        return indexing.csr_getitem(self, key)

    def __setitem__(self, key, value):
        from spmm_tpu_torch.sparse import indexing

        indexing.csr_setitem(self, key, value)

    def getcol(self, j: int) -> "CSR":
        """Column j as an (m, 1) CSR; j is taken modulo n, as in JAX."""
        return self[:, int(j) % self._shape[1]]

    def setdiag(self, values, k: int = 0) -> None:
        """Write `values` along diagonal k in place, as scipy's `setdiag`: a
        scalar fills the whole diagonal, an array its first len(values)
        places (cut to the diagonal's length); k <= -m or k >= n raises
        ValueError.  Explicit zeros are stored, as in assignment."""
        from spmm_tpu_torch.sparse import indexing

        m, n = self._shape
        if k <= -m or k >= n:
            raise ValueError(f"k ({k}) exceeds matrix dimensions")
        m_st, n_st = max(0, -k), max(0, k)
        dlen = min(m - m_st, n - n_st)
        vals = indexing._values(values, self.dtype, self.device)
        if vals.dim() == 0:
            L = dlen
            vals = vals.expand(L)
        else:
            L = min(dlen, vals.shape[0])
            vals = vals[:L]
        idx = torch.arange(L, dtype=torch.int64, device=self.device)
        indexing._assign_entries(self, m_st + idx, n_st + idx, vals)


def diagonal_of(coo, k: int) -> torch.Tensor:
    """Diagonal k of a COO: the entries with col == row + k, kept in stored
    order (a mask and a compaction, one host sync on a card), each added in
    that order into a zero vector (the in-order `axis_sum`)."""
    m, n = coo.shape
    size = max(0, min(m + min(k, 0), n - max(k, 0)))
    on_diag = coo.col == coo.row + k
    return axis_sum(coo.col[on_diag] - max(k, 0), coo.data[on_diag], size)

"""COO (coordinate) sparse matrix on an explicit torch device.

Port of `spmm_tpu/sparse/coo.py`: int32 (row, col) and a data tensor, the
static shape and a canonical flag.  Canonicalisation is a stable (row, col)
lexsort, one host read of the distinct count (with the longest run, in the
same copy), and the in-order duplicate sum of
`_primitives.sum_duplicates_sorted`: JAX's bits, no atomics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.base import (INDEX_DTYPE, SparseMatrix,
                                        as_data, as_tensor,
                                        checked_device,
                                        is_dense_2d, issparse,
                                        resolve_device, torch_dtype)


class COO(SparseMatrix):
    format = "coo"

    def __init__(self, arg1, shape: Optional[Tuple[int, int]] = None,
                 dtype=None, copy: bool = False, *, canonical: bool = False,
                 device=None):
        """COO from another sparse matrix, `(data, (row, col))` or a dense
        2-D array, on `device` (default: the device of the tensors given,
        else the card; raises where there is none)."""
        dtype = torch_dtype(dtype)
        if issparse(arg1):
            coo = arg1.tocoo()
            if device is not None:
                coo = coo.to(device)
            row, col, data = coo.row, coo.col, coo.data
            shape, canonical = coo.shape, coo._canonical
        elif (isinstance(arg1, tuple) and len(arg1) == 2
              and isinstance(arg1[1], (tuple, list)) and len(arg1[1]) == 2):
            data, (row, col) = arg1
            dev = resolve_device(device, data, row, col)
            data = as_data(data, dtype, dev)
            row = as_tensor(row, INDEX_DTYPE, dev)
            col = as_tensor(col, INDEX_DTYPE, dev)
            if shape is None:
                shape = ((int(row.max()) + 1 if row.numel() else 0),
                         (int(col.max()) + 1 if col.numel() else 0))
        elif is_dense_2d(arg1):
            from spmm_tpu_torch.sparse import convert

            coo = convert.dense_to_coo(arg1, dtype=dtype, device=device)
            row, col, data = coo.row, coo.col, coo.data
            shape, canonical = coo.shape, True
        else:
            raise ValueError("unsupported COO constructor argument")
        if dtype is not None:
            data = data.to(dtype)
        self._set(row, col, data, shape, canonical)

    def _set(self, row, col, data, shape, canonical):
        if not (row.dim() == col.dim() == data.dim() == 1):
            raise ValueError("row, col and data must be 1-D")
        if row.dtype != INDEX_DTYPE or col.dtype != INDEX_DTYPE:
            raise ValueError("row and col must be int32")
        if not (row.device == col.device == data.device):
            raise ValueError("row, col and data must share a device")
        if not row.numel() == col.numel() == data.numel():
            raise ValueError(f"row, col and data differ in length: "
                             f"{row.numel()}, {col.numel()}, {data.numel()}")
        self.row, self.col, self.data = row, col, data
        self._shape = (int(shape[0]), int(shape[1]))
        self._canonical = bool(canonical)

    @classmethod
    def _wrap(cls, row, col, data, shape, *, canonical=False) -> "COO":
        """COO of tensors already on one device (no copy, no host sync)."""
        obj = cls.__new__(cls)
        obj._set(row, col, data, shape, canonical)
        return obj

    @classmethod
    def from_parts(cls, row, col, data, shape, *, canonical=False,
                   device=None) -> "COO":
        """COO from tensors or arrays, moved to `device` (default: the device
        of `data` when it is a tensor, else the card)."""
        dev = resolve_device(device, data)
        return cls._wrap(as_tensor(row, INDEX_DTYPE, dev),
                         as_tensor(col, INDEX_DTYPE, dev),
                         as_tensor(data, None, dev), shape,
                         canonical=canonical)

    def _with_data(self, data) -> "COO":
        return COO._wrap(self.row, self.col, data, self._shape,
                         canonical=self._canonical)

    def to(self, device) -> "COO":
        device = checked_device(device)
        return COO._wrap(self.row.to(device), self.col.to(device),
                         self.data.to(device), self._shape,
                         canonical=self._canonical)

    # -- canonicalisation ----------------------------------------------------

    @property
    def has_canonical_format(self) -> bool:
        return self._canonical

    def sum_duplicates(self) -> "COO":
        """Canonical COO: (row, col) lex-sorted, duplicates summed in
        stored order (one host read of the distinct count)."""
        if self._canonical:
            return self
        if self.nnz == 0:
            return COO._wrap(self.row, self.col, self.data, self._shape,
                             canonical=True)
        row_s, col_s, (data_s,) = prim.lexsort_rowcol(
            self.row, self.col, (self.data,), self._shape)
        nout = int(prim.count_unique_sorted(row_s, col_s))  # host sync
        if nout != self.nnz:
            row_s, col_s, data_s = prim.sum_duplicates_sorted(
                row_s, col_s, data_s, nout)
        return COO._wrap(row_s, col_s, data_s, self._shape, canonical=True)

    def eliminate_zeros(self) -> "COO":
        """The entries whose value is not 0, in stored order (one host read
        of their count)."""
        mask = self.data != 0
        keep = prim.compact_positions(mask, int(mask.sum()))
        return COO._wrap(self.row[keep], self.col[keep], self.data[keep],
                         self._shape, canonical=self._canonical)

    # -- conversions ---------------------------------------------------------

    def tocoo(self) -> "COO":
        return self

    def tocsr(self):
        from spmm_tpu_torch.sparse.csr import CSR

        coo = self.sum_duplicates()
        indptr = prim.build_indptr(coo.row, self._shape[0])
        return CSR._wrap(indptr, coo.col, coo.data, self._shape,
                         canonical=True)

    def tocsc(self):
        from spmm_tpu_torch.sparse.csc import CSC

        coo = self.sum_duplicates()
        # column-major order: lexsort by (col, row)
        col_s, row_s, (data_s,) = prim.lexsort_rowcol(
            coo.col, coo.row, (coo.data,), (self._shape[1], self._shape[0]))
        indptr = prim.build_indptr(col_s, self._shape[1])
        return CSC._wrap(indptr, row_s, data_s, self._shape, canonical=True)

    def toarray(self, order=None, out=None) -> torch.Tensor:
        """Dense (m, n) tensor on the matrix's device.  Duplicates are
        summed in stored order and every value is added to 0, as JAX's
        `zeros.at[row, col].add(data)` does (so a stored -0.0 reads +0.0)."""
        self._check_order(order, out)
        coo = self.sum_duplicates()
        m, n = self._shape
        flat = coo.row.long() * n + coo.col.long()
        dense = torch.zeros(m * n, dtype=self.dtype, device=self.device)
        dense[flat] = prim.plus_zero(coo.data)
        return dense.view(m, n)

    def transpose(self) -> "COO":
        return COO._wrap(self.col, self.row, self.data,
                         (self._shape[1], self._shape[0]), canonical=False)

    def reshape(self, *shape, order="C"):
        raise NotImplementedError("reshape of sparse matrices is unsupported")

    def __repr__(self):
        m, n = self.shape
        return (f"<{m}x{n} sparse matrix of type {self.dtype} with {self.nnz} "
                f"stored elements in COOrdinate format on {self.device}>")

"""DIA (diagonal) sparse matrix on an explicit torch device.

Port of `spmm_tpu/sparse/dia.py`: a (ndiag, L) data tensor and one host
integer offset per diagonal, scipy's column-indexed convention: ``data[i,
j]`` holds the value at ``(j - offsets[i], j)``.  The offsets stay on the
host, as in JAX (there, static pytree data); the index arithmetic that
follows from them is host numpy, and values move on the device.  Products
go through `tocsr()`, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spmm_tpu_torch.sparse.base import (INDEX_DTYPE, SparseMatrix, as_data,
                                        checked_device, host, is_dense_2d,
                                        issparse, resolve_device,
                                        torch_dtype)


class DIA(SparseMatrix):
    format = "dia"

    def __init__(self, arg1, shape: Optional[Tuple[int, int]] = None,
                 dtype=None, copy: bool = False, *, device=None):
        """DIA from another sparse matrix, `(data, offsets)` with `shape`,
        or a dense 2-D array, on `device` (default: the device of the tensors
        given, else the card)."""
        dtype = torch_dtype(dtype)
        if issparse(arg1):
            d = arg1.todia()
            if device is not None:
                d = d.to(device)
            data, offsets, shape = d.data, d._offsets, d.shape
        elif isinstance(arg1, tuple) and len(arg1) == 2:
            data, offsets = arg1
            data = as_data(data, dtype, resolve_device(device, data))
            data = data.view(1, -1) if data.dim() < 2 else data
            offsets = tuple(int(o) for o in np.atleast_1d(host(offsets)))
            if len(set(offsets)) != len(offsets):
                raise ValueError("offset array contains duplicate values")
            if data.shape[0] != len(offsets):
                raise ValueError(
                    f"number of diagonals ({data.shape[0]}) does not match "
                    f"the number of offsets ({len(offsets)})")
            if shape is None:
                raise ValueError("DIA((data, offsets)) requires shape")
        elif is_dense_2d(arg1):
            from spmm_tpu_torch.sparse.coo import COO

            d = COO(arg1, dtype=dtype, device=device).todia()
            data, offsets, shape = d.data, d._offsets, d.shape
        else:
            raise ValueError("unsupported DIA constructor argument")
        self.data = data if dtype is None else data.to(dtype)
        self._offsets = tuple(offsets)
        self._shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_parts(cls, data, offsets, shape, *, device=None) -> "DIA":
        """DIA of (ndiag, L) values and host offsets.  A tensor stays where
        it is (no copy) unless `device` is given; a host array goes to the
        card unless `device` says otherwise (raises where there is none),
        converted as `jnp.asarray` converts it (float64 to float32, as with
        x64 off)."""
        obj = cls.__new__(cls)
        obj.data = as_data(data, None, resolve_device(device, data))
        obj._offsets = tuple(int(o) for o in offsets)
        obj._shape = (int(shape[0]), int(shape[1]))
        return obj

    def _with_data(self, data) -> "DIA":
        return DIA.from_parts(data, self._offsets, self._shape)

    def to(self, device) -> "DIA":
        return self._with_data(self.data.to(checked_device(device)))

    # -- properties ----------------------------------------------------------

    @property
    def offsets(self) -> torch.Tensor:
        return torch.tensor(self._offsets, dtype=INDEX_DTYPE,
                            device=self.device)

    def _inbounds_mask(self) -> np.ndarray:
        """(ndiag, L) host mask of the slots that fall inside the matrix."""
        m, n = self._shape
        cols = np.arange(self.data.shape[1])
        rows = cols[None, :] - np.asarray(self._offsets, np.int64)[:, None]
        return (rows >= 0) & (rows < m) & (cols[None, :] < n)

    @property
    def nnz(self) -> int:
        """Stored in-bounds values (explicit zeros inside the band count,
        slots outside the matrix do not), as scipy's dia_matrix."""
        return int(self._inbounds_mask().sum())

    @property
    def has_canonical_format(self) -> bool:
        return True  # one slot per (row, col) by construction

    def sum_duplicates(self) -> "DIA":
        return self

    def _slots(self, mask: np.ndarray):
        """Host (diagonal, column, row) of the slots set in `mask`."""
        di, cj = np.nonzero(mask)
        return di, cj, cj - np.asarray(self._offsets, np.int64)[di]

    # -- conversions ---------------------------------------------------------

    def tocoo(self):
        """The entries in (row, col) order, explicit zeros dropped, as
        scipy's dia -> coo (one host copy of the data for the mask)."""
        from spmm_tpu_torch.sparse.coo import COO

        di, cj, ri = self._slots(self._inbounds_mask()
                                 & (host(self.data) != 0))
        order = np.lexsort((cj, ri))
        di, cj, ri = di[order], cj[order], ri[order]
        dev = self.device
        vals = self.data[torch.as_tensor(di, device=dev),
                         torch.as_tensor(cj, device=dev)]
        return COO._wrap(torch.as_tensor(ri, dtype=INDEX_DTYPE, device=dev),
                         torch.as_tensor(cj, dtype=INDEX_DTYPE, device=dev),
                         vals, self._shape, canonical=True)

    def tocsr(self):
        return self.tocoo().tocsr()

    def todia(self) -> "DIA":
        return self

    def toarray(self, order=None, out=None) -> torch.Tensor:
        """Dense (m, n) tensor: each in-bounds slot stored at its place
        (distinct offsets never share a place)."""
        self._check_order(order, out)
        m, n = self._shape
        di, cj, ri = self._slots(self._inbounds_mask())
        dev = self.device
        dense = torch.zeros((m, n), dtype=self.dtype, device=dev)
        dense[torch.as_tensor(ri, device=dev),
              torch.as_tensor(cj, device=dev)] = self.data[
            torch.as_tensor(di, device=dev), torch.as_tensor(cj, device=dev)]
        return dense

    def transpose(self) -> "DIA":
        """Aᵀ: diagonal k of A is diagonal -k of Aᵀ, its value at column j
        moved to column j - k (host index arithmetic, values moved on the
        device)."""
        m, n = self._shape
        ndiag, L = self.data.shape
        offs = np.asarray(self._offsets, np.int64)
        cols = np.arange(L)[None, :]
        hi = np.minimum(np.minimum(n, m + offs), L)[:, None]
        di, cj = np.nonzero((cols >= np.maximum(0, offs)[:, None])
                            & (cols < hi))
        dev = self.device
        out = torch.zeros((ndiag, max(m, L)), dtype=self.dtype, device=dev)
        di_t = torch.as_tensor(di, device=dev)
        out[di_t, torch.as_tensor(cj - offs[di], device=dev)] = self.data[
            di_t, torch.as_tensor(cj, device=dev)]
        return DIA.from_parts(out, [-k for k in self._offsets], (n, m))

    def diagonal(self, k: int = 0) -> torch.Tensor:
        m, n = self._shape
        size = max(0, min(m + min(k, 0), n - max(k, 0)))
        if k not in self._offsets:
            return torch.zeros(size, dtype=self.dtype, device=self.device)
        row = self.data[self._offsets.index(k)]
        lo = max(0, k)
        row = torch.nn.functional.pad(row,
                                      (0, max(0, lo + size - row.numel())))
        return row[lo:lo + size]

    # -- products go through CSR, as in JAX ----------------------------------

    def __matmul__(self, other):
        return self.tocsr() @ other

    def __mul__(self, other):
        return self.tocsr() * other


def coo_to_dia(coo) -> DIA:
    """COO -> DIA (the `todia` of every format): one diagonal per distinct
    col - row, from host copies of the structure."""
    coo = coo.sum_duplicates()
    m, n = coo.shape
    row_h, col_h = host(coo.row), host(coo.col)
    ks = col_h.astype(np.int64) - row_h
    offsets = np.unique(ks)
    dev = coo.device
    if offsets.size == 0:
        return DIA.from_parts(torch.zeros((1, max(n, 1)), dtype=coo.dtype,
                                          device=dev), [0], (m, n))
    di = np.searchsorted(offsets, ks)
    data = torch.zeros((offsets.size, max(n, 1)), dtype=coo.dtype,
                       device=dev)
    data[torch.as_tensor(di, device=dev),
         torch.as_tensor(col_h, dtype=torch.long, device=dev)] = coo.data
    return DIA.from_parts(data, offsets, (m, n))

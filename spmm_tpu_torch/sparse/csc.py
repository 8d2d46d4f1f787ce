"""CSC (compressed sparse column) matrix on an explicit torch device.

Port of `spmm_tpu/sparse/csc.py`: (indptr over columns, row indices, data).
The products go through CSR, as in JAX (CSR @ CSC converts the CSC).  The
constructor forms and checks are CSR's (`csr._Compressed`).
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.sparse.csr import CSR, _Compressed


class CSC(_Compressed):
    format = "csc"
    _major = 1

    @property
    def cols(self) -> torch.Tensor:
        """Per-entry column ids."""
        return self._majors

    # -- conversions ---------------------------------------------------------

    def tocsc(self) -> "CSC":
        return self

    def tocoo(self):
        from spmm_tpu_torch.sparse.coo import COO

        return COO._wrap(self.indices, self.cols, self.data, self._shape,
                         canonical=False)

    def tocsr(self):
        return self.tocoo().tocsr()

    def toarray(self, order=None, out=None) -> torch.Tensor:
        self._check_order(order, out)
        return self.tocoo().toarray()

    def transpose(self) -> CSR:
        """CSC (m, n) read as the CSR of shape (n, m): free."""
        return CSR._wrap(self.indptr, self.indices, self.data,
                         (self._shape[1], self._shape[0]),
                         canonical=self._canonical)

    def sum_duplicates(self) -> "CSC":
        if self._canonical:
            return self
        return self.tocoo().tocsc()

    def sort_indices(self) -> "CSC":
        return CSC._wrap(self.indptr, *self._sorted_minor(), self._shape,
                         canonical=self._canonical)

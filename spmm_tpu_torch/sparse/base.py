"""Base class of the sparse containers.

Port of the part of `spmm_tpu/sparse/base.py` that the alg1 SpGEMM slice
needs: shape / dtype / device / nnz / density, the scipy bridge, and `@`
routed to `spmm_tpu_torch.ops.dispatch`.  Unlike the JAX containers, these
hold tensors on an explicit device and are not pytrees.
"""

from __future__ import annotations

import numbers
from typing import Tuple

import numpy as np
import torch


class SparseMatrix:
    """Abstract base of the port's sparse formats (CSR in this slice)."""

    format: str = "base"

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(m * n) if m and n else 0.0

    def tocsr(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def to(self, device):  # pragma: no cover - abstract
        raise NotImplementedError

    def to_scipy(self):
        """Host scipy CSR copy."""
        import scipy.sparse as sp

        a = self.tocsr()
        return sp.csr_matrix((a.data.cpu().numpy(), a.indices.cpu().numpy(),
                              a.indptr.cpu().numpy()), shape=self.shape)

    def __matmul__(self, other):
        from spmm_tpu_torch.ops import dispatch

        if isinstance(other, numbers.Number) or (
                isinstance(other, (torch.Tensor, np.ndarray))
                and other.ndim == 0):
            # scipy's spmatrix.__matmul__ rejects scalars the same way
            raise ValueError("Scalar operands are not allowed, use '*' instead")
        return dispatch.matmul(self, other)

    def __repr__(self):
        m, n = self.shape
        return (f"<{m}x{n} sparse matrix of type {self.dtype} with {self.nnz} "
                f"stored elements in {self.format.upper()} format on "
                f"{self.device}>")


def issparse(x) -> bool:
    return isinstance(x, SparseMatrix)

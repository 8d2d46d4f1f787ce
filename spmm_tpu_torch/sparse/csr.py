"""CSR (compressed sparse row) matrix on an explicit torch device.

Port of the alg1-slice part of `spmm_tpu/sparse/csr.py`: int32 `indptr` and
`indices`, a `data` tensor (float32 on the SpGEMM path), the static shape and
a canonical flag (sorted, duplicate-free indices), all three tensors on one
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.base import SparseMatrix

INDEX_DTYPE = prim.INDEX_DTYPE


def _as_tensor(x, dtype, device) -> torch.Tensor:
    """Contiguous tensor on `device`; `dtype` None keeps x's type."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


class CSR(SparseMatrix):
    format = "csr"

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, shape: Tuple[int, int], *,
                 canonical: bool = False):
        if not (indptr.dim() == indices.dim() == data.dim() == 1):
            raise ValueError("indptr, indices and data must be 1-D")
        if indptr.dtype != INDEX_DTYPE or indices.dtype != INDEX_DTYPE:
            raise ValueError("indptr and indices must be int32")
        if not (indptr.device == indices.device == data.device):
            raise ValueError("indptr, indices and data must share a device")
        if indices.numel() != data.numel():
            raise ValueError(f"data length {data.numel()} != indices length "
                             f"{indices.numel()}")
        m, n = int(shape[0]), int(shape[1])
        if indptr.numel() != m + 1:
            raise ValueError(f"indptr length {indptr.numel()} != rows+1 "
                             f"({m + 1})")
        self.indptr, self.indices, self.data = indptr, indices, data
        self._shape = (m, n)
        self._canonical = bool(canonical)

    @classmethod
    def from_parts(cls, indptr, indices, data, shape, *, canonical=False,
                   device=None) -> "CSR":
        """CSR from tensors or arrays, moved to `device` (default: the
        device of `data` when it is a tensor, else the CPU)."""
        if device is None:
            device = data.device if isinstance(data, torch.Tensor) else "cpu"
        device = _checked_device(device)
        out = cls(_as_tensor(indptr, INDEX_DTYPE, device),
                  _as_tensor(indices, INDEX_DTYPE, device),
                  _as_tensor(data, None, device), shape, canonical=canonical)
        out._check_structure()
        return out

    def _check_structure(self) -> None:
        """Reject structure the kernels would read or write out of bounds
        (one host sync): indptr must run from 0 to nnz without decreasing,
        and every column index must lie in [0, n)."""
        ip = self.indptr
        bad = (ip[0] != 0) | (ip[-1] != self.nnz) | (ip[1:] < ip[:-1]).any()
        if self.nnz:
            bad |= (self.indices.min() < 0) | (self.indices.max()
                                               >= self._shape[1])
        if bool(bad):
            raise ValueError(f"invalid CSR structure for shape {self._shape}: "
                             "indptr must go from 0 to nnz without "
                             "decreasing and column indices must lie in "
                             "[0, n)")

    @classmethod
    def from_scipy(cls, mat, device="cpu") -> "CSR":
        mat = mat.tocsr()
        return cls.from_parts(mat.indptr, mat.indices, mat.data, mat.shape,
                              canonical=bool(mat.has_canonical_format),
                              device=device)

    def to(self, device) -> "CSR":
        """The same matrix on `device`.  Raises if the device is not
        available, rather than staying where it is."""
        device = _checked_device(device)
        return CSR(self.indptr.to(device), self.indices.to(device),
                   self.data.to(device), self._shape,
                   canonical=self._canonical)

    @property
    def has_canonical_format(self) -> bool:
        return self._canonical

    @property
    def rows(self) -> torch.Tensor:
        """Per-entry row ids (csr2coo direction)."""
        return prim.rows_from_indptr(self.indptr, self.nnz)

    def check_canonical(self) -> bool:
        """Check on the device that indices are per-row sorted and
        duplicate-free."""
        return bool(prim.is_sorted_canonical(self.rows, self.indices))

    def sum_duplicates(self) -> "CSR":
        """Canonical form: this matrix, flagged canonical, when its indices
        are already sorted and unique.  Sorting and summing duplicates needs
        the bitwise `segsum_tree` of the ESC slice and is not ported yet."""
        if self._canonical:
            return self
        if self.check_canonical():
            return CSR(self.indptr, self.indices, self.data, self._shape,
                       canonical=True)
        raise NotImplementedError(
            "sum_duplicates on unsorted or duplicate indices is not ported "
            "yet (ROADMAP §1.5, primitives: lexsort_rowcol, "
            "sum_duplicates_sorted, segsum_tree)")

    def tocsr(self) -> "CSR":
        return self

    def toarray(self) -> torch.Tensor:
        """Dense (m, n) tensor on the matrix's device."""
        if self._canonical:
            return prim.csr_to_dense_canonical(self.indptr, self.indices,
                                               self.data, self._shape)
        m, n = self._shape
        flat = self.rows.long() * n + self.indices.long()
        out = torch.zeros(m * n, dtype=self.dtype, device=self.device)
        return out.index_put_((flat,), self.data, accumulate=True).view(m, n)


def _checked_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"cannot place a CSR on {device}: CUDA is not "
                           "available")
    return device

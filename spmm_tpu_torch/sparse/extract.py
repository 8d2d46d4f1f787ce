"""Nonzero extraction: find / tril / triu.

Port of `spmm_tpu/sparse/extract.py`: masks over COO entries, scipy's
k-diagonal conventions, one host read of the kept count and an in-order
compaction (as `eliminate_zeros`).
"""

from __future__ import annotations

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.base import issparse
from spmm_tpu_torch.sparse.coo import COO


def _as_coo(A) -> COO:
    if issparse(A):
        return A.tocoo()
    if getattr(A, "ndim", None) != 2:
        raise TypeError("A must be a 2-D array or a sparse matrix")
    return COO(A)


def _masked_coo(coo: COO, mask) -> COO:
    """The entries where `mask` holds, in stored order."""
    keep = prim.compact_positions(mask, int(mask.sum()))  # host sync
    return COO._wrap(coo.row[keep], coo.col[keep], coo.data[keep], coo.shape,
                     canonical=coo.has_canonical_format)


def find(A):
    """(rows, cols, values) of the nonzero entries of A, in (row, col)
    order: duplicates summed, explicit zeros dropped."""
    coo = _as_coo(A).sum_duplicates()
    nz = _masked_coo(coo, coo.data != 0)
    return nz.row, nz.col, nz.data


def tril(A, k: int = 0, format=None):
    """Lower-triangular part: the entries with row + k >= col."""
    coo = _as_coo(A)
    return _masked_coo(coo, coo.row + k >= coo.col).asformat(format or "coo")


def triu(A, k: int = 0, format=None):
    """Upper-triangular part: the entries with row + k <= col."""
    coo = _as_coo(A)
    return _masked_coo(coo, coo.row + k <= coo.col).asformat(format or "coo")

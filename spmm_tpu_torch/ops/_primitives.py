"""Tensor building blocks shared by the container and the kernels.

Ports the slice of `spmm_tpu/ops/_primitives.py` that the alg1 SpGEMM path
needs.  Indices are int32 (`INDEX_DTYPE`), as in the JAX package; flat
dense offsets are formed in int64, since row*k+col passes 2^31 at large
shapes.  Everything is deterministic: no float atomics.
"""

from __future__ import annotations

from typing import Tuple

import torch

INDEX_DTYPE = torch.int32


def build_indptr(rows_sorted: torch.Tensor, nrows: int) -> torch.Tensor:
    """CSR indptr from sorted row ids (the `coo2csr` direction)."""
    counts = torch.bincount(rows_sorted.long(), minlength=nrows)
    zero = torch.zeros(1, dtype=INDEX_DTYPE, device=rows_sorted.device)
    return torch.cat([zero, torch.cumsum(counts, 0, dtype=INDEX_DTYPE)])


def rows_from_indptr(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Per-entry row ids of a CSR (the `csr2coo` direction)."""
    m = indptr.numel() - 1
    rows = torch.arange(m, dtype=INDEX_DTYPE, device=indptr.device)
    return torch.repeat_interleave(rows, (indptr[1:] - indptr[:-1]).long(),
                                   output_size=nnz)


def is_sorted_canonical(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """True iff (row, col) pairs are strictly increasing lexicographically:
    sorted and duplicate-free."""
    if row.numel() <= 1:
        return torch.ones((), dtype=torch.bool, device=row.device)
    row_ok = row[1:] > row[:-1]
    col_ok = (row[1:] == row[:-1]) & (col[1:] > col[:-1])
    return torch.all(row_ok | col_ok)


def csr_to_dense_canonical(indptr: torch.Tensor, indices: torch.Tensor,
                           data: torch.Tensor,
                           shape: Tuple[int, int]) -> torch.Tensor:
    """Dense (m, k) of a canonical CSR.  Positions are unique, so the
    assignment is a plain deterministic scatter; a stored zero stays 0."""
    m, k = shape
    rows = rows_from_indptr(indptr, data.numel())
    flat = rows.long() * k + indices.long()
    out = torch.zeros(m * k, dtype=data.dtype, device=data.device)
    out[flat] = data
    return out.view(m, k)

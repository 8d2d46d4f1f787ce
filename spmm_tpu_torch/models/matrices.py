"""Synthetic sparse-matrix families.

Port of the power-law family of `spmm_tpu/models/matrices.py`
(`power_law_rows`), the load-imbalance stress family.  It draws from the
same `numpy.random.Generator` calls in the same order (the Zipf row lengths,
one column draw without replacement per non-empty row, then the values), so
a seed gives the JAX package's matrix bit for bit.  The only change is that
the loop skips the empty rows (a draw of size 0 takes no random numbers), so
a 2^20-row matrix, more than 99 % of it empty rows, needs a few thousand
draws instead of a million.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.sparse.csr import CSR


def power_law_rows(m: int, n: int, avg_nnz_per_row: int, alpha: float = 1.5,
                   seed: int = 0, dtype: torch.dtype = torch.float32,
                   device="cuda") -> CSR:
    """Canonical CSR with Zipf(alpha)-distributed row lengths scaled to
    `avg_nnz_per_row` on average (each capped at n), columns distinct
    within a row, values U[0,1)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"power_law_rows: dtype must be float32 or float64, "
                         f"got {dtype}")
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=m).astype(np.float64)
    lengths = np.minimum(
        np.maximum((raw / raw.mean() * avg_nnz_per_row).astype(np.int64), 0),
        n)
    nz = np.flatnonzero(lengths)
    cols = (np.concatenate([rng.choice(n, size=int(lengths[r]),
                                       replace=False) for r in nz])
            if nz.size else np.zeros((0,), np.int64))
    vals = rng.random(cols.shape[0]).astype(np.float32)
    rows = np.repeat(np.arange(m), lengths)
    order = np.lexsort((cols, rows))  # canonical: columns sorted per row
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    data = torch.from_numpy(vals[order]).to(dtype)
    return CSR.from_parts(indptr.astype(np.int32),
                          cols[order].astype(np.int32), data, (m, n),
                          canonical=True, device=device)

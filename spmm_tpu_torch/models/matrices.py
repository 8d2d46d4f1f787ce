"""Synthetic sparse-matrix families.

Port of `spmm_tpu/models/matrices.py`: `uniform` (the reference's
generator), `banded`, `block_sparse` (the BSR-friendly family) and
`power_law_rows` (the load-imbalance stress family), each drawn with a
`numpy.random.Generator` from its seed.

`power_law_rows` draws from the same generator calls in the same order as
the JAX package (the Zipf row lengths, one column draw without replacement
per non-empty row, then the values), so a seed gives JAX's matrix bit for
bit.  The only change is that the loop skips the empty rows (a draw of size
0 takes no random numbers), so a 2^20-row matrix, more than 99 % of it
empty rows, needs a few thousand draws instead of a million.  The other
three draw with `jax.random` in JAX, whose bits torch cannot reproduce:
the same seed gives another matrix of the same family.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spmm_tpu_torch.sparse import construct
from spmm_tpu_torch.sparse.base import INDEX_DTYPE, resolve_device
from spmm_tpu_torch.sparse.coo import COO
from spmm_tpu_torch.sparse.csr import CSR


def uniform(m: int, n: int, density: float, seed: int = 0,
            dtype: torch.dtype = torch.float32, format: str = "csr",
            low: float = 0.0, high: float = 1.0, device="cuda"):
    """Uniformly random positions (`construct.random`), values U[low,
    high)."""
    a = construct.random(m, n, density, format="coo", dtype=dtype, seed=seed,
                         device=device)
    if (low, high) != (0.0, 1.0):
        a = a._with_data(low + (high - low) * a.data)
    return a.asformat(format)


def banded(m: int, n: int, bandwidth: int, seed: int = 0,
           dtype: torch.dtype = torch.float32, format: str = "csr",
           device="cuda"):
    """A dense band of half-width `bandwidth` around the diagonal, values
    U[0, 1)."""
    rng = np.random.default_rng(seed)
    offsets = list(range(-bandwidth, bandwidth + 1))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    diagonals = [rng.random(max(0, min(m + min(k, 0), n - max(k, 0))),
                            dtype=np_dtype) for k in offsets]
    return construct.diags(diagonals, offsets, shape=(m, n), format=format,
                           dtype=dtype, device=resolve_device(device))


def block_sparse(m: int, n: int, block: Tuple[int, int],
                 block_density: float, seed: int = 0,
                 dtype: torch.dtype = torch.float32, format: str = "csr",
                 device="cuda"):
    """Dense (R, C) blocks, max(1, int(block_density * mb * nb)) of them,
    placed uniformly at random without replacement, values U[0, 1)."""
    R, C = block
    mb, nb = m // R, n // C
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    nblocks = max(1, int(block_density * mb * nb))
    flat = rng.choice(mb * nb, size=nblocks, replace=False)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    vals = torch.from_numpy(rng.random((nblocks, R, C), dtype=np_dtype))
    brow, bcol = (torch.as_tensor(x, dtype=INDEX_DTYPE, device=device)
                  for x in (flat // nb, flat % nb))
    r_in = torch.arange(R, dtype=INDEX_DTYPE, device=device)
    c_in = torch.arange(C, dtype=INDEX_DTYPE, device=device)
    rr = (brow.view(-1, 1, 1) * R + r_in.view(1, R, 1)).expand(nblocks, R, C)
    cc = (bcol.view(-1, 1, 1) * C + c_in.view(1, 1, C)).expand(nblocks, R, C)
    coo = COO._wrap(rr.reshape(-1), cc.reshape(-1),
                    vals.reshape(-1).to(device), (m, n))
    return coo.asformat(format)


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


FAMILIES = {
    "uniform": uniform,
    "banded": banded,
    "block": block_sparse,
    "powerlaw": power_law_rows,
}

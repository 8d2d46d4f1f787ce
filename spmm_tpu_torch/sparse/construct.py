"""Sparse matrix constructors.

Port of `spmm_tpu/sparse/construct.py`: `random` (`rand`), `eye`,
`identity`, `spdiags`, `diags`, `kron`, `kronsum`, `bmat`, `vstack` and
`hstack`, with JAX's semantics and default formats.  `random` draws
exactly ``int(density*m*n)`` distinct positions uniformly without
replacement from the flattened index space, values U[0,1), with a
`numpy.random.Generator`, so its bits differ from `spmm_tpu.random` (which
uses `jax.random`) for the same seed; its COO holds the positions in
(row, col) order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmm_tpu_torch.sparse.base import (INDEX_DTYPE, as_data, issparse,
                                        resolve_device, torch_dtype)
from spmm_tpu_torch.sparse.coo import COO


def random(m: int, n: int, density: float = 0.01, format: str = "coo",
           dtype=torch.float32, seed=None, device="cuda"):
    """Random matrix with exactly ``int(density*m*n)`` entries, as a COO
    unless `format` says otherwise, on the card unless `device` says
    otherwise.

    `seed` is an int, None, or a `numpy.random.Generator` to draw from."""
    dtype = torch_dtype(dtype)
    if dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise ValueError(f"random: dtype must be float32, float64 or "
                         f"bfloat16, got {dtype}")
    if not 0 <= density <= 1:
        raise ValueError("density expected to be 0 <= density <= 1")
    m, n = int(m), int(n)
    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    k = int(density * m * n)
    flat = np.sort(rng.choice(m * n, size=k, replace=False)).astype(np.int64)
    # bfloat16: the float32 draw rounded to nearest, as numpy has no bf16
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    data = torch.from_numpy(rng.random(k, dtype=np_dtype)).to(dtype)
    coo = COO.from_parts(flat // n, flat % n, data, (m, n), canonical=True,
                         device=device)
    return coo.asformat(format)


rand = random


def _diag_size(m: int, n: int, k: int) -> int:
    return max(0, min(m + min(k, 0), n - max(k, 0)))


def _diag_coords(m: int, n: int, k: int, device):
    """(rows, cols) of diagonal k of an (m, n) matrix, int32."""
    idx = torch.arange(_diag_size(m, n, k), dtype=INDEX_DTYPE, device=device)
    return idx - min(k, 0), idx + max(k, 0)


def eye(m: int, n: Optional[int] = None, k: int = 0, dtype=torch.float32,
        format: str = "dia", device="cuda"):
    """Ones on diagonal k."""
    n = m if n is None else n
    m, n = int(m), int(n)
    device = resolve_device(device)
    row, col = _diag_coords(m, n, k, device)
    data = torch.ones(row.numel(), dtype=torch_dtype(dtype), device=device)
    return COO._wrap(row, col, data, (m, n), canonical=True).asformat(format)


def identity(n: int, dtype=torch.float32, format: str = "dia",
             device="cuda"):
    return eye(n, n, dtype=dtype, format=format, device=device)


def _from_diagonals(values, offsets, m, n, device):
    """COO of (value vector, offset) pairs; each vector gives its diagonal's
    entries in order (empty diagonals skipped)."""
    rows, cols, vals = [], [], []
    for v, k in zip(values, offsets):
        r, c = _diag_coords(m, n, int(k), device)
        if r.numel():
            rows.append(r)
            cols.append(c)
            vals.append(v(c))
    if not rows:
        return None
    return COO._wrap(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                     (m, n))


def spdiags(data, diags_offsets, m: int, n: int, format: str = "dia",
            device=None):
    """Matrix from diagonals, scipy's `spdiags`: diagonal k takes
    data[i][c] at column c (an index past the row reads its last value, as
    JAX's clamped gather does)."""
    dev = resolve_device(device, data)
    data = as_data(data, None, dev)
    if data.dim() == 1:
        data = data[None, :]
    offsets = np.atleast_1d(np.asarray(diags_offsets, np.int64))
    last = data.shape[1] - 1
    coo = _from_diagonals(
        [lambda c, d=d: d[c.long().clamp(max=last)] for d in data], offsets,
        m, n, dev)
    if coo is None:
        coo = COO._wrap(torch.zeros(0, dtype=INDEX_DTYPE, device=dev),
                        torch.zeros(0, dtype=INDEX_DTYPE, device=dev),
                        torch.zeros(0, dtype=data.dtype, device=dev), (m, n),
                        canonical=True)
    return coo.asformat(format)


def diags(diagonals, offsets=0, shape=None, format: str = "dia", dtype=None,
          device=None):
    """scipy's `diags`: a list of diagonals with their offsets; a scalar
    fills its whole diagonal."""
    if np.isscalar(offsets):
        offsets, diagonals = [offsets], [diagonals]
    dev = resolve_device(device, *diagonals)
    dtype = torch_dtype(dtype)
    diagonals = [as_data(d, None, dev) for d in diagonals]
    offsets = [int(o) for o in offsets]
    if shape is None:
        extent = max(len(d) + abs(o) if d.dim() else 1 + abs(o)
                     for d, o in zip(diagonals, offsets))
        shape = (extent, extent)
    m, n = int(shape[0]), int(shape[1])

    def values(d):
        if d.dim() == 0:
            return lambda c: torch.full((c.numel(),), d.item(),
                                        dtype=dtype or d.dtype, device=dev)
        return lambda c: (d[:c.numel()] if dtype is None
                          else d[:c.numel()].to(dtype))

    coo = _from_diagonals([values(d) for d in diagonals], offsets, m, n, dev)
    return coo.asformat(format)


def _operand_coo(A, device=None) -> COO:
    return A.tocoo() if issparse(A) else COO(A, device=device)


def kron(A, B, format: Optional[str] = None):
    """Kronecker product: A's entries expanded into B-sized blocks in COO
    space, the data the outer product of the two data vectors, in A's
    dtype.  Blocks come in A-entry order, so the result is not canonical."""
    dev = resolve_device(None, A, B)
    A, B = _operand_coo(A, dev), _operand_coo(B, dev)
    out_shape = (A.shape[0] * B.shape[0], A.shape[1] * B.shape[1])
    if A.nnz == 0 or B.nnz == 0:
        z = COO._wrap(torch.zeros(0, dtype=INDEX_DTYPE, device=dev),
                      torch.zeros(0, dtype=INDEX_DTYPE, device=dev),
                      torch.zeros(0, dtype=A.dtype, device=dev), out_shape,
                      canonical=True)
        return z.asformat(format or "coo")
    if max(out_shape) > np.iinfo(np.int32).max:
        raise ValueError(f"kron output shape {out_shape} exceeds the int32 "
                         "index space of the containers")
    bn = B.nnz
    row = (A.row * B.shape[0]).repeat_interleave(bn).view(-1, bn) + B.row
    col = (A.col * B.shape[1]).repeat_interleave(bn).view(-1, bn) + B.col
    data = A.data.repeat_interleave(bn).view(-1, bn) * B.data.to(A.dtype)
    out = COO._wrap(row.reshape(-1), col.reshape(-1), data.reshape(-1),
                    out_shape, canonical=False)
    return out.asformat(format or "coo")


def kronsum(A, B, format: Optional[str] = None):
    """Kronecker sum kron(I_n, A) + kron(B, I_m) of square A (m, m) and B
    (n, n)."""
    dev = resolve_device(None, A, B)
    A, B = _operand_coo(A, dev), _operand_coo(B, dev)
    if A.shape[0] != A.shape[1]:
        raise ValueError("A is not square matrix")
    if B.shape[0] != B.shape[1]:
        raise ValueError("B is not square matrix")
    dtype = torch.promote_types(A.dtype, B.dtype)
    L = kron(eye(B.shape[0], dtype=dtype, format="coo", device=dev),
             A.astype(dtype))
    R = kron(B.astype(dtype),
             eye(A.shape[0], dtype=dtype, format="coo", device=dev))
    return (L.tocsr() + R.tocsr()).asformat(format or "csr")


def bmat(blocks, format: Optional[str] = None, dtype=None):
    """A matrix from a 2-D grid of blocks (None for a zero block)."""
    nrows, ncols = len(blocks), len(blocks[0])
    heights, widths = [None] * nrows, [None] * ncols
    for i in range(nrows):
        for j in range(ncols):
            if blocks[i][j] is not None:
                heights[i], widths[j] = blocks[i][j].shape
    if None in heights or None in widths:
        raise ValueError("bmat grid has an all-None row or column")
    row_off = np.concatenate([[0], np.cumsum(heights)])
    col_off = np.concatenate([[0], np.cumsum(widths)])
    given = [b for line in blocks for b in line if b is not None]
    dev = resolve_device(None, *given)
    rows, cols, vals = [], [], []
    for i in range(nrows):
        for j in range(ncols):
            if blocks[i][j] is None:
                continue
            coo = _operand_coo(blocks[i][j], dev)
            rows.append(coo.row + int(row_off[i]))
            cols.append(coo.col + int(col_off[j]))
            vals.append(coo.data)
    shape = (int(row_off[-1]), int(col_off[-1]))
    out = COO._wrap(torch.cat(rows), torch.cat(cols), torch.cat(vals), shape)
    if dtype is not None:
        out = out.astype(dtype)
    return out.asformat(format or "coo")


def vstack(blocks, format=None, dtype=None):
    return bmat([[b] for b in blocks], format=format, dtype=dtype)


def hstack(blocks, format=None, dtype=None):
    return bmat([list(blocks)], format=format, dtype=dtype)

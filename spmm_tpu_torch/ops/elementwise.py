"""Element-wise sparse arithmetic (add / subtract / multiply).

Port of `spmm_tpu/ops/elementwise.py`: `add` concatenates the COO triplets
and canonicalises them (stable sort, in-order duplicate sum); `multiply` of
two sparse matrices intersects their canonical patterns the same way.  The
sums are `_primitives.sum_duplicates_sorted`'s, in stored order: JAX's
bits, no atomics.
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.base import as_data, issparse


def add(a, b):
    """a + b: sparse + sparse stays sparse (in a's format); sparse + dense
    gives a dense tensor."""
    from spmm_tpu_torch.sparse.coo import COO

    if not issparse(b):
        return a.toarray() + as_data(b, None, a.device)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch for add: {a.shape} vs {b.shape}")
    ca, cb = a.tocoo(), b.tocoo()
    dtype = torch.promote_types(ca.dtype, cb.dtype)
    out = COO._wrap(torch.cat([ca.row, cb.row]), torch.cat([ca.col, cb.col]),
                    torch.cat([ca.data.to(dtype), cb.data.to(dtype)]),
                    a.shape).sum_duplicates()
    return out.asformat(a.format)


def multiply(a, b):
    """Element-wise (Hadamard) product, with a scalar, a dense (m, n),
    (n,), (1, n) or (m, 1) operand, or a sparse matrix of a's shape."""
    from spmm_tpu_torch.sparse.coo import COO

    if not issparse(b):
        b = as_data(b, None, a.device)
        coo = a.tocoo()
        if b.dim() == 0:
            return a._with_data(a.data * b)
        if b.dim() == 2 and tuple(b.shape) == a.shape:
            picked = b[coo.row.long(), coo.col.long()]
        elif b.dim() == 1 and b.shape[0] == a.shape[1]:
            picked = b[coo.col.long()]  # row-vector broadcast
        elif b.dim() == 2 and tuple(b.shape) == (1, a.shape[1]):
            picked = b[0, coo.col.long()]
        elif b.dim() == 2 and tuple(b.shape) == (a.shape[0], 1):
            picked = b[coo.row.long(), 0]
        else:
            raise ValueError("unsupported multiply broadcast")
        return a._with_data(coo.data * picked).asformat(a.format)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch for multiply: {a.shape} vs "
                         f"{b.shape}")
    # intersection of the canonical patterns: a's values ride as (v, 0),
    # b's as (0, w); a position held by both sums to (v, w), one held by
    # one side to a product of 0, dropped below
    ca = a.tocoo().sum_duplicates()
    cb = b.tocoo().sum_duplicates()
    dtype = torch.promote_types(ca.dtype, cb.dtype)
    za = torch.zeros_like(ca.data, dtype=dtype)
    zb = torch.zeros_like(cb.data, dtype=dtype)
    va = torch.cat([ca.data.to(dtype), zb])
    vb = torch.cat([za, cb.data.to(dtype)])
    row_s, col_s, (va_s, vb_s) = prim.lexsort_rowcol(
        torch.cat([ca.row, cb.row]), torch.cat([ca.col, cb.col]), (va, vb),
        a.shape)
    nout = int(prim.count_unique_sorted(row_s, col_s))  # host sync
    r, c, da = prim.sum_duplicates_sorted(row_s, col_s, va_s, nout)
    _, _, db = prim.sum_duplicates_sorted(row_s, col_s, vb_s, nout)
    out = COO._wrap(r, c, da * db, a.shape, canonical=True).eliminate_zeros()
    return out.asformat(a.format)

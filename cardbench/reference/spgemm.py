"""Plain reference of C = A @ B for two CSR matrices, in plain PyTorch.

It imports nothing of the measured program.  It densifies row blocks of A
and all of B in float64, multiplies, and keeps every cell whose structural
count (the product of the 0/1 patterns) is above zero: the structure of
scipy's and cuSPARSE's product, where entries that cancel stay.  Sums of
products of float32 values are exact or nearly so in float64, so the
result stands for the exact product of the float32 operands.

`operand_round="tf32"` rounds both operands to TF32 (10 mantissa bits,
nearest, ties away from zero) before the product: the float32 product as
a TF32 GEMM computes it, the lower-precision control of a float32 cell;
`"float32"` rounds them to float32, the control of a float64 cell
(`reference/rounding.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cardbench.reference.rounding import rounded


def dense_rows(indptr, indices, data, r0: int, r1: int, cols: int,
               dtype) -> torch.Tensor:
    """Rows r0:r1 of a CSR as a dense (r1 - r0, cols) tensor."""
    ip = indptr.to(torch.int64)
    lo, hi = int(ip[r0]), int(ip[r1])
    counts = ip[r0 + 1:r1 + 1] - ip[r0:r1]
    rows = torch.repeat_interleave(
        torch.arange(r1 - r0, device=indptr.device), counts)
    out = torch.zeros((r1 - r0, cols), dtype=dtype, device=indptr.device)
    out.index_put_((rows, indices[lo:hi].to(torch.int64)),
                   data[lo:hi].to(dtype), accumulate=True)
    return out


def spgemm(a, b, operand_round: Optional[str] = None,
           block_rows: int = 2048
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(indptr int64, indices int64, data float64) of A @ B; `a` and `b`
    are (indptr, indices, data, shape), on any one device."""
    (a_ip, a_ix, a_v, (m, k)), (b_ip, b_ix, b_v, (_, n)) = a, b
    a_v, b_v = rounded(a_v, operand_round), rounded(b_v, operand_round)
    f64 = torch.float64
    bd = dense_rows(b_ip, b_ix, b_v, 0, k, n, f64)
    bp = dense_rows(b_ip, b_ix, torch.ones_like(b_v), 0, k, n, f64)
    counts, cols, vals = [], [], []
    for r0 in range(0, m, block_rows):
        r1 = min(m, r0 + block_rows)
        mask = (dense_rows(a_ip, a_ix, torch.ones_like(a_v), r0, r1, k, f64)
                @ bp) > 0
        c = dense_rows(a_ip, a_ix, a_v, r0, r1, k, f64) @ bd
        counts.append(mask.sum(1))
        cols.append(mask.nonzero()[:, 1])
        vals.append(c[mask])
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=a_ip.device)
    indptr[1:] = torch.cumsum(torch.cat(counts), 0)
    return indptr, torch.cat(cols), torch.cat(vals)

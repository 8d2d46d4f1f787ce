"""Plain reference of y = A @ x for a CSR A and a dense vector x, in plain
PyTorch.

It imports nothing of the measured program.  Each block of rows gathers
its entries' products a_ij * x_j in float64 and adds them into its rows
(`index_add_`).  Products and sums of float32 or float64 values in float64
stand for the exact product closely enough: a sum of a row's 27 terms in
float64 is off by a few units of 2^-53.

`operand_round` rounds A's values and x before the product
(`reference/rounding.py`): "float32" for the control of a float64 cell,
"tf32" for that of a float32 cell.
"""

from __future__ import annotations

from typing import Optional

import torch

from cardbench.reference.rounding import rounded


def spmv(a, x: torch.Tensor, operand_round: Optional[str] = None,
         block_rows: int = 2**18) -> torch.Tensor:
    """y (float64) of A @ x; `a` is (indptr, indices, data, shape), on x's
    device."""
    ip, ix, v, (m, _) = a
    f64 = torch.float64
    v = rounded(v, operand_round).to(f64)
    x = rounded(x, operand_round).to(f64)
    ip = ip.to(torch.int64)
    y = torch.zeros(m, dtype=f64, device=x.device)
    for r0 in range(0, m, block_rows):
        r1 = min(m, r0 + block_rows)
        lo, hi = int(ip[r0]), int(ip[r1])
        rows = torch.repeat_interleave(
            torch.arange(r0, r1, device=x.device), ip[r0 + 1:r1 + 1]
            - ip[r0:r1])
        y.index_add_(0, rows, v[lo:hi] * x[ix[lo:hi].to(torch.int64)])
    return y

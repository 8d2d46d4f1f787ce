"""Plain reference of Y = A @ H for a CSR A and a dense row-major H, in
plain PyTorch.

It imports nothing of the measured program.  It walks A's entries in
blocks of at most `block_entries` (not rows: a hub row of a power-law
graph holds 10^5 entries and more), gathers each entry's row of H in
float64, scales it by the entry's value and adds it into its row of Y
(`index_add_`).  Products of float32 values are exact in float64 and a
row's sum of up to 10^5 and more of them is off by a few units of 2^-53
of the row's magnitude, so Y stands for the exact product of the float32
operands.  The gathered block is what bounds the memory beside Y: 8 * k
bytes an entry of a block.

`operand_round` rounds A's values and H before the product
(`reference/rounding.py`): "tf32" for the control of a float32 cell,
"float32" for that of a float64 cell.
"""

from __future__ import annotations

from typing import Optional

import torch

from cardbench.reference.rounding import rounded


def spmm(a, h: torch.Tensor, operand_round: Optional[str] = None,
         block_entries: int = 2**21) -> torch.Tensor:
    """Y (float64, (m, k)) of A @ H; `a` is (indptr, indices, data, shape),
    on H's device."""
    ip, ix, v, (m, _) = a
    f64 = torch.float64
    v = rounded(v, operand_round).to(f64)
    h = rounded(h, operand_round).to(f64)
    dev = h.device
    nnz = ix.numel()
    y = torch.zeros((m, h.shape[1]), dtype=f64, device=dev)
    for e0 in range(0, nnz, block_entries):
        e1 = min(nnz, e0 + block_entries)
        e = torch.arange(e0, e1, device=dev, dtype=ip.dtype)
        # the row of entry e: the last r with indptr[r] <= e
        rows = torch.searchsorted(ip, e, right=True) - 1
        y.index_add_(0, rows, h[ix[e0:e1].to(torch.int64)] * v[e0:e1, None])
    return y

"""The work an SpMM call Y = A @ H asks for, from its inputs alone: A's
three arrays read once, each row of H that some entry of A references read
once, and Y written once; two operations for each entry of A and column of
H.  The count is the same whatever path computes Y."""

from __future__ import annotations

import torch

from cardbench.work.spgemm import csr_bytes


def spmm_call(a, k: int) -> dict:
    """`spmm(A, H)` with A (m, n) and H (n, k), H and Y in A's value
    type."""
    ip, ix, v, (m, n) = a
    vb = v.element_size()
    referenced = int((torch.bincount(ix.to(torch.int64), minlength=n) > 0)
                     .sum())
    return {"flops": 2 * ix.numel() * k,
            "bytes": csr_bytes(m, ix.numel(), ix.element_size(), vb)
            + (referenced + m) * k * vb}

"""The work an SpMV call asks for, from its inputs alone: A's three arrays
read once, x read once and y written once; two operations for each of A's
entries."""

from __future__ import annotations

from cardbench.work.spgemm import csr_bytes


def spmv_call(a) -> dict:
    """`spmv(A, x)` with A (m, n) and x, y in A's value type."""
    ip, ix, v, (m, n) = a
    vb = v.element_size()
    return {"flops": 2 * ix.numel(),
            "bytes": csr_bytes(m, ix.numel(), ix.element_size(), vb)
            + (n + m) * vb}

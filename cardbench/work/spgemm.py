"""The work a SpGEMM call asks for, from its inputs alone.

The count never depends on how the program computes C, so a change of
engine leaves it as it is.  Bytes: each array the call takes is read once
and each array it returns is written once.  Operations: two for each
product a_ik * b_kj that the structures of A and B imply.
"""

from __future__ import annotations

import torch


def products(a_indices: torch.Tensor, b_indptr: torch.Tensor) -> int:
    """P = the sum over A's entries (i, k) of the length of B's row k."""
    lens = (b_indptr[1:] - b_indptr[:-1]).to(torch.int64)
    return int(lens[a_indices.to(torch.int64)].sum())


def csr_bytes(rows: int, nnz: int, index_bytes: int, value_bytes: int) -> int:
    """indptr, indices and values of a CSR."""
    return (rows + 1) * index_bytes + nnz * (index_bytes + value_bytes)


def spgemm_call(a, b, nnz_c: int) -> dict:
    """`spgemm(A, B)`: A and B in, C out, all three whole."""
    (a_ip, a_ix, a_v, (m, _)), (b_ip, b_ix, b_v, (k, _)) = a, b
    vb, ib = a_v.element_size(), a_ix.element_size()
    return {"flops": 2 * products(a_ix, b_ip),
            "bytes": (csr_bytes(m, a_ix.numel(), ib, vb)
                      + csr_bytes(k, b_ix.numel(), ib, vb)
                      + csr_bytes(m, nnz_c, ib, vb))}


def plan_call(a, b, nnz_c: int) -> dict:
    """A serving plan's call: A's and B's values in, C's values out; the
    structures are the plan's constants."""
    a_v, b_v = a[2], b[2]
    vb = a_v.element_size()
    return {"flops": 2 * products(a[1], b[0]),
            "bytes": (a_v.numel() + b_v.numel() + nnz_c) * vb}

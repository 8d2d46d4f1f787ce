"""`@` dispatch with a sparse left operand.

Port of the sparse @ sparse branch of `spmm_tpu/ops/dispatch.py::matmul`:
both operands go to CSR, are canonicalised and meet in `spgemm`.  Sparse @
dense (SpMV, SpMM) is a later slice.
"""

from __future__ import annotations

from spmm_tpu_torch.ops.spgemm import spgemm


def matmul(a, b, alpha=1.0, alg: int = 0):
    """`a @ b` with `a` sparse."""
    from spmm_tpu_torch.sparse.base import issparse

    if not issparse(a):
        raise TypeError("matmul dispatch expects sparse lhs")
    if not issparse(b):
        raise NotImplementedError(
            "sparse @ dense (SpMV / SpMM) is not ported yet (ROADMAP §1.3)")
    return spgemm(a.tocsr().sum_duplicates(), b.tocsr().sum_duplicates(),
                  alpha=alpha, alg=alg)

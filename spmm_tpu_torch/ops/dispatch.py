"""`@` dispatch with a sparse operand, and the density-aware routing.

Port of `spmm_tpu/ops/dispatch.py` (`matmul`, `rmatmul`,
`break_even_density`, `_dense_fits`), following the reference table of
`csr_matrix.__mul__`:

    A @ B (sparse)   -> tocsr + sum_duplicates both -> spgemm
    A @ 1-D dense    -> spmv (of A.tocsr())
    A @ 2-D dense    -> spmm of A.tocsr() (dense when A's density reaches
                        the break-even curve and the dense operands fit)
    x @ A, X @ A     -> spmv(A, x, transa=True), spmm(A, X.T, transa=True).T

for A of any format (COO, CSR, CSC, BSR, DIA): as in JAX, a BSR @ dense
takes the CSR path; its own routes are `spmm(via="bsr"/"bsr_pallas")`.

The break-even curve is the JAX package's hard-coded fallback only.  Its
`.break_even.json` was measured on a TPU and is not read; an H100
calibration is ROADMAP §1.7.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.ops.spgemm import spgemm
from spmm_tpu_torch.ops.spmm import spmm
from spmm_tpu_torch.ops.spmv import as_dense, spmv


def break_even_density(m: int, k: int, n: int) -> float:
    """Density above which one dense GEMM beats the sparse paths, by
    problem scale (the JAX package's hard-coded curve, seeded from the
    reference's measured GPU curve, BASELINE.md §break-even)."""
    scale = max(m, k, n)
    if scale <= 2048:
        return 1.0
    if scale <= 8192:
        return 3e-2
    if scale <= 32768:
        return 1e-2
    return 3e-3


def _dense_fits(m: int, k: int, n: int, itemsize: int = 4,
                budget: int = int(4e9)) -> bool:
    return itemsize * (m * k + k * n + m * n) <= budget


def _ndim(b) -> int:
    return b.dim() if isinstance(b, torch.Tensor) else np.ndim(b)


def matmul(a, b, alpha=1.0, alg: int = 0, mode: str = "auto"):
    """`a @ b` with `a` sparse.  `mode`: "auto" (density-aware), "sparse",
    "dense"."""
    from spmm_tpu_torch.sparse.base import issparse

    if not issparse(a):
        raise TypeError("matmul dispatch expects sparse lhs")
    if not issparse(b):
        ndim = _ndim(b)
        if ndim == 1:
            return spmv(a, b, alpha=alpha)
        if ndim == 2:
            a_csr = a.tocsr()
            b = as_dense(b, a_csr, "matmul")
            m, k = a_csr.shape
            n = b.shape[1]
            if mode == "dense" or (
                    mode == "auto"
                    and a_csr.density >= break_even_density(m, k, n)
                    and _dense_fits(m, k, n)):
                return spmm(a_csr, b, alpha=alpha, via="dense")
            return spmm(a_csr, b, alpha=alpha)
        raise ValueError(f"cannot multiply sparse by {ndim}-D array")
    return spgemm(a.tocsr().sum_duplicates(), b.tocsr().sum_duplicates(),
                  alpha=alpha, alg=alg)


def rmatmul(a, other):
    """`other @ a` with `a` sparse, computed as (aᵀ @ otherᵀ)ᵀ."""
    from spmm_tpu_torch.sparse.base import issparse

    if issparse(other):
        return matmul(other, a)
    ndim = _ndim(other)
    if ndim == 1:
        return spmv(a.tocsr(), other, transa=True)
    if ndim == 2:
        other = as_dense(other, a, "rmatmul")
        return spmm(a.tocsr(), other.T, transa=True).T
    raise ValueError(f"cannot multiply {ndim}-D array by sparse")

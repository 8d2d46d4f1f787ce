"""spmm_tpu_torch — the PyTorch and CUDA port of spmm_tpu, for NVIDIA Hopper.

It is written beside the JAX package `spmm_tpu`, which stays the reference.
This slice carries the alg1 SpGEMM main path: a CSR container on an explicit
torch device, `random`, `spgemm(alg=0/1)`, `spgemm_fixed`, `@`, and two
hand-written CUDA kernels (densify, extract) built with `nvcc` for `sm_90a`
on first use.  On CPU tensors every kernel runs its plain PyTorch version.
It imports torch and never jax.
"""

from spmm_tpu_torch.ops import (  # noqa: F401
    matmul,
    spgemm,
    spgemm_fixed,
    spgemm_nnz_estimate,
)
from spmm_tpu_torch.sparse import (  # noqa: F401
    CSR,
    SparseMatrix,
    from_reference,
    random,
)

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "SparseMatrix",
    "from_reference",
    "matmul",
    "random",
    "spgemm",
    "spgemm_fixed",
    "spgemm_nnz_estimate",
]

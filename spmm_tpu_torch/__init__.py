"""spmm_tpu_torch — the PyTorch and CUDA port of spmm_tpu, for NVIDIA Hopper.

It is written beside the JAX package `spmm_tpu`, which stays the reference.
It carries the SpGEMM paths (a CSR container on an explicit torch device
with `sum_duplicates` and `sort_indices`, `random`, `spgemm` alg 0/1, the
blocked dense and the ESC alg 2/3, `spgemm_fixed`, and the fixed-structure
serving plans `spgemm_plan` / `SpgemmPlan`) and the SpMV/SpMM paths
(`spmv`, `spmv_plan`, `spmm`, `break_even_density`, and `A @ x`, `A @ X`,
`x @ A`, `X @ A`), with nine hand-written CUDA kernels built with `nvcc`
for `sm_90a` on first use.  Its constructors put data on the card unless
`device="cpu"` is passed; on CPU tensors every kernel runs its plain
PyTorch version.
It imports torch and never jax.
"""

from spmm_tpu_torch.ops import (  # noqa: F401
    break_even_density,
    SpgemmPlan,
    matmul,
    spgemm,
    spgemm_fixed,
    spgemm_nnz_estimate,
    spgemm_plan,
    spmm,
    spmv,
    spmv_plan,
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
    "SpgemmPlan",
    "break_even_density",
    "from_reference",
    "matmul",
    "random",
    "spgemm",
    "spgemm_fixed",
    "spgemm_nnz_estimate",
    "spgemm_plan",
    "spmm",
    "spmv",
    "spmv_plan",
]

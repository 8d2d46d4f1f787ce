"""spmm_tpu_torch — the PyTorch and CUDA port of spmm_tpu, for NVIDIA Hopper.

It is written beside the JAX package `spmm_tpu`, which stays the reference.
It carries the sparse containers (COO, CSR, CSC, BSR and DIA on an explicit
torch device, with the conversions between them, the constructors,
`find`/`tril`/`triu`, element-wise and data ops, and io), the SpGEMM paths
(`spgemm` alg 0/1, the blocked dense and the ESC alg 2/3, `spgemm_fixed`,
and the fixed-structure serving plans `spgemm_plan` / `SpgemmPlan`) and the
SpMV/SpMM paths (`spmv`, `spmv_plan`, `spmm` with its CSR, dense and BSR
routes, `break_even_density` with its table measured on the card, and
`A @ x`, `A @ X`, `x @ A`, `X @ A` for every format) in JAX's dtypes and
precision modes, `sddmm`, CSR indexing and assignment (`A[...]`,
`A[...] = B`, `setdiag`, `getcol`), the profiler (`utils`), the headline
script (`python3 -m spmm_tpu_torch.bench`), the speed drivers
(`spmm_tpu_torch.benchmarks`), the determinism, native cross-check and
numerical-error suites (`spmm_tpu_torch.experiments`) and distribution on
`torch.distributed` (`spmm_tpu_torch.parallel`: one process per rank,
row-sharded SpMV, SpMM and SpGEMM, the sparse collectives, SUMMA), with eleven
hand-written CUDA kernels in place of the
Pallas ones, and two of the port's own (the in-order segment sum and the
binned SpMV plan), built with `nvcc` for `sm_90a` on first use.  Its
constructors put data on the card unless `device="cpu"` is passed, or the
tensors they are given lie elsewhere; on CPU tensors every kernel runs its
plain PyTorch version.
It imports torch and never jax.
"""

from spmm_tpu_torch.ops import (  # noqa: F401
    break_even_density,
    SpgemmPlan,
    matmul,
    sddmm,
    spgemm,
    spgemm_fixed,
    spgemm_nnz_estimate,
    spgemm_plan,
    spmm,
    spmv,
    spmv_plan,
)
from spmm_tpu_torch.sparse import (  # noqa: F401
    BSR,
    COO,
    CSC,
    CSR,
    DIA,
    SparseMatrix,
    bmat,
    diags,
    eye,
    from_reference,
    hstack,
    identity,
    issparse,
    isspmatrix,
    rand,
    random,
    spdiags,
    vstack,
)

from spmm_tpu_torch import utils  # noqa: F401,E402

__version__ = "0.1.0"

__all__ = [
    "BSR",
    "COO",
    "CSC",
    "CSR",
    "DIA",
    "SparseMatrix",
    "SpgemmPlan",
    "bmat",
    "break_even_density",
    "diags",
    "eye",
    "from_reference",
    "hstack",
    "identity",
    "issparse",
    "isspmatrix",
    "matmul",
    "rand",
    "random",
    "sddmm",
    "spdiags",
    "spgemm",
    "spgemm_fixed",
    "spgemm_nnz_estimate",
    "spgemm_plan",
    "spmm",
    "spmv",
    "spmv_plan",
    "vstack",
]

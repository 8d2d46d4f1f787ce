"""Sparse operations of the port: alg1 SpGEMM and `@` dispatch."""

from spmm_tpu_torch.ops.dispatch import matmul  # noqa: F401
from spmm_tpu_torch.ops.spgemm import (  # noqa: F401
    spgemm,
    spgemm_fixed,
    spgemm_nnz_estimate,
)

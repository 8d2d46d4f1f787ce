"""Sparse operations of the port: SpGEMM (alg1, the blocked dense
alg2/alg3 engines and ESC alg2/alg3), fixed-structure serving plans, SpMV,
SpMM and `@` dispatch."""

from spmm_tpu_torch.ops.dispatch import (  # noqa: F401
    break_even_density,
    matmul,
)
from spmm_tpu_torch.ops.serving import SpgemmPlan, spgemm_plan  # noqa: F401
from spmm_tpu_torch.ops.spgemm import (  # noqa: F401
    spgemm,
    spgemm_fixed,
    spgemm_nnz_estimate,
)
from spmm_tpu_torch.ops.spmm import spmm  # noqa: F401
from spmm_tpu_torch.ops.spmv import spmv, spmv_plan  # noqa: F401

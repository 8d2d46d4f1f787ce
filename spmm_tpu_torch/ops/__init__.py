"""Sparse operations of the port: SpGEMM (alg1, the blocked dense
alg2/alg3 engines and ESC alg2/alg3), fixed-structure serving plans, SpMV,
SpMM, SDDMM, `@` dispatch and the availability table."""

from spmm_tpu_torch.ops.availability import (  # noqa: F401
    check_availability,
    has_fast_path,
)
from spmm_tpu_torch.ops.dispatch import (  # noqa: F401
    break_even_density,
    matmul,
    reload_break_even,
)
from spmm_tpu_torch.ops.sddmm import sddmm  # noqa: F401
from spmm_tpu_torch.ops.serving import SpgemmPlan, spgemm_plan  # noqa: F401
from spmm_tpu_torch.ops.spgemm import (  # noqa: F401
    spgemm,
    spgemm_fixed,
    spgemm_nnz_estimate,
)
from spmm_tpu_torch.ops.spmm import spmm  # noqa: F401
from spmm_tpu_torch.ops.spmv import spmv, spmv_plan  # noqa: F401

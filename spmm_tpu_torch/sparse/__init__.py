"""Sparse containers of the port (CSR in this slice)."""

from spmm_tpu_torch.sparse.base import SparseMatrix, issparse  # noqa: F401
from spmm_tpu_torch.sparse.construct import random  # noqa: F401
from spmm_tpu_torch.sparse.convert import from_reference  # noqa: F401
from spmm_tpu_torch.sparse.csr import CSR  # noqa: F401

"""Sparse containers and constructors of the port (the
`spmm_tpu.sparse` / `cupyx.scipy.sparse` analogue)."""

from spmm_tpu_torch.sparse.base import (  # noqa: F401
    SparseMatrix,
    issparse,
    isspmatrix,
)
from spmm_tpu_torch.sparse.coo import COO  # noqa: F401
from spmm_tpu_torch.sparse.csr import CSR  # noqa: F401
from spmm_tpu_torch.sparse.csc import CSC  # noqa: F401
from spmm_tpu_torch.sparse.bsr import BSR  # noqa: F401
from spmm_tpu_torch.sparse.dia import DIA  # noqa: F401
from spmm_tpu_torch.sparse.construct import (  # noqa: F401
    bmat,
    diags,
    eye,
    hstack,
    identity,
    kron,
    kronsum,
    rand,
    random,
    spdiags,
    vstack,
)
from spmm_tpu_torch.sparse.extract import find, tril, triu  # noqa: F401
from spmm_tpu_torch.sparse import convert  # noqa: F401
from spmm_tpu_torch.sparse.convert import from_reference  # noqa: F401

# scipy-style aliases
coo_matrix = COO
csr_matrix = CSR
csc_matrix = CSC
bsr_matrix = BSR
dia_matrix = DIA


def isspmatrix_csr(x):
    return isinstance(x, CSR)


def isspmatrix_dia(x):
    return isinstance(x, DIA)


def isspmatrix_csc(x):
    return isinstance(x, CSC)


def isspmatrix_coo(x):
    return isinstance(x, COO)

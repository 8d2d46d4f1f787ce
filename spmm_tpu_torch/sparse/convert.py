"""Dense <-> sparse conversion, and carrying a matrix across from another
package.

Port of `spmm_tpu/sparse/convert.py`: the nonzero count of a dense array is
read back once, then the nonzeros are compacted in row-major order.
`from_reference` takes any matrix with scipy's attributes for its format
(a `spmm_tpu` container, a scipy matrix), reads its arrays through
`np.asarray` and returns the port's container of that format.  It names no
other package, so it imports where only torch is installed.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.base import as_data, issparse, resolve_device


def dense_to_coo(x, dtype=None, device=None):
    """Canonical COO of the nonzeros of a 2-D tensor or array, on `device`
    (default: the tensor's device, else the card)."""
    from spmm_tpu_torch.sparse.coo import COO

    x = as_data(x, dtype, resolve_device(device, x))
    if x.dim() != 2:
        raise ValueError("expected a 2-D array")
    n = x.shape[1]
    mask = (x != 0).reshape(-1)
    flat = prim.compact_positions(mask, int(mask.sum()))  # host sync
    return COO._wrap(flat // n, flat % n, x.reshape(-1)[flat], tuple(x.shape),
                     canonical=True)


def dense_to_csr(x, dtype=None, device=None):
    return dense_to_coo(x, dtype, device).tocsr()


def dense_to_csc(x, dtype=None, device=None):
    return dense_to_coo(x, dtype, device).tocsc()


def to_dense(a):
    return a.toarray() if issparse(a) else torch.as_tensor(a)


def from_reference(obj, device="cuda"):
    """The port's container of `obj`'s format (COO, CSR, CSC, BSR or DIA)
    holding the same arrays, on the card unless `device` says otherwise."""
    from spmm_tpu_torch import sparse

    fmt = getattr(obj, "format", "csr")
    shape = tuple(obj.shape)
    canonical = bool(getattr(obj, "has_canonical_format", False))
    if fmt in ("csr", "csc"):
        cls = sparse.CSR if fmt == "csr" else sparse.CSC
        return cls.from_parts(np.asarray(obj.indptr), np.asarray(obj.indices),
                              np.asarray(obj.data), shape,
                              canonical=canonical, device=device)
    if fmt == "coo":
        return sparse.COO.from_parts(np.asarray(obj.row), np.asarray(obj.col),
                                     np.asarray(obj.data), shape,
                                     canonical=canonical, device=device)
    if fmt == "bsr":
        return sparse.BSR.from_parts(np.asarray(obj.indptr),
                                     np.asarray(obj.indices),
                                     np.asarray(obj.data), shape,
                                     device=device)
    if fmt == "dia":
        dev = resolve_device(device)
        return sparse.DIA.from_parts(torch.as_tensor(np.asarray(obj.data),
                                                     device=dev),
                                     np.asarray(obj.offsets), shape)
    raise TypeError(f"from_reference: unknown format {fmt!r}")

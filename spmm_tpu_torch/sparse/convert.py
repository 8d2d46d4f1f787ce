"""Carry a CSR across from another package.

`from_reference` takes any CSR-like object with `.indptr/.indices/.data/
.shape` (a `spmm_tpu.CSR`, a scipy CSR matrix), reads its arrays through
`np.asarray` and returns the port's CSR, canonical flag kept.  It names no
other package, so it imports where only torch is installed.
"""

from __future__ import annotations

import numpy as np

from spmm_tpu_torch.sparse.csr import CSR


def from_reference(obj, device="cuda") -> CSR:
    """The port's CSR holding the same indptr, indices and data as `obj`,
    on the card unless `device` says otherwise."""
    fmt = getattr(obj, "format", "csr")
    if fmt != "csr":
        raise TypeError(f"from_reference expects a CSR matrix, got format "
                        f"{fmt!r}")
    return CSR.from_parts(np.asarray(obj.indptr), np.asarray(obj.indices),
                          np.asarray(obj.data), tuple(obj.shape),
                          canonical=bool(obj.has_canonical_format),
                          device=device)

"""Sparse matrix constructors.

Port of `spmm_tpu/sparse/construct.py::random`, with the same semantics:
exactly ``int(density*m*n)`` distinct positions drawn uniformly without
replacement from the flattened index space, values U[0,1).  It draws with a
`numpy.random.Generator`, so the bits differ from `spmm_tpu.random` (which
uses `jax.random`) for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.sparse.csr import CSR


def random(m: int, n: int, density: float = 0.01, format: str = "csr",
           dtype: torch.dtype = torch.float32, seed=None,
           device="cpu") -> CSR:
    """Random canonical CSR with exactly ``int(density*m*n)`` entries.

    `seed` is an int, None, or a `numpy.random.Generator` to draw from.
    """
    if format != "csr":
        raise NotImplementedError(
            f"random(format={format!r}): only CSR is ported yet (ROADMAP "
            "§1.8, containers)")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"random: dtype must be float32 or float64, got "
                         f"{dtype}")
    if not 0 <= density <= 1:
        raise ValueError("density expected to be 0 <= density <= 1")
    m, n = int(m), int(n)
    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    k = int(density * m * n)
    flat = np.sort(rng.choice(m * n, size=k, replace=False)).astype(np.int64)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    data = torch.from_numpy(rng.random(k, dtype=np_dtype))
    indptr = prim.build_indptr(torch.from_numpy(flat // n), m)
    indices = torch.from_numpy((flat % n).astype(np.int32))
    return CSR.from_parts(indptr, indices, data, (m, n), canonical=True,
                          device=device)

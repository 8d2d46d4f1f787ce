"""Law `uniform`: the upstream's `scipy.sparse.random(..., format="csr")`
matrices.  A spec reads

    {"rows": 1024, "cols": 1024, "density": 0.1, "seed_offset": 0}

and becomes a canonical CSR (sorted, unique columns in each row) with
exactly `int(density * rows * cols)` entries at positions drawn uniformly
without replacement and values drawn from U[0, 1).  Each matrix has its own
`torch.Generator` on the device, seeded with the run's seed plus its
`seed_offset`; a few large calls make it, and the same seed gives the same
matrix on the same kind of device.
"""

from __future__ import annotations

import torch

from cardbench.operands import Csr, generator


def uniform_csr(rows: int, cols: int, density: float, seed: int,
                dtype=torch.float32, device="cuda") -> Csr:
    """`int(density * rows * cols)` uniform positions, U[0, 1) values."""
    g = generator(seed, device)
    k = int(density * rows * cols)
    flat = torch.randperm(rows * cols, generator=g, device=device,
                          dtype=torch.int64)[:k].sort().values
    data = torch.rand(k, generator=g, device=device, dtype=dtype)
    counts = torch.bincount(flat // cols, minlength=rows)
    indptr = torch.zeros(rows + 1, dtype=torch.int32, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    return Csr(indptr, (flat % cols).to(torch.int32), data, (rows, cols))


def make(spec: dict, seed: int, dtype, device) -> Csr:
    return uniform_csr(spec["rows"], spec["cols"], spec["density"],
                       seed + spec["seed_offset"], dtype, device)


def small(spec: dict) -> dict:
    """At most 64 rows and columns, at least 0.1 dense, so that a product
    of two has entries to alter and rows to leave out."""
    return dict(spec, rows=min(spec["rows"], 64), cols=min(spec["cols"], 64),
                density=max(spec["density"], 0.1))

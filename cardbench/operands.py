"""Operands of a configuration, made from the run's seed on the device.

A matrix entry of a configuration file reads

    {"rows": 1024, "cols": 1024, "density": 0.1, "seed_offset": 0}

and becomes a canonical CSR (sorted, unique columns in each row) with
exactly `int(density * rows * cols)` entries at positions drawn uniformly
without replacement and values drawn from U[0, 1), as the upstream's
`scipy.sparse.random(..., format="csr")` matrices.  Each matrix has its
own `torch.Generator` on the device, seeded with the run's seed plus its
`seed_offset`; a few large calls make it, and the same seed gives the same
matrix on the same kind of device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Csr(NamedTuple):
    """A CSR made by the benchmark: int32 indptr and indices, values."""
    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


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


def values_pool(count: int, nnz: int, seed: int, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """(count, nnz) values from U[0, 1): new values for a fixed structure."""
    return torch.rand((count, nnz), generator=generator(seed, device),
                      device=device, dtype=dtype)


def make(config: dict, seed: int, device) -> Dict[str, Csr]:
    """Every matrix the configuration names, from `seed`."""
    dtype = DTYPES[config["dtype"]]
    return {name: uniform_csr(m["rows"], m["cols"], m["density"],
                              seed + m["seed_offset"], dtype, device)
            for name, m in config["matrices"].items()}

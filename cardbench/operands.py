"""Operands of a configuration, made from the run's seed on the device.

Each matrix entry of a configuration file is made by its law,
`laws/<law>.py`, found by the name in its `"law"` key; an entry without
one is `uniform` (`laws/uniform.py`: the upstream's scipy.sparse.random
matrices).  Every law gives a canonical CSR with int32 indices, in the
configuration's dtype, on the run's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from cardbench.files import load_file

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


def values_pool(count: int, nnz: int, seed: int, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """(count, nnz) values from U[0, 1): new values for a fixed structure,
    or a pool of dense vectors."""
    return torch.rand((count, nnz), generator=generator(seed, device),
                      device=device, dtype=dtype)


def law(spec: dict, root: Path):
    """The law module of a matrix entry of a configuration."""
    name = spec.get("law", "uniform")
    return load_file(root / "cardbench" / "laws" / f"{name}.py")


def make(config: dict, seed: int, device, root: Path) -> Dict[str, Csr]:
    """Every matrix the configuration names, from `seed`."""
    dtype = DTYPES[config["dtype"]]
    return {name: law(m, root).make(m, seed, dtype, device)
            for name, m in config["matrices"].items()}


def small(config: dict, root: Path) -> dict:
    """The patch of `config` that runs it at its laws' small sizes."""
    return {"matrices": {name: law(m, root).small(m)
                         for name, m in config["matrices"].items()}}

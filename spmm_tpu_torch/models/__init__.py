"""Synthetic matrix families of the port (numpy-seeded)."""

from spmm_tpu_torch.models.matrices import (  # noqa: F401
    FAMILIES,
    banded,
    block_sparse,
    power_law_rows,
    uniform,
)

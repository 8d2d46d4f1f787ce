"""Synthetic matrix families of the port (numpy-seeded)."""

from spmm_tpu_torch.models.matrices import power_law_rows  # noqa: F401

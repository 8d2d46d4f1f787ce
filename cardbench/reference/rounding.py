"""Operands rounded to the precision just below a configuration's dtype:
the lower-precision control of a cell, the reference put in the program's
place.  float32 goes to TF32 (10 mantissa bits, nearest, ties away from
zero), as a TF32 GEMM rounds its operands; float64 goes to float32.  The
references then compute in float64 from the rounded operands."""

from __future__ import annotations

import torch

LOWER = {torch.float32: "tf32", torch.float64: "float32"}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, as float32."""
    x = x.to(torch.float32).contiguous()
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def rounded(x: torch.Tensor, how) -> torch.Tensor:
    """`x` rounded as `how` says: None (unchanged), "tf32" or "float32"."""
    if how is None:
        return x
    if how == "tf32":
        return round_tf32(x)
    if how == "float32":
        return x.to(torch.float32)
    raise ValueError(f"unknown operand_round {how!r}")

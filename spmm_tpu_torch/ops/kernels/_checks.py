"""Argument checks shared by the SpMV/SpMM kernel wrappers.

A wrapper raises on what its kernel does not take, before it launches:
wrong types, shapes or strides, and tensors on different devices (a plan
built on one device and used with x on another).
"""

from __future__ import annotations

import torch

from spmm_tpu_torch.ops import _primitives as prim


def check_csr(indptr, indices, data, m: int, what: str) -> None:
    """A CSR's arrays: contiguous 1-D int32 / int32 / float32 on one CPU or
    CUDA device, indptr of length m + 1.  `data` None checks the structure
    alone (against the device of `indices`)."""
    arrays = [("indptr", indptr, prim.INDEX_DTYPE),
              ("indices", indices, prim.INDEX_DTYPE)]
    if data is not None:
        arrays.append(("data", data, torch.float32))
    ref, ref_name = arrays[-1][1], arrays[-1][0]
    for name, t, dtype in arrays:
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 1-D "
                             f"{dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} is on {t.device}, {ref_name} "
                             f"on {ref.device}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {ref.device}")
    if indptr.numel() != m + 1:
        raise ValueError(f"{what}: indptr has {indptr.numel()} entries for "
                         f"{m} rows")
    if data is not None and indices.numel() != data.numel():
        raise ValueError(f"{what}: indices and data differ in length")


def check_dense(x, ndim: int, n: int, device: torch.device,
                what: str) -> None:
    """x must be a contiguous float32 tensor of `ndim` dimensions (a vector,
    or a row-major matrix) with n rows, on the plan's device."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
            or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous {ndim}-D float32 "
                         f"tensor")
    if x.shape[0] != n:
        raise ValueError(f"{what}: x has {x.shape[0]} rows, the plan {n} "
                         f"columns")
    if x.device != device:
        raise ValueError(f"{what}: x is on {x.device}, the plan on "
                         f"{device}")

"""Argument checks shared by the SpMV/SpMM kernel wrappers.

A wrapper raises on what its kernel does not take, before it launches:
wrong types, shapes or strides, and tensors on different devices (a plan
built on one device and used with x on another).
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim


def csr_for_plan(indptr, indices, data, device):
    """A plan's CSR (indptr, indices, data) as tensors: tensors stay where
    they lie, in their dtypes (moved to `device` where it is given); host
    arrays, as JAX's plan functions take them, become int32 / int32 /
    float32 (float64 values too, as JAX's do) and go to the card unless
    `device="cpu"` is given, and raise where there is no card (no quiet
    fallback to the CPU)."""
    from spmm_tpu_torch.sparse.base import checked_device

    arrays = (indptr, indices, data)
    if all(isinstance(t, torch.Tensor) for t in arrays):
        if device is None:
            return arrays
        dev = checked_device(device)
        return tuple(t.to(dev) for t in arrays)
    dev = checked_device(device or "cuda")
    return tuple(torch.as_tensor(np.ascontiguousarray(t, dtype), device=dev)
                 if not isinstance(t, torch.Tensor) else t.to(dev)
                 for t, dtype in zip(arrays, (np.int32, np.int32,
                                              np.float32)))


def check_csr(indptr, indices, data, m: int, what: str,
              dtypes=(torch.float32,)) -> None:
    """A CSR's arrays: contiguous 1-D int32 / int32 / float32 on one CPU or
    CUDA device, indptr of length m + 1.  `data` None checks the structure
    alone (against the device of `indices`); data may be of any dtype in
    `dtypes` (the routed plan's: float32 and float64)."""
    arrays = [("indptr", indptr, prim.INDEX_DTYPE),
              ("indices", indices, prim.INDEX_DTYPE)]
    if data is not None:
        arrays.append(("data", data, data.dtype if data.dtype in dtypes
                       else dtypes[0]))
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
                what: str, dtype=torch.float32) -> None:
    """x must be a contiguous tensor of `dtype` (the plan's: float32, or
    float64 for a float64 routed plan) of `ndim` dimensions (a vector, or a
    row-major matrix) with n rows, on the plan's device."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype \
            or x.dim() != ndim or not x.is_contiguous():
        name = str(dtype).removeprefix("torch.")
        raise ValueError(f"{what}: x must be a contiguous {ndim}-D {name} "
                         f"tensor")
    if x.shape[0] != n:
        raise ValueError(f"{what}: x has {x.shape[0]} rows, the plan {n} "
                         f"columns")
    if x.device != device:
        raise ValueError(f"{what}: x is on {x.device}, the plan on "
                         f"{device}")


def check_spmv_call(indptr, indices, data, x, on_plan, m: int, n: int,
                    nnz: int, what: str) -> None:
    """One SpMV call over a plan that was validated when it was built (for
    an (m, n) matrix of nnz entries, with `on_plan` one of its tensors):
    the CSR's and x's types, lengths, contiguity and device, read in one
    expression, since this runs on every call; the detailed checks above
    run only to word the error."""
    dev = data.get_device()
    if (isinstance(x, torch.Tensor)
            and indptr.dtype == indices.dtype == prim.INDEX_DTYPE
            and data.dtype == x.dtype == torch.float32
            and indptr.shape == (m + 1,) and x.shape == (n,)
            and indices.shape == data.shape == (nnz,)
            and indptr.get_device() == indices.get_device() == dev
            and x.get_device() == on_plan.get_device() == dev
            and indptr.is_contiguous() and indices.is_contiguous()
            and data.is_contiguous() and x.is_contiguous()):
        return
    check_csr(indptr, indices, data, m, what)
    check_dense(x, 1, n, data.device, what)
    raise ValueError(f"{what}: the plan is for a matrix with {nnz} entries "
                     f"on {on_plan.device}, not {data.numel()} on "
                     f"{data.device}")

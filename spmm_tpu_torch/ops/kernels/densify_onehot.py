"""Canonical CSR -> dense f32 values + bf16 structural 0/1 pattern.

Port of `spmm_tpu/ops/kernels/densify_onehot.py::densify_onehot`.  On a CUDA
tensor the wrapper launches the hand-written kernel `csrc/densify.cu` (one
warp per row, a direct scatter: canonical positions are unique, so no
atomics); on a CPU tensor it runs `densify_onehot_plain`.  Both give the
same bits: values are moved, never computed.

The TPU kernel's static chunk plan (`densify_onehot_plan`) and its bf16
value splits exist because the TPU has no vector scatter; the CUDA kernel
needs neither, so the port takes no plan.  Bound on the card: the zero-fill
of the outputs (6 bytes a dense cell), not the scatter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import check_csr


def densify_onehot_plain(indptr: torch.Tensor, indices: torch.Tensor,
                         data: torch.Tensor, m: int, k: int,
                         with_pattern: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel, on any device."""
    val = prim.csr_to_dense_canonical(indptr, indices, data, (m, k))
    if not with_pattern:
        return val, None
    ones = torch.ones_like(data, dtype=torch.bfloat16)
    pat = prim.csr_to_dense_canonical(indptr, indices, ones, (m, k))
    return val, pat


def densify_onehot(indptr: torch.Tensor, indices: torch.Tensor,
                   data: torch.Tensor, m: int, k: int,
                   with_pattern: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dense (m, k) f32 values and, when `with_pattern`, the (m, k) bf16
    structural 0/1 pattern (explicit zeros kept) of a canonical CSR."""
    check_csr(indptr, indices, data, m, "densify_onehot")
    if data.device.type == "cpu":
        return densify_onehot_plain(indptr, indices, data, m, k, with_pattern)
    val = torch.zeros((m, k), dtype=torch.float32, device=data.device)
    pat = (torch.zeros((m, k), dtype=torch.bfloat16, device=data.device)
           if with_pattern else None)
    if m == 0 or k == 0 or data.numel() == 0:
        return val, pat  # a zero-size grid is a launch error
    lib = _build.library()
    with torch.cuda.device(data.device):
        err = lib.spmm_densify(
            indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
            val.data_ptr(), pat.data_ptr() if with_pattern else None,
            m, k, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "densify_onehot")
    _build.LAUNCHES["densify_onehot"] += 1
    return val, pat

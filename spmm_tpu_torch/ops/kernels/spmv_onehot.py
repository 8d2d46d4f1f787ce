"""SpMV over fixed entry chunks: balanced under any skew, one launch.

Port of `spmm_tpu/ops/kernels/spmv_onehot.py` (`spmv_onehot_plan`, Pallas
`spmv_onehot`).  The TPU kernel gathers x and reduces rows with one-hot MXU
contractions over bf16 triples, because it can neither gather nor scatter;
on Hopper both are native.  What carries over is the plan: the entries are
cut into chunks of `ch`, and each chunk knows its rows.  Here a chunk owns
the rows whose first entry lies in it (`own`; the last chunk also the
trailing empty rows) and knows the row of its first entry (`row_s`, the TPU
plan's `r0s`).  `csrc/spmv_onehot.cu` gives each chunk a block that writes
every row it owns once; a row running past its chunk is closed in the same
launch by the last of its chunks to finish, picked by the plan's integer
counters, so y needs no memset and a call is one launch.

The plan is validated once, when it is built; a call checks only what a
launch needs to stay in bounds.  Not copied from the TPU plan: `W_MAX` (its
row window must fit the VMEM accumulator) and the VMEM bounds on n and m,
and its None for an empty matrix (the public `spmv_plan` keeps that None).
Any canonical f32 CSR gets a plan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import check_spmv_call

CH_DEFAULT = 2048
BLOCK = 256
CH_CHOICES = tuple(BLOCK << i for i in range(5))  # the kernel's chunk sizes


class SpmvOnehotPlan(NamedTuple):
    m: int
    n: int
    nnz: int
    ch: int                # entries per chunk
    row_s: torch.Tensor    # (nchunks,) i32 — row of each chunk's first entry
    own: torch.Tensor      # (nchunks+1,) i32 — first row each chunk owns
    counters: torch.Tensor  # (nchunks,) i32 — zeros; one per chunk's last row
    carry: torch.Tensor    # (2*nchunks,) f32 — scratch: edge pieces

    @property
    def nchunks(self) -> int:
        return int(self.row_s.numel())


def spmv_onehot_plan(indptr, m: int, n: int, ch: int = CH_DEFAULT,
                     device=None) -> SpmvOnehotPlan:
    """Chunk plan of a CSR's indptr, with one host read of nnz.

    A tensor's plan lies on the tensor's device (or on `device`, where it
    is given); a host array's plan goes to the card unless `device="cpu"`
    is given, and raises where there is no card, as the constructors do."""
    from spmm_tpu_torch.sparse.base import checked_device

    if ch not in CH_CHOICES:
        raise ValueError(f"spmv_onehot_plan: ch must be a multiple of "
                         f"{BLOCK}, one of {CH_CHOICES}, got {ch}")
    if isinstance(indptr, torch.Tensor):
        if device is not None:
            indptr = indptr.to(checked_device(device))
    else:
        indptr = torch.as_tensor(np.asarray(indptr, np.int32),
                                 device=checked_device(device or "cuda"))
    if indptr.dtype != prim.INDEX_DTYPE or indptr.dim() != 1 \
            or indptr.numel() != m + 1:
        raise ValueError(f"spmv_onehot_plan: indptr must be int32 with "
                         f"{m + 1} entries")
    nnz = int(indptr[-1])
    nchunks = max(1, -(-nnz // ch))
    dev = indptr.device
    starts = torch.arange(nchunks, dtype=torch.int64, device=dev) * ch
    ip = indptr.long()
    row_s = (torch.searchsorted(ip, starts, right=True) - 1).clamp_(0)
    own = torch.searchsorted(ip[:-1], starts)
    own = torch.cat([own, own.new_full((1,), m)])
    return SpmvOnehotPlan(
        m, n, nnz, ch, row_s.to(prim.INDEX_DTYPE), own.to(prim.INDEX_DTYPE),
        torch.zeros(nchunks, dtype=prim.INDEX_DTYPE, device=dev),
        torch.empty(2 * nchunks, dtype=torch.float32, device=dev))


def spmv_onehot_plain(indptr, indices, data, x, m: int, n: int,
                      plan: SpmvOnehotPlan) -> torch.Tensor:
    """Plain PyTorch version: per-row sums of data * x[indices]."""
    return prim.segment_sum_rows(data * x[indices.long()], indptr)


def spmv_onehot(indptr: torch.Tensor, indices: torch.Tensor,
                data: torch.Tensor, x: torch.Tensor, m: int, n: int,
                plan: SpmvOnehotPlan) -> torch.Tensor:
    """y = A @ x, (m,) f32, for a canonical CSR A (m, n) and its plan."""
    if (plan.m, plan.n) != (m, n):
        raise ValueError(f"spmv_onehot: the plan is for a {plan.m}x{plan.n} "
                         f"matrix, not {m}x{n}")
    check_spmv_call(indptr, indices, data, x, plan.own, m, n, plan.nnz,
                    "spmv_onehot")
    if not data.is_cuda:
        return spmv_onehot_plain(indptr, indices, data, x, m, n, plan)
    y = data.new_empty(m)
    if m == 0:
        return y  # a zero-size grid is a launch error
    err = _build.launch(
        data.get_device(), "spmm_spmv_onehot", indptr.data_ptr(),
        indices.data_ptr(), data.data_ptr(), x.data_ptr(),
        plan.row_s.data_ptr(), plan.own.data_ptr(), plan.nchunks,
        plan.ch, plan.nnz, plan.counters.data_ptr(), plan.carry.data_ptr(),
        y.data_ptr())
    _build.check(err, "spmv_onehot")
    _build.LAUNCHES["spmv_onehot"] += 1
    return y

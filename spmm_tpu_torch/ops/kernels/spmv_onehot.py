"""SpMV over fixed entry chunks with row windows: balanced under any skew.

Port of `spmm_tpu/ops/kernels/spmv_onehot.py` (`spmv_onehot_plan`, Pallas
`spmv_onehot`).  The TPU kernel gathers x and reduces rows with one-hot MXU
contractions over bf16 triples, because it can neither gather nor scatter;
on Hopper both are native.  What carries over is the plan: the entries are
cut into chunks of `ch`, and each chunk knows its row window, here the rows
of its first and last entries (`row_s`, `row_e`; the TPU plan's `r0s` and
`W`).  `csrc/spmv_onehot.cu` gives each chunk a block that writes the rows
it holds whole and passes its two edge rows to a carry buffer, which a
second small launch adds in chunk order.

Not copied from the TPU plan: `W_MAX` (its row window must fit the VMEM
accumulator) and the VMEM bounds on n and m, and its None for an empty
matrix (the public `spmv_plan` keeps that None).  Any canonical f32 CSR
gets a plan.  `ch` must be a positive multiple of 256, the kernel's block.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import check_csr, check_dense

CH_DEFAULT = 1024
BLOCK = 256


class SpmvOnehotPlan(NamedTuple):
    m: int
    n: int
    nnz: int
    ch: int                # entries per chunk
    row_s: torch.Tensor    # (nchunks,) i32 — row of each chunk's first entry
    row_e: torch.Tensor    # (nchunks,) i32 — row of each chunk's last entry

    @property
    def nchunks(self) -> int:
        return int(self.row_s.numel())


def spmv_onehot_plan(indptr, m: int, n: int,
                     ch: int = CH_DEFAULT) -> SpmvOnehotPlan:
    """Chunk plan of a CSR's indptr (a tensor, on its device, or a host
    array), with one host read of nnz."""
    if ch < BLOCK or ch % BLOCK:
        raise ValueError(f"spmv_onehot_plan: ch must be a positive multiple "
                         f"of {BLOCK}, got {ch}")
    if not isinstance(indptr, torch.Tensor):
        indptr = torch.as_tensor(np.asarray(indptr, np.int32))
    if indptr.dtype != prim.INDEX_DTYPE or indptr.numel() != m + 1:
        raise ValueError(f"spmv_onehot_plan: indptr must be int32 with "
                         f"{m + 1} entries")
    nnz = int(indptr[-1])
    starts = torch.arange(0, nnz, ch, dtype=torch.int64,
                          device=indptr.device)
    lasts = torch.clamp(starts + ch, max=nnz) - 1
    ip = indptr.long()
    row_s = torch.searchsorted(ip, starts, right=True) - 1
    row_e = torch.searchsorted(ip, lasts, right=True) - 1
    return SpmvOnehotPlan(m, n, nnz, ch, row_s.to(prim.INDEX_DTYPE),
                          row_e.to(prim.INDEX_DTYPE))


def spmv_onehot_plain(indptr, indices, data, x, m: int, n: int,
                      plan: SpmvOnehotPlan) -> torch.Tensor:
    """Plain PyTorch version: per-row sums of data * x[indices]."""
    return prim.segment_sum_rows(data * x[indices.long()], indptr)


def spmv_onehot(indptr: torch.Tensor, indices: torch.Tensor,
                data: torch.Tensor, x: torch.Tensor, m: int, n: int,
                plan: SpmvOnehotPlan) -> torch.Tensor:
    """y = A @ x, (m,) f32, for a canonical CSR A (m, n) and its plan."""
    check_csr(indptr, indices, data, m, "spmv_onehot")
    check_dense(x, 1, n, data.device, "spmv_onehot")
    if (plan.m, plan.n, plan.nnz) != (m, n, data.numel()):
        raise ValueError(f"spmv_onehot: the plan is for a {plan.m}x{plan.n} "
                         f"matrix with {plan.nnz} entries, not {m}x{n} with "
                         f"{data.numel()}")
    if plan.row_s.device != data.device:
        raise ValueError(f"spmv_onehot: the plan is on {plan.row_s.device}, "
                         f"the matrix on {data.device}")
    if data.device.type == "cpu":
        return spmv_onehot_plain(indptr, indices, data, x, m, n, plan)
    y = torch.zeros(m, dtype=torch.float32, device=data.device)
    nchunks = plan.nchunks
    if nchunks == 0:
        return y  # no entries; a zero-size grid is a launch error
    carry = torch.zeros((2, nchunks), dtype=torch.float32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        err = lib.spmm_spmv_onehot(
            indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
            x.data_ptr(), plan.row_s.data_ptr(), plan.row_e.data_ptr(),
            nchunks, plan.ch, plan.nnz, carry[0].data_ptr(),
            carry[1].data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "spmv_onehot")
    _build.LAUNCHES["spmv_onehot"] += 1
    return y

"""SpMV over a per-call plan of row-length bins.

Port of `spmm_tpu/ops/kernels/spmv_binned.py` (`spmv_binned_plan`,
`spmv_binned`, Pallas `_spmv_binned_call`).  The TPU plan bins entries by
column class for its lane gather (a host-side numpy analysis); none of that
carries over, because Hopper gathers x directly.  The port's plan sorts the
rows, stably, into four length classes (bounds `CLASS_BOUNDS`), each served
by a group width in `csrc/spmv_binned.cu`: a thread, 8 lanes, a warp, or a
block of 1024 threads per row.  It is made on the matrix's device with no
host sync (a stable sort and a `searchsorted`), cheap enough to build on
every call, as the TPU's is.

On a CUDA tensor `spmv_binned` launches the kernel; on a CPU tensor it runs
`spmv_binned_plain`.  The TPU plan's limits (`n <= C*16384/R`, the class-
skew rejection) are not copied: this plan takes any canonical f32 CSR.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import check_csr, check_dense

# a row of length L goes to the first class whose bound is >= L
CLASS_BOUNDS = (4, 64, 2048)
NCLASSES = len(CLASS_BOUNDS) + 1


class SpmvBinnedPlan(NamedTuple):
    m: int
    n: int
    indptr: torch.Tensor     # (m+1,) i32, the CSR the plan was made for
    indices: torch.Tensor    # (nnz,) i32
    data: torch.Tensor       # (nnz,) f32
    rows: torch.Tensor       # (m,) i32 — rows sorted stably by class
    class_off: torch.Tensor  # (NCLASSES+1,) i32 — class bounds in `rows`


def spmv_binned_plan(indptr: torch.Tensor, indices: torch.Tensor,
                     data: torch.Tensor, m: int, n: int) -> SpmvBinnedPlan:
    """Row-length bins of a canonical CSR, on its device.  Any CSR gets a
    plan, an empty one included: its rows are written as 0."""
    check_csr(indptr, indices, data, m, "spmv_binned_plan")
    lens = indptr[1:] - indptr[:-1]
    bounds = torch.tensor(CLASS_BOUNDS, dtype=lens.dtype, device=lens.device)
    cls = torch.bucketize(lens, bounds, out_int32=True)
    sorted_cls, order = torch.sort(cls, stable=True)
    edges = torch.arange(NCLASSES + 1, dtype=torch.int32, device=lens.device)
    class_off = torch.searchsorted(sorted_cls, edges, out_int32=True)
    return SpmvBinnedPlan(m, n, indptr, indices, data,
                          order.to(prim.INDEX_DTYPE), class_off)


def spmv_binned_plain(x: torch.Tensor, plan: SpmvBinnedPlan) -> torch.Tensor:
    """Plain PyTorch version: per-row sums of data * x[indices]."""
    prod = plan.data * x[plan.indices.long()]
    return prim.segment_sum_rows(prod, plan.indptr)


def spmv_binned(x: torch.Tensor, plan: SpmvBinnedPlan) -> torch.Tensor:
    """y = A @ x, (m,) f32, for the CSR captured in `plan`."""
    check_dense(x, 1, plan.n, plan.data.device, "spmv_binned")
    if x.device.type == "cpu":
        return spmv_binned_plain(x, plan)
    y = torch.empty(plan.m, dtype=torch.float32, device=x.device)
    if plan.m == 0:
        return y  # a zero-size grid is a launch error
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.spmm_spmv_binned(
            plan.indptr.data_ptr(), plan.indices.data_ptr(),
            plan.data.data_ptr(), x.data_ptr(), plan.rows.data_ptr(),
            plan.class_off.data_ptr(), y.data_ptr(), plan.m,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "spmv_binned")
    _build.LAUNCHES["spmv_binned"] += 1
    return y

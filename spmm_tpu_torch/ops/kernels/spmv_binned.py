"""SpMV over a plan of row-length classes: one persistent launch.

Port of `spmm_tpu/ops/kernels/spmv_binned.py` (`spmv_binned_plan`,
`spmv_binned`, Pallas `_spmv_binned_call`).  The TPU plan bins entries by
column class for its lane gather (a host-side numpy analysis); none of that
carries over, because Hopper gathers x directly.  The port's plan
partitions the rows, stably, into four length classes (bounds
`CLASS_BOUNDS`), each served by a group width in `csrc/spmv_binned.cu`: a
thread, 8 lanes or a warp per row, and for the longest rows a block per
piece of `PIECE` entries, the pieces of one row added in order by the last
of their blocks (an integer counter in the plan picks it).

The plan is made on the matrix's device with no host sync and no sort, cheap
enough to build on every call, as the TPU's is.  On a CUDA tensor two plan
kernels of `csrc/spmv_binned.cu` build it (per-tile class counts, then each
tile's rows placed after the tiles before it); their plain version,
`spmv_binned_plan_plain`, which the CPU runs, takes one `cumsum` over the
class one-hot laid out class-major for every row's place, and a `cumsum`
over the rows' piece counts and a `searchsorted` for the pieces' table.
The counters start at zero and each launch resets them, so a plan may be
reused, on one stream at a time.

On a CUDA tensor `spmv_binned` launches the kernel; on a CPU tensor it runs
`spmv_binned_plain`.  The TPU plan's limits (`n <= C*16384/R`, the class-
skew rejection) are not copied: this plan takes any canonical f32 CSR.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import (check_csr, check_dense,
                                                csr_for_plan)

# a row of length L goes to the first class whose bound is >= L
CLASS_BOUNDS = (4, 64, 2048)
NCLASSES = len(CLASS_BOUNDS) + 1
PIECE = 4096  # entries of a class-3 row per block (csrc: kPiece)
ROWS_PER_UNIT = 8  # the fewest rows a unit of classes 0-2 holds (a warp each)
PLAN_TILE = 2048  # rows per block of the plan kernels (csrc: kTile)
PLAN_STATS = NCLASSES + 1  # per tile: the rows of each class, the pieces


class SpmvBinnedPlan(NamedTuple):
    m: int
    n: int
    indptr: torch.Tensor     # (m+1,) i32, the CSR the plan was made for
    indices: torch.Tensor    # (nnz,) i32
    data: torch.Tensor       # (nnz,) f32
    rows: torch.Tensor       # (m,) i32 — rows partitioned stably by class
    class_off: torch.Tensor  # (NCLASSES+1,) i32 — class bounds in `rows`
    piece_end: torch.Tensor  # (m,) i32 — running count of class-3 pieces
    piece_row: torch.Tensor  # (max_pieces,) i32 — the row of each piece
    counters: torch.Tensor   # (max_pieces,) i32 — 0 at each cut row's first
    partial: torch.Tensor    # (max_pieces,) f32 — scratch: piece sums
    max_units: int           # bound on the kernel's work units (host)


@functools.cache
def _consts(device: torch.device):
    """The class bounds and class ids as tensors on `device`, made once."""
    return (torch.tensor(CLASS_BOUNDS, dtype=torch.int32, device=device),
            torch.arange(NCLASSES, dtype=torch.int32,
                         device=device).unsqueeze(1))


def spmv_binned_plan_plain(indptr: torch.Tensor, m: int, max_pieces: int):
    """Plain PyTorch version of the plan kernels, on any device: (rows,
    class_off, piece_end, piece_row, counters) of a CSR's indptr (m > 0),
    with no host sync.  piece_row holds m past the last piece; the counters
    are all zero."""
    dev = indptr.device
    i32 = prim.INDEX_DTYPE
    bounds, class_ids = _consts(dev)
    lens = indptr[1:] - indptr[:-1]
    cls = torch.bucketize(lens, bounds, out_int32=True)
    # class-major running count: row r of class c goes to rank[c, r] - 1
    rank = (cls == class_ids).view(-1).cumsum(0, dtype=i32).view(NCLASSES, m)
    pos = rank.gather(0, cls.long().unsqueeze(0)).squeeze(0) - 1
    rows = torch.empty(m, dtype=i32, device=dev).scatter_(
        0, pos.long(), torch.arange(m, dtype=i32, device=dev))
    class_off = torch.cat([rank.new_zeros(1), rank[:, -1]])
    pieces = torch.where(cls == NCLASSES - 1, (lens + PIECE - 1) // PIECE, 0)
    piece_end = pieces.cumsum(0, dtype=i32)
    piece_row = torch.searchsorted(
        piece_end, torch.arange(max_pieces, dtype=i32, device=dev),
        right=True, out_int32=True)
    return (rows, class_off, piece_end, piece_row,
            torch.zeros(max_pieces, dtype=i32, device=dev))


def _plan_kernels(indptr: torch.Tensor, m: int, max_pieces: int):
    """The plan kernels' (rows, class_off, piece_end, piece_row, counters),
    views of one int32 buffer; counters are 0 where a launch reads them."""
    ntiles = -(-m // PLAN_TILE)
    sizes = [m, NCLASSES + 1, m, max_pieces, max_pieces, PLAN_STATS * ntiles]
    buf = torch.empty(sum(sizes), dtype=prim.INDEX_DTYPE, device=indptr.device)
    parts = torch.split(buf, sizes)
    err = _build.launch(indptr.get_device(), "spmm_spmv_binned_plan",
                        indptr.data_ptr(), m, ntiles,
                        *(t.data_ptr() for t in parts[-1:] + parts[:-1]))
    _build.check(err, "spmv_binned_plan")
    _build.LAUNCHES["spmv_binned_plan"] += 1
    return parts[:-1]


def spmv_binned_plan(indptr, indices, data, m: int, n: int,
                     device=None) -> SpmvBinnedPlan:
    """Row-length classes and hub pieces of a canonical CSR, with no host
    sync.  A tensor CSR's plan lies on its device (or on `device`, where it
    is given); a host CSR's (numpy arrays, as JAX's plan function takes)
    goes to the card unless `device="cpu"` is given.  Any CSR gets a plan, an empty
    one included: its rows are written as 0."""
    indptr, indices, data = csr_for_plan(indptr, indices, data, device)
    check_csr(indptr, indices, data, m, "spmv_binned_plan")
    dev = indptr.device
    nnz = data.numel()
    # every class-3 row has more than CLASS_BOUNDS[-1] entries: at most
    # nnz / 2049 of them, each with at most one piece short of PIECE
    max_pieces = nnz // PIECE + nnz // (CLASS_BOUNDS[-1] + 1) + 1
    max_units = -(-m // ROWS_PER_UNIT) + NCLASSES + max_pieces
    partial = torch.empty(max_pieces, dtype=torch.float32, device=dev)
    if m == 0:  # no rows: nothing to launch
        parts = tuple(torch.zeros(k, dtype=prim.INDEX_DTYPE, device=dev)
                      for k in (0, NCLASSES + 1, 0, max_pieces, max_pieces))
    elif dev.type == "cpu":
        parts = spmv_binned_plan_plain(indptr, m, max_pieces)
    else:
        parts = _plan_kernels(indptr, m, max_pieces)
    return SpmvBinnedPlan(m, n, indptr, indices, data, *parts, partial,
                          max_units)


def spmv_binned_plain(x: torch.Tensor, plan: SpmvBinnedPlan) -> torch.Tensor:
    """Plain PyTorch version: per-row sums of data * x[indices]."""
    prod = plan.data * x[plan.indices.long()]
    return prim.segment_sum_rows(prod, plan.indptr)


def spmv_binned(x: torch.Tensor, plan: SpmvBinnedPlan) -> torch.Tensor:
    """y = A @ x, (m,) f32, for the CSR captured in `plan`."""
    check_dense(x, 1, plan.n, plan.data.device, "spmv_binned")
    if not x.is_cuda:
        return spmv_binned_plain(x, plan)
    y = x.new_empty(plan.m)
    if plan.m == 0:
        return y  # a zero-size grid is a launch error
    err = _build.launch(
        x.get_device(), "spmm_spmv_binned", plan.indptr.data_ptr(),
        plan.indices.data_ptr(), plan.data.data_ptr(), x.data_ptr(),
        plan.rows.data_ptr(), plan.class_off.data_ptr(),
        plan.piece_end.data_ptr(), plan.piece_row.data_ptr(),
        plan.counters.data_ptr(), plan.partial.data_ptr(), y.data_ptr(),
        plan.m, plan.max_units)
    _build.check(err, "spmv_binned")
    _build.LAUNCHES["spmv_binned"] += 1
    return y

"""The serving SpMV and SpMM over a plan made once: SELL-32-sigma rows plus
chunked long rows.

Port of `spmm_tpu/ops/kernels/spmv_routed.py` (`spmv_routed_plan`,
`spmv_routed`, `spmm_routed`; Pallas `_spmv_routed_call`,
`_spmm_routed_call`, `_spmm_routed_call_matsum`,
`_spmm_routed_call_fused`).  The TPU plan edge-colours every 128-row group
(König) so that lane gathers and one static permute route each product to
its row's lane; that exists because a TPU cannot gather, and none of it
carries over.  The idea kept is the serving one: analyse the structure
once, re-lay the values so that the kernel streams them with no index work.

The port's plan, built on the matrix's device (a few host syncs for sizes,
each a `sync.<what>` span: `sync.long_rows`, `sync.long_chunks` and
`sync.long_nnz` in every plan):

  * rows of length <= `cut` go to SELL-32-sigma slices: sorted longest
    first within windows of `SIGMA` rows, 32 to a slice, each slice as wide
    as its longest row and stored column-major (`sell_col`, `sell_val`);
    dead slots carry val 0.0 and col 0, as the TPU plan's `val_tbl` does.
    The SpMV kernel splits a slice across 1, 2, 4 or 8 warps, at most
    `COLS` columns a warp (its class); the slices are stored in class
    order, most warps first, and `classes` counts each class;
  * rows longer than `cut` are cut into chunks of at most `ch` entries
    (`chunk_start`, `chunk_end`, and `chunk_row`, the long row each
    belongs to), summed a warp each and closed per row in chunk order, so
    no thread walks a long row alone.

`csrc/spmv_routed.cu` runs the SpMV over it in one launch: the plan's
`counters` (one a long row, zero when built, reset by the warp that closes
the row) pick which chunk's warp adds the row's `partial`s, so a call
allocates and zero-fills nothing but y.  A plan serves one launch at a
time: it is not shared by launches on two streams at once.
`csrc/spmm_routed.cu` runs the SpMM in one launch too, with the plan's
row order and the CSR arrays: a group of lanes a row (half a warp at
k = 64), and the same chunks for the long rows, taken in `chunk_order`
(by first column) and closed through the same counters.  `slack` is
slots / nnz, the statistic the JAX plan reports.  A plan made with
`sell=False` carries only the long-row chunks and their counters: it
serves `spmm_routed` (a per-call `spmm`), not `spmv_routed`.

Not copied from the TPU plan: its limit `n <= C*16384/R` (the x table's
reach), its rejection of pathological class skew, and its None for an
empty matrix (the public `spmv_plan` keeps that None).  This plan takes any
canonical float32 or float64 CSR tensor, and keeps its values, `sell_val`
and `partial` in that dtype: `spmv_routed` then runs in it
(`spmm_spmv_routed` or `spmm_spmv_routed_f64`, one layout and one order of
every sum), where the JAX package plans float32 alone.  Host arrays become
float32, as JAX's plan function takes them.  `spmm_routed` takes float32
plans only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from spmm_tpu_torch.ops import _primitives as prim
from spmm_tpu_torch.ops.kernels import _build
from spmm_tpu_torch.ops.kernels._checks import (check_csr, check_dense,
                                                csr_for_plan)
from spmm_tpu_torch.utils.profiler import span

CUT = 256        # rows longer than this leave the slices
CH = 512         # entries per chunk of a long row
SIGMA = 16384    # rows per sorting window
SLICE = 32       # rows per slice: a lane per row
COLS = 16        # slice columns a warp of the SpMV kernel takes, at most
WARPS = 8        # warps a slice is split across, at most (the block)

INDEX_DTYPE = prim.INDEX_DTYPE
DTYPES = (torch.float32, torch.float64)  # a plan's values: its dtype
# the SpMV kernel's C entry for each dtype
_SPMV_ENTRY = {torch.float32: "spmm_spmv_routed",
               torch.float64: "spmm_spmv_routed_f64"}


class SpmvRoutedPlan(NamedTuple):
    m: int
    n: int
    cut: int
    ch: int
    indptr: torch.Tensor          # (m+1,) i32 — the plan's CSR
    indices: torch.Tensor         # (nnz,) i32
    data: torch.Tensor            # (nnz,) f32 or f64: the plan's dtype
    long_rows: torch.Tensor       # (nlong,) i32 — rows longer than cut
    long_chunk_ptr: torch.Tensor  # (nlong+1,) i32 — chunks of each long row
    chunk_start: torch.Tensor     # (nchunks,) i32 — entry range of a chunk
    chunk_end: torch.Tensor       # (nchunks,) i32
    chunk_row: torch.Tensor       # (nchunks,) i32 — its long row's index
    # (nchunks,) i32 — the chunks by (first column, chunk id): the order
    # in which the SpMM kernel takes them
    chunk_order: torch.Tensor
    counters: torch.Tensor        # (nlong,) i32 — zeros
    slots: int                    # slice slots + long-row entries
    order: Optional[torch.Tensor] = None       # (ns,) i32 — slice rows
    slice_rows: Optional[torch.Tensor] = None  # (nslices*32,) i32, -1 pads
    slice_ptr: Optional[torch.Tensor] = None   # (nslices+1,) i64 — slots
    sell_col: Optional[torch.Tensor] = None    # (slice slots,) i32
    sell_val: Optional[torch.Tensor] = None    # (slice slots,) data's
    # slices split across 8, 4, 2 and 1 warps, stored in that order
    classes: Tuple[int, int, int, int] = (0, 0, 0, 0)
    partial: Optional[torch.Tensor] = None     # (nchunks,) data's — scratch

    @property
    def nnz(self) -> int:
        return int(self.data.numel())

    @property
    def nslices(self) -> int:
        return 0 if self.slice_ptr is None else self.slice_ptr.numel() - 1

    @property
    def slack(self) -> float:
        """Slots streamed per stored entry (1.0 = no padding)."""
        return self.slots / max(self.nnz, 1)


def slice_warps(width: torch.Tensor) -> torch.Tensor:
    """The warps the SpMV kernel splits a slice of `width` columns across:
    the fewest of 1, 2, 4 and 8 that give each at most COLS columns, else
    8."""
    w = torch.ones_like(width)
    for k in (1, 2, 4):
        w = torch.where(width > k * COLS, 2 * k, w)
    return w


def _long_row_chunks(indptr: torch.Tensor, lens: torch.Tensor, cut: int,
                     ch: int):
    """(long_rows, long_chunk_ptr, chunk_start, chunk_end, chunk_row) of
    the rows longer than `cut`, each cut into chunks of at most `ch`
    entries.  Two host syncs: `nonzero`'s size (span `sync.long_rows`) and
    the chunk count (`sync.long_chunks`)."""
    dev = indptr.device
    with span("sync.long_rows"):
        long_rows = torch.nonzero(lens > cut).flatten()
    llens = lens[long_rows]
    nch = (llens + ch - 1) // ch
    zero = torch.zeros(1, dtype=INDEX_DTYPE, device=dev)
    long_chunk_ptr = torch.cat([zero, torch.cumsum(nch, 0, dtype=INDEX_DTYPE)])
    nchunks = prim.read_host(long_chunk_ptr[-1], "long_chunks")
    owner = torch.repeat_interleave(
        torch.arange(long_rows.numel(), device=dev), nch.long(),
        output_size=nchunks)
    q = torch.arange(nchunks, dtype=torch.int64, device=dev) \
        - long_chunk_ptr[owner].long()
    row = long_rows[owner]
    start = indptr[row].long() + q * ch
    end = torch.minimum(start + ch, indptr[row + 1].long())
    return (long_rows.to(INDEX_DTYPE), long_chunk_ptr,
            start.to(INDEX_DTYPE), end.to(INDEX_DTYPE),
            owner.to(INDEX_DTYPE))


def spmv_routed_plan(indptr, indices, data, m: int, n: int, *,
                     cut: int = CUT, ch: int = CH, sell: bool = True,
                     device=None) -> SpmvRoutedPlan:
    """The serving plan of a canonical f32 or f64 CSR (see the module
    docstring), in the dtype of a tensor CSR's values, float32 for host
    arrays.  A tensor CSR's plan lies on its device (or on `device`, where
    it is given); a host CSR's (numpy arrays, as JAX's plan function takes)
    goes to the card unless `device="cpu"` is given.  `sell=False` skips
    the slices (an SpMM-only plan, cheap enough to make per call).  `cut`
    and `ch` set the long-row threshold and chunk length (tests lower them
    to reach the long-row path at small sizes)."""
    indptr, indices, data = csr_for_plan(indptr, indices, data, device)
    check_csr(indptr, indices, data, m, "spmv_routed_plan", dtypes=DTYPES)
    if cut < 1 or ch < 1:
        raise ValueError(f"spmv_routed_plan: cut and ch must be positive, "
                         f"got {cut}, {ch}")
    dev = data.device
    lens = (indptr[1:] - indptr[:-1]).long()
    long_rows, long_chunk_ptr, chunk_start, chunk_end, chunk_row = \
        _long_row_chunks(indptr, lens, cut, ch)
    long_nnz = prim.read_host(lens[long_rows.long()].sum(), "long_nnz")
    # stable: chunks with the same first column keep their id order
    chunk_order = torch.sort(indices[chunk_start.long()],
                             stable=True).indices.to(INDEX_DTYPE)
    plan = SpmvRoutedPlan(m, n, cut, ch, indptr, indices, data, long_rows,
                          long_chunk_ptr, chunk_start, chunk_end, chunk_row,
                          chunk_order,
                          torch.zeros(long_rows.numel(), dtype=INDEX_DTYPE,
                                      device=dev),
                          slots=long_nnz)
    if not sell:
        return plan

    # slice rows: longest first within each window of SIGMA rows (stable,
    # so ties keep row order)
    short = torch.nonzero(lens <= cut).flatten()
    key = (short // SIGMA) * (cut + 1) + (cut - lens[short])
    order = short[torch.sort(key, stable=True).indices]
    ns = order.numel()
    nslices = -(-ns // SLICE)
    pad = nslices * SLICE - ns
    slice_rows = torch.cat([order, torch.full((pad,), -1, dtype=order.dtype,
                                              device=dev)])
    width = torch.cat([lens[order], torch.zeros(pad, dtype=lens.dtype,
                                                device=dev)])
    width = width.view(nslices, SLICE).amax(1) if nslices else width
    # the slices in class order, most warps first (stable): slice s of
    # `order` is stored as slice inv[s]
    warps = slice_warps(width)
    perm = torch.sort(WARPS - warps, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(nslices, device=dev)
    width = width[perm]
    slice_rows = slice_rows.view(nslices, SLICE)[perm].reshape(-1)
    slice_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(width * SLICE, 0)])
    counts = torch.stack([(warps == w).sum() for w in (8, 4, 2, 1)])
    # host sync: the layout's size and the class counts, in one read
    nslots, *classes = torch.cat([slice_ptr[-1:], counts]).tolist()

    # slot of every entry of a slice row: slice_ptr[s] + 32*j + lane
    pos = torch.full((m,), -1, dtype=torch.int64, device=dev)
    pos[order] = torch.arange(ns, device=dev)
    rows = prim.rows_from_indptr(indptr, data.numel()).long()
    ent = torch.nonzero(lens[rows] <= cut).flatten()
    er = rows[ent]
    p = pos[er]
    slot = (slice_ptr[inv[p // SLICE]] + (ent - indptr[er].long()) * SLICE
            + p % SLICE)
    sell_col = torch.zeros(nslots, dtype=INDEX_DTYPE, device=dev)
    sell_val = torch.zeros(nslots, dtype=data.dtype, device=dev)
    sell_col[slot] = indices[ent]
    sell_val[slot] = data[ent]
    return plan._replace(
        slots=nslots + long_nnz, order=order.to(INDEX_DTYPE),
        slice_rows=slice_rows.to(INDEX_DTYPE), slice_ptr=slice_ptr,
        sell_col=sell_col, sell_val=sell_val, classes=tuple(classes),
        partial=torch.empty(chunk_row.numel(), dtype=data.dtype,
                            device=dev))


def _long_partials(v: torch.Tensor, plan: SpmvRoutedPlan) -> torch.Tensor:
    """Per-chunk sums of data * v[indices] over the long rows' chunks, v a
    vector or a row-major matrix: (nchunks,) or (nchunks, k)."""
    dev = plan.data.device
    lens = (plan.chunk_end - plan.chunk_start).long()
    cptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(lens, 0)])
    total = int(cptr[-1])
    owner = prim.rows_from_indptr(cptr, total).long()
    e = (torch.arange(total, device=dev) - cptr[owner]
         + plan.chunk_start[owner].long())
    vals = plan.data[e]
    if v.dim() == 2:
        vals = vals[:, None]
    return prim.segment_sum_rows(vals * v[plan.indices[e].long()], cptr)


def spmv_routed_plain(x: torch.Tensor, plan: SpmvRoutedPlan) -> torch.Tensor:
    """Plain PyTorch version over the plan's own layout: every slot's
    product (dead slots add 0.0 * x[0]) summed into its slice row, and the
    long rows from their chunks, in the plan's dtype."""
    _need_sell(plan)
    dev = plan.data.device
    y = torch.zeros(plan.m, dtype=plan.data.dtype, device=dev)
    nslots = plan.sell_val.numel()
    if nslots:
        per_slice = plan.slice_ptr[1:] - plan.slice_ptr[:-1]
        sl = torch.repeat_interleave(
            torch.arange(plan.nslices, device=dev), per_slice,
            output_size=nslots)
        lane = (torch.arange(nslots, device=dev) - plan.slice_ptr[sl]) % SLICE
        row = plan.slice_rows[sl * SLICE + lane].long()
        live = row >= 0
        prod = plan.sell_val * x[plan.sell_col.long()]
        y.index_add_(0, row[live], prod[live])
    if plan.long_rows.numel():
        y[plan.long_rows.long()] = prim.segment_sum_rows(
            _long_partials(x, plan), plan.long_chunk_ptr)
    return y


def spmv_routed(x: torch.Tensor, plan: SpmvRoutedPlan) -> torch.Tensor:
    """y = A @ x, (m,) in the plan's dtype (x's too), for the CSR captured
    in `plan`."""
    # one expression on every call (the plan was checked when it was
    # built); the worded checks only where it fails
    val = plan.sell_val
    if not (val is not None and isinstance(x, torch.Tensor)
            and x.dtype == val.dtype and x.shape == (plan.n,)
            and x.get_device() == val.get_device() and x.is_contiguous()):
        _need_sell(plan)
        check_dense(x, 1, plan.n, plan.data.device, "spmv_routed",
                    val.dtype)
        raise ValueError("spmv_routed: x does not fit the plan")
    if not x.is_cuda:
        return spmv_routed_plain(x, plan)
    y = x.new_empty(plan.m)
    if plan.m == 0:
        return y  # a zero-size grid is a launch error
    err = _build.launch(
        x.get_device(), _SPMV_ENTRY[val.dtype], plan.slice_ptr.data_ptr(),
        plan.slice_rows.data_ptr(), plan.sell_col.data_ptr(), val.data_ptr(),
        *plan.classes, plan.indices.data_ptr(), plan.data.data_ptr(),
        plan.chunk_start.data_ptr(), plan.chunk_end.data_ptr(),
        plan.chunk_row.data_ptr(), plan.chunk_row.numel(),
        plan.long_rows.data_ptr(), plan.long_chunk_ptr.data_ptr(),
        x.data_ptr(), plan.counters.data_ptr(), plan.partial.data_ptr(),
        y.data_ptr())
    _build.check(err, "spmv_routed")
    _build.LAUNCHES["spmv_routed"] += 1
    return y


def spmm_routed_plain(x: torch.Tensor, plan: SpmvRoutedPlan) -> torch.Tensor:
    """Plain PyTorch version: per-row sums of data[:, None] * X[indices]."""
    prod = plan.data[:, None] * x[plan.indices.long()]
    return prim.segment_sum_rows(prod, plan.indptr)


def spmm_groups(k: int, vec4: bool) -> Tuple[int, int]:
    """(G, VEC) of `csrc/spmm_routed.cu` for k columns: VEC = 4 columns a
    lane where `vec4` (k % 4 == 0 and X, Y, the partials 16-byte aligned),
    else 1; G the fewest of 8, 16 and 32 lanes that reach k, else 32 (and
    k split into column blocks of G * VEC)."""
    vec = 4 if vec4 else 1
    lanes = -(-k // vec)
    return next((g for g in (8, 16) if lanes <= g), 32), vec


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf on float32 tensors: the exact product and sum in float64,
    rounded once (twice, through float64, in a rare tie: an emulation)."""
    return (a.double() * b.double() + c.double()).float()


def spmm_routed_schedule(x: torch.Tensor, plan: SpmvRoutedPlan, group: int,
                         vec: int = 1, seed: int = 0) -> torch.Tensor:
    """CPU emulation of `csrc/spmm_routed.cu`'s work split, for tests: the
    items (a chunk of a long row in `chunk_order`, then a row up to `cut`,
    each with a column block of group * vec columns) finish in a random
    order drawn from `seed`; a chunk stores its partial and counts its row,
    and the item whose count completes the row adds the row's partials in
    chunk order from 0.0 and resets the counter.  Sums are fmaf chains in
    entry order.  Checks that every cell is written once and every counter
    is left at zero."""
    import numpy as np

    k = x.shape[1]
    reach = group * vec
    ncb = -(-k // reach)
    nchunks = plan.chunk_order.numel()
    rows = (plan.order.tolist() if plan.order is not None
            else list(range(plan.m)))
    items = [("chunk", c, b) for c in plan.chunk_order.tolist()
             for b in range(ncb)]
    items += [("row", r, b) for r in rows for b in range(ncb)]
    ip = plan.indptr.tolist()
    cptr = plan.long_chunk_ptr.tolist()
    y = torch.full((plan.m, k), float("nan"))
    written = torch.zeros((plan.m, k), dtype=torch.int32)
    partial = torch.full((max(nchunks, 1), k), float("nan"))
    counters = plan.counters.clone()

    def dot(s, e, cols):
        acc = torch.zeros(cols.stop - cols.start)
        for t in range(s, e):
            acc = _fmaf(plan.data[t], x[int(plan.indices[t]), cols], acc)
        return acc

    for i in np.random.default_rng(seed).permutation(len(items)):
        kind, j, b = items[i]
        cols = slice(b * reach, min((b + 1) * reach, k))
        if kind == "row":
            if ip[j + 1] - ip[j] <= plan.cut:
                y[j, cols] = dot(ip[j], ip[j + 1], cols)
                written[j, cols] += 1
            continue
        partial[j, cols] = dot(int(plan.chunk_start[j]),
                               int(plan.chunk_end[j]), cols)
        r = int(plan.chunk_row[j])
        counters[r] += 1
        if counters[r] == (cptr[r + 1] - cptr[r]) * ncb:
            acc = torch.zeros(k)
            for p in range(cptr[r], cptr[r + 1]):
                acc = acc + partial[p]
            row = int(plan.long_rows[r])
            y[row] = acc
            written[row] += 1
            counters[r] = 0
    assert bool((written == 1).all()), "a cell written other than once"
    assert not counters.any(), "a counter left set"
    return y


def spmm_routed(x: torch.Tensor, plan: SpmvRoutedPlan) -> torch.Tensor:
    """Y = A @ X, (m, k) f32 row-major, for a contiguous row-major X (n, k)
    and the CSR captured in a float32 `plan` (either kind of plan)."""
    # one expression on every call (the plan was checked when it was
    # built); the worded checks only where it fails
    data = plan.data
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and data.dtype == torch.float32
            and x.dim() == 2 and x.shape[0] == plan.n
            and x.get_device() == data.get_device() and x.is_contiguous()):
        if data.dtype != torch.float32:
            raise ValueError(f"spmm_routed: the plan is {data.dtype}; the "
                             f"kernel takes float32 plans only")
        check_dense(x, 2, plan.n, data.device, "spmm_routed")
        raise ValueError("spmm_routed: x does not fit the plan")
    if not x.is_cuda:
        return spmm_routed_plain(x, plan)
    k = x.shape[1]
    y = x.new_empty((plan.m, k))
    if plan.m == 0 or k == 0:
        return y  # a zero-size grid is a launch error
    nchunks = plan.chunk_start.numel()
    partial = x.new_empty((max(nchunks, 1), k))  # scratch of this call
    order = plan.order
    err = _build.launch(
        x.get_device(), "spmm_spmm_routed", plan.indptr.data_ptr(),
        plan.indices.data_ptr(), data.data_ptr(),
        None if order is None else order.data_ptr(),
        plan.m if order is None else order.numel(), plan.cut,
        plan.chunk_start.data_ptr(), plan.chunk_end.data_ptr(),
        plan.chunk_row.data_ptr(), plan.chunk_order.data_ptr(), nchunks,
        plan.long_rows.data_ptr(), plan.long_chunk_ptr.data_ptr(),
        plan.counters.data_ptr(), x.data_ptr(), k, partial.data_ptr(),
        y.data_ptr())
    _build.check(err, "spmm_routed")
    _build.LAUNCHES["spmm_routed"] += 1
    return y


def _need_sell(plan: SpmvRoutedPlan) -> None:
    if plan.slice_ptr is None:
        raise ValueError("spmv_routed: this plan was made with sell=False "
                         "(SpMM only); make it with sell=True")
